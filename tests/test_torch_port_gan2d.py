"""The gan2d baseline on the CPU, the port against ``sdface_gan_tpu/gan2d/``
in f32, same weights and inputs:

* the generator at 16^2, 32^2 and 64^2 on weights carried across either
  way: <= 1e-5 of the output's max;
* the D and G steps on JAX's own codes (``jax.random.normal`` repeated):
  losses within 1e-4 relative, each gradient within 1e-3 of its norm
  (JAX's step functions with an optax transform that keeps the gradient
  as its state); the EMA within 1e-6 of JAX's after a real RMSprop step;
* a gan2d ``model`` tree built by the JAX package and written with
  ``scripts/export_jax_checkpoint.py``'s ``to_archive`` imports through
  ``import_jax_checkpoints --sdf 0`` (``method: gan2d``), and ``train --sdf
  0 --device cpu`` resumes it, logs, visualises and saves.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import optax  # noqa: E402

from sdface_gan_tpu.gan2d import generator as j_gen  # noqa: E402
from sdface_gan_tpu.gan2d import trainer as j_trainer  # noqa: E402
from sdface_gan_tpu.giraffe import discriminator as j_disc  # noqa: E402
from sdface_gan_tpu_torch import import_jax_checkpoints as import_cli  # noqa: E402
from sdface_gan_tpu_torch import train as train_cli  # noqa: E402
from sdface_gan_tpu_torch.gan2d import generator as p_gen  # noqa: E402
from sdface_gan_tpu_torch.gan2d import trainer as p_trainer  # noqa: E402
from sdface_gan_tpu_torch.giraffe import discriminator as p_disc  # noqa: E402
from sdface_gan_tpu_torch.training.ema import accumulate  # noqa: E402
from sdface_gan_tpu_torch.training.optim import RMSprop  # noqa: E402
from sdface_gan_tpu_torch.utils import checkpoints  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import (  # noqa: E402
    jax_dc_disc_params_to_state_dict,
    jax_gan2d_params_to_state_dict,
)

from test_torch_port_giraffe import REPO, T, _jax_tree  # noqa: E402
from test_torch_port_giraffe_training import (  # noqa: E402,F401
    _Capture,
    _capture_tx,
    _close_grads,
    _close_loss,
    _jit,
    _of_max,
)
from test_torch_port_training import _two_threads  # noqa: E402,F401  (autouse: two threads)

sys.path.insert(0, str(REPO / "scripts"))
from export_jax_checkpoint import to_archive  # noqa: E402

BATCH, Z, SIZE = 2, 8, 16


def _cfgs(size=SIZE, z=Z):
    kw = dict(z_dim=z, size=size, nfilter=4, nfilter_max=16)
    return j_gen.Gan2dGeneratorConfig(**kw), p_gen.Gan2dGeneratorConfig(**kw)


@pytest.mark.parametrize("size", [16, 32, 64])
def test_gan2d_generator_matches_jax(size):
    """Images in [-1, 1], both ways: JAX's init through the converter, the
    port's init through the inverse."""
    jcfg, pcfg = _cfgs(size)
    z = np.random.default_rng(size).standard_normal((3, Z)).astype(np.float32)
    apply = _jit(functools.partial(j_gen.apply_gan2d_generator, cfg=jcfg))
    jp = _jit(j_gen.init_gan2d_generator, static_argnums=1)(jax.random.PRNGKey(size), jcfg)
    from_jax = p_gen.Gan2dGenerator(pcfg)
    from_jax.load_state_dict(jax_gan2d_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jp)))
    ours = p_gen.Gan2dGenerator(pcfg, torch.Generator().manual_seed(size))
    for params, model in ((jp, from_jax), (_jax_tree(ours.state_dict()), ours)):
        with torch.no_grad():
            got = model(T(z))
        assert got.shape == (3, size, size, 3)
        _of_max(got, apply(params, z=z))


@functools.lru_cache(maxsize=None)
def _models():
    jcfg, pcfg = _cfgs()
    g = p_gen.Gan2dGenerator(pcfg, torch.Generator().manual_seed(1))
    d = p_disc.DCDiscriminator(p_disc.DCDiscConfig(n_feat=16, img_size=SIZE),
                               torch.Generator().manual_seed(2))
    return _jax_tree(g.state_dict()), _jax_tree(d.state_dict()), g, d


def _setup():
    jcfg, pcfg = _cfgs()
    jd = j_disc.DCDiscConfig(n_feat=16, img_size=SIZE)
    return jcfg, pcfg, jd, j_trainer.Gan2dTrainHParams(batch_size=BATCH), \
        p_trainer.Gan2dTrainHParams(batch_size=BATCH)


def _fresh(module):
    import copy

    return copy.deepcopy(module)


X_REAL = np.random.default_rng(3).random((BATCH, SIZE, SIZE, 3), dtype=np.float32)


def test_gan2d_d_step_matches_jax():
    jcfg, pcfg, jd, jhp, php = _setup()
    gp, dp, g, d = _models()
    key = jax.random.PRNGKey(4)
    step = _jit(j_trainer.make_gan2d_d_step(jcfg, jd, jhp, _capture_tx()))
    _, grads, metrics = step(gp, dp, _capture_tx().init(dp), key, X_REAL)
    g, d = _fresh(g), _fresh(d)
    opt = _Capture(d)
    z = T(jax.random.normal(key, (BATCH, Z)))
    got = p_trainer.gan2d_d_step(g, d, opt, php, T(X_REAL), z)
    for k in ("discriminator", "regularizer"):
        _close_loss(got[k], metrics[k])
    _close_grads(opt.grads, jax_dc_disc_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, grads)))
    assert all(p.grad is None for p in list(g.parameters()) + list(d.parameters()))


def test_gan2d_g_step_and_ema_match_jax():
    """The G step's gradients (none into D), and after a real RMSprop step
    the EMA over every leaf within 1e-6 of JAX's."""
    jcfg, pcfg, jd, jhp, php = _setup()
    gp, dp, g, d = _models()
    key = jax.random.PRNGKey(5)
    step = _jit(j_trainer.make_gan2d_g_step(jcfg, jd, jhp, _capture_tx()))
    _, grads, _, metrics = step(gp, dp, _capture_tx().init(gp), gp, key)
    g0, d0 = _fresh(g), _fresh(d)
    opt = _Capture(g0)
    z = T(jax.random.normal(key, (BATCH, Z)))
    got = p_trainer.gan2d_g_step(g0, d0, opt, _fresh(g), php, z)
    _close_loss(got["generator"], metrics["generator"])
    _close_grads(opt.grads, jax_gan2d_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, grads)))
    assert all(p.grad is None and p.requires_grad for p in d0.parameters())

    tx = optax.rmsprop(jhp.lr_g, decay=0.99, eps=1e-8)
    ema_tree = _jax_tree(p_gen.Gan2dGenerator(pcfg, torch.Generator().manual_seed(6))
                         .state_dict())
    new_g, _, new_ema, _ = _jit(j_trainer.make_gan2d_g_step(jcfg, jd, jhp, tx))(
        gp, dp, tx.init(gp), ema_tree, key)
    ema, g_new = p_gen.Gan2dGenerator(pcfg), p_gen.Gan2dGenerator(pcfg)
    conv = functools.partial(jax.tree_util.tree_map, np.asarray)
    ema.load_state_dict(jax_gan2d_params_to_state_dict(conv(ema_tree)))
    g_new.load_state_dict(jax_gan2d_params_to_state_dict(conv(new_g)))
    accumulate(ema, g_new, php.ema_beta)
    want = jax_gan2d_params_to_state_dict(conv(new_ema))
    for k, v in ema.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-6)


# ------------------------------------------------------- import and the CLI
GAN2D_YAML = """method: gan2d
data:
  path: tests/fixtures/images/head*[gp]
  img_size: 16
model:
  z_dim: 16
training:
  out_dir: out/g2d
  batch_size: 2
  max_it: 3
  print_every: 1
  checkpoint_every: 1
  visualize_every: 3
"""


def _jax_gan2d_run():
    """A gan2d ``model`` tree as JAX's loop saves it after one iteration (its
    RMSprop states stepped once, so that nu is not zero)."""
    jcfg = j_gen.Gan2dGeneratorConfig(z_dim=16, size=16)
    jd = j_disc.DCDiscConfig(img_size=16)
    hp = j_trainer.Gan2dTrainHParams(batch_size=2)
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    g = _jit(j_gen.init_gan2d_generator, static_argnums=1)(kg, jcfg)
    d = _jit(j_disc.init_dc_discriminator, static_argnums=1)(kd, jd)
    tx = optax.rmsprop(5e-4, decay=0.99, eps=1e-8)
    g_state, d_state = tx.init(g), optax.rmsprop(1e-4, decay=0.99, eps=1e-8).init(d)
    d_tx = optax.rmsprop(1e-4, decay=0.99, eps=1e-8)
    x = np.random.default_rng(0).random((2, 16, 16, 3), dtype=np.float32)
    d, d_state, _ = _jit(j_trainer.make_gan2d_d_step(jcfg, jd, hp, d_tx))(
        g, d, d_state, jax.random.PRNGKey(1), x)
    g_new, g_state, g_ema, _ = _jit(j_trainer.make_gan2d_g_step(jcfg, jd, hp, tx))(
        g, d, g_state, g, jax.random.PRNGKey(2))
    # the optimizer states as orbax restores them: the rmsprop chain's
    # ScaleByRmsState a dict, its empty states without a leaf
    return {"g": g_new, "d": d, "g_ema": g_ema, "g_opt": [{"nu": g_state[0].nu}],
            "d_opt": [{"nu": d_state[0].nu}], "it": 1}


def test_gan2d_run_imports_and_trains_on(tmp_path, monkeypatch, capsys):
    """The JAX tree through ``to_archive`` and the import CLI: every tensor
    and nu equal to JAX's; then ``train --sdf 0`` resumes it at it 2, writes
    a metrics line per iteration, a 4-wide grid at ``visualize_every`` and
    ``model`` at it 3."""
    tree = _jax_gan2d_run()
    (tmp_path / "run").mkdir()
    np.savez(tmp_path / "run" / "model.npz", **to_archive(tree))
    (tmp_path / "g2d.yaml").write_text(GAN2D_YAML)
    os.symlink(REPO / "tests", tmp_path / "tests")
    monkeypatch.chdir(tmp_path)
    import_cli.main(["--src", "run", "--config", "g2d.yaml", "--sdf", "0"])
    assert "wrote" in capsys.readouterr().out
    state = checkpoints.load_checkpoint("out/g2d", "model")
    assert set(state) == {"g", "d", "g_ema", "g_opt", "d_opt", "it"} and state["it"] == 1
    conv = functools.partial(jax.tree_util.tree_map, np.asarray)
    for k, converter in (("g", jax_gan2d_params_to_state_dict), ("g_ema",
                         jax_gan2d_params_to_state_dict), ("d", jax_dc_disc_params_to_state_dict)):
        want = converter(conv(tree[k]))
        assert all(torch.equal(state[k][n], v) for n, v in want.items()), k
    g = p_gen.Gan2dGenerator(p_gen.Gan2dGeneratorConfig(z_dim=16, size=16))
    opt = RMSprop(g.parameters(), 5e-4)
    opt.load_state_dict(state["g_opt"])
    nu = jax_gan2d_params_to_state_dict(conv(tree["g_opt"][0]["nu"]))
    for n, p in g.named_parameters():
        assert torch.equal(opt.state[p]["nu"], nu[n]), n
    assert float(nu["fc.weight"].abs().max()) > 0

    train_cli.main(["--config", "g2d.yaml", "--sdf", "0", "--device", "cpu"])
    out = tmp_path / "out" / "g2d"
    rows = [json.loads(line) for line in open(out / "gan2d_metrics.jsonl")]
    assert [r["step"] for r in rows] == [2, 3]
    assert all(np.isfinite(r[k]) for r in rows for k in ("discriminator", "regularizer",
                                                           "generator"))
    assert checkpoints.load_checkpoint(str(out), "model")["it"] == 3
    from sdface_gan_tpu_torch.data.png import decode_png

    assert decode_png((out / "vis_0000003.png").read_bytes()).shape == (4 * 16, 4 * 16, 3)

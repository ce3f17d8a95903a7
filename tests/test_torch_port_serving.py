"""The port's sampler, its device contract and its independence from JAX."""

import ast
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu.geometry import generate_camera_params as j_cams  # noqa: E402
from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.utils.torch_import import import_generator_state  # noqa: E402
from sdface_gan_tpu_torch.geometry import generate_camera_params  # noqa: E402
from sdface_gan_tpu_torch.models.generator import Generator  # noqa: E402
from sdface_gan_tpu_torch.ops import _ext  # noqa: E402
from sdface_gan_tpu_torch.serving import SDFaceSampler  # noqa: E402

from test_torch_import import _build_reference_state  # noqa: E402
from test_torch_port_models import (  # noqa: E402
    DEPTH,
    IMAGE_TOL,
    RES,
    SIZE,
    STYLE,
    WIDTH,
    _configs,
    _port_model,
)
from test_torch_port_training import _two_threads  # noqa: E402,F401  (autouse: two threads)

PACKAGE = Path(__file__).resolve().parents[1] / "sdface_gan_tpu_torch"


@pytest.fixture(scope="module")
def tiny():
    state = _build_reference_state(depth=DEPTH, width=WIDTH, style=STYLE, size=SIZE,
                                   in_res=RES)
    jcfg, pcfg = _configs()
    return state, jcfg, pcfg


@pytest.mark.parametrize("request_kind,dtype", [
    ("seed", "float32"), ("angles", "float32"), ("seed", "bfloat16")])
def test_sampler_serves_finite_images_on_cpu(tiny, request_kind, dtype):
    state, _, pcfg = tiny
    before = _ext.LAUNCHES["siren_field"]
    sampler = SDFaceSampler.from_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                                            pcfg, device="cpu", dtype=getattr(torch, dtype),
                                            batch=3)
    if request_kind == "seed":
        img = sampler.sample(seed=4)
        again = sampler.sample(seed=4)
        assert torch.equal(img, again)
    else:
        img = sampler.sample(azim=0.2, elev=-0.1)
    assert img.shape == (3, SIZE, SIZE, 3)
    assert img.dtype == getattr(torch, dtype)
    assert bool(torch.isfinite(img).all())
    assert _ext.LAUNCHES["siren_field"] == before  # the CPU runs the plain version


def test_sampler_matches_jax_generator_forward(tiny):
    """Same weights, z, cameras (azim/elev) and truncation pair: the
    sampler's image equals JAX ``generator_forward``'s in eval mode."""
    state, jcfg, pcfg = tiny
    pcfg = replace(pcfg, renderer=replace(pcfg.renderer, perturb=0.0))
    params = import_generator_state(state, renderer_type="sdf", depth=DEPTH)
    rng = np.random.default_rng(21)
    z = rng.standard_normal((2, STYLE)).astype(np.float32)
    zs = rng.standard_normal((32, STYLE)).astype(np.float32)
    r_lat = j_gen.map_style(params, jnp.asarray(zs))
    from sdface_gan_tpu.models.stylegan2 import decoder_mean_latent

    pair = (jnp.mean(r_lat, 0, keepdims=True),
            decoder_mean_latent(params["decoder"], jcfg.decoder, r_lat))
    azim, elev = 0.25, -0.05
    cams = j_cams(RES, None, locations=jnp.asarray([[azim, elev]] * 2, jnp.float32))
    ref = j_gen.generator_forward(params, jcfg, [jnp.asarray(z)], cams.extrinsics,
                                  cams.focal, cams.near, cams.far, key=None,
                                  truncation=0.7, truncation_latent=pair,
                                  randomize_noise=False)
    model = _port_model(state, pcfg)
    sampler = SDFaceSampler(model, batch=2, truncation=0.7,
                            truncation_latent=tuple(torch.from_numpy(np.array(t)) for t in pair))
    ours = sampler.sample(z=z, azim=azim, elev=elev)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref.rgb), **IMAGE_TOL)


def test_sampler_from_jax_params_matches_from_state_dict(tiny):
    state, _, pcfg = tiny
    params = import_generator_state(state, renderer_type="sdf", depth=DEPTH)
    a = SDFaceSampler.from_jax_params(params, pcfg, device="cpu", batch=2)
    b = SDFaceSampler.from_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                                      pcfg, device="cpu", batch=2)
    assert torch.equal(a.sample(seed=3), b.sample(seed=3))


def test_entry_points_refuse_a_missing_card(tiny):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    state, _, pcfg = tiny
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SDFaceSampler.from_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, pcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Generator(pcfg)
    # cameras without a device: the sweep path, and the random path with a
    # CPU generator, must not fall back to the CPU
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_camera_params(RES, batch=2, sweep=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_camera_params(RES, torch.Generator().manual_seed(0), batch=2)


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sdface_gan_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'yaml', 'PIL')\n"
        "       or m == 'sdface_gan_tpu' or m.startswith('sdface_gan_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith('sdface_gan_tpu_torch')]))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=PACKAGE.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15  # every submodule was imported


def test_no_source_file_imports_jax_or_the_jax_package():
    """Nor PyYAML or PIL, which the card's machine lacks: the port reads its
    yaml and PNG files itself."""
    def banned(name):
        return (name.split(".")[0] in ("jax", "yaml", "PIL")
                or name == "sdface_gan_tpu" or name.startswith("sdface_gan_tpu."))

    files = sorted(PACKAGE.rglob("*.py")) + [PACKAGE.parent / "chip_smoke.py"]
    assert files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(banned(n) for n in names), (path, names)

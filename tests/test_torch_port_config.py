"""The port's config layer against PyYAML and the JAX package, on the CPU.

* the YAML subset reader against ``yaml.safe_load`` on every file of
  ``configs/`` and on the plain-scalar forms YAML 1.1 resolves, and its
  refusals; the writer read back by both;
* ``load_config`` (``inherit_from`` over ``configs/default.yaml``)
  against the JAX package's, on every file;
* the per-stage resolution of every ``configs/**/*sdf*.yaml`` (stage A and
  B; ``--ngp``/``--fc`` where ``resolve_renderer_type`` allows) and the
  dataclasses built from it, against the JAX package's.

Every comparison is exact.
"""

import dataclasses
import glob
import math
import os

import pytest
import yaml

from sdface_gan_tpu.config import build as j_build
from sdface_gan_tpu.config import load_config as j_load_config
from sdface_gan_tpu.config import sdf_options as j_opts
from sdface_gan_tpu.config.yaml_config import default_config_path as j_default
from sdface_gan_tpu_torch.config import build, load_config, save_config, sdf_options
from sdface_gan_tpu_torch.config.yaml_config import default_config_path
from sdface_gan_tpu_torch.config.yaml_subset import safe_dump, safe_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL = sorted(os.path.relpath(p, REPO)
             for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
SDF = [p for p in ALL if "sdf" in os.path.basename(p)]
# fields no option sets: the resolution leaves them at their defaults
UNSET = {"GeneratorConfig": ("channel_base",),
         "RendererConfig": ("use_fused_kernel", "return_weights", "eikonal_mode")}


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    """``inherit_from: configs/...`` resolves against the current directory."""
    monkeypatch.chdir(REPO)


def test_every_config_file_is_listed():
    assert len(ALL) >= 40 and len(SDF) >= 25 and "configs/default.yaml" in ALL


@pytest.mark.parametrize("path", ALL)
def test_yaml_reader_and_load_config_equal_the_jax_package(path, tmp_path):
    text = open(path).read()
    assert safe_load(text) == yaml.safe_load(text)
    cfg = load_config(path, default_config_path())
    ref = j_load_config(path, j_default()).to_dict()
    assert cfg.to_dict() == ref
    out = str(tmp_path / "saved.yaml")
    save_config(cfg, out)
    assert yaml.safe_load(open(out).read()) == ref
    assert load_config(out).to_dict() == ref


PLAIN = ["yes", "No", "on", "OFF", "true", "False", "0.", "1.5", "-2.25", "1e-4", "1.0e-4",
         "1.5e+3", "1.5E3", ".5", "+.5", "-.inf", ".NaN", "0o17", "1_000", "-1", "+1", "0",
         "~", "null", "NULL", "", "x:y", ":x", "-x", "b c", "b#c", "data/ffhq/images/*.png",
         "out/ffhq256_sdf"]


@pytest.mark.parametrize("scalar", PLAIN)
def test_plain_scalars_resolve_as_pyyaml_resolves_them(scalar):
    def same(a, b):
        return type(a) is type(b) and (a == b or (isinstance(a, float) and math.isnan(a)
                                                  and math.isnan(b)))

    ref = yaml.safe_load(f"a: {scalar}")["a"]
    assert same(safe_load(f"a: {scalar}")["a"], ref)
    written = safe_dump({"a": ref})
    assert same(safe_load(written)["a"], ref) and same(yaml.safe_load(written)["a"], ref)


@pytest.mark.parametrize("text", [
    "a: [1, 'b', [c, d], {e: f}]\nb: {}\nc: []",
    "a: 'it''s # not a comment'  # a comment\nb: \"x\\ty\\\\z\\\"\"",
    "top:\n  mid:\n    leaf: [0.4167, 0.5]\n  other: 2\nlast: 3",
    "1: x\nyes: 2\nempty:\n",
    "---\na: {x: , y: 1}\nb: [a, ]",
])
def test_nested_and_flow_documents(text):
    assert safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: &anchor 1", "a: *alias", "a: !!str 1", "a: |\n  block", "a: >\n  folded",
    "a: 1\n---\nb: 2", "- a\n- b", "a:\n  - 1", "a: b: c", "a: [1,\n 2]", "a: 'x\n  y'",
    "a: 2001-12-14", "<<: {a: 1}", "a: hello\n  world", "? a\n: b", "%YAML 1.1\na: 1",
    "a: 017", "a: 0x1F", "a: -0b101", "a: 1:30", "a: 1:30.5", "a: \"\\u00e9\"",
])
def test_yaml_reader_refuses_what_is_outside_the_subset(text):
    with pytest.raises(ValueError):
        safe_load(text)


def _asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _check_unset(cfg) -> None:
    for obj in (cfg, cfg.renderer):
        kind = type(obj).__name__
        defaults = {f.name: f.default for f in dataclasses.fields(obj)}
        for name in UNSET[kind]:
            assert getattr(obj, name) == defaults[name], (kind, name)


@pytest.mark.parametrize("stage_a", [True, False], ids=["stage_a", "stage_b"])
@pytest.mark.parametrize("path", SDF)
def test_stage_resolution_equals_the_jax_package(path, stage_a):
    """As ``train.py`` resolves a config for one stage, for ``--ngp 0/1`` and
    ``--fc 1``: the option tree, then the generator, both discriminators and
    the training hyperparameters, field by field."""
    cfg, jcfg = load_config(path, default_config_path()), j_load_config(path, j_default())
    assert sdf_options.rendering_overrides(cfg) == j_opts.rendering_overrides(jcfg)
    expname = cfg["training"]["out_dir"].split("/")[1]
    resolved = 0
    for ngp, fc in ((False, False), (True, False), (False, True)):
        try:
            j_ngp = j_opts.resolve_renderer_type(jcfg, ngp)
        except ValueError:
            with pytest.raises(ValueError):
                sdf_options.resolve_renderer_type(cfg, ngp)
            continue
        assert sdf_options.resolve_renderer_type(cfg, ngp) == j_ngp
        ref = j_opts.get_vol_render_opt(
            expname, stage_a, ngp=j_ngp, fc=fc, size=jcfg["data"].get("img_size", 256),
            batch=4, extra_argv=j_opts.rendering_overrides(jcfg))
        opt = build.stage_options(cfg, stage_a, ngp=ngp, fc=fc, batch=4)
        assert opt.to_dict() == ref.to_dict()
        gcfg = build.generator_config(opt, stage_a=stage_a)
        assert _asdict(gcfg) == _asdict(j_build.generator_config(ref, stage_a=stage_a))
        _check_unset(gcfg)
        for ours, theirs in zip(build.discriminator_configs(opt),
                                j_build.discriminator_configs(ref)):
            assert _asdict(ours) == _asdict(theirs)
        assert _asdict(build.train_hparams(opt)) == _asdict(j_build.train_hparams(ref))
        resolved += 1
    assert resolved >= 2


@pytest.mark.parametrize("section,body", [
    ("rendering", {"sparsity_lamda": 0.1}), ("train_args", {"no_such_knob": 1})])
def test_rendering_overrides_raise_on_unknown_keys(section, body):
    cfg = load_config("configs/256res/ffhq_256_sdf.yaml", default_config_path())
    jcfg = j_load_config("configs/256res/ffhq_256_sdf.yaml", j_default())
    cfg[section], jcfg[section] = dict(body), dict(body)
    with pytest.raises(ValueError) as ours:
        sdf_options.rendering_overrides(cfg)
    with pytest.raises(ValueError) as ref:
        j_opts.rendering_overrides(jcfg)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("yaml_type,ngp", [("sdf", True), ("mesh", False)])
def test_resolve_renderer_type_raises_where_the_jax_package_raises(yaml_type, ngp):
    cfg = {"rendering": {"type": yaml_type}}
    with pytest.raises(ValueError) as ours:
        sdf_options.resolve_renderer_type(cfg, ngp)
    with pytest.raises(ValueError) as ref:
        j_opts.resolve_renderer_type(cfg, ngp)
    assert str(ours.value) == str(ref.value)


def test_inherit_from_falls_back_to_the_file_directory_then_root(tmp_path, monkeypatch):
    """The current directory first, then the file's own directory; the
    repository root last (the port's own fallback)."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "base.yaml").write_text("a: 1\nb: {c: 2}\n")
    (tmp_path / "sub" / "child.yaml").write_text("inherit_from: base.yaml\nb: {d: 3}\n")
    (tmp_path / "child2.yaml").write_text("inherit_from: sub/base.yaml\na: 5\n")
    monkeypatch.chdir(tmp_path / "sub")
    cfg = load_config("child.yaml").to_dict()
    assert cfg == j_load_config("child.yaml").to_dict() and cfg["b"] == {"c": 2, "d": 3}
    monkeypatch.chdir(REPO)
    cfg = load_config(str(tmp_path / "sub" / "child.yaml")).to_dict()
    assert cfg == j_load_config(str(tmp_path / "sub" / "child.yaml")).to_dict()
    assert cfg["b"] == {"c": 2, "d": 3}
    other = tmp_path / "other"
    other.mkdir()
    (other / "child3.yaml").write_text("inherit_from: sub/base.yaml\n")
    with pytest.raises(FileNotFoundError):
        load_config(str(other / "child3.yaml"))
    with pytest.raises(FileNotFoundError):
        j_load_config(str(other / "child3.yaml"))
    assert load_config(str(tmp_path / "child2.yaml"))["a"] == 5
    (other / "child4.yaml").write_text("inherit_from: configs/256res/ffhq_256_sdf.yaml\n")
    monkeypatch.chdir(other)
    with pytest.raises(FileNotFoundError):
        j_load_config("child4.yaml")
    cfg = load_config("child4.yaml").to_dict()
    assert cfg.pop("inherit_from") == "configs/256res/ffhq_256_sdf.yaml"
    assert cfg == load_config(os.path.join(REPO, "configs", "256res", "ffhq_256_sdf.yaml")).to_dict()

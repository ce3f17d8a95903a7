"""Checkpoints in the port's own ``torch.save`` format.

The names follow ``sdface_gan_tpu/utils/checkpoints.py``: periodic
``models_{step:07d}`` and the stage artifacts ``sdf_init_models``,
``vol_renderer``, ``full_pipeline`` and stage C's ``encoder``, each one file
``<name>.pt`` under the stage's directory holding a dict of state dicts and
scalars (stage C's ``models_*``: ``{e, e_opt, step}``, the optimizer's
state dict carrying Ranger's slow weights and step count).  The GIRAFFE
family's :class:`CheckpointIO` keeps named checkpoints of one directory
(``model``, ``model_best``, ``model_{it:07d}``, ``encoder``) in the same
format.  A save writes a temporary file and renames it, so a cut run
never leaves half a checkpoint.  ``load_generator`` builds a stored generator for the eval and
geometry entries and the sampler.

``import_jax_run`` turns a JAX run, exported from its orbax checkpoints by
``scripts/export_jax_checkpoint.py``, into these files under the same
names, so the port's training resumes a JAX run and its tools read it: an
SDF run (stages A, B and C) or a GIRAFFE or gan2d run (every tree of its
``CheckpointIO``), optimizer states included.
"""

from __future__ import annotations

import os
import re
import shutil
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch


def _path(base_dir: str, name: str) -> str:
    return os.path.abspath(os.path.join(base_dir, f"{name}.pt"))


def save_checkpoint(base_dir: str, name: str, tree: Dict[str, Any]) -> str:
    """Save ``tree`` (state dicts, tensors, numbers) as ``<name>.pt``, replacing it."""
    os.makedirs(base_dir, exist_ok=True)
    path = _path(base_dir, name)
    torch.save(tree, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_checkpoint(base_dir: str, name: str,
                    map_location: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
    """Load ``<name>.pt`` (tensors only: ``weights_only``)."""
    return torch.load(_path(base_dir, name), map_location=map_location, weights_only=True)


def checkpoint_exists(base_dir: str, name: str) -> bool:
    return os.path.isfile(_path(base_dir, name))


def latest_checkpoint_step(base_dir: str, prefix: str = "models_") -> Optional[int]:
    """The newest ``<prefix>{step}`` checkpoint's step, or None."""
    if not os.path.isdir(base_dir):
        return None
    pat = re.compile(rf"^{re.escape(prefix)}(\d+)\.pt$")
    steps = [int(m.group(1)) for m in map(pat.match, os.listdir(base_dir)) if m]
    return max(steps) if steps else None


def load_generator(base_dir: str, name: str, cfg, which: str = "g_ema",
                   device: Union[str, torch.device] = "cuda"):
    """The generator ``which`` (``g`` or ``g_ema``) of checkpoint ``<name>.pt``,
    built for ``cfg`` (a ``GeneratorConfig``) on ``device``, in eval mode.
    Tensors of a stored dtype (bf16 training) load into the f32 model."""
    from ..models.generator import Generator

    model = Generator(cfg, device=device)
    model.load_state_dict(load_checkpoint(base_dir, name, map_location=device)[which])
    return model.eval()


class CheckpointIO:
    """GIRAFFE-style named checkpoints: ``<checkpoint_dir>/<name>.pt``, each a
    dict of state dicts and scalars (``save("model", g=..., it=...)``)."""

    def __init__(self, checkpoint_dir: str):
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)

    def save(self, filename: str, **kwargs: Any) -> str:
        return save_checkpoint(self.checkpoint_dir, filename, dict(kwargs))

    def load(self, filename: str,
             map_location: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
        if not self.exists(filename):
            raise FileNotFoundError(_path(self.checkpoint_dir, filename))
        return load_checkpoint(self.checkpoint_dir, filename, map_location)

    def exists(self, filename: str) -> bool:
        return checkpoint_exists(self.checkpoint_dir, filename)

    def backup_model_best(self) -> Optional[str]:
        """A timestamped copy ``backup_<time>_model_best.pt`` of
        ``model_best.pt``, or None when there is none."""
        if not self.exists("model_best"):
            return None
        ts = time.strftime("%Y_%m_%d_%H_%M_%S")
        dst = _path(self.checkpoint_dir, f"backup_{ts}_model_best")
        shutil.copyfile(_path(self.checkpoint_dir, "model_best"), dst)
        return dst


class GiraffeRunConfigs(NamedTuple):
    """The configs a GIRAFFE or gan2d run trains under, as the train entry
    builds them from a yaml and its flags: the generator's
    (``GiraffeConfig``, or ``Gan2dGeneratorConfig`` for gan2d), the DC
    discriminator's, the trainer's hyperparameters (the optimizer and its
    learning rates) and the VAE encoder's (GIRAFFE's ``--vae 1``)."""
    generator: Any
    discriminator: Any
    hp: Any
    encoder: Any = None


class RunConfigs(NamedTuple):
    """The configs a run trains under, as the train entry builds them from
    a yaml and its flags: (GeneratorConfig, discriminator config,
    TrainHParams) of stages A and B, and stage C's two encoders."""
    stage_a: Tuple[Any, Any, Any]
    stage_b: Tuple[Any, Any, Any]
    vae: Any
    psp: Any


_STAGE_DIRS = {"volume_renderer": "a", "": "b", "encoder": "vae", "encoder_psp": "psp"}
# (stage, artifact) -> the keys of its tree; "models" stands for models_*
_KEYS = {("a", "sdf_init_models"): {"g", "g_ema"},
         ("a", "vol_renderer"): {"g", "d", "g_ema"},
         ("a", "models"): {"g", "d", "g_ema", "g_opt", "d_opt", "step"},
         ("b", "full_pipeline"): {"g", "d", "g_ema"},
         ("b", "models"): {"g", "d", "g_ema", "g_opt", "d_opt", "step", "mean_path_length"},
         ("vae", "encoder"): {"e", "g_ema"}, ("psp", "encoder"): {"e", "g_ema"},
         ("vae", "models"): {"e", "e_opt", "step"}, ("psp", "models"): {"e", "e_opt", "step"}}


def _jax_kind(rel: str) -> Tuple[str, str]:
    """(stage, artifact) of an exported checkpoint by its path in the run:
    ``volume_renderer/{sdf_init_models,vol_renderer,models_*}``,
    ``{full_pipeline,models_*}``, ``encoder[_psp]/{encoder,models_*}``."""
    stage_dir, name = os.path.split(rel)
    kind = (_STAGE_DIRS.get(stage_dir), "models" if re.fullmatch(r"models_\d+", name) else name)
    if kind not in _KEYS:
        raise ValueError(
            f"{rel}: not a checkpoint of the SDF stages (volume_renderer/, full_pipeline, "
            "encoder[_psp]/); a GIRAFFE run's CheckpointIO trees import with --sdf 0")
    return kind


# the GIRAFFE run's CheckpointIO trees (``giraffe/train_loop.py``); "model_it"
# stands for model_{it:07d}
_GIRAFFE_KEYS = {"model": {"g", "d", "g_ema", "g_opt", "d_opt", "it", "fid_best"},
                 "model_best": {"g", "d", "g_ema", "it", "fid_best"},
                 "model_it": {"g", "d", "g_ema", "it"},
                 "encoder": {"e", "e_opt"}}
# a gan2d run's one tree (``gan2d/train_loop.py``)
_GAN2D_KEYS = {"model": {"g", "d", "g_ema", "g_opt", "d_opt", "it"}}


def _giraffe_kind(rel: str, gan2d: bool) -> str:
    """The kind of a GIRAFFE run's top-level checkpoint (``model``,
    ``model_best``, ``model_it`` or ``encoder``), or a gan2d run's
    (``model``)."""
    kind = "model_it" if re.fullmatch(r"model_\d{7}", rel) else rel
    if kind not in (_GAN2D_KEYS if gan2d else _GIRAFFE_KEYS):
        raise ValueError(
            f"{rel}: not a checkpoint of a {'gan2d' if gan2d else 'GIRAFFE'} run ("
            + ("model" if gan2d else "model, model_best, model_<it>, encoder")
            + " at its top level); an SDF run's stages import with --sdf 1")
    return kind


def _optax_state(opt: torch.optim.Optimizer, module, state: Any, to_state_dict,
                 what: str) -> Dict[str, Any]:
    """optax's ``rmsprop`` or ``adam`` chain state as ``opt``'s state dict."""
    from ..training.optim import RMSprop
    from .jax_export import adam_state, rmsprop_state

    if isinstance(opt, RMSprop):
        return rmsprop_state(opt, module, state, to_state_dict, what)
    if not isinstance(state[0], dict) or "count" not in state[0]:
        raise ValueError(f"{what}: not optax's adam state; was the run trained with another "
                         "optimizer?")
    return adam_state(opt, module, state[0], to_state_dict, what)


def _giraffe_tree(tree: Dict[str, Any], kind: str, configs: GiraffeRunConfigs,
                  what: str) -> Dict[str, Any]:
    """A GIRAFFE or gan2d tree in the port's form: ``g``, ``d``, ``g_ema``
    with ``it`` (and ``fid_best``), the optimizer states of ``model``; or
    the VAE encoder ``e`` and its Adam state."""
    from ..encoder.vae import VAEEncoder
    from ..gan2d.generator import Gan2dGenerator, Gan2dGeneratorConfig
    from ..giraffe.discriminator import DCDiscriminator
    from ..giraffe.generator import GiraffeGenerator
    from ..training.optim import encoder_optimizer, giraffe_optimizers
    from .convert import (
        jax_dc_disc_params_to_state_dict,
        jax_gan2d_params_to_state_dict,
        jax_giraffe_params_to_state_dict,
        jax_vae_params_to_state_dict,
    )
    from .jax_export import convert

    if kind == "encoder":
        def e_sd(t):
            return convert(jax_vae_params_to_state_dict, t)

        e = VAEEncoder(configs.encoder)
        opt = encoder_optimizer(e.parameters(), vae=True)
        return {"e": e_sd(tree["e"]),
                "e_opt": _optax_state(opt, e, tree["e_opt"], e_sd, f"{what} e_opt")}
    gan2d = isinstance(configs.generator, Gan2dGeneratorConfig)

    def g_sd(t):
        if gan2d:
            return convert(jax_gan2d_params_to_state_dict, t)
        return convert(jax_giraffe_params_to_state_dict, t, configs.generator)

    def d_sd(t):
        return convert(jax_dc_disc_params_to_state_dict, t)

    out: Dict[str, Any] = {"g": g_sd(tree["g"]), "d": d_sd(tree["d"]),
                           "g_ema": g_sd(tree["g_ema"]), "it": int(tree["it"])}
    if "fid_best" in tree:
        out["fid_best"] = float(tree["fid_best"])
    if "g_opt" in tree:
        g = (Gan2dGenerator if gan2d else GiraffeGenerator)(configs.generator)
        d = DCDiscriminator(configs.discriminator)
        g_opt, d_opt = giraffe_optimizers(configs.hp, g, d)
        out["g_opt"] = _optax_state(g_opt, g, tree["g_opt"], g_sd, f"{what} g_opt")
        out["d_opt"] = _optax_state(d_opt, d, tree["d_opt"], d_sd, f"{what} d_opt")
    return out


def _gan_stage_tree(tree: Dict[str, Any], stage: str, artifact: str, configs: RunConfigs,
                    what: str) -> Dict[str, Any]:
    """A stage-A or stage-B tree in the port's form."""
    from ..models.discriminator import StyleDiscriminator, VolumeRenderDiscriminator
    from ..models.generator import Generator
    from ..training.optim import stage_a_optimizers, stage_b_optimizers
    from .convert import jax_disc_params_to_state_dict, jax_params_to_state_dict
    from .jax_export import adam_state, convert, fill_like

    gcfg, dcfg, hp = configs.stage_a if stage == "a" else configs.stage_b

    def g_sd(t):
        return convert(jax_params_to_state_dict, t, gcfg)

    def d_sd(t):
        return convert(jax_disc_params_to_state_dict, t)

    out = {k: g_sd(tree[k]) for k in ("g", "g_ema")}
    if "d" in tree:
        out["d"] = d_sd(tree["d"])
    if artifact != "models":
        return out
    g = Generator(gcfg, device="cpu")
    d = (VolumeRenderDiscriminator if stage == "a" else StyleDiscriminator)(dcfg)
    if stage == "a":
        g_opt, d_opt = stage_a_optimizers(g, d, hp.a_d_reg_every)
        g_adam = tree["g_opt"][0]
    else:
        g_opt, d_opt = stage_b_optimizers(g, d, lr=2e-3, g_reg_every=hp.g_reg_every,
                                          d_reg_every=hp.d_reg_every)
        # decoder_only's multi_transform: the "train" branch's Adam, whose
        # moments lack the frozen leaves
        g_adam = tree["g_opt"]["inner_states"]["train"]["inner_state"][0]
        g_adam = dict(g_adam, mu=fill_like(g_adam["mu"], tree["g"]),
                      nu=fill_like(g_adam["nu"], tree["g"]))
        out["mean_path_length"] = torch.as_tensor(tree["mean_path_length"])
    out["g_opt"] = adam_state(g_opt, g, g_adam, g_sd, f"{what} g_opt")
    out["d_opt"] = adam_state(d_opt, d, tree["d_opt"][0], d_sd, f"{what} d_opt")
    out["step"] = int(tree["step"])
    return out


def _encoder_tree(tree: Dict[str, Any], stage: str, artifact: str, configs: RunConfigs,
                  what: str) -> Dict[str, Any]:
    """A stage-C tree (the VAE, or pSp) in the port's form."""
    from ..encoder import PSPEncoder, VAEEncoder
    from ..training.optim import encoder_optimizer
    from .convert import (
        jax_params_to_state_dict,
        jax_psp_params_to_state_dict,
        jax_vae_params_to_state_dict,
    )
    from .jax_export import adam_state, convert, ranger_state

    psp = stage == "psp"

    def e_sd(t):
        return convert(jax_psp_params_to_state_dict if psp else jax_vae_params_to_state_dict, t)

    out: Dict[str, Any] = {"e": e_sd(tree["e"])}
    if artifact != "models":
        out["g_ema"] = convert(jax_params_to_state_dict, tree["g_ema"], configs.stage_b[0])
        return out
    e = PSPEncoder(configs.psp) if psp else VAEEncoder(configs.vae)
    opt = encoder_optimizer(e.parameters(), vae=not psp)
    out["e_opt"] = (ranger_state(opt, e, tree["e_opt"], e_sd, f"{what} e_opt") if psp
                    else adam_state(opt, e, tree["e_opt"][0], e_sd, f"{what} e_opt"))
    out["step"] = int(tree["step"])
    return out


def import_jax_run(src: str, out_base: str, configs) -> List[str]:
    """Write the port's checkpoint ``<out_base>/<rel>.pt`` for every archive
    ``<src>/<rel>.npz`` of an exported JAX run trained under ``configs``: a
    :class:`RunConfigs` for an SDF run (``models_*`` with their optimizer
    states, and the stage artifacts), a :class:`GiraffeRunConfigs` for a
    GIRAFFE run (``model`` with its optimizer states, ``model_best``,
    ``model_*``, the VAE's ``encoder``) or a gan2d run (``model``).
    Refuses, before writing anything, a tree of another family and a port
    checkpoint that exists.  Returns the paths written."""
    from ..gan2d.generator import Gan2dGeneratorConfig
    from .jax_export import export_keys, read_export

    giraffe = isinstance(configs, GiraffeRunConfigs)
    gan2d = giraffe and isinstance(configs.generator, Gan2dGeneratorConfig)
    plan = []
    for root, _, names in os.walk(src):
        for n in sorted(names):
            if n.endswith(".npz"):
                rel = os.path.relpath(os.path.join(root, n), src)[:-4]
                plan.append((rel, _giraffe_kind(rel, gan2d), None) if giraffe
                            else (rel, *_jax_kind(rel)))
    if not plan:
        raise FileNotFoundError(f"no exported checkpoint (.npz) under {src}")
    for rel, stage, artifact in plan:
        if os.path.exists(_path(out_base, rel)):
            raise FileExistsError(f"{_path(out_base, rel)} exists; the import does not "
                                  "overwrite a port checkpoint")
        keys = export_keys(os.path.join(src, rel + ".npz"))
        want = ((_GAN2D_KEYS if gan2d else _GIRAFFE_KEYS)[stage] if giraffe
                else _KEYS[stage, artifact])
        if keys != want:
            raise ValueError(f"{rel}: keys {sorted(keys)}, expected {sorted(want)}")
    written = []
    for rel, stage, artifact in sorted(plan):
        tree = read_export(os.path.join(src, rel + ".npz"))
        base, name = os.path.split(os.path.join(out_base, rel))
        if giraffe:
            port = _giraffe_tree(tree, stage, configs, rel)
        else:
            to_port = _gan_stage_tree if stage in ("a", "b") else _encoder_tree
            port = to_port(tree, stage, artifact, configs, rel)
        written.append(save_checkpoint(base, name, port))
    return written

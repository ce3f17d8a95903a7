"""The ``SDFModel`` bundle, port of ``sdface_gan_tpu/models/container.py``.

The reference's top-level model (``im2scene/sdf/models/__init__.py:3-57``
with the stage-aware assembly of ``sdf/config.py:8-35``): the generator,
its EMA copy ``generator_test``, the stage's discriminator and its config,
and an optional VAE inversion encoder.  A convenience wrapper for users
coming from the reference's module tree; the training loops build their
modules themselves.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional, Union

import torch
from torch import nn

from ..utils.device import resolve_device
from .discriminator import (
    StyleDiscConfig,
    StyleDiscriminator,
    VolumeRenderDiscConfig,
    VolumeRenderDiscriminator,
)
from .generator import Generator, GeneratorConfig


def _port_config(cls, cfg):
    """The port's dataclass ``cls`` with the fields of ``cfg`` (a JAX
    package config of the same fields), nested configs included."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                       else f.default)
            value = _port_config(type(default), value)
        kwargs[f.name] = value
    return cls(**kwargs)


@dataclass
class SDFModel:
    gcfg: GeneratorConfig
    generator: Generator
    generator_test: Generator  # EMA copy (reference naming)
    discriminator: nn.Module
    dcfg: Any
    encoder: Optional[nn.Module] = None

    @classmethod
    def create(
        cls,
        gcfg: GeneratorConfig,
        generator: Optional[torch.Generator] = None,
        stage_a: Optional[bool] = None,
        with_encoder: bool = False,
        encoder_cfg: Optional[Any] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> "SDFModel":
        """Build the generator (and its EMA copy) and the stage's
        discriminator, drawn in turn from ``generator`` (seed 0 when None)
        on the CPU, then moved to ``device`` (the card by default; raises
        without one).  Stage A (``stage_a`` None means ``not
        gcfg.full_pipeline``) takes ``VolumeRenderDiscriminator`` on the
        renderer's output resolution, stage B the StyleGAN2 D at
        ``gcfg.size`` and ``gcfg.channel_multiplier`` with its default
        ``channel_base``, as the JAX bundle builds it.  ``with_encoder`` adds
        a ``VAEEncoder`` (``encoder_cfg``, else ``img_size=gcfg.size``,
        ``z_size=gcfg.style_dim``)."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if stage_a is None:
            stage_a = not gcfg.full_pipeline
        g = Generator(gcfg, device="cpu", generator=generator)
        if stage_a:
            dcfg: Any = VolumeRenderDiscConfig(in_res=gcfg.renderer.out_im_res)
            d: nn.Module = VolumeRenderDiscriminator(dcfg, generator=generator)
        else:
            dcfg = StyleDiscConfig(size=gcfg.size, channel_multiplier=gcfg.channel_multiplier)
            d = StyleDiscriminator(dcfg, generator=generator)
        encoder = None
        if with_encoder:
            from ..encoder.vae import VAEEncoder, VAEEncoderConfig

            ecfg = encoder_cfg or VAEEncoderConfig(img_size=gcfg.size, z_size=gcfg.style_dim)
            encoder = VAEEncoder(ecfg, generator=generator).to(device)
        g.to(device)
        return cls(gcfg=gcfg, generator=g, generator_test=copy.deepcopy(g),
                   discriminator=d.to(device), dcfg=dcfg, encoder=encoder)

    @classmethod
    def from_jax(cls, jax_model: Any, device: Union[str, torch.device] = "cuda") -> "SDFModel":
        """The port's bundle holding a JAX ``SDFModel``'s configs and
        weights, bit for bit, on ``device``: its generator trees through
        ``jax_params_to_state_dict``, its discriminator through
        ``jax_disc_params_to_state_dict``, its encoder through
        ``jax_vae_params_to_state_dict`` (the encoder's config read from its
        weights' shapes, since the JAX bundle keeps none)."""
        from ..encoder.vae import VAEEncoder, VAEEncoderConfig
        from ..utils.convert import (
            jax_disc_params_to_state_dict,
            jax_params_to_state_dict,
            jax_vae_params_to_state_dict,
        )

        device = resolve_device(device)
        gcfg = _port_config(GeneratorConfig, jax_model.gcfg)

        def port_generator(params) -> Generator:
            g = Generator(gcfg, device="cpu")
            g.load_state_dict(jax_params_to_state_dict(params, gcfg))
            return g.to(device)

        stage_a = hasattr(jax_model.dcfg, "in_res")
        if stage_a:
            dcfg: Any = _port_config(VolumeRenderDiscConfig, jax_model.dcfg)
            d: nn.Module = VolumeRenderDiscriminator(dcfg)
        else:
            dcfg = _port_config(StyleDiscConfig, jax_model.dcfg)
            d = StyleDiscriminator(dcfg)
        d.load_state_dict(jax_disc_params_to_state_dict(jax_model.discriminator))
        encoder = None
        if jax_model.encoder is not None:
            p = jax_model.encoder
            fc_in, z_size = p["fc"]["w"].shape[0], p["l_mu"]["w"].shape[1]
            ecfg = VAEEncoderConfig(img_size=8 * math.isqrt(fc_in // 256),
                                    channel_in=p["blocks"][0]["conv"]["w"].shape[2],
                                    z_size=z_size)
            encoder = VAEEncoder(ecfg)
            encoder.load_state_dict(jax_vae_params_to_state_dict(p))
            encoder = encoder.to(device)
        return cls(gcfg=gcfg, generator=port_generator(jax_model.generator),
                   generator_test=port_generator(jax_model.generator_test),
                   discriminator=d.to(device), dcfg=dcfg, encoder=encoder)

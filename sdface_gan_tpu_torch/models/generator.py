"""The full SDF generator, port of ``sdface_gan_tpu/models/generator.py``.

mapping MLP -> volume renderer -> StyleGAN2 decoder.  ``Generator`` holds
the modules under the reference ``g_ema`` names (``style.{i}``,
``renderer.*``, ``decoder.*``); :func:`generator_forward` takes the config
separately, as the JAX function does, so a caller can switch runtime
options (the fused field, extra outputs) without touching the module.

Stage B freezes the renderer (``freeze_renderer``): the render runs
without autograd and its outputs are detached, the analog of the JAX
package's ``stop_gradient`` on them (the optimizer holds ``decoder.*``
only).  :func:`generator_init_forward` is the sphere-init pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops.siren_kernel import SirenFieldPack
from ..utils.device import resolve_device
from .renderer import RendererConfig, RenderOutput, VolumeFeatureRenderer, mlp_init_pass, render
from .stylegan2 import (
    Decoder,
    DecoderConfig,
    MappingLinear,
    apply_decoder,
    decoder_mean_latent,
    make_decoder_latent,
)


@dataclass(frozen=True)
class GeneratorConfig:
    size: int = 256
    style_dim: int = 256
    full_pipeline: bool = True
    freeze_renderer: bool = False
    channel_multiplier: int = 2
    channel_base: int = 512
    lr_mapping: float = 0.01
    renderer: RendererConfig = field(default_factory=RendererConfig)

    @property
    def decoder(self) -> DecoderConfig:
        return DecoderConfig(
            size=self.size,
            style_dim=self.style_dim * 2,
            in_res=self.renderer.out_im_res,
            in_channels=self.renderer.width,
            channel_multiplier=self.channel_multiplier,
            channel_base=self.channel_base,
            lr_mapping=self.lr_mapping,
        )


class GeneratorOutput(NamedTuple):
    rgb: Optional[torch.Tensor]  # [B, size, size, 3] (full pipeline only)
    thumb_rgb: torch.Tensor  # [B, res, res, 3]
    xyz: Optional[torch.Tensor]
    sdf: Optional[torch.Tensor]
    eikonal_term: Optional[torch.Tensor]
    mask: Optional[torch.Tensor]
    latent: Optional[torch.Tensor]  # decoder per-layer latent
    weights: Optional[torch.Tensor] = None  # [B, res, res, S]
    s_vals: Optional[torch.Tensor] = None  # [B, res, res, S]


class Generator(nn.Module):
    """The generator's modules, initialized from ``generator`` (seed 0 when
    None) with the JAX package's distributions, then moved to ``device``.

    ``device`` defaults to the card and raises without one; pass
    ``device="cpu"`` to build on the CPU.
    """

    def __init__(
        self,
        cfg: GeneratorConfig,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.style = nn.Sequential(
            *[MappingLinear(cfg.style_dim, cfg.style_dim, generator=generator)
              for _ in range(3)])
        self.renderer = VolumeFeatureRenderer(cfg.renderer, generator=generator)
        if cfg.full_pipeline:
            self.decoder = Decoder(cfg.decoder, generator=generator)
        self.to(device)


def pack_generator_for_inference(model: Generator) -> Generator:
    """One-time load-time repack for NGP serving: add the corner-packed hash
    table to the renderer network when ``renderer.ngp_pack_mb`` > 0, in
    place (a non-persistent buffer, so the state dict is unchanged).  No-op
    for SIREN and FC, with the budget at 0, or when already packed; never
    used in training.  Returns ``model``."""
    rcfg = model.cfg.renderer
    if rcfg.type == "ngp" and rcfg.ngp_pack_mb > 0:
        model.renderer.network.pack_tables()
    return model


def map_style(model: Generator, z: torch.Tensor) -> torch.Tensor:
    """3-layer renderer mapping."""
    return model.style(z)


def mean_latent(
    model: Generator, generator: torch.Generator, n_latent: int = 10000
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Truncation statistics ``(renderer_mean, decoder_mean)`` from
    ``n_latent`` random z drawn on the model's device."""
    device = next(model.parameters()).device
    z = torch.randn((n_latent, model.cfg.style_dim), generator=generator, device=device)
    renderer_latent = map_style(model, z)
    renderer_mean = torch.mean(renderer_latent, dim=0, keepdim=True)
    decoder_mean = None
    if model.cfg.full_pipeline:
        decoder_mean = decoder_mean_latent(model.decoder, renderer_latent)
    return renderer_mean, decoder_mean


def generator_forward(
    model: Generator,
    cfg: GeneratorConfig,
    styles: Sequence[torch.Tensor],
    cam_extrinsics: torch.Tensor,
    focal: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    truncation: float = 1.0,
    truncation_latent: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    input_is_latent: bool = False,
    inject_index: Optional[int] = None,
    return_latents: bool = False,
    return_sdf: bool = False,
    return_xyz: bool = False,
    return_eikonal: bool = False,
    return_weights: bool = False,
    randomize_noise: bool = True,
    decoder_noise: Optional[List[Optional[torch.Tensor]]] = None,
    renderer_latent: Optional[torch.Tensor] = None,
    field_pack: Optional[SirenFieldPack] = None,
    eikonal_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> GeneratorOutput:
    """Full generator forward.

    styles: list of [B, style_dim] latents (2 => style mixing; the renderer
    takes the first).  Cameras come from ``generate_camera_params``.
    ``generator`` draws the depth jitter and, with ``randomize_noise``, the
    decoder noise (None: deterministic eval mode).  ``truncation_latent``
    is ``(renderer_mean, decoder_mean)`` from :func:`mean_latent`.
    ``field_pack``: weights packed once for the fused field.
    ``return_eikonal`` (and ``eikonal_draws``) as in ``render``.
    """
    if not input_is_latent:
        styles = [map_style(model, s) for s in styles]
    if truncation < 1.0 and truncation_latent is not None:
        tl = truncation_latent[0]
        styles = [tl + truncation * (s - tl) for s in styles]
    latents = list(styles)

    rcfg = cfg.renderer
    if return_sdf or return_xyz:
        rcfg = replace(rcfg, return_sdf=return_sdf, return_xyz=return_xyz)
    if return_weights:
        rcfg = replace(rcfg, return_weights=True)
    if renderer_latent is not None:
        latent0 = renderer_latent
    else:
        latent0 = latents[0][:, 0] if (input_is_latent and latents[0].ndim == 3) else latents[0]
    with torch.set_grad_enabled(torch.is_grad_enabled() and not cfg.freeze_renderer):
        out = render(model.renderer, rcfg, focal, cam_extrinsics, near, far, latent0,
                     generator=generator, field_pack=field_pack,
                     return_eikonal=return_eikonal, eikonal_draws=eikonal_draws)
    if cfg.freeze_renderer:
        out = RenderOutput(*(t.detach() if t is not None else None for t in out))

    rgb = dec_latent = None
    if cfg.full_pipeline:
        dcfg = cfg.decoder
        dec_latent = make_decoder_latent(
            model.decoder, dcfg, latents, inject_index=inject_index,
            truncation=truncation,
            truncation_latent=truncation_latent[1] if truncation_latent is not None else None,
            input_is_latent=input_is_latent,
        )
        rgb = apply_decoder(model.decoder, dcfg, out.features, dec_latent,
                            noise=decoder_noise,
                            generator=generator if randomize_noise else None)

    return GeneratorOutput(
        rgb=rgb, thumb_rgb=out.rgb, xyz=out.xyz, sdf=out.sdf,
        eikonal_term=out.eikonal_term, mask=out.mask,
        latent=dec_latent if return_latents else None,
        weights=out.weights, s_vals=out.s_vals,
    )


def generator_init_forward(
    model: Generator,
    cfg: GeneratorConfig,
    styles: Sequence[torch.Tensor],
    cam_extrinsics: torch.Tensor,
    focal: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    t_rand: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sphere-init pass: ``(sdf, target)`` of ``mlp_init_pass`` on the
    mapped first style."""
    return mlp_init_pass(model.renderer, cfg.renderer, focal, cam_extrinsics, near, far,
                         map_style(model, styles[0]), generator=generator, t_rand=t_rand)

"""Serving API: a warmed sampler around the full-pipeline generator.

Port of ``sdface_gan_tpu/serving.py``:

* truncation statistics (``mean_latent``) computed once at construction,
* the port's CUDA kernels on by default (``use_fused_kernel``): the fused
  SIREN field, whose weights are packed once here, or the NGP field's
  hash-grid encode and table gather (off: every kernel's plain version),
* the NGP corner-packed tables built once here (``ngp_pack_mb`` > 0),
* a fixed batch, and camera handling (random poses or explicit angles).

Example:
    model = Generator(cfg, device="cuda").to(torch.bfloat16)
    sampler = SDFaceSampler(model, batch=8)
    imgs = sampler.sample(seed=0)              # [8, 256, 256, 3] in [-1, 1]
    imgs = sampler.sample(azim=0.3, elev=0.1)  # fixed viewpoint

Not ported yet: the JAX sampler's ``mesh`` (data parallelism) and orbax
``from_checkpoint``.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import replace
from typing import Dict, Optional, Tuple, Union

import torch

from .geometry.cameras import generate_camera_params
from .models.generator import (
    Generator,
    GeneratorConfig,
    generator_forward,
    mean_latent,
    pack_generator_for_inference,
)
from .models.siren import plain_encode
from .ops.siren_kernel import pack_siren_field
from .utils.convert import jax_params_to_state_dict


class SDFaceSampler:
    def __init__(
        self,
        model: Generator,
        batch: int = 16,
        truncation: float = 0.7,
        use_fused_kernel: bool = True,
        seed: int = 0,
        truncation_latent: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    ):
        """Serve ``model`` on its own device and dtype.

        ``truncation_latent``: precomputed ``(renderer_mean, decoder_mean)``;
        when None it is computed with ``mean_latent`` from ``seed``.  An NGP
        model gets its packed table here, in place.
        """
        cfg = model.cfg
        if use_fused_kernel and cfg.renderer.type in ("sdf", "ngp"):
            cfg = replace(cfg, renderer=replace(cfg.renderer, use_fused_kernel=True))
        self.model = pack_generator_for_inference(model.eval())
        self.cfg = cfg
        self.use_fused_kernel = use_fused_kernel
        self.batch = batch
        self.truncation = truncation
        self.device = next(model.parameters()).device
        with torch.inference_mode():
            if truncation_latent is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                truncation_latent = mean_latent(model, gen)
            self._trunc = truncation_latent
            self._field_pack = (pack_siren_field(model.renderer.network)
                                if cfg.renderer.use_fused_kernel and cfg.renderer.type == "sdf"
                                else None)

    @classmethod
    def from_state_dict(
        cls,
        state_dict: Dict[str, torch.Tensor],
        cfg: GeneratorConfig,
        device: Union[str, torch.device] = "cuda",
        dtype: Optional[torch.dtype] = None,
        **kwargs,
    ) -> "SDFaceSampler":
        """Build from a state dict under the reference ``g_ema`` names;
        ``dtype`` casts every weight (e.g. ``torch.bfloat16`` for serving)."""
        model = Generator(cfg, device=device)
        model.load_state_dict(state_dict)
        if dtype is not None:
            model = model.to(dtype)
        return cls(model, **kwargs)

    @classmethod
    def from_jax_params(
        cls,
        params,
        cfg: GeneratorConfig,
        device: Union[str, torch.device] = "cuda",
        dtype: Optional[torch.dtype] = None,
        **kwargs,
    ) -> "SDFaceSampler":
        """Build from a JAX generator parameter tree (numpy leaves)."""
        return cls.from_state_dict(jax_params_to_state_dict(params, cfg), cfg,
                                   device=device, dtype=dtype, **kwargs)

    def warmup(self) -> None:
        self.sample(seed=0)

    def sample(
        self,
        seed: int = 0,
        z: Optional[torch.Tensor] = None,
        azim: Optional[float] = None,
        elev: Optional[float] = None,
    ) -> torch.Tensor:
        """A batch of images [batch, size, size, 3] in [-1, 1] on the
        model's device; a fixed viewpoint when azim/elev are given.  ``seed``
        draws z (unless given), random cameras and the depth jitter."""
        with torch.inference_mode():
            gen = torch.Generator(device=self.device).manual_seed(seed)
            if z is None:
                z = torch.randn((self.batch, self.cfg.style_dim), generator=gen,
                                device=self.device)
            else:
                z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
                if tuple(z.shape) != (self.batch, self.cfg.style_dim):
                    raise ValueError(
                        f"z must be [{self.batch}, {self.cfg.style_dim}], got {tuple(z.shape)}")
            res = self.cfg.renderer.out_im_res
            if azim is not None or elev is not None:
                loc = torch.tensor([[azim or 0.0, elev or 0.0]], device=self.device)
                cams = generate_camera_params(res, batch=self.batch,
                                              locations=loc.expand(self.batch, 2))
            else:
                cams = generate_camera_params(res, gen, batch=self.batch, device=self.device)
            with nullcontext() if self.use_fused_kernel else plain_encode():
                out = generator_forward(
                    self.model, self.cfg, [z], cams.extrinsics, cams.focal, cams.near,
                    cams.far, generator=gen, truncation=self.truncation,
                    truncation_latent=self._trunc, randomize_noise=False,
                    field_pack=self._field_pack,
                )
            return out.rgb if out.rgb is not None else out.thumb_rgb

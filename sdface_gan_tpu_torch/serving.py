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

``from_checkpoint`` serves a stored generator: the port's own checkpoints,
or a JAX run's imported by ``python -m
sdface_gan_tpu_torch.import_jax_checkpoints``.

``mesh`` (:func:`..parallel.make_mesh`) serves one batch over the ranks, as
the JAX sampler's mesh does: the weights are replicated from rank 0, the
batch's z and cameras are drawn whole, each rank renders its rows through
the fused field, and ``sample`` returns the gathered batch on every rank.
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
from .parallel.mesh import Mesh, gather_rows, over, replicate, shard_batch
from .utils.checkpoints import load_generator
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
        mesh: Optional[Mesh] = None,
    ):
        """Serve ``model`` on its own device and dtype.

        ``truncation_latent``: precomputed ``(renderer_mean, decoder_mean)``;
        when None it is computed with ``mean_latent`` from ``seed``.  An NGP
        model gets its packed table here, in place.  ``mesh``: the ranks
        that share each batch (the world must divide ``batch``).
        """
        if mesh is not None and batch % mesh.world:
            raise ValueError(f"batch {batch} must divide the {mesh.world}-rank world")
        replicate([model], mesh)
        self.mesh = mesh
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
            replicate([t for t in truncation_latent if t is not None], mesh)
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

    @classmethod
    def from_checkpoint(
        cls,
        out_dir: str,
        name: str = "full_pipeline",
        cfg: Optional[GeneratorConfig] = None,
        device: Union[str, torch.device] = "cuda",
        dtype: Optional[torch.dtype] = None,
        **kwargs,
    ) -> "SDFaceSampler":
        """Serve ``g_ema`` of the checkpoint ``<out_dir>/<name>.pt``, built for
        ``cfg`` (the default ``GeneratorConfig`` when None) on ``device``,
        in f32 or cast to ``dtype``; the other keywords go to the sampler
        (``batch``, ``truncation``, ``truncation_latent``, ...)."""
        model = load_generator(out_dir, name, cfg or GeneratorConfig(), device=device)
        return cls(model if dtype is None else model.to(dtype), **kwargs)

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
        draws z (unless given), random cameras and the depth jitter, for the
        whole batch; over a mesh each rank renders its rows."""
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
            z, cams = shard_batch((z, cams), self.mesh)
            with nullcontext() if self.use_fused_kernel else plain_encode(), over(self.mesh):
                out = generator_forward(
                    self.model, self.cfg, [z], cams.extrinsics, cams.focal, cams.near,
                    cams.far, generator=gen, truncation=self.truncation,
                    truncation_latent=self._trunc, randomize_noise=False,
                    field_pack=self._field_pack,
                )
            return gather_rows(out.rgb if out.rgb is not None else out.thumb_rgb, self.mesh)

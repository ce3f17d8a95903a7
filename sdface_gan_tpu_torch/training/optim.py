"""Stage optimizers, port of ``sdface_gan_tpu/training/optim.py`` (the SDF
stages).

* Stage A (volume renderer): Adam, G lr 2e-5 / D lr 2e-4, betas (0, 0.9).
* Stage B (full pipeline): StyleGAN2's lazy-regularization Adam, lr and
  betas scaled by ``reg_every / (reg_every + 1)`` (``b1 = 0.0 ** ratio``),
  with the G optimizer over the ``decoder.*`` parameters only: the JAX
  package's optax mask trains the ``decoder`` subtree and leaves
  ``mapping`` (here ``style.*``) and ``renderer`` frozen.
* Stage C (the encoder): Adam 5e-4 for the VAE, Ranger 1e-4 for pSp
  (``sdface_gan_tpu/training/optim.py:74-159``).
* The GIRAFFE and gan2d families: :class:`RMSprop` (G lr 5e-4, D lr 1e-4
  by default), or Adam when the yaml names it
  (``sdface_gan_tpu/giraffe/trainer.py:51-60``).

``torch.optim.Adam`` with ``eps=1e-8`` is optax's ``adam`` (``eps_root=0``).
``Ranger`` is the JAX package's ``ranger``: gradient centralization, then
optax's ``radam``, inside its ``lookahead`` (slow weights in the optimizer
state).  ``torch.optim.RAdam`` puts eps elsewhere and is not used.
:class:`RMSprop` is optax's ``rmsprop(lr, decay=0.99, eps=1e-8)``, whose eps
lies inside the root; ``torch.optim.RMSprop`` adds it outside and is not
used.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Tuple

import torch
from torch import nn


def _adam(params, lr: float, b1: float, b2: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)


def _reg_ratio(reg_every: int) -> float:
    return reg_every / (reg_every + 1) if reg_every > 0 else 1.0


def stage_a_optimizers(
    g: nn.Module, d: nn.Module, d_reg_every: int = 1
) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """(G, D) optimizers for the volume-renderer stage.  ``d_reg_every`` is
    the stage-A lazy-R1 interval: above 1 the D's lr and betas take the
    same ratio adjustment as in stage B."""
    d_ratio = _reg_ratio(d_reg_every) if d_reg_every > 1 else 1.0
    return (_adam(g.parameters(), 2e-5, 0.0, 0.9),
            _adam(d.parameters(), 2e-4 * d_ratio, 0.0**d_ratio, 0.9**d_ratio))


def decoder_only(g: nn.Module) -> List[nn.Parameter]:
    """The generator's ``decoder.*`` parameters, the only ones stage B trains."""
    return [p for name, p in g.named_parameters() if name.startswith("decoder.")]


def stage_b_optimizers(
    g: nn.Module, d: nn.Module, lr: float = 2e-3, g_reg_every: int = 4,
    d_reg_every: int = 16,
) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """(G over :func:`decoder_only`, D) optimizers for the StyleGAN stage."""
    g_ratio, d_ratio = _reg_ratio(g_reg_every), _reg_ratio(d_reg_every)
    return (_adam(decoder_only(g), lr * g_ratio, 0.0**g_ratio, 0.99**g_ratio),
            _adam(d.parameters(), lr * d_ratio, 0.0**d_ratio, 0.99**d_ratio))


def gradient_centralization(g: torch.Tensor) -> torch.Tensor:
    """Subtract the mean over the axes the JAX package centres: axes
    1..ndim of its own layouts.  For a conv stored HWIO [kh, kw, in, out]
    that is the mean over (kw, in, out) for each kh: OIHW dims (0, 1, 3)
    here; for a linear [in, out] the mean over out for each input row:
    dim 0 of the port's [out, in].  (Upstream Ranger centres each output
    channel instead; ROADMAP queue 3.)  1-D gradients pass unchanged."""
    if g.ndim == 4:
        return g - g.mean(dim=(0, 1, 3), keepdim=True)
    if g.ndim == 2:
        return g - g.mean(dim=0, keepdim=True)
    if g.ndim == 1:
        return g
    raise ValueError(f"no JAX layout known for a {g.ndim}-D parameter")


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def radam_scalars(step: int, b1: float, b2: float) -> Tuple[float, float, float, float]:
    """(1 - b1^t, 1 - b2^t, rho_t, r_t) of optax's ``scale_by_radam`` at
    count ``step``, in f32 as optax computes them under ``jit`` (``b^t`` by
    f32 ``pow``: 1 - b2^t cancels at the first rectified steps, so f64
    would move r_t visibly).  Host scalars: the card and the CPU step with
    the same numbers."""
    t = _f32(float(step))
    b1t, b2t = torch.pow(_f32(b1), t), torch.pow(_f32(b2), t)
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    ro = _f32(ro_inf) - _f32(2.0 * step) * b2t / (1 - b2t)
    r = torch.sqrt((ro - 4.0) * (ro - 2.0) * _f32(ro_inf)
                   / (_f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
    return (1 - b1t).item(), (1 - b2t).item(), ro.item(), r.item()


# Ranger's constants (the JAX package's ``ranger``): RAdam's betas, eps and
# rectification threshold on rho_t; lookahead's sync period k and step alpha
RADAM_B1, RADAM_B2, RADAM_EPS, RADAM_THRESHOLD = 0.9, 0.999, 1e-8, 5.0
LOOKAHEAD_K, LOOKAHEAD_ALPHA = 6, 0.5


class Ranger(torch.optim.Optimizer):
    """Ranger = gradient centralization + RAdam + Lookahead (reference
    ``encoder/ranger.py``; the JAX package's ``ranger(lr)``): per step,
    centre the gradient, take optax's RAdam update (b1 0.9, b2 0.999, eps
    1e-8 added to sqrt(v_hat), the rectified update once rho_t >= 5, else
    the bias-corrected momentum), and every 6 steps move the slow weights
    halfway toward the fast ones and reset the fast weights to them.  The
    slow weights (a real copy, made at construction as optax's ``init``
    does) and the step count live in the optimizer state, so they survive
    a checkpoint.  A parameter without a gradient steps with a zero one, as
    optax sees it."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float):
        super().__init__(params, dict(lr=lr))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = dict(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p),
                                     slow=p.detach().clone())

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Ranger takes no closure")
        b1, b2 = RADAM_B1, RADAM_B2
        for group in self.param_groups:
            if not group["params"]:
                continue
            t = self.state[group["params"][0]]["step"] + 1
            bc1, bc2, ro, r = radam_scalars(t, b1, b2)
            sync = t % LOOKAHEAD_K == 0
            for p in group["params"]:
                st = self.state[p]
                g = gradient_centralization(p.grad if p.grad is not None
                                            else torch.zeros_like(p))
                st["mu"] = g * (1 - b1) + st["mu"] * b1
                st["nu"] = g * g * (1 - b2) + st["nu"] * b2
                u = st["mu"] / bc1
                if ro >= RADAM_THRESHOLD:
                    u = r * u / (torch.sqrt(st["nu"] / bc2) + RADAM_EPS)
                fast = p + u * -group["lr"]
                if sync:
                    st["slow"] = st["slow"] + LOOKAHEAD_ALPHA * (fast - st["slow"])
                    fast = st["slow"]
                p.add_(fast - p)
                st["step"] = t
        return None


def encoder_optimizer(params: Iterable[torch.Tensor], vae: bool = True) -> torch.optim.Optimizer:
    """Stage C's optimizer (reference ``config.py:186-191``): Adam 5e-4 for
    the VAE, Ranger 1e-4 for pSp."""
    params = list(params)
    return _adam(params, 5e-4, 0.9, 0.999) if vae else Ranger(params, 1e-4)


RMS_DECAY, RMS_EPS = 0.99, 1e-8


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop(lr, decay=0.99, eps=1e-8)`` (``scale_by_rms`` with
    ``initial_scale=0`` and ``eps_in_sqrt=True``; no bias correction, no
    momentum, not centred): per step ``nu <- decay * nu + (1 - decay) *
    g^2`` and ``p <- p - lr * g / sqrt(nu + eps)``, in optax's order of
    operations (``RMS_DECAY``, ``RMS_EPS``).  The state of each parameter
    is ``nu`` alone.  A parameter without a gradient steps with a zero one,
    as optax sees it."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float):
        super().__init__(params, dict(lr=lr))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = dict(nu=torch.zeros_like(p))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RMSprop takes no closure")
        for group in self.param_groups:
            lr = group["lr"]
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st = self.state[p]
                st["nu"] = (1 - RMS_DECAY) * (g * g) + RMS_DECAY * st["nu"]
                p.add_(torch.rsqrt(st["nu"] + RMS_EPS) * g * -lr)
        return None


def giraffe_optimizers(hp: Any, g: nn.Module,
                       d: nn.Module) -> Tuple[torch.optim.Optimizer, torch.optim.Optimizer]:
    """(G, D) optimizers of the GIRAFFE and gan2d trainers: :class:`RMSprop`
    at ``hp.lr_g`` / ``hp.lr_d``, or optax's ``adam`` (``torch.optim.Adam``'s
    defaults) when ``hp.optimizer`` is not RMSprop."""
    if getattr(hp, "optimizer", "RMSprop").lower() == "rmsprop":
        return RMSprop(g.parameters(), hp.lr_g), RMSprop(d.parameters(), hp.lr_d)
    return (_adam(g.parameters(), hp.lr_g, 0.9, 0.999),
            _adam(d.parameters(), hp.lr_d, 0.9, 0.999))

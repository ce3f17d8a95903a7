"""The leaky-ReLU mask rule the card-against-CPU and card-against-one-rank
training checks share, JAX-free: ``leaky_relu_masks`` records the masks of
the port's kinked activations in one run and replays them in another, so
that a unit within rounding of 0 takes the same slope on both sides
(``chip_smoke.masked_parity``, ``torch_parallel_ranks``'s card job)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def leaky_relu_masks(record=None, replay=None, flips=None):
    """The masks of the port's kinked activations: the mapping network's
    and the discriminators' ``fused_leaky_relu`` and ``torch.nn.functional``'s
    ``relu``, ``prelu`` and ``leaky_relu`` (the encoders'): appended to
    ``record`` in call order, or taken from the front of ``replay`` in the
    same order, counting in ``flips`` the units whose own mask differs
    ({"flipped": n, "units": n}).  Each keeps its function's own side at an
    exact 0 (``x >= 0`` for ``fused_leaky_relu``, ``x > 0`` for torch's), so
    only the masks' source differs from an unpatched run."""
    from sdface_gan_tpu_torch.models import discriminator, stylegan2
    from sdface_gan_tpu_torch.ops.fused_act import SQRT2

    original = discriminator.fused_leaky_relu
    originals = {name: getattr(F, name) for name in ("relu", "prelu", "leaky_relu")}
    if flips is not None:
        flips.update(flipped=0, units=0)

    def masked(x, strict=False):
        mask = x > 0 if strict else x >= 0
        if replay is not None:
            own, mask = mask, replay.pop(0).to(x.device)
            flips["flipped"] += int((own != mask).sum())
            flips["units"] += own.numel()
        if record is not None:
            record.append(mask)
        return mask

    def fn(x, bias=None, negative_slope=0.2, scale=SQRT2):
        if bias is not None:
            x = x + bias.reshape((1, -1) + (1,) * (x.ndim - 2))
        return scale * torch.where(masked(x), x, negative_slope * x)

    def relu(x, inplace=False):
        return torch.where(masked(x, True), x, torch.zeros_like(x))

    def prelu(x, weight):
        w = weight.reshape((1, -1) + (1,) * (x.ndim - 2)) if x.ndim > 1 else weight
        return torch.where(masked(x, True), x, w * x)

    def leaky_relu(x, negative_slope=0.01, inplace=False):
        return torch.where(masked(x, True), x, negative_slope * x)

    for module in (discriminator, stylegan2):
        module.fused_leaky_relu = fn
    F.relu, F.prelu, F.leaky_relu = relu, prelu, leaky_relu
    try:
        yield
    finally:
        for module in (discriminator, stylegan2):
            module.fused_leaky_relu = original
        for name, f in originals.items():
            setattr(F, name, f)

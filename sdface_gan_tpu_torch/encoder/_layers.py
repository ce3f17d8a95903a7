"""Layers the encoders share: torch-initialized convs and linears drawn from
an explicit ``torch.Generator`` (the JAX package's ``_torch_conv`` and
``_linear``: U(+-1/sqrt(fan_in)) for weight and bias), and the two batch
norms of the encoder family."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..models.init import uniform

BN_EPS = 1e-5


def uniform_conv(in_ch: int, out_ch: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = True, generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=padding, bias=bias)
    bound = 1.0 / math.sqrt(in_ch * k * k)
    with torch.no_grad():
        conv.weight.copy_(uniform(conv.weight.shape, bound, generator))
        if bias:
            conv.bias.copy_(uniform((out_ch,), bound, generator))
    return conv


def uniform_linear(in_dim: int, out_dim: int, bias: bool = True,
                   generator: Optional[torch.Generator] = None) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim, bias=bias)
    bound = 1.0 / math.sqrt(in_dim)
    with torch.no_grad():
        lin.weight.copy_(uniform((out_dim, in_dim), bound, generator))
        if bias:
            lin.bias.copy_(uniform((out_dim,), bound, generator))
    return lin


class BatchStatNorm(nn.Module):
    """Batch norm over the batch statistics, in training and in evaluation
    alike, with the biased variance and eps 1e-5 (the VAE encoder's
    ``_batch_norm``); an affine ``weight`` / ``bias``, no running buffers.
    Written out rather than ``F.batch_norm``, which refuses a batch of one
    (the reconstruction pass encodes one identity at a time; its fc
    statistics are then those of one sample, as in the JAX encoder)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mean = x.mean(dim=dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
        return ((x - mean) * torch.rsqrt(var + BN_EPS) * self.weight.view(shape)
                + self.bias.view(shape))


class StatNorm(nn.Module):
    """Batch norm over stored statistics, in training and in evaluation alike
    (ir_se-50's ``_apply_bn``), under ``nn.BatchNorm``'s state-dict names, so
    an upstream ``model_ir_se50.pth`` loads with ``load_state_dict``.  As in
    the JAX tree, where the statistics are leaves of the parameter tree,
    ``running_mean`` and ``running_var`` are parameters: an encoder that
    trains this net (pSp) trains them too.  ``num_batches_tracked`` is kept
    only for the archive's sake."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.running_mean = nn.Parameter(torch.zeros(ch))
        self.running_var = nn.Parameter(torch.ones(ch))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(self.running_var + BN_EPS).view(shape)
        return ((x - self.running_mean.view(shape)) * inv * self.weight.view(shape)
                + self.bias.view(shape))

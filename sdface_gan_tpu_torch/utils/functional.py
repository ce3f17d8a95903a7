"""Run a function of a module with some of its tensors replaced."""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn


class _Call(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args, **kwargs):
        return fn(self.model, *args, **kwargs)


def call_with(module: nn.Module, tensors: Dict[str, torch.Tensor], fn: Callable, *args,
              **kwargs):
    """``fn(module, *args, **kwargs)`` with the parameters and buffers named
    in ``tensors`` replaced for the call (``torch.func.functional_call``):
    gradients flow to the given tensors."""
    return torch.func.functional_call(
        _Call(module), {f"model.{k}": v for k, v in tensors.items()}, (fn, *args), kwargs)

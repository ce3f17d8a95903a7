"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``, refusing a missing card.

    Entry points default to ``"cuda"`` and call this: without a card they
    raise, and the CPU is used only when the caller names it.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def disable_tf32() -> None:
    """Keep f32 matmuls and cuDNN convolutions in f32 (PyTorch's default lets
    cuDNN use TF32): the precision at which the card is held against the
    CPU.  Prints the line the entry points' checks look for."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("precision: f32 matmuls and convolutions without TF32", flush=True)

"""Gradient accumulation over microbatches, port of
``sdface_gan_tpu/training/microbatch.py``.

The reference fits an 11 GB GPU by looping ``chunk``-sized microbatches
with ``.backward()`` per chunk before one optimizer step
(``training_utils.py:365-375,682-709``).  The JAX package does it as a
``lax.scan`` inside one jitted step; here it is a Python loop over the
chunks, each chunk's gradient taken with ``torch.autograd.grad`` and
summed, so one chunk's graph is freed before the next is built.  No
training step of either package calls it yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple, Union

import torch

Params = Union[Dict[str, torch.Tensor], Sequence[torch.Tensor]]


def _split(batch: Any, n_chunks: int, i: int) -> Any:
    """Chunk ``i`` of ``n_chunks`` along the leading axis of every tensor in
    ``batch`` (a tensor, or a dict, list or tuple of them)."""
    if isinstance(batch, dict):
        return {k: _split(v, n_chunks, i) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_split(v, n_chunks, i) for v in batch)
    size = batch.shape[0] // n_chunks
    return batch[i * size:(i + 1) * size]


def accumulate_gradients(
    loss_fn: Callable[[Params, Any], Tuple[torch.Tensor, Any]],
    params: Params,
    batch: Any,
    n_chunks: int,
) -> Tuple[Params, torch.Tensor, Any]:
    """Mean gradients of ``loss_fn(params, chunk)`` over ``n_chunks``
    microbatches split along the leading axis of every tensor in ``batch``.

    ``params`` is a dict or a sequence of tensors that require grad;
    ``loss_fn`` must return ``(loss, aux)``.  Returns ``(grads, mean_loss,
    last_aux)``, ``grads`` in the structure of ``params``.
    """
    names = list(params) if isinstance(params, dict) else None
    leaves = [params[k] for k in names] if names is not None else list(params)
    acc = [torch.zeros_like(p) for p in leaves]
    loss_sum = torch.zeros((), device=leaves[0].device)
    aux = None
    for i in range(n_chunks):
        loss, aux = loss_fn(params, _split(batch, n_chunks, i))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for a, g in zip(acc, grads):
            if g is not None:
                a.add_(g)
        loss_sum = loss_sum + loss.detach()
    mean = [a / n_chunks for a in acc]
    grads_out = dict(zip(names, mean)) if names is not None else mean
    return grads_out, loss_sum / n_chunks, aux

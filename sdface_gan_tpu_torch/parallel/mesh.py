"""Data parallelism over ``torch.distributed``, port of
``sdface_gan_tpu/parallel/mesh.py``.

The JAX package runs each train step as one global program over a
``Mesh`` with a ``('data',)`` axis: the batch sharded ``P('data')``, the
parameters replicated, gradient averaging GSPMD's psum.  Here each rank is a
process (started by ``python -m torch.distributed.run``, or by a caller
that formed the group itself), and the global program is rebuilt by hand so
that a W-rank step computes what one rank computes at the same global batch:

* :class:`Mesh`: rank, world, the rank's device and the process group; the
  world of one (no group) is the single-process program, and every helper
  below is then the identity, with no collective;
* :func:`replicate`: parameters, buffers and optimizer state broadcast from
  rank 0 (JAX's ``replicate``);
* :func:`shard_batch`: the rank's contiguous rows ``[r B / W, (r + 1) B /
  W)`` of every batch-shaped tensor (JAX's ``P('data')`` layout);
* :func:`all_reduce_grads`: the psum, one flattened all-reduce per dtype;
* inside :func:`over` (the span of one step), what couples samples is taken
  over the global batch: :func:`all_gather_batch` (differentiable, and its
  backward too: the StyleGAN D's minibatch stddev, through R1's double
  backward), :func:`all_reduce_sum` (differentiable: the VAE's batch
  statistics), :func:`global_mean` (detached: the path-length mean), and
  :func:`batch_draw`, which makes a draw shaped by the batch at the global
  batch from the shared generator and keeps the rank's rows;
* :func:`mean_metrics`, :func:`decide` (rank 0's choice, e.g. the
  ``--exit-after`` cut), :func:`barrier`, :func:`broadcast_generator`;
  ``Mesh.is_main`` names the rank that writes.

``batch_sharding``, ``replicated_sharding`` and ``data_parallel_jit`` have
no counterpart: a rank holds its rows as ordinary tensors (:func:`shard_batch`)
and its replicated parameters as ordinary modules (:func:`replicate`), and
the step runs eagerly on them, with :func:`all_reduce_grads` and the
collectives above where JAX's partitioner would insert them.

Gathers are all-reduces of a zero-padded global tensor (exact: each element
sums one value and zeros), since gloo offers only broadcast and all-reduce on
CUDA tensors; two ranks sharing one card run on gloo, NCCL needs a card per
rank.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

# Rank 0 alone writes checkpoints and grids and scores FID while the others
# wait in a collective: the group's timeout covers that work.
GROUP_TIMEOUT = datetime.timedelta(hours=2)
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel world.  ``group`` None: one
    process and no collective (the default ``Mesh()``)."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int, what: str = "global batch") -> slice:
        """This rank's contiguous rows of ``n`` (raises unless the world
        divides ``n``)."""
        if n % self.world:
            raise ValueError(f"{what} {n} must divide across the {self.world}-rank world")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)


def _rank_device(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def make_mesh(device: Union[str, torch.device] = "cuda") -> Mesh:
    """The data-parallel world of this process.

    * ``torch.distributed`` already initialized (a caller formed the group,
      e.g. gloo ranks sharing one card): adopt its default group;
    * the launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
      ``MASTER_PORT``): form the group, NCCL for a CUDA device (the rank's
      ``cuda:<LOCAL_RANK>``) and gloo for the CPU, at any world size; a
      failure raises, it never falls back to one rank;
    * otherwise the world of one, with no group.
    """
    device = _rank_device(torch.device(device))
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.get_rank(), dist.get_world_size(), device, dist.group.WORLD)
    if all(k in os.environ for k in _LAUNCHER_ENV):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                timeout=GROUP_TIMEOUT)
        mesh = Mesh(dist.get_rank(), dist.get_world_size(), device, dist.group.WORLD)
        print(f"data-parallel mesh: rank {mesh.rank} of {mesh.world} on {device} "
              f"({dist.get_backend()})", flush=True)
        return mesh
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']} without the launcher's "
            f"{', '.join(_LAUNCHER_ENV)}: refusing to run as one rank")
    return Mesh(device=device)


def close(mesh: Optional[Mesh]) -> None:
    """Leave the group this process formed (the end of an entry point)."""
    if mesh is not None and mesh.distributed and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------- the span of a step
_ACTIVE: ContextVar[Optional[Mesh]] = ContextVar("active_mesh", default=None)


@contextlib.contextmanager
def over(mesh: Optional[Mesh]) -> Iterator[None]:
    """The span in which the batch is ``mesh``'s: the couplings inside take
    the global batch (nothing changes without a group)."""
    token = _ACTIVE.set(mesh if mesh is not None and mesh.distributed else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Mesh]:
    """The mesh of the enclosing :func:`over`, None outside or without a group."""
    return _ACTIVE.get()


def batch_draw(fn: Callable, shape: Sequence[int], generator: Optional[torch.Generator],
               device=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``fn(shape, generator=..., device=..., dtype=...)`` (``torch.rand`` or
    ``torch.randn``) for a draw whose dim 0 is the batch: inside :func:`over`
    it is drawn at the global batch and the rank keeps its rows, so the
    generator advances, and the rows hold, what one rank would draw."""
    mesh = active()
    if mesh is None:
        return fn(tuple(shape), generator=generator, device=device, dtype=dtype)
    full = fn((shape[0] * mesh.world, *shape[1:]), generator=generator, device=device,
              dtype=dtype)
    return full[mesh.rows(full.shape[0])]


# ---------------------------------------------------------------- collectives
def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``x`` over the ranks, in place (a CPU tensor of an NCCL group goes
    through the rank's card)."""
    if x.device.type == "cpu" and mesh.device.type == "cuda":
        buf = x.to(mesh.device)
        dist.all_reduce(buf, group=mesh.group)
        return x.copy_(buf)
    dist.all_reduce(x, group=mesh.group)
    return x


def _broadcast(x: torch.Tensor, mesh: Mesh) -> None:
    if x.device.type == "cpu" and mesh.device.type == "cuda":
        buf = x.to(mesh.device)
        dist.broadcast(buf, src=0, group=mesh.group)
        x.copy_(buf)
    else:
        dist.broadcast(x, src=0, group=mesh.group)


def _gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    out = x.new_zeros((x.shape[0] * mesh.world, *x.shape[1:]))
    out[mesh.rows(out.shape[0])] = x
    return _all_reduce(out, mesh)


class _GatherBatch(torch.autograd.Function):
    """Rows of every rank, concatenated along dim 0; the backward sums the
    cotangent over the ranks and keeps this rank's rows
    (:class:`_SumRows`), whose own backward is this gather again."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _SumRows.apply(grad, ctx.mesh), None


class _SumRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x.clone(), mesh)[mesh.rows(x.shape[0])].clone()

    @staticmethod
    def backward(ctx, grad):
        return _GatherBatch.apply(grad, ctx.mesh), None


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward is the same sum of the cotangent
    (each rank's loss reads every rank's share)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x.clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.mesh), None


def all_gather_batch(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The global batch [W * b, ...] from every rank's rows [b, ...]
    (``mesh`` defaults to :func:`active`), differentiable to any order."""
    mesh = mesh or active()
    if mesh is None or not mesh.distributed:
        return x
    return _GatherBatch.apply(x, mesh)


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` summed over the ranks (``mesh`` defaults to :func:`active`),
    differentiable to any order."""
    mesh = mesh or active()
    if mesh is None or not mesh.distributed:
        return x
    return _AllReduceSum.apply(x, mesh)


def global_mean(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The mean over the ranks of a detached per-rank mean (equal shards:
    the mean over the global batch)."""
    mesh = mesh or active()
    if mesh is None or not mesh.distributed:
        return x
    return _all_reduce(x.detach().clone(), mesh) / mesh.world


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """Every rank's slice of ``x`` along ``dim``, concatenated in rank order
    (no autograd; non-f32 floats travel as f32, exactly)."""
    if mesh is None or not mesh.distributed:
        return x
    y = x.float() if x.is_floating_point() and x.dtype != torch.float32 else x
    out = _gather_rows(y.movedim(dim, 0).contiguous(), mesh).movedim(0, dim)
    return out.to(x.dtype)


def all_reduce_grads(grads: Sequence[torch.Tensor], mesh: Optional[Mesh],
                     op: str = "mean") -> List[torch.Tensor]:
    """The gradients summed over the ranks (``op="sum"``: the loss is a sum
    over the batch) or averaged (``"mean"``: the loss is a batch mean): one
    flattened all-reduce per dtype.  Every rank then holds the same bits."""
    grads = list(grads)
    if mesh is None or not mesh.distributed:
        return grads
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    by_kind: Dict[Any, List[int]] = {}
    for i, g in enumerate(grads):
        by_kind.setdefault((g.dtype, g.device), []).append(i)
    for idx in by_kind.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        _all_reduce(flat, mesh)
        if op == "mean":
            flat.div_(mesh.world)
        elif op != "sum":
            raise ValueError(f"op must be 'mean' or 'sum', got {op!r}")
        for i, part in zip(idx, torch.split(flat, [grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def _state_tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, nn.Module):
        return [t.data for t in obj.parameters()] + list(obj.buffers())
    if isinstance(obj, torch.optim.Optimizer):
        return [v for state in obj.state.values() for _, v in sorted(state.items())
                if torch.is_tensor(v)]
    if torch.is_tensor(obj):
        return [obj.data]
    raise TypeError(f"cannot replicate a {type(obj).__name__}")


def replicate(objs: Iterable[Any], mesh: Optional[Mesh]) -> None:
    """Broadcast rank 0's modules (parameters and buffers), optimizers (their
    state tensors) and tensors to every rank, in place."""
    if mesh is None or not mesh.distributed:
        return
    for obj in objs:
        if obj is None:
            continue
        with torch.no_grad():
            for t in _state_tensors(obj):
                _broadcast(t, mesh)


def broadcast_generator(generator: torch.Generator, mesh: Optional[Mesh]) -> None:
    """Rank 0's generator state on every rank (after rank 0 alone drew)."""
    if mesh is None or not mesh.distributed:
        return
    state = generator.get_state()
    _broadcast(state, mesh)
    generator.set_state(state)


def _is_batched(x) -> bool:
    return torch.is_tensor(x) and x.ndim >= 1


def shard_batch(batch: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's rows of ``batch``: a tensor (dim 0), or a (named) tuple of
    them, recursively; 0-d tensors, numbers, generators and None are kept
    whole (replicated)."""
    if mesh is None or not mesh.distributed:
        return batch
    if _is_batched(batch):
        return batch[mesh.rows(batch.shape[0])]
    if isinstance(batch, tuple):
        parts = [shard_batch(x, mesh) for x in batch]
        return type(batch)(*parts) if hasattr(batch, "_fields") else tuple(parts)
    if isinstance(batch, list):
        return [shard_batch(x, mesh) for x in batch]
    return batch


def mean_metrics(metrics: Dict[str, Any], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """Scalar metrics averaged over the ranks (one all-reduce)."""
    if mesh is None or not mesh.distributed or not metrics:
        return metrics
    keys = sorted(metrics)
    vals = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                        device=mesh.device)
    _all_reduce(vals, mesh)
    return {k: v / mesh.world for k, v in zip(keys, vals.tolist())}


def decide(flag: bool, mesh: Optional[Mesh]) -> bool:
    """Rank 0's ``flag`` on every rank, so that a choice made on one clock
    (the ``--exit-after`` cut) is made by all ranks at the same step."""
    if mesh is None or not mesh.distributed:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    _broadcast(t, mesh)
    return bool(t.item())


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait, host and device, until every rank arrives."""
    if mesh is None or not mesh.distributed:
        return
    t = torch.zeros(1, device=mesh.device)
    _all_reduce(t, mesh)
    t.item()

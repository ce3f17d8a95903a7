"""Multiresolution hash-grid encoding (Instant-NGP).

Port of ``sdface_gan_tpu/ops/hash_encoder.py``: the grid geometry
(:class:`HashGridSpec`), the encode and its gradients, the table VJP by
sort and segment sum (:func:`hash_encode_vjp_sorted`), the total-variation
regularizer (:func:`hash_table_total_variation`), and the corner-packed
inference tables (:class:`PackPlan`, :func:`plan_packing`,
:func:`pack_hash_table`, :func:`hash_encode_packed`).

Hand-written CUDA kernels (``csrc/hash_grid.cu``) carry the path, each
beside its plain PyTorch version:

* :func:`hash_encode` - the 8-corner encode of a set of levels (plain
  version :func:`hash_encode_reference`, which follows the JAX function
  step for step: ``[K, N]`` corner-major indices and weights, one gather
  per level, OOB points zeroed at every level).  Under autograd it is a
  ``torch.autograd.Function`` whose backward is itself a ``Function``, so
  ``create_graph=True`` (the eikonal term) reaches the double backward,
  and whose forward-mode tangent (``eikonal_mode="jvp"``) is the double
  backward's d g, differentiable in the table through its d table:
* :func:`hash_encode_backward` - d table and d x of the encode (plain
  version :func:`hash_encode_backward_reference`: the sorted segment sum
  for the table, autograd through the plain encode for the points);
* :func:`hash_encode_double_backward` - d table and d g of ``<v, d x>``
  (plain version :func:`hash_encode_double_backward_reference`, autograd's
  double backward through the plain encode);
* :func:`table_gather` - ``table[idx, col:col + ncols]``, the port of the
  Pallas probe ``probe_pallas_gather.kernel``
  (``scripts/bench_packed_gather.py:128``), whose production form is the
  packed-level gather of :func:`hash_encode_packed` (plain version
  :func:`table_gather_reference`).  Inference only: training never packs,
  and the wrapper refuses tensors that require grad while grad mode is on.

A wrapper runs its plain version on a CPU tensor and launches its kernel
on a CUDA tensor, or raises: nothing falls back.  The kernels' table
gradients are summed with f32 atomics, so their last bits vary from run
to run; the plain versions are deterministic.

The hash is the reference's prime XOR in wrapping uint32 arithmetic
(``x*1 ^ y*2654435761 ^ z*805459861``, then ``% size``).  The plain
versions compute it in int64 and mask each product to 32 bits.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import _ext

# First three of the reference's seven hash primes (D=3 uses three).
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_U32 = 0xFFFFFFFF
_TABLE_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_LEVEL_DIMS = (1, 2, 4, 8)
_KERNEL_MAX_LEVELS = 32  # kMaxLevels in csrc/hash_grid.cu
_PACK_CHUNK_CELLS = 1 << 21  # cells repacked at a time, to bound host memory


@dataclass(frozen=True)
class HashGridSpec:
    """Static geometry of a multires hash grid (a copy of the JAX spec)."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    per_level_scale: float = 2.0
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    align_corners: bool = False
    interpolation: str = "linear"  # 'linear' | 'smoothstep'
    offsets: Tuple[int, ...] = field(default=())

    @staticmethod
    def create(
        input_dim: int = 3,
        num_levels: int = 16,
        level_dim: int = 2,
        per_level_scale: float = 2.0,
        base_resolution: int = 16,
        log2_hashmap_size: int = 19,
        desired_resolution: Optional[int] = None,
        align_corners: bool = False,
        interpolation: str = "linear",
    ) -> "HashGridSpec":
        if desired_resolution is not None:
            per_level_scale = 2.0 ** (
                math.log2(desired_resolution / base_resolution) / (num_levels - 1)
            )
        offsets: List[int] = []
        offset = 0
        max_params = 2**log2_hashmap_size
        for lvl in range(num_levels):
            resolution = int(np.ceil(base_resolution * per_level_scale**lvl))
            side = resolution if align_corners else resolution + 1
            params_in_level = min(max_params, side**input_dim)
            params_in_level = int(np.ceil(params_in_level / 8) * 8)  # 8-align
            offsets.append(offset)
            offset += params_in_level
        offsets.append(offset)
        return HashGridSpec(
            input_dim=input_dim,
            num_levels=num_levels,
            level_dim=level_dim,
            per_level_scale=per_level_scale,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            align_corners=align_corners,
            interpolation=interpolation,
            offsets=tuple(offsets),
        )

    @property
    def table_size(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def level_scale(self, level: int) -> float:
        return float(2.0 ** (level * math.log2(self.per_level_scale)) * self.base_resolution - 1.0)

    def level_resolution(self, level: int) -> int:
        return int(np.ceil(self.level_scale(level))) + 1

    def level_table_size(self, level: int) -> int:
        return self.offsets[level + 1] - self.offsets[level]

    def level_side(self, level: int) -> int:
        res = self.level_resolution(level)
        return res if self.align_corners else res + 1

    def level_uses_hash(self, level: int) -> bool:
        """Hashed when the level's dense grid does not fit its table slice."""
        return self.level_side(level) ** self.input_dim > self.level_table_size(level)


def _corner_offsets(dim: int) -> np.ndarray:
    """All 2^dim corner bit patterns, shape [2^dim, dim]."""
    return np.array(
        [[(c >> d) & 1 for d in range(dim)] for c in range(2**dim)], dtype=np.int64
    )


def _normalize(x: torch.Tensor, spec: HashGridSpec, bound: float):
    """Flat positions mapped to [0, 1]: ``(x01 clipped f32 [N, D], oob [N, 1])``.
    The clip is ``jnp.clip``'s ``minimum(maximum(x, 0), 1)``, whose
    derivative is 1/2 on a face of the box (``clamp``'s would be 1)."""
    x01 = (x.reshape(-1, spec.input_dim) + bound) / (2.0 * bound)
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(-1, keepdim=True)
    x01f = x01.float()
    return torch.minimum(torch.maximum(x01f, x01f.new_zeros(())), x01f.new_ones(())), oob


def _cell(x01f: torch.Tensor, spec: HashGridSpec, lvl: int):
    """Cell base coordinates (int64 [N, D]) and fractions (f32 [N, D])."""
    pos = x01f * spec.level_scale(lvl) + (0.0 if spec.align_corners else 0.5)
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    if spec.interpolation == "smoothstep":
        frac = frac * frac * (3.0 - 2.0 * frac)
    return pos_grid.long(), frac


def _corner_weights(frac: torch.Tensor, corners: np.ndarray) -> torch.Tensor:
    """d-linear weights [K, N], products taken in the order d = 0, 1, ..."""
    one_minus = 1.0 - frac
    factors = []
    for k in range(corners.shape[0]):
        f = None
        for d in range(corners.shape[1]):
            fd = frac[:, d] if corners[k, d] == 1 else one_minus[:, d]
            f = fd if f is None else f * fd
        factors.append(f)
    return torch.stack(factors, 0)


def _level_index_weight(
    x01f: torch.Tensor, spec: HashGridSpec, lvl: int, corners: np.ndarray
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global table rows (int64) and weights (f32) of one level, both [K, N]."""
    pg, frac = _cell(x01f, spec, lvl)
    cg = pg[None, :, :] + torch.from_numpy(corners).to(pg.device)[:, None, :]  # [K, N, D]
    return _corner_rows(cg, spec, lvl), _corner_weights(frac, corners)


def _corner_rows(cg: torch.Tensor, spec: HashGridSpec, lvl: int) -> torch.Tensor:
    """Global table rows (int64 [...]) of integer grid coordinates [..., D]."""
    idx = torch.zeros_like(cg[..., 0])
    if spec.level_uses_hash(lvl):
        for d in range(spec.input_dim):
            idx = idx ^ ((cg[..., d] * _PRIMES[d]) & _U32)
    else:
        stride = 1
        for d in range(spec.input_dim):
            idx = (idx + cg[..., d] * stride) & _U32
            stride *= spec.level_side(lvl)
    return idx % spec.level_table_size(lvl) + spec.offsets[lvl]


def _check_grad(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or "
            "torch.inference_mode()")


def _levels(spec: HashGridSpec, levels: Optional[Sequence[int]]) -> Tuple[int, ...]:
    levels = tuple(range(spec.num_levels)) if levels is None else tuple(levels)
    if any(not 0 <= lvl < spec.num_levels for lvl in levels):
        raise ValueError(f"levels {levels} outside 0..{spec.num_levels - 1}")
    return levels


def hash_encode_reference(
    x: torch.Tensor,
    table: torch.Tensor,
    spec: HashGridSpec,
    bound: float = 1.0,
    levels: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Plain PyTorch encode: [..., D] positions in [-bound, bound] ->
    [..., len(levels) * level_dim] in the table's dtype, level-major,
    accumulated in f32; points outside the box give zeros."""
    if x.shape[-1] != spec.input_dim:
        raise ValueError(f"expected last dim {spec.input_dim}, got {tuple(x.shape)}")
    levels = _levels(spec, levels)
    x01f, oob = _normalize(x, spec, bound)
    corners = _corner_offsets(spec.input_dim)
    outs = []
    for lvl in levels:
        idx, w = _level_index_weight(x01f, spec, lvl, corners)
        gathered = table[idx]  # [K, N, C]
        outs.append(torch.einsum("kn,knc->nc", w, gathered.float()))
    n = x01f.shape[0]
    out = torch.cat(outs, -1) if outs else x01f.new_zeros(n, 0)
    out = torch.where(oob, 0.0, out)
    return out.reshape(x.shape[:-1] + (len(levels) * spec.level_dim,)).to(table.dtype)


def hash_encode_vjp_sorted(
    x: torch.Tensor,
    table: torch.Tensor,
    spec: HashGridSpec,
    cotangent: torch.Tensor,
    bound: float = 1.0,
    levels: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Table gradient of the encode of ``levels`` (default: all) by sort +
    sorted segment sum: the (row, value) update pairs of all levels are
    sorted by row (stable), then each row's values are summed in order
    (``segment_reduce``).  Deterministic; f32 sums cast once to the table's
    dtype.  Returns d loss / d table ``[table_size, level_dim]`` for
    ``cotangent`` = d loss / d encode ``[..., len(levels) * level_dim]``."""
    levels = _levels(spec, levels)
    c = spec.level_dim
    x01f, oob = _normalize(x.detach(), spec, bound)
    n = x01f.shape[0]
    cot = cotangent.detach().reshape(n, len(levels), c).float()
    cot = torch.where(oob[:, :, None], 0.0, cot)  # OOB points contribute nothing
    corners = _corner_offsets(spec.input_dim)
    keys, vals = [], []
    for i, lvl in enumerate(levels):
        idx, w = _level_index_weight(x01f, spec, lvl, corners)  # [K, N] each
        keys.append(idx.reshape(-1))
        vals.append((w[:, :, None] * cot[None, :, i, :]).reshape(-1, c))
    skeys, order = torch.sort(torch.cat(keys), stable=True)
    rows, counts = torch.unique_consecutive(skeys, return_counts=True)
    sums = torch.segment_reduce(torch.cat(vals)[order], "sum", lengths=counts, axis=0)
    grad = torch.zeros(table.shape, dtype=torch.float32, device=table.device)
    grad[rows] = sums
    return grad.to(table.dtype)


def _own_graph():
    """The plain versions' inner autograd graph keeps its own saved tensors:
    they may run inside a caller's ``checkpoint`` forward (the forward-mode
    eikonal term under remat), whose saved-tensor hooks would otherwise
    recompute the caller when the inner gradient unpacks them."""
    return torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t)


def hash_encode_backward_reference(
    x: torch.Tensor,
    table: torch.Tensor,
    g: torch.Tensor,
    spec: HashGridSpec,
    bound: float = 1.0,
    levels: Optional[Sequence[int]] = None,
    need_x: bool = True,
    need_table: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain version of :func:`hash_encode_backward`: d x by autograd
    through the plain encode on an f32 copy of the table, d table by
    :func:`hash_encode_vjp_sorted`'s segment sum."""
    dx = dtable = None
    if need_x:
        with torch.enable_grad(), _own_graph():
            xg = x.detach().requires_grad_(True)
            out = hash_encode_reference(xg, table.detach().float(), spec, bound, levels)
            (dx,) = torch.autograd.grad(out, xg, g.detach().float())
    if need_table:
        dtable = hash_encode_vjp_sorted(x, table, spec, g, bound, levels)
    return dx, dtable


def hash_encode_double_backward_reference(
    x: torch.Tensor,
    table: torch.Tensor,
    g: Optional[torch.Tensor],
    v: torch.Tensor,
    spec: HashGridSpec,
    bound: float = 1.0,
    levels: Optional[Sequence[int]] = None,
    need_table: bool = True,
    need_g: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain version of :func:`hash_encode_double_backward`: autograd's
    double backward through the plain encode, in f32 on f32 copies of the
    table and g, cast to their dtypes (d g alone when g is None: zeros
    stand in for it, as d g does not depend on g)."""
    if g is None:
        _check_g(g, need_table)
        width = len(_levels(spec, levels)) * spec.level_dim
        g = torch.zeros(x.shape[:-1] + (width,), dtype=table.dtype, device=x.device)
    with torch.enable_grad(), _own_graph():
        xg = x.detach().requires_grad_(True)
        tg = table.detach().float().requires_grad_(True)
        gg = g.detach().float().requires_grad_(True)
        out = hash_encode_reference(xg, tg, spec, bound, levels)
        (dx,) = torch.autograd.grad(out, xg, gg, create_graph=True)
        dtable, dg = torch.autograd.grad(dx, (tg, gg), v.detach().float(), allow_unused=True)
    dtable = dtable.to(table.dtype) if need_table and dtable is not None else None
    dg = dg.to(g.dtype) if need_g and dg is not None else None
    return dtable, dg


def _check_kernel_inputs(x, table, spec, levels) -> Tuple[int, ...]:
    """The CUDA kernels' input checks; returns the selected levels."""
    levels = _levels(spec, levels)
    if x.shape[-1] != 3 or spec.input_dim != 3 or x.dtype != torch.float32:
        raise ValueError(f"the CUDA encode takes f32 [..., 3] positions, got "
                         f"{x.dtype} {tuple(x.shape)}")
    c = spec.level_dim
    if (table.dtype not in _TABLE_DTYPES or tuple(table.shape) != (spec.table_size, c)
            or c not in _KERNEL_LEVEL_DIMS):
        raise ValueError(f"the CUDA encode takes an f32/bf16 [{spec.table_size}, C] table "
                         f"with C in {_KERNEL_LEVEL_DIMS}, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if not 1 <= len(levels) <= _KERNEL_MAX_LEVELS:
        raise ValueError(f"the CUDA encode takes 1..{_KERNEL_MAX_LEVELS} levels")
    if table.device != x.device or not (table.is_contiguous() and x.is_contiguous()):
        raise ValueError("the CUDA encode takes contiguous tensors on one device")
    if table.data_ptr() % 16:
        raise ValueError("the CUDA encode takes a 16-byte aligned table")
    return levels


def _level_args(spec: HashGridSpec, levels: Tuple[int, ...]) -> list:
    """The selected levels' f32 scales, dense sides, slice sizes, offsets
    and hash flags as ctypes arrays."""
    def arr(ctype, values):
        return (ctype * len(values))(*values)

    return [arr(ctypes.c_float, [float(np.float32(spec.level_scale(l))) for l in levels])] + [
        arr(ctypes.c_uint, vals) for vals in (
            [spec.level_side(l) for l in levels],
            [spec.level_table_size(l) for l in levels],
            [spec.offsets[l] for l in levels],
            [int(spec.level_uses_hash(l)) for l in levels],
        )]


_GEOMETRY_ARGTYPES = ([ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
                      + [ctypes.POINTER(ctypes.c_uint)] * 4 + [ctypes.c_void_p])


def _launch(name: str, symbol: str, device: torch.device, pointers: list, n: int,
            levels: Tuple[int, ...], spec: HashGridSpec, bound: float) -> None:
    """Call ``csrc/hash_grid.cu``'s ``symbol(table_bf16, *pointers, n,
    n_levels, C, bound, align_corners, smoothstep, *level_args, stream)``
    on the device's current stream; raise on a CUDA error; count it."""
    lib = _ext.load("hash_grid")
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * (len(pointers) - 1) + _GEOMETRY_ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*pointers, n, len(levels), spec.level_dim, float(bound),
                  int(spec.align_corners), int(spec.interpolation == "smoothstep"),
                  *_level_args(spec, levels), stream)
    _ext.check(lib, code, name)
    _ext.LAUNCHES[name] += 1


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _encode_kernel(x, table, spec, bound, levels) -> torch.Tensor:
    n = x.numel() // 3
    out = torch.empty(x.shape[:-1] + (len(levels) * spec.level_dim,), dtype=table.dtype,
                      device=x.device)
    if n:
        _launch("hash_encode", "hash_encode_forward", x.device,
                [int(table.dtype == torch.bfloat16), x.data_ptr(), table.data_ptr(),
                 out.data_ptr()], n, levels, spec, bound)
    return out


def _encode(x, table, spec, bound, levels) -> torch.Tensor:
    """The encode without autograd: the plain version on a CPU tensor, the
    kernel on a CUDA one."""
    if x.device.type == "cpu":
        return hash_encode_reference(x, table, spec, bound, levels)
    return _encode_kernel(x, table, spec, bound, _check_kernel_inputs(x, table, spec, levels))


def _table_grad_scratch(table: torch.Tensor) -> torch.Tensor:
    """The zeroed f32 buffer that K1 and K2 reduce the table gradient into.
    They add a corner row's channels as one vector (a float4 per 4
    channels), and at C <= 2 an aligned pair of rows as one, so the buffer
    must start on a 16-byte boundary (8 for C = 1)."""
    scratch = torch.zeros(table.shape, dtype=torch.float32, device=table.device)
    if scratch.data_ptr() % min(16, 8 * table.shape[1]):
        raise RuntimeError("the table gradient's buffer is not aligned to its rows' vectors")
    return scratch


def hash_encode_backward(
    x: torch.Tensor,
    table: torch.Tensor,
    g: torch.Tensor,
    spec: HashGridSpec,
    bound: float = 1.0,
    levels: Optional[Sequence[int]] = None,
    need_x: bool = True,
    need_table: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(d x [..., 3] f32, d table [T, C] in the table's dtype)`` of
    ``<g, encode(x, table, levels)>``, each None unless asked for: the
    kernel ``hash_encode_backward`` on a CUDA tensor (f32 atomics, cast
    once; not deterministic in the last bits), the plain version on a CPU
    one.  Points on a face of the box take half the derivative, as
    ``jnp.clip``'s does."""
    if x.device.type == "cpu":
        return hash_encode_backward_reference(x, table, g, spec, bound, levels, need_x,
                                              need_table)
    levels = _check_kernel_inputs(x, table, spec, levels)
    n = x.numel() // 3
    g = g.to(table.dtype).reshape(n, len(levels) * spec.level_dim).contiguous()
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device) if need_x else None
    scratch = _table_grad_scratch(table) if need_table else None
    if n and (need_x or need_table):
        _launch("hash_encode_backward", "hash_encode_backward", x.device,
                [int(table.dtype == torch.bfloat16), x.data_ptr(), table.data_ptr(),
                 g.data_ptr(), _ptr(dx), _ptr(scratch)], n, levels, spec, bound)
    return dx, None if scratch is None else scratch.to(table.dtype)


def _check_g(g: Optional[torch.Tensor], need_table: bool) -> None:
    if g is None and need_table:
        raise ValueError("the table gradient of <v, d x> needs g")


def hash_encode_double_backward(
    x: torch.Tensor,
    table: torch.Tensor,
    g: Optional[torch.Tensor],
    v: torch.Tensor,
    spec: HashGridSpec,
    bound: float = 1.0,
    levels: Optional[Sequence[int]] = None,
    need_table: bool = True,
    need_g: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(d table [T, C], d g)`` of ``<v, d x>``, d x being
    :func:`hash_encode_backward`'s for ``g``, each None unless asked for:
    the kernel ``hash_encode_double_backward`` on a CUDA tensor, the plain
    version on a CPU one.  The term with respect to x (the d-linear
    weights' cross derivatives) is not computed.

    d g is the encode's Jacobian applied to v (its forward-mode tangent
    along v) and does not depend on g: with ``g=None`` and
    ``need_table=False`` it comes alone, [..., L * C] from x's shape, the
    kernel reads no g, and the launch counts as ``hash_encode_jvp``."""
    if x.device.type == "cpu":
        return hash_encode_double_backward_reference(x, table, g, v, spec, bound, levels,
                                                     need_table, need_g)
    levels = _check_kernel_inputs(x, table, spec, levels)
    n = x.numel() // 3
    width = len(levels) * spec.level_dim
    _check_g(g, need_table)
    if g is not None:
        g = g.to(table.dtype).reshape(n, width).contiguous()
    v = v.float().reshape(n, 3).contiguous()
    scratch = _table_grad_scratch(table) if need_table else None
    dg = torch.empty((n, width), dtype=table.dtype, device=x.device) if need_g else None
    if n and (need_table or need_g):
        _launch("hash_encode_jvp" if g is None else "hash_encode_double_backward",
                "hash_encode_double_backward", x.device,
                [int(table.dtype == torch.bfloat16), x.data_ptr(), table.data_ptr(),
                 _ptr(g), v.data_ptr(), _ptr(scratch), _ptr(dg)], n, levels, spec,
                bound)
    return (None if scratch is None else scratch.to(table.dtype),
            None if dg is None else dg.reshape(x.shape[:-1] + (width,)))


# PyTorch's private query of the running backward pass: will it execute this
# node?  Its one use is :func:`_wanted`.  Without it (a PyTorch that drops
# the symbol) every gradient that ``needs_input_grad`` names is computed: the
# eikonal's first pass then scatters a table gradient that nothing reads
# (about 1 % of an upstream-grid G step), and
# ``test_engine_query_is_available`` fails.
_WILL_ENGINE_EXECUTE = getattr(torch._C, "_will_engine_execute_node", None)


def _wanted(ctx, i: int) -> bool:
    """Whether the running backward needs the gradient of input ``i``.
    ``needs_input_grad`` is fixed at the forward; the engine also knows
    which nodes this backward pass executes (an eikonal's
    ``autograd.grad(sdf, points)`` needs no table gradient).  The engine is
    not asked about a leaf (it cannot answer under ``autograd.grad``):
    :func:`hash_encode` hands it views of its leaves instead."""
    if not ctx.needs_input_grad[i]:
        return False
    node = ctx.next_functions[i][0]
    if (_WILL_ENGINE_EXECUTE is None or node is None
            or type(node).__name__ == "AccumulateGrad"):
        return True
    return bool(_WILL_ENGINE_EXECUTE(node))


class _HashEncode(torch.autograd.Function):
    """``encode(x, table)``; its backward is :class:`_HashEncodeBackward`,
    a ``Function`` too, so ``create_graph=True`` reaches the double
    backward.  ``geom`` is ``(spec, bound, levels)``."""

    @staticmethod
    def forward(ctx, x, table, geom):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, table)
        ctx.save_for_forward(x, table)
        ctx.geom = geom
        return _encode(x, table, *geom)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None
        x, table = ctx.saved_tensors
        dx, dtable = _HashEncodeBackward.apply(x, table, g, ctx.geom, _wanted(ctx, 0),
                                               _wanted(ctx, 1))
        return dx, dtable, None

    @staticmethod
    def jvp(ctx, t, t_table, _):
        """The tangent of the encode along the points' tangent ``t``
        (:class:`_HashEncodeJvp`, differentiable in the table).  The
        renderer's dual inputs are points: a tangent of the table raises."""
        if t_table is not None:
            raise NotImplementedError("the encode's forward mode takes a tangent of the "
                                      "points only, not of the table")
        x, table = ctx.saved_tensors
        if t is None:
            return None
        return _HashEncodeJvp.apply(x, table, t, ctx.geom)


class _HashEncodeJvp(torch.autograd.Function):
    """``J t``, the encode's Jacobian with respect to the points applied to
    the tangent ``t`` [..., 3], in the table's dtype: the kernel
    ``hash_encode_double_backward`` (K2) as d g of ``<t, d x>``, which reads
    no g.  Its backward for a cotangent ``g`` is K2's d table with the same
    ``t``.  The gradients with respect to x and t are None: x as in
    :meth:`_HashEncodeBackward.backward`, and t is a constant direction
    (the renderer's unit tangents, scaled by the camera's depth range)."""

    @staticmethod
    def forward(ctx, x, table, t, geom):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, table, t)
        ctx.geom = geom
        return hash_encode_double_backward(x, table, None, t, *geom, need_table=False)[1]

    @staticmethod
    def backward(ctx, g):
        if g is None or not _wanted(ctx, 1):
            return None, None, None, None
        x, table, t = ctx.saved_tensors
        d_table = hash_encode_double_backward(x, table, g, t, *ctx.geom, need_g=False)[0]
        return None, d_table, None, None


class _HashEncodeBackward(torch.autograd.Function):
    """``(d x, d table)`` of the encode for the cotangent ``g``."""

    @staticmethod
    def forward(ctx, x, table, g, geom, need_x, need_table):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, table, g)
        ctx.geom = geom
        return hash_encode_backward(x, table, g, *geom, need_x=need_x,
                                    need_table=need_table)

    @staticmethod
    def backward(ctx, v, w):
        """``v``, ``w``: the cotangents of d x and d table.  The gradient
        with respect to x is None: it is the d-linear weights' second
        derivative term, and every caller's points are detached leaves with
        no parameter upstream (the renderer's eikonal points), so no
        parameter's gradient needs it."""
        x, table, g = ctx.saved_tensors
        need_table, need_g = _wanted(ctx, 1), _wanted(ctx, 2)
        d_table = d_g = None
        if v is not None and (need_table or need_g):
            d_table, d_g = hash_encode_double_backward(x, table, g, v, *ctx.geom,
                                                       need_table=need_table, need_g=need_g)
        if w is not None and need_g:
            # d table = sum_k w_k g scattered, so its d g is an encode of w
            enc = _encode(x, w.to(table.dtype).contiguous(), *ctx.geom)
            d_g = enc if d_g is None else d_g + enc
        return None, d_table, d_g, None, None, None


def _engine_view(t: torch.Tensor) -> torch.Tensor:
    """A view of a leaf that requires grad, so that :func:`_wanted` can ask
    the engine about its node."""
    return t.view_as(t) if t.requires_grad and t.grad_fn is None else t


def hash_encode(
    x: torch.Tensor,
    table: torch.Tensor,
    spec: HashGridSpec,
    bound: float = 1.0,
    levels: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """The encode of ``levels`` (default: all): the CUDA kernel on a CUDA
    tensor, :func:`hash_encode_reference` (and its autograd) on a CPU
    tensor.  On the card, when autograd records, the encode is
    :class:`_HashEncode`, whose backward and double backward are the
    kernels ``hash_encode_backward`` and ``hash_encode_double_backward``.

    The kernels take f32 positions with D = 3, an f32 or bf16 ``[T, C]``
    table with C in (1, 2, 4, 8), and at most 32 levels."""
    if x.device.type == "cpu":
        return hash_encode_reference(x, table, spec, bound, levels)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    levels = _check_kernel_inputs(x, table, spec, levels)
    if torch.is_grad_enabled() and (x.requires_grad or table.requires_grad):
        return _HashEncode.apply(_engine_view(x), _engine_view(table),
                                 (spec, float(bound), levels))
    return _encode_kernel(x, table, spec, bound, levels)


def hash_table_total_variation(
    table: torch.Tensor,
    spec: HashGridSpec,
    x: torch.Tensor,
    bound: float = 1.0,
) -> torch.Tensor:
    """TV regularizer over grid embeddings at sampled locations: the mean
    over the points of the squared differences between each point's cell
    row and its +1 neighbours' along each axis, summed over the levels
    (the differentiable analog of the reference's ``kernel_grad_tv``,
    ``gridencoder.cu:507``).  Plain PyTorch; no training step calls it."""
    x01f, _ = _normalize(x.detach(), spec, bound)
    total = x01f.new_zeros(())
    for lvl in range(spec.num_levels):
        pos = x01f * spec.level_scale(lvl) + (0.0 if spec.align_corners else 0.5)
        pg = torch.floor(pos).long()
        center = table[_corner_rows(pg, spec, lvl)]
        for d in range(spec.input_dim):
            nb = pg.clone()
            nb[:, d] += 1
            diff = center - table[_corner_rows(nb, spec, lvl)]
            total = total + torch.sum(diff.float() ** 2)
    return total / x01f.shape[0]


# ---------------------------------------------------------------------------
# Row gather (port of probe_pallas_gather.kernel)
# ---------------------------------------------------------------------------

def _gather_cols(table: torch.Tensor, col: int, ncols: Optional[int]) -> int:
    ncols = table.shape[1] - col if ncols is None else ncols
    if table.dim() != 2 or not (0 <= col and 1 <= ncols and col + ncols <= table.shape[1]):
        raise ValueError(f"columns {col}:{col + ncols} outside the table {tuple(table.shape)}")
    return ncols


def table_gather_reference(
    table: torch.Tensor, idx: torch.Tensor, col: int = 0, ncols: Optional[int] = None
) -> torch.Tensor:
    """``table[idx, col:col + ncols]`` -> [*idx.shape, ncols].  Indices are
    clamped to the table's rows, as XLA's gather clamps them."""
    ncols = _gather_cols(table, col, ncols)
    rows = idx.long().clamp(0, table.shape[0] - 1)
    return table[rows, col:col + ncols]


def table_gather(
    table: torch.Tensor, idx: torch.Tensor, col: int = 0, ncols: Optional[int] = None
) -> torch.Tensor:
    """Row gather: the CUDA kernel on a CUDA tensor (contiguous f32/bf16
    table, int32 indices), :func:`table_gather_reference` on a CPU tensor."""
    _check_grad("table_gather", table)
    if table.device.type == "cpu":
        return table_gather_reference(table, idx, col, ncols)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    ncols = _gather_cols(table, col, ncols)
    if table.dtype not in _TABLE_DTYPES or idx.dtype != torch.int32:
        raise ValueError(f"the CUDA gather takes an f32/bf16 table and int32 indices, "
                         f"got {table.dtype} and {idx.dtype}")
    if idx.device != table.device or not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("the CUDA gather takes contiguous tensors on one device")
    out = torch.empty(idx.shape + (ncols,), dtype=table.dtype, device=table.device)
    if idx.numel() == 0:
        return out
    es = table.element_size()
    lib = _ext.load("hash_grid")
    fn = lib.table_gather_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
                  table.shape[0], table.shape[1] * es, col * es, ncols * es, es, stream)
    _ext.check(lib, code, "table_gather")
    _ext.LAUNCHES["table_gather"] += 1
    return out


# ---------------------------------------------------------------------------
# Packed-corner inference tables: one gather per (level, point) instead of 8
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PackPlan:
    """Which levels are corner-packed, and where each starts.

    A packed level stores, for every grid cell, the 2^D corner rows the
    standard encode would gather (hash collisions included) side by side,
    so one [2^D * C]-wide row per (level, point) replaces 2^D gathers.  All
    packed levels share one [total_rows, 2^D * C] table (``row_offsets``),
    so they resolve in one :func:`table_gather`."""

    spec: HashGridSpec
    packed_levels: Tuple[int, ...]
    row_offsets: Tuple[int, ...]  # start row per packed level, + total

    @property
    def total_rows(self) -> int:
        return self.row_offsets[-1]

    @property
    def row_width(self) -> int:
        return (2**self.spec.input_dim) * self.spec.level_dim


def plan_packing(
    spec: HashGridSpec, max_bytes: int = 1 << 30, bytes_per_el: int = 2
) -> PackPlan:
    """Pack the cheapest levels first (fewest cells) under ``max_bytes``."""
    row_bytes = (2**spec.input_dim) * spec.level_dim * bytes_per_el
    packed: List[int] = []
    total = 0
    for lvl in sorted(range(spec.num_levels), key=spec.level_resolution):
        rows = spec.level_resolution(lvl) ** spec.input_dim
        if total + rows * row_bytes > max_bytes:
            break
        packed.append(lvl)
        total += rows * row_bytes
    packed.sort()
    offsets = [0]
    for lvl in packed:
        offsets.append(offsets[-1] + spec.level_resolution(lvl) ** spec.input_dim)
    return PackPlan(spec=spec, packed_levels=tuple(packed), row_offsets=tuple(offsets))


def pack_hash_table(
    table: Union[torch.Tensor, np.ndarray],
    plan: PackPlan,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Build the packed-corner table on the host, in numpy with the encode's
    uint32 arithmetic; the result lands on the table's device."""
    spec = plan.spec
    device = table.device if isinstance(table, torch.Tensor) else torch.device("cpu")
    np_table = (table.detach().float().cpu().numpy() if isinstance(table, torch.Tensor)
                else np.asarray(table, dtype=np.float32))
    corners = _corner_offsets(spec.input_dim).astype(np.uint32)
    out = np.empty((plan.total_rows, plan.row_width), dtype=np.float32)
    for li, lvl in enumerate(plan.packed_levels):
        res = spec.level_resolution(lvl)
        size = spec.level_table_size(lvl)
        side = spec.level_side(lvl)
        use_hash = spec.level_uses_hash(lvl)
        n_cells = res**spec.input_dim
        base = plan.row_offsets[li]
        for start in range(0, n_cells, _PACK_CHUNK_CELLS):
            stop = min(start + _PACK_CHUNK_CELLS, n_cells)
            rem = np.arange(start, stop, dtype=np.uint32)
            # cell coords, axis-0-minor to match the encode's linear index
            coords = np.empty((stop - start, spec.input_dim), dtype=np.uint32)
            for d in range(spec.input_dim):
                coords[:, d] = rem % res
                rem = rem // res
            for k in range(corners.shape[0]):
                cg = coords + corners[k][None, :]
                idx = np.zeros(cg.shape[0], dtype=np.uint32)
                stride = 1
                for d in range(spec.input_dim):
                    if use_hash:
                        idx ^= cg[:, d] * np.uint32(_PRIMES[d])
                    else:
                        idx += cg[:, d] * np.uint32(stride)
                        stride *= side
                rows = (idx % np.uint32(size)).astype(np.int64) + spec.offsets[lvl]
                out[base + start:base + stop,
                    k * spec.level_dim:(k + 1) * spec.level_dim] = np_table[rows]
    return torch.from_numpy(out).to(device=device, dtype=dtype)


def hash_encode_packed(
    x: torch.Tensor,
    table: torch.Tensor,
    packed: torch.Tensor,
    plan: PackPlan,
    bound: float = 1.0,
    use_kernels: bool = True,
) -> torch.Tensor:
    """:func:`hash_encode` with corner-packed levels: one :func:`table_gather`
    of [2^D * C]-wide rows over all packed levels, then the interpolation in
    PyTorch; the other levels go through :func:`hash_encode`.  Equal to the
    unpacked encode up to the packed table's dtype.  ``use_kernels=False``
    runs the plain versions whatever the device."""
    spec = plan.spec
    if x.shape[-1] != spec.input_dim:
        raise ValueError(f"expected last dim {spec.input_dim}, got {tuple(x.shape)}")
    encode = hash_encode if use_kernels else hash_encode_reference
    gather = table_gather if use_kernels else table_gather_reference
    x01f, oob = _normalize(x, spec, bound)
    corners = _corner_offsets(spec.input_dim)
    k, c = corners.shape[0], spec.level_dim
    n = x01f.shape[0]

    level_outs = {}
    if plan.packed_levels:
        idx_rows, w_rows = [], []
        for li, lvl in enumerate(plan.packed_levels):
            pg, frac = _cell(x01f, spec, lvl)
            res = spec.level_resolution(lvl)
            lin = torch.zeros_like(pg[:, 0])
            stride = 1
            for d in range(spec.input_dim):
                lin = lin + pg[:, d] * stride
                stride *= res
            idx_rows.append(lin + plan.row_offsets[li])
            w_rows.append(_corner_weights(frac, corners))
        idx = torch.stack(idx_rows, 0).to(torch.int32)  # [Lp, N]
        gathered = gather(packed, idx).reshape(len(plan.packed_levels), n, k, c)
        w = torch.stack(w_rows, 0)  # [Lp, K, N] f32
        out_p = torch.einsum("lkn,lnkc->lnc", w, gathered.float())
        out_p = torch.where(oob, 0.0, out_p).to(table.dtype)
        for li, lvl in enumerate(plan.packed_levels):
            level_outs[lvl] = out_p[li]
    rest = [lvl for lvl in range(spec.num_levels) if lvl not in level_outs]
    if rest:
        enc = encode(x.reshape(-1, spec.input_dim), table, spec, bound, levels=rest)
        for i, lvl in enumerate(rest):
            level_outs[lvl] = enc[:, i * c:(i + 1) * c]
    out = torch.cat([level_outs[lvl] for lvl in range(spec.num_levels)], -1)
    return out.reshape(x.shape[:-1] + (spec.output_dim,))

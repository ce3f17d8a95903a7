"""Fused FiLM-SIREN field: CUDA kernel wrapper and its plain version.

Port of ``sdface_gan_tpu/ops/siren_kernel.py`` (the Pallas kernel
``_siren_kernel``, driven by ``siren_field_fused_parts``).  The whole field
of ``models/siren.py`` runs per point in one launch over the batch, with
its activations kept on chip (``csrc/siren_field.cu``).

* :func:`pack_siren_field` stacks the weights once, in the dot dtype
  (counterpart of ``_pack_params``); the sampler packs at construction.
* :func:`film_coeffs` computes the per-sample gamma/beta with the model's
  own heads, in the parameter dtype (bf16 gamma in bf16 serving, as in the
  JAX package's ``_film_coeffs``), outside the kernel.
* :func:`siren_field_fused_parts` launches the kernel on CUDA tensors and
  runs :func:`siren_field_reference` on CPU tensors.  It picks by device
  only: a build or launch failure raises.

The dot dtype is the packed weights' dtype, which is the network's
parameter dtype, and it alone picks the kernel (:func:`kernel_name`): bf16
weights give bf16 operands with f32 accumulation on the tensor cores
(``mma.sync``), f32 weights an f32 field on the FMA pipes.  (The JAX fused
path always rounds operands to bf16.)  The sampler enables this path by
default; the JAX sampler's opposite default rests on a TPU timing that
says nothing of this card.
The kernel has no backward, as the TPU kernel has none: the wrapper
refuses grad mode and inputs that require grad.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from . import _ext
from .transcendental import fast_sin

_KERNELS = {torch.bfloat16: "siren_field_mma_kernel", torch.float32: "siren_field_f32_kernel"}


def kernel_name(dot_dtype: torch.dtype) -> str:
    """The name of the CUDA kernel that runs a field of this dot dtype, as
    the profiler shows it: bf16 on the tensor cores, f32 on the FMA pipes."""
    if dot_dtype not in _KERNELS:
        raise ValueError(f"dot dtype must be one of {tuple(_KERNELS)}, got {dot_dtype}")
    return _KERNELS[dot_dtype]


@dataclass(frozen=True)
class SirenFieldPack:
    """Field weights in kernel layout: ``[in, out]`` matrices in the dot
    dtype, f32 biases."""

    w_first: torch.Tensor   # [3, W]
    b_first: torch.Tensor   # [W]
    w_hidden: torch.Tensor  # [D-1, W, W]
    b_hidden: torch.Tensor  # [D-1, W]
    wv_h: torch.Tensor      # [W, W]  views layer, point-feature rows
    wv_d: torch.Tensor      # [3, W]  views layer, view-direction rows
    b_v: torch.Tensor       # [W]
    w_sdf: torch.Tensor     # [W, 1]
    b_sdf: torch.Tensor     # [1]
    w_rgb: torch.Tensor     # [W, 3]
    b_rgb: torch.Tensor     # [3]

    @property
    def depth(self) -> int:
        return self.w_hidden.shape[0] + 1

    @property
    def width(self) -> int:
        return self.w_first.shape[1]

    @property
    def dot_dtype(self) -> torch.dtype:
        return self.w_first.dtype

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return (self.w_first, self.b_first, self.w_hidden, self.b_hidden,
                self.wv_h, self.wv_d, self.b_v, self.w_sdf, self.b_sdf,
                self.w_rgb, self.b_rgb)


@torch.no_grad()
def pack_siren_field(network) -> SirenFieldPack:
    """Pack a ``SirenGenerator``'s weights for the fused field, in the
    network's parameter dtype (the dtype :func:`film_coeffs` also uses)."""
    dot = network.pts_linears[0].weight.dtype
    width = network.cfg.width

    def mat(w):  # torch [out, in] -> kernel [in, out]
        return w.detach().t().to(dot).contiguous()

    def vec(b):
        return b.detach().float().contiguous()

    layers = network.pts_linears
    hidden_w = [mat(layer.weight) for layer in layers[1:]]
    hidden_b = [vec(layer.bias) for layer in layers[1:]]
    ref = layers[0].weight
    wv = network.views_linears.weight  # [W, W + 3]
    return SirenFieldPack(
        w_first=mat(layers[0].weight),
        b_first=vec(layers[0].bias),
        w_hidden=(torch.stack(hidden_w) if hidden_w
                  else torch.empty(0, width, width, dtype=dot, device=ref.device)),
        b_hidden=(torch.stack(hidden_b) if hidden_b
                  else torch.empty(0, width, device=ref.device)),
        wv_h=mat(wv[:, :width]),
        wv_d=mat(wv[:, width:]),
        b_v=vec(network.views_linears.bias),
        w_sdf=mat(network.sigma_linear.weight),
        b_sdf=vec(network.sigma_linear.bias),
        w_rgb=mat(network.rgb_linear.weight),
        b_rgb=vec(network.rgb_linear.bias),
    )


def film_coeffs(network, style: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample FiLM (gamma, beta), each [B, D+1, W] f32: rows 0..D-1 for
    the point layers, row D for the views layer.  Computed by the model's
    heads in the parameter dtype, then widened (exactly) to f32."""
    layers = list(network.pts_linears) + [network.views_linears]
    films = [layer.film(style) for layer in layers]
    gamma = torch.stack([g for g, _ in films], 1).float().contiguous()
    beta = torch.stack([b for _, b in films], 1).float().contiguous()
    return gamma, beta


def siren_field_reference(
    pack: SirenFieldPack,
    pts: torch.Tensor,
    views: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused field.

    pts/views [B, P, 3], gamma/beta [B, D+1, W].  Returns ``(rgb [B,P,3]
    f32, sdf [B,P,1] f32, feat [B,P,W] dot dtype)``.  Each product rounds
    its operands to the dot dtype and accumulates in f32.
    """
    dot_dtype = pack.dot_dtype

    def dot(a, w):
        return torch.matmul(a.to(dot_dtype).float(), w.float())

    def film(z, layer):
        return fast_sin(gamma[:, layer:layer + 1] * z + beta[:, layer:layer + 1])

    h = film(dot(pts, pack.w_first) + pack.b_first, 0)
    for layer in range(pack.depth - 1):
        h = film(dot(h, pack.w_hidden[layer]) + pack.b_hidden[layer], layer + 1)
    sdf = dot(h, pack.w_sdf) + pack.b_sdf
    f = dot(h, pack.wv_h) + dot(views, pack.wv_d)
    feat = film(f + pack.b_v, pack.depth).to(dot_dtype)
    rgb = dot(feat, pack.w_rgb) + pack.b_rgb
    return rgb, sdf, feat


def _check_inputs(pack, pts, views, gamma, beta) -> None:
    b, p, _ = pts.shape
    d, w = pack.depth, pack.width
    expect = {"pts": (pts, (b, p, 3)), "views": (views, (b, p, 3)),
              "gamma": (gamma, (b, d + 1, w)), "beta": (beta, (b, d + 1, w))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected f32 {shape}, got {t.dtype} {tuple(t.shape)}")
    kernel_name(pack.dot_dtype)
    if w % 64 or not 64 <= w <= 512:
        raise ValueError(f"the CUDA field takes widths 64..512 in steps of 64, got {w}")
    for t in (pts, views, gamma, beta) + pack.tensors():
        if t.device != pts.device:
            raise ValueError(f"all tensors must be on {pts.device}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA field takes contiguous tensors")
    for t in (gamma, beta) + pack.tensors():  # 16-byte weight copies, paired loads
        if t.data_ptr() % 16:
            raise ValueError("the CUDA field takes 16-byte aligned weights and FiLM tensors")


def siren_field_fused_parts(
    pack: SirenFieldPack,
    pts: torch.Tensor,
    views: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused field: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor.  Same contract as :func:`siren_field_reference`."""
    if torch.is_grad_enabled() or any(
        t.requires_grad for t in (pts, views, gamma, beta) + pack.tensors()
    ):
        raise RuntimeError(
            "the fused SIREN field has no backward: call it under "
            "torch.no_grad() or torch.inference_mode()"
        )
    if pts.device.type == "cpu":
        return siren_field_reference(pack, pts, views, gamma, beta)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    _check_inputs(pack, pts, views, gamma, beta)
    b, p, _ = pts.shape
    rgb = torch.empty(b, p, 3, dtype=torch.float32, device=pts.device)
    sdf = torch.empty(b, p, 1, dtype=torch.float32, device=pts.device)
    feat = torch.empty(b, p, pack.width, dtype=pack.dot_dtype, device=pts.device)
    lib = _ext.load("siren_field")
    fn = lib.siren_field_forward
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(
            int(pack.dot_dtype == torch.bfloat16),
            pts.data_ptr(), views.data_ptr(),
            *(t.data_ptr() for t in pack.tensors()),
            gamma.data_ptr(), beta.data_ptr(),
            rgb.data_ptr(), sdf.data_ptr(), feat.data_ptr(),
            b, p, pack.depth, pack.width, stream,
        )
    _ext.check(lib, code, "siren_field")
    _ext.LAUNCHES["siren_field"] += 1
    return rgb, sdf, feat

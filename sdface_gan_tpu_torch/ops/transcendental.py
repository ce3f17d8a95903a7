"""Polynomial sine and cosine, the FiLM-SIREN activation.

Port of ``sdface_gan_tpu/ops/transcendental.py``: wrap the argument to
[-pi, pi] with a round-based reduction, then evaluate a degree-11 odd
minimax polynomial (max abs error 9.6e-8 on the reduced range).  The
reduction runs in f32 for f32, bf16 and f16 inputs: in bf16,
``round(x / 2pi) * 2pi`` keeps only 8 mantissa bits and is useless for
|x| >> 1.  f64 inputs stay in f64 (finite-difference checks).
``torch.round`` rounds half to even, as ``jnp.round`` does.  The CUDA field
kernel carries the same function as a device function
(``csrc/siren_field.cu``).

:func:`fast_sin_lean` is the same function for training: an autograd
function that saves only its argument, with the polynomial's exact first
and second derivatives written out (``round`` has zero derivative, as in
JAX's autodiff of ``fast_sin``), and its forward-mode tangent, itself
differentiable once.  Eager autograd of :func:`fast_sin` would
save every Horner step, and the eikonal term's double backward would save
the Horner steps of the derivative as well: about twelve [points, width]
tensors per FiLM layer, 1.6 GB each at the stage-A batch.

:func:`film_sin` is the FiLM sine below f32: ``fast_sin(arg + beta)`` with
the sum taken in f32 and only the sine rounded, as XLA's fusion computes
the JAX layer; it saves its two inputs in their own dtype.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

TWO_PI = 6.283185307179586
INV_TWO_PI = 0.15915494309189535

# Odd minimax coefficients for sin on [-pi, pi]: sin(x) ~ x * p(x^2).
S1 = 9.9999959990e-01
S3 = -1.6666552631e-01
S5 = 8.3324029612e-03
S7 = -1.9808632624e-04
S9 = 2.6997138288e-06
S11 = -2.0362212148e-08


def _reduced(x: torch.Tensor) -> torch.Tensor:
    """``x`` in its compute dtype (f32, or f64 for f64), wrapped to [-pi, pi]."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    return x - torch.round(x * INV_TWO_PI) * TWO_PI


def _sin_poly(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    p = S11 * x2 + S9
    p = p * x2 + S7
    p = p * x2 + S5
    p = p * x2 + S3
    p = p * x2 + S1
    return x * p


def _dsin_poly(x: torch.Tensor) -> torch.Tensor:
    """d/dx [x p(x^2)] = sum_k (2k+1) S_{2k+1} x^{2k}."""
    x2 = x * x
    p = (11.0 * S11) * x2 + 9.0 * S9
    p = p * x2 + 7.0 * S7
    p = p * x2 + 5.0 * S5
    p = p * x2 + 3.0 * S3
    return p * x2 + S1


def _d2sin_poly(x: torch.Tensor) -> torch.Tensor:
    """d^2/dx^2 [x p(x^2)] = sum_k (2k+1)(2k) S_{2k+1} x^{2k-1}."""
    x2 = x * x
    p = (110.0 * S11) * x2 + 72.0 * S9
    p = p * x2 + 42.0 * S7
    p = p * x2 + 20.0 * S5
    p = p * x2 + 6.0 * S3
    return x * p


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) via wrap-to-[-pi, pi] and a degree-11 odd polynomial."""
    return _sin_poly(_reduced(x)).to(x.dtype)


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    """cos(x) = sin(x + pi/2) through the same path."""
    return fast_sin(x + 1.5707963267948966)


class _FastSin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        return fast_sin(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return _FastSinGrad.apply(x, grad)

    @staticmethod
    def jvp(ctx, t):
        """The tangent ``t * fast_sin'(x)``, through :class:`_FastSinGrad`
        so that reverse mode passes back through it (the forward-mode
        eikonal term's parameter gradient)."""
        (x,) = ctx.saved_tensors
        return _FastSinGrad.apply(x, t)


class _FastSinGrad(torch.autograd.Function):
    """``grad * fast_sin'(x)``, itself differentiable once (the eikonal
    term's double backward), saving only ``x`` and ``grad``."""

    @staticmethod
    def forward(ctx, x, grad):
        ctx.save_for_backward(x, grad)
        xr = _reduced(x)
        return (grad.to(xr.dtype) * _dsin_poly(xr)).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, gg):
        x, grad = ctx.saved_tensors
        xr = _reduced(x)
        gg = gg.to(xr.dtype)
        dx = dgrad = None
        if ctx.needs_input_grad[0]:
            dx = (gg * grad.to(xr.dtype) * _d2sin_poly(xr)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dgrad = (gg * _dsin_poly(xr)).to(grad.dtype)
        return dx, dgrad


def fast_sin_lean(x: torch.Tensor) -> torch.Tensor:
    """:func:`fast_sin` whose autograd saves only ``x`` (twice differentiable)."""
    return _FastSin.apply(x)


class _FiLMSin(torch.autograd.Function):
    """``fast_sin(arg + beta)``, the sum in f32 (recomputed from the saved
    inputs in the backward and the tangent), the sine rounded to ``arg``'s
    dtype; twice differentiable through :class:`_FastSinGrad`."""

    @staticmethod
    def forward(ctx, arg, beta):
        ctx.save_for_backward(arg, beta)
        ctx.save_for_forward(arg, beta)
        return fast_sin(arg.float() + beta.float()).to(arg.dtype)

    @staticmethod
    def backward(ctx, grad):
        arg, beta = ctx.saved_tensors
        g = _FastSinGrad.apply(arg.float() + beta.float(), grad)
        return g.to(arg.dtype), g.sum_to_size(beta.shape).to(beta.dtype)

    @staticmethod
    def jvp(ctx, t_arg, t_beta):
        arg, beta = ctx.saved_tensors
        t = sum(t.float() for t in (t_arg, t_beta) if t is not None)
        return _FastSinGrad.apply(arg.float() + beta.float(), t).to(arg.dtype)


def film_sin(arg: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``fast_sin(arg + beta)`` for ``arg`` below f32 (``beta`` broadcast to
    it): the sum in f32, the sine rounded to ``arg``'s dtype."""
    return _FiLMSin.apply(arg, beta)

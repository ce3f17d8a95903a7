from .fused_act import fused_leaky_relu
from .siren_kernel import (
    film_coeffs,
    pack_siren_field,
    siren_field_fused_parts,
    siren_field_reference,
)
from .transcendental import fast_cos, fast_sin
from .upfirdn2d import blur, make_kernel, upfirdn2d, upsample2d

__all__ = [
    "fused_leaky_relu",
    "film_coeffs",
    "pack_siren_field",
    "siren_field_fused_parts",
    "siren_field_reference",
    "fast_cos",
    "fast_sin",
    "blur",
    "make_kernel",
    "upfirdn2d",
    "upsample2d",
]

from .fused_act import fused_leaky_relu
from .hash_encoder import (
    HashGridSpec,
    PackPlan,
    hash_encode,
    hash_encode_packed,
    hash_encode_reference,
    pack_hash_table,
    plan_packing,
    table_gather,
    table_gather_reference,
)
from .sh_encoder import sh_encode, sh_output_dim
from .siren_kernel import (
    film_coeffs,
    pack_siren_field,
    siren_field_fused_parts,
    siren_field_reference,
)
from .transcendental import fast_cos, fast_sin, fast_sin_lean
from .upfirdn2d import blur, make_kernel, upfirdn2d, upsample2d

__all__ = [
    "fused_leaky_relu",
    "HashGridSpec",
    "PackPlan",
    "hash_encode",
    "hash_encode_packed",
    "hash_encode_reference",
    "pack_hash_table",
    "plan_packing",
    "table_gather",
    "table_gather_reference",
    "sh_encode",
    "sh_output_dim",
    "film_coeffs",
    "pack_siren_field",
    "siren_field_fused_parts",
    "siren_field_reference",
    "fast_cos",
    "fast_sin",
    "fast_sin_lean",
    "blur",
    "make_kernel",
    "upfirdn2d",
    "upsample2d",
]

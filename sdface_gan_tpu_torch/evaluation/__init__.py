"""FID and KID with the FID InceptionV3, counterpart of
``sdface_gan_tpu/evaluation``."""

from .fid import (
    calculate_activation_statistics,
    calculate_frechet_distance,
    calculate_kid,
    compute_activations,
    fid_from_activations,
    load_stats_npz,
)
from .inception import InceptionV3, inception_pool3, init_inception, load_inception

__all__ = [
    "compute_activations",
    "calculate_activation_statistics",
    "calculate_frechet_distance",
    "calculate_kid",
    "fid_from_activations",
    "load_stats_npz",
    "inception_pool3",
    "init_inception",
    "load_inception",
    "InceptionV3",
]

from .gan_losses import (
    d_logistic_loss,
    d_logits_and_r1,
    d_r1_loss,
    g_content_loss,
    g_nonsaturating_loss,
    g_path_regularize,
    smooth_l1,
    viewpoints_loss,
)
from .geometry_losses import (
    distortion_loss,
    eikonal_loss,
    occupancy_sparsity_loss,
    sphere_init_loss,
)

__all__ = [
    "d_logistic_loss",
    "d_logits_and_r1",
    "d_r1_loss",
    "g_content_loss",
    "g_nonsaturating_loss",
    "g_path_regularize",
    "smooth_l1",
    "viewpoints_loss",
    "distortion_loss",
    "eikonal_loss",
    "occupancy_sparsity_loss",
    "sphere_init_loss",
]

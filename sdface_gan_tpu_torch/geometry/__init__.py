from .cameras import CameraParams, camera_extrinsics_from_angles, generate_camera_params
from .rays import Rays, base_t_vals, get_rays, pixel_grid

__all__ = [
    "CameraParams",
    "camera_extrinsics_from_angles",
    "generate_camera_params",
    "Rays",
    "base_t_vals",
    "get_rays",
    "pixel_grid",
]

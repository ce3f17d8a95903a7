from .cameras import CameraParams, camera_extrinsics_from_angles, generate_camera_params
from .mesh import Mesh, align_volume, extract_mesh_with_marching_cubes, xyz2mesh
from .rays import Rays, base_t_vals, get_rays, pixel_grid

__all__ = [
    "CameraParams",
    "camera_extrinsics_from_angles",
    "generate_camera_params",
    "Mesh",
    "align_volume",
    "extract_mesh_with_marching_cubes",
    "xyz2mesh",
    "Rays",
    "base_t_vals",
    "get_rays",
    "pixel_grid",
]

"""Mesh extraction for SDF volumes, port of ``sdface_gan_tpu/geometry/mesh.py``.

Rebuild of the reference mesh path (``im2scene/sdf/models/sdf_utils.py:
160-331`` + ``sdf_mesh.py:132-182``):

* :func:`align_volume` - warp the SDF sample volume into the camera
  frustum (the renderer samples along diverging rays, so the raw
  [H, W, D] volume is a frustum, not a cube), on the volume's device.
* :func:`extract_mesh_with_marching_cubes` - the zero isosurface through
  the port's native marching cubes (``native/marching_cubes.cpp``), with
  the reference's 0.24 world scale and normal-direction fixes.
* :func:`xyz2mesh` - Delaunay depth-map mesh from a surface point cloud.
* OBJ / PLY export.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass
class Mesh:
    """Host-side triangle mesh."""

    verts: np.ndarray  # [V, 3] float32
    faces: np.ndarray  # [F, 3] int32

    def export_obj(self, path: str) -> None:
        with open(path, "w") as f:
            for v in self.verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for face in self.faces:
                f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")

    def export_ply(self, path: str) -> None:
        with open(path, "wb") as f:
            header = (
                "ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(self.verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {len(self.faces)}\n"
                "property list uchar int vertex_indices\nend_header\n"
            )
            f.write(header.encode())
            f.write(np.ascontiguousarray(self.verts, dtype="<f4").tobytes())
            body = np.empty((len(self.faces),), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
            body["n"] = 3
            body["idx"] = self.faces.astype("<i4")
            f.write(body.tobytes())


def align_volume(volume: torch.Tensor, near: float = 0.88, far: float = 1.12) -> torch.Tensor:
    """Frustum-align an SDF sample volume (reference ``align_volume``,
    ``sdf_utils.py:162-183``).

    volume: [B, H, W, D, C] sampled along camera rays; per depth the (x, y)
    extent is rescaled by ``far/near -> 1`` so the output is a regular cube
    volume.  Trilinear resampling with border clamping
    (``grid_sample(padding_mode='border', align_corners=True)``, which the
    JAX package computes as ``map_coordinates(order=1, mode='nearest')``);
    out-of-frustum cells are set to 1 (outside the surface) so marching
    cubes sees no spurious zero crossings.
    """
    b, h, w, d, c = volume.shape
    # The grid is built on the host, so that every device samples at the
    # same coordinates; it then moves to the volume's device.
    yy = torch.linspace(-1.0, 1.0, h).reshape(h, 1, 1)
    xx = torch.linspace(-1.0, 1.0, w).reshape(1, w, 1)
    zz = torch.linspace(-1.0, 1.0, d).reshape(1, 1, d)
    adjust = torch.linspace(far / near, 1.0, d).reshape(1, 1, d)
    gy = (yy * adjust).expand(h, w, d)
    gx = (xx * adjust).expand(h, w, d)
    gz = zz.expand(h, w, d)
    dev = volume.device
    oob = ((gy.abs() > 1.0) | (gx.abs() > 1.0) | (gz.abs() > 1.0))[None, :, :, :, None].to(dev)
    # For a [N, C, h, w, d] input, grid[..., 0] indexes the last axis (d)
    # and grid[..., 2] the first (h).
    grid = torch.stack([gz, gx, gy], dim=-1)[None].expand(b, h, w, d, 3).to(dev)
    out = F.grid_sample(volume.float().permute(0, 4, 1, 2, 3), grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    out = out.permute(0, 2, 3, 4, 1)
    return torch.where(oob, torch.ones((), device=dev), out)


def extract_mesh_with_marching_cubes(sdf: np.ndarray, level: float = 0.0) -> Mesh:
    """Triangulate an SDF volume (reference ``sdf_utils.py:187-205``).

    sdf: [B, H, W, D, 1] (host numpy); uses volume [0].  Vertices are
    mapped to the reference's world convention: centered, scaled by 0.24,
    with y/z flipped to fix normal orientation.
    """
    from ..native import marching_cubes

    _, h, w, d, _ = sdf.shape
    vol = np.ascontiguousarray(np.swapaxes(np.asarray(sdf)[0, ..., 0], 0, 1))
    verts, faces = marching_cubes(vol, level)
    verts = verts.copy()
    verts[:, 0] = (verts[:, 0] / float(w) - 0.5) * 0.24
    verts[:, 1] = (verts[:, 1] / float(h) - 0.5) * 0.24
    verts[:, 2] = (verts[:, 2] / float(d) - 0.5) * 0.24
    verts[:, 1] *= -1
    verts[:, 2] *= -1
    return Mesh(verts=verts, faces=faces.astype(np.int32))


def xyz2mesh(xyz: np.ndarray) -> Mesh:
    """Depth-map Delaunay mesh from a surface point cloud (reference
    ``sdf_utils.py:209-223``).

    xyz: [1, H, W, 3] world-space surface points (channel-last).
    """
    from scipy.spatial import Delaunay

    _, h, w, _ = xyz.shape
    x, y = np.meshgrid(np.arange(h), np.arange(w))
    tri = Delaunay(np.concatenate((x.reshape(h * w, 1), y.reshape(h * w, 1)), axis=1))
    faces = tri.simplices.copy()
    faces[:, [0, 1]] = faces[:, [1, 0]]  # invert normals
    verts = np.asarray(xyz)[0].reshape(h * w, 3)
    return Mesh(verts=verts.astype(np.float32), faces=faces.astype(np.int32))

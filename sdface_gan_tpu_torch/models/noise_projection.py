"""Geometry-anchored noise projection for flicker-free video rendering.

Port of ``sdface_gan_tpu/models/noise_projection.py`` (numpy on the
host, over the port's native rasterizer).  Rebuild of the reference
``NoiseInjection.project_noise`` (``im2scene/sdf/models/sdf_model.py:
713-792`` + the pytorch3d renderer helpers ``sdf_utils.py:241-331``):
attach one Gaussian noise scalar to every vertex of the extracted face
mesh, render that attribute from the current camera (native z-buffer
rasterizer), and splice it into the decoder's per-layer noise maps
wherever the surface is visible.  Because
the noise rides the SURFACE, it stays fixed under camera motion —
removing the texture flicker of per-frame random noise.

The reference calls this "very slow (~20 min/video)" through pytorch3d;
the native rasterizer is a host loop over the faces.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geometry.mesh import Mesh
from ..native import raster_mesh


def subdivide(verts: np.ndarray, faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Midpoint (loop-topology) subdivision: each triangle -> 4
    (the reference uses ``trimesh.remesh.subdivide`` for high-res layers,
    ``sdf_model.py:737-751``)."""
    edge_mid: Dict[Tuple[int, int], int] = {}
    new_verts = [v for v in verts]

    def midpoint(a: int, b: int) -> int:
        key = (a, b) if a < b else (b, a)
        if key not in edge_mid:
            edge_mid[key] = len(new_verts)
            new_verts.append(0.5 * (verts[a] + verts[b]))
        return edge_mid[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces.extend([(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)])
    return np.asarray(new_verts, np.float32), np.asarray(new_faces, np.int32)


@dataclass
class NoiseProjector:
    """Per-mesh projector with cached subdivisions and vertex noise."""

    mesh: Mesh
    seed: int = 0
    fov: float = 12.0  # reference projection fov (sdf_model.py:769)

    def __post_init__(self):
        self._levels: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def _mesh_for(self, resolution: int):
        """Subdivide once per 2x resolution step above 128 (reference
        subdivision ladder, ``sdf_model.py:735-751``)."""
        n_subdiv = max(0, int(math.log2(max(resolution, 128) // 128)))
        if n_subdiv not in self._levels:
            v, f = self.mesh.verts.astype(np.float32), self.mesh.faces
            for _ in range(n_subdiv):
                v, f = subdivide(v, f)
            rng = np.random.default_rng(self.seed)
            noise = rng.standard_normal(len(v)).astype(np.float32)
            self._levels[n_subdiv] = (v, f, noise)
        return self._levels[n_subdiv]

    def project(
        self,
        cam_extrinsics: np.ndarray,  # [3, 4] camera-to-world (one camera)
        resolution: int,
        prev_noise: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Render the anchored noise from this camera.

        Returns [resolution, resolution, 1]; pixels off the surface keep
        ``prev_noise`` (or fresh Gaussian noise on the first call),
        matching ``sdf_model.py:776-790``.
        """
        verts, faces, vnoise = self._mesh_for(resolution)
        r = np.asarray(cam_extrinsics)[:, :3]  # camera-to-world rotation
        t = np.asarray(cam_extrinsics)[:, 3]
        cam = (verts - t) @ r  # world -> camera (R^T (p - t))
        # our camera looks along -z (see geometry/rays.py); depth = -z
        depth = -cam[:, 2]
        focal = 0.5 * resolution / math.tan(0.5 * self.fov * math.pi / 180.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            x_pix = focal * cam[:, 0] / np.maximum(depth, 1e-6) + resolution / 2.0
            y_pix = -focal * cam[:, 1] / np.maximum(depth, 1e-6) + resolution / 2.0
        verts_px = np.stack([x_pix, y_pix, depth], axis=-1)
        attr, zbuf = raster_mesh(verts_px, faces, vnoise, resolution, resolution)
        valid = zbuf < 1e29

        if prev_noise is None:
            rng = np.random.default_rng(self.seed + resolution)
            prev_noise = rng.standard_normal((resolution, resolution)).astype(np.float32)
        out = np.where(valid, attr, np.asarray(prev_noise).reshape(resolution, resolution))
        return out[..., None].astype(np.float32)

    def decoder_noise(
        self, cam_extrinsics: np.ndarray, noise_resolutions: List[int]
    ) -> List[np.ndarray]:
        """Per-layer [1, r, r, 1] noise list, one projected map per decoder
        layer resolution (channel-last, as ``project`` returns it)."""
        return [
            self.project(cam_extrinsics, r)[None] for r in noise_resolutions
        ]

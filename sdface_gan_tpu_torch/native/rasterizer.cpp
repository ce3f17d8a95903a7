// Minimal z-buffer triangle rasterizer: host-side mesh rendering for
// geometry-anchored noise projection.
//
// The port's copy of sdface_gan_tpu/native/rasterizer.cpp.  Replaces the
// reference's pytorch3d depth-mesh renderer used by
// NoiseInjection.project_noise (im2scene/sdf/models/sdf_model.py:754-792,
// sdf_utils.py:241-331): render a marching-cubes face mesh carrying one
// scalar attribute per vertex (the anchored noise) from a given camera,
// producing the interpolated attribute image and a validity (depth) mask.
//
// Inputs are pre-projected: verts_px = [V, 3] (x_pix, y_pix, depth) with
// depth increasing away from the camera; standard barycentric coverage
// with a z-buffer.  C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// attr_out [h, w] receives interpolated vertex attributes where covered;
// depth_out [h, w] receives the nearest depth (1e30 where empty).
// Returns the number of covered pixels.
int64_t raster_mesh(
    const float* verts_px,   // [V, 3]
    const int32_t* faces,    // [F, 3]
    const float* vert_attr,  // [V]
    int64_t n_verts, int64_t n_faces,
    int64_t h, int64_t w,
    float* attr_out, float* depth_out) {
  std::fill(depth_out, depth_out + h * w, 1e30f);
  int64_t covered = 0;

  for (int64_t f = 0; f < n_faces; ++f) {
    const int32_t ia = faces[3 * f], ib = faces[3 * f + 1], ic = faces[3 * f + 2];
    if (ia < 0 || ib < 0 || ic < 0 || ia >= n_verts || ib >= n_verts || ic >= n_verts)
      continue;
    const float ax = verts_px[3 * ia], ay = verts_px[3 * ia + 1], az = verts_px[3 * ia + 2];
    const float bx = verts_px[3 * ib], by = verts_px[3 * ib + 1], bz = verts_px[3 * ib + 2];
    const float cx = verts_px[3 * ic], cy = verts_px[3 * ic + 1], cz = verts_px[3 * ic + 2];

    const float den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy);
    if (std::fabs(den) < 1e-12f) continue;

    int64_t x0 = std::max<int64_t>(0, (int64_t)std::floor(std::min({ax, bx, cx})));
    int64_t x1 = std::min<int64_t>(w - 1, (int64_t)std::ceil(std::max({ax, bx, cx})));
    int64_t y0 = std::max<int64_t>(0, (int64_t)std::floor(std::min({ay, by, cy})));
    int64_t y1 = std::min<int64_t>(h - 1, (int64_t)std::ceil(std::max({ay, by, cy})));
    if (x0 > x1 || y0 > y1) continue;

    const float va = vert_attr[ia], vb = vert_attr[ib], vc = vert_attr[ic];
    for (int64_t y = y0; y <= y1; ++y) {
      for (int64_t x = x0; x <= x1; ++x) {
        const float px = (float)x + 0.5f, py = (float)y + 0.5f;
        float l0 = ((by - cy) * (px - cx) + (cx - bx) * (py - cy)) / den;
        float l1 = ((cy - ay) * (px - cx) + (ax - cx) * (py - cy)) / den;
        float l2 = 1.0f - l0 - l1;
        const float eps = -1e-5f;
        if (l0 < eps || l1 < eps || l2 < eps) continue;
        const float z = l0 * az + l1 * bz + l2 * cz;
        if (z <= 0.0f) continue;  // behind the camera
        float* dz = &depth_out[y * w + x];
        if (z < *dz) {
          if (*dz >= 1e29f) ++covered;
          *dz = z;
          attr_out[y * w + x] = l0 * va + l1 * vb + l2 * vc;
        }
      }
    }
  }
  return covered;
}

}  // extern "C"

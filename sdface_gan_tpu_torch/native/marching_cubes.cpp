// Marching cubes: triangulate the zero level set of a dense SDF volume.
//
// The port's copy of sdface_gan_tpu/native/marching_cubes.cpp, the
// counterpart of the reference's scikit-image marching_cubes call
// (im2scene/sdf/models/sdf_utils.py:188-205, sdf_mesh.py:161-182).  The
// volume is evaluated on the card, copied to the host, and triangulated
// here: the per-cell table walk is branchy scalar work.
//
// Vertices are de-duplicated per grid edge (hash map keyed by the packed
// canonical corner pair), producing a closed mesh the downstream .obj /
// depth-mesh consumers expect.  Exposed through a C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

#include "mc_tables.h"

namespace {

// Cube corner offsets in (x, y, z), canonical MC corner numbering.
static const int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

// Each of the 12 cube edges connects two corners.
static const int kEdgeCorners[12][2] = {
    {0, 1}, {1, 2}, {2, 3}, {3, 0},
    {4, 5}, {5, 6}, {6, 7}, {7, 4},
    {0, 4}, {1, 5}, {2, 6}, {3, 7},
};

struct MeshResult {
  std::vector<float> verts;   // xyz triples, grid coordinates
  std::vector<int32_t> faces; // index triples
};

}  // namespace

extern "C" {

// Triangulate grid (C-order [nx, ny, nz]) at `level`.  Returns an opaque
// result handle; query with mc_num_verts/mc_num_faces, copy out with
// mc_copy, free with mc_free.  NULL on failure.
void* mc_run(const float* grid, int64_t nx, int64_t ny, int64_t nz,
             float level) {
  if (nx < 2 || ny < 2 || nz < 2) return nullptr;
  auto* res = new MeshResult();
  std::unordered_map<uint64_t, int32_t> edge_to_vert;
  edge_to_vert.reserve(1 << 16);

  const int64_t syx = ny * nz;  // stride for x
  const int64_t syy = nz;       // stride for y

  auto vidx = [&](int64_t x, int64_t y, int64_t z) -> uint64_t {
    return static_cast<uint64_t>((x * ny + y) * nz + z);
  };

  float corner_val[8];
  int64_t corner_id[8];
  float corner_pos[8][3];

  for (int64_t x = 0; x + 1 < nx; ++x) {
    for (int64_t y = 0; y + 1 < ny; ++y) {
      for (int64_t z = 0; z + 1 < nz; ++z) {
        int cube = 0;
        for (int c = 0; c < 8; ++c) {
          int64_t cx = x + kCorner[c][0];
          int64_t cy = y + kCorner[c][1];
          int64_t cz = z + kCorner[c][2];
          float v = grid[cx * syx + cy * syy + cz];
          corner_val[c] = v;
          corner_id[c] = static_cast<int64_t>(vidx(cx, cy, cz));
          corner_pos[c][0] = static_cast<float>(cx);
          corner_pos[c][1] = static_cast<float>(cy);
          corner_pos[c][2] = static_cast<float>(cz);
          if (v < level) cube |= (1 << c);
        }
        int edges = kEdgeTable[cube];
        if (edges == 0) continue;

        int32_t edge_vert[12];
        for (int e = 0; e < 12; ++e) {
          if (!(edges & (1 << e))) continue;
          int a = kEdgeCorners[e][0], b = kEdgeCorners[e][1];
          uint64_t ia = static_cast<uint64_t>(corner_id[a]);
          uint64_t ib = static_cast<uint64_t>(corner_id[b]);
          uint64_t key = ia < ib ? (ia << 32) | ib : (ib << 32) | ia;
          auto it = edge_to_vert.find(key);
          if (it != edge_to_vert.end()) {
            edge_vert[e] = it->second;
            continue;
          }
          float va = corner_val[a], vb = corner_val[b];
          float denom = vb - va;
          float t = denom != 0.0f ? (level - va) / denom : 0.5f;
          if (t < 0.0f) t = 0.0f;
          if (t > 1.0f) t = 1.0f;
          int32_t id = static_cast<int32_t>(res->verts.size() / 3);
          for (int d = 0; d < 3; ++d) {
            res->verts.push_back(corner_pos[a][d] +
                                 t * (corner_pos[b][d] - corner_pos[a][d]));
          }
          edge_to_vert.emplace(key, id);
          edge_vert[e] = id;
        }

        const int* tri = kTriTable[cube];
        for (int t = 0; tri[t] != -1; t += 3) {
          res->faces.push_back(edge_vert[tri[t]]);
          res->faces.push_back(edge_vert[tri[t + 1]]);
          res->faces.push_back(edge_vert[tri[t + 2]]);
        }
      }
    }
  }
  return res;
}

int64_t mc_num_verts(void* rp) {
  return static_cast<int64_t>(static_cast<MeshResult*>(rp)->verts.size() / 3);
}

int64_t mc_num_faces(void* rp) {
  return static_cast<int64_t>(static_cast<MeshResult*>(rp)->faces.size() / 3);
}

void mc_copy(void* rp, float* verts_out, int32_t* faces_out) {
  auto* r = static_cast<MeshResult*>(rp);
  std::memcpy(verts_out, r->verts.data(), r->verts.size() * sizeof(float));
  std::memcpy(faces_out, r->faces.data(), r->faces.size() * sizeof(int32_t));
}

void mc_free(void* rp) { delete static_cast<MeshResult*>(rp); }

}  // extern "C"

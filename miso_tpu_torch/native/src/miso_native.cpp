// miso_native: C++ geometry runtime for miso_tpu.
//
// Replaces the reference's host-side dependencies (mcubes, pysdf,
// open3d raycasting/trimesh) with a single self-contained library:
//   * marching cubes surface extraction (reference usage:
//     grid_opt/utils/utils_sdf.py:89-101, mcubes.marching_cubes)
//   * BVH over triangle meshes with
//       - signed distance queries via angle-weighted pseudonormals
//         (replaces pysdf; reference grid_opt/datasets/sdf_3d.py:54)
//       - ray casting for simulated depth cameras (replaces open3d
//         RaycastingScene; reference sdf_3d.py:209-312)
//       - area-weighted surface sampling (replaces
//         trimesh.sample / open3d sample_points_uniformly)
//
// Exposed through a plain C ABI consumed with ctypes
// (miso_tpu_torch/native/__init__.py, which builds it with g++ at first use).
// A copy of the JAX package's runtime; the code is the same.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

#include "mc_tables.h"

namespace {

struct V3 {
  float x = 0, y = 0, z = 0;
};
inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float norm(V3 a) { return std::sqrt(dot(a, a)); }
inline V3 normalized(V3 a) {
  float n = norm(a);
  return n > 1e-20f ? (1.0f / n) * a : V3{0, 0, 0};
}
inline V3 vmin(V3 a, V3 b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(V3 a, V3 b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

// ---------------------------------------------------------------------------
// Marching cubes
// ---------------------------------------------------------------------------

// Cube corner offsets matching the classic tables (Bourke numbering).
static const int kCorner[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                                  {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
// Edge -> corner pair.
static const int kEdgeCorners[12][2] = {{0, 1}, {1, 2}, {2, 3}, {3, 0},
                                        {4, 5}, {5, 6}, {6, 7}, {7, 4},
                                        {0, 4}, {1, 5}, {2, 6}, {3, 7}};

struct MCResult {
  std::vector<float> verts;
  std::vector<int> tris;
};

// field is (nx, ny, nz) row-major (x slowest), values at grid nodes.
MCResult marching_cubes_impl(const float* field, int nx, int ny, int nz,
                             float iso, const float* origin,
                             const float* spacing) {
  MCResult out;
  auto F = [&](int i, int j, int k) -> float {
    return field[(size_t(i) * ny + j) * nz + k];
  };
  std::unordered_map<uint64_t, int> edge_cache;
  edge_cache.reserve(1 << 16);
  auto edge_key = [&](int i, int j, int k, int axis) -> uint64_t {
    // Vertex on edge starting at node (i,j,k) along axis (0=x,1=y,2=z).
    return ((uint64_t(i) * uint64_t(ny + 1) + j) * uint64_t(nz + 1) + k) * 4 +
           axis;
  };
  auto vert_on_edge = [&](int i, int j, int k, int axis) -> int {
    uint64_t key = edge_key(i, j, k, axis);
    auto it = edge_cache.find(key);
    if (it != edge_cache.end()) return it->second;
    int i2 = i + (axis == 0), j2 = j + (axis == 1), k2 = k + (axis == 2);
    float v1 = F(i, j, k), v2 = F(i2, j2, k2);
    float denom = v2 - v1;
    float t = std::abs(denom) < 1e-12f ? 0.5f : (iso - v1) / denom;
    t = std::min(1.0f, std::max(0.0f, t));
    float px = origin[0] + spacing[0] * (i + t * (axis == 0));
    float py = origin[1] + spacing[1] * (j + t * (axis == 1));
    float pz = origin[2] + spacing[2] * (k + t * (axis == 2));
    int idx = int(out.verts.size() / 3);
    out.verts.push_back(px);
    out.verts.push_back(py);
    out.verts.push_back(pz);
    edge_cache[key] = idx;
    return idx;
  };

  for (int i = 0; i < nx - 1; ++i) {
    for (int j = 0; j < ny - 1; ++j) {
      for (int k = 0; k < nz - 1; ++k) {
        int cube = 0;
        float vals[8];
        for (int c = 0; c < 8; ++c) {
          vals[c] = F(i + kCorner[c][0], j + kCorner[c][1], k + kCorner[c][2]);
          if (vals[c] < iso) cube |= (1 << c);
        }
        int edges = kEdgeTable[cube];
        if (edges == 0) continue;
        int ev[12];
        for (int e = 0; e < 12; ++e) {
          if (!(edges & (1 << e))) continue;
          int c1 = kEdgeCorners[e][0];
          // Edge base node + axis.
          int bi = i + kCorner[c1][0], bj = j + kCorner[c1][1],
              bk = k + kCorner[c1][2];
          int c2 = kEdgeCorners[e][1];
          int axis = (kCorner[c2][0] != kCorner[c1][0])   ? 0
                     : (kCorner[c2][1] != kCorner[c1][1]) ? 1
                                                          : 2;
          // Base must be the lower corner along the axis.
          if (kCorner[c2][axis] < kCorner[c1][axis]) {
            bi = i + kCorner[c2][0];
            bj = j + kCorner[c2][1];
            bk = k + kCorner[c2][2];
          }
          ev[e] = vert_on_edge(bi, bj, bk, axis);
        }
        const int* tt = kTriTable[cube];
        // Emit with flipped winding so face normals point outward
        // (toward positive field values); the reference does the same
        // flip after mcubes (utils_sdf.py:127-128).
        for (int t = 0; tt[t] != -1; t += 3) {
          out.tris.push_back(ev[tt[t]]);
          out.tris.push_back(ev[tt[t + 2]]);
          out.tris.push_back(ev[tt[t + 1]]);
        }
      }
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// BVH mesh: signed distance + raycast + sampling
// ---------------------------------------------------------------------------

struct Tri {
  V3 a, b, c;
  V3 n;                  // face normal (area-weighted direction, normalized)
  V3 en[3];              // edge pseudonormals (ab, bc, ca)
  V3 vn[3];              // vertex pseudonormals (a, b, c)
  float area = 0;
};

struct Node {
  V3 lo, hi;
  int left = -1, right = -1;  // children; leaf if left < 0
  int start = 0, count = 0;   // triangle range for leaves
};

struct Mesh {
  std::vector<Tri> tris;
  std::vector<int> order;  // triangle indices in BVH order
  std::vector<Node> nodes;
  std::vector<float> cum_area;
  float total_area = 0;
  bool watertight_normals = false;
};

float aabb_dist2(const V3& p, const V3& lo, const V3& hi) {
  float d = 0;
  float dx = std::max({lo.x - p.x, 0.0f, p.x - hi.x});
  float dy = std::max({lo.y - p.y, 0.0f, p.y - hi.y});
  float dz = std::max({lo.z - p.z, 0.0f, p.z - hi.z});
  d = dx * dx + dy * dy + dz * dz;
  return d;
}

// Closest point on triangle (Ericson, Real-Time Collision Detection).
// Also reports the feature region: 0=face, 1..3=edge(ab,bc,ca), 4..6=vertex(a,b,c).
V3 closest_point_triangle(const V3& p, const Tri& t, int* feature) {
  V3 ab = t.b - t.a, ac = t.c - t.a, ap = p - t.a;
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) { *feature = 4; return t.a; }
  V3 bp = p - t.b;
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) { *feature = 5; return t.b; }
  float vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    float v = d1 / (d1 - d3);
    *feature = 1;
    return t.a + v * ab;
  }
  V3 cp = p - t.c;
  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) { *feature = 6; return t.c; }
  float vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    float w = d2 / (d2 - d6);
    *feature = 3;
    return t.a + w * ac;
  }
  float va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    float w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    *feature = 2;
    return t.b + w * (t.c - t.b);
  }
  float denom = 1.0f / (va + vb + vc);
  float v = vb * denom, w = vc * denom;
  *feature = 0;
  return t.a + v * ab + w * ac;
}

int build_bvh(Mesh& m, std::vector<int>& idx, int start, int count,
              std::vector<V3>& centroids, int depth = 0) {
  Node node;
  node.lo = {1e30f, 1e30f, 1e30f};
  node.hi = {-1e30f, -1e30f, -1e30f};
  for (int i = start; i < start + count; ++i) {
    const Tri& t = m.tris[idx[i]];
    node.lo = vmin(node.lo, vmin(t.a, vmin(t.b, t.c)));
    node.hi = vmax(node.hi, vmax(t.a, vmax(t.b, t.c)));
  }
  int node_id = int(m.nodes.size());
  m.nodes.push_back(node);
  if (count <= 4 || depth > 40) {
    m.nodes[node_id].start = start;
    m.nodes[node_id].count = count;
    return node_id;
  }
  V3 ext = node.hi - node.lo;
  int axis = (ext.x >= ext.y && ext.x >= ext.z) ? 0 : (ext.y >= ext.z ? 1 : 2);
  auto key = [&](int t) {
    const V3& c = centroids[t];
    return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
  };
  int mid = start + count / 2;
  std::nth_element(idx.begin() + start, idx.begin() + mid,
                   idx.begin() + start + count,
                   [&](int a, int b) { return key(a) < key(b); });
  int l = build_bvh(m, idx, start, count / 2, centroids, depth + 1);
  int r = build_bvh(m, idx, mid, count - count / 2, centroids, depth + 1);
  m.nodes[node_id].left = l;
  m.nodes[node_id].right = r;
  m.nodes[node_id].count = 0;
  return node_id;
}

Mesh* mesh_build_impl(const float* verts, int nv, const int* tris, int nt) {
  Mesh* m = new Mesh();
  m->tris.resize(nt);
  std::vector<V3> vs(nv);
  for (int i = 0; i < nv; ++i) vs[i] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};

  // Accumulate angle-weighted vertex pseudonormals and edge normals.
  std::vector<V3> vert_normal(nv, V3{});
  std::unordered_map<uint64_t, V3> edge_normal;
  edge_normal.reserve(size_t(nt) * 3);
  auto ekey = [&](int a, int b) -> uint64_t {
    if (a > b) std::swap(a, b);
    return (uint64_t(a) << 32) | uint64_t(b);
  };
  for (int i = 0; i < nt; ++i) {
    int ia = tris[3 * i], ib = tris[3 * i + 1], ic = tris[3 * i + 2];
    Tri& t = m->tris[i];
    t.a = vs[ia];
    t.b = vs[ib];
    t.c = vs[ic];
    V3 fn = cross(t.b - t.a, t.c - t.a);
    t.area = 0.5f * norm(fn);
    t.n = normalized(fn);
    // Angle weights at each vertex.
    auto angle = [&](V3 p, V3 q, V3 r) {
      V3 u = normalized(q - p), v = normalized(r - p);
      float c = std::min(1.0f, std::max(-1.0f, dot(u, v)));
      return std::acos(c);
    };
    vert_normal[ia] = vert_normal[ia] + angle(t.a, t.b, t.c) * t.n;
    vert_normal[ib] = vert_normal[ib] + angle(t.b, t.c, t.a) * t.n;
    vert_normal[ic] = vert_normal[ic] + angle(t.c, t.a, t.b) * t.n;
    edge_normal[ekey(ia, ib)] = edge_normal[ekey(ia, ib)] + t.n;
    edge_normal[ekey(ib, ic)] = edge_normal[ekey(ib, ic)] + t.n;
    edge_normal[ekey(ic, ia)] = edge_normal[ekey(ic, ia)] + t.n;
  }
  for (int i = 0; i < nt; ++i) {
    int ia = tris[3 * i], ib = tris[3 * i + 1], ic = tris[3 * i + 2];
    Tri& t = m->tris[i];
    t.vn[0] = normalized(vert_normal[ia]);
    t.vn[1] = normalized(vert_normal[ib]);
    t.vn[2] = normalized(vert_normal[ic]);
    t.en[0] = normalized(edge_normal[ekey(ia, ib)]);
    t.en[1] = normalized(edge_normal[ekey(ib, ic)]);
    t.en[2] = normalized(edge_normal[ekey(ic, ia)]);
  }
  // BVH.
  std::vector<V3> centroids(nt);
  for (int i = 0; i < nt; ++i) {
    const Tri& t = m->tris[i];
    centroids[i] = (1.0f / 3.0f) * (t.a + t.b + t.c);
  }
  m->order.resize(nt);
  for (int i = 0; i < nt; ++i) m->order[i] = i;
  if (nt > 0) build_bvh(*m, m->order, 0, nt, centroids);
  // Area CDF for sampling.
  m->cum_area.resize(nt);
  float acc = 0;
  for (int i = 0; i < nt; ++i) {
    acc += m->tris[i].area;
    m->cum_area[i] = acc;
  }
  m->total_area = acc;
  return m;
}

struct ClosestHit {
  float d2 = 1e30f;
  int tri = -1;
  V3 point{};
  int feature = 0;
};

void closest_point_bvh(const Mesh& m, const V3& p, ClosestHit* hit) {
  if (m.nodes.empty()) return;
  int stack[64];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    int ni = stack[--sp];
    const Node& node = m.nodes[ni];
    if (aabb_dist2(p, node.lo, node.hi) >= hit->d2) continue;
    if (node.left < 0) {
      for (int i = node.start; i < node.start + node.count; ++i) {
        int t = m.order[i];
        int feat;
        V3 cp = closest_point_triangle(p, m.tris[t], &feat);
        V3 d = p - cp;
        float d2 = dot(d, d);
        if (d2 < hit->d2) {
          hit->d2 = d2;
          hit->tri = t;
          hit->point = cp;
          hit->feature = feat;
        }
      }
    } else {
      // Visit nearer child first.
      float dl = aabb_dist2(p, m.nodes[node.left].lo, m.nodes[node.left].hi);
      float dr = aabb_dist2(p, m.nodes[node.right].lo, m.nodes[node.right].hi);
      int first = dl <= dr ? node.left : node.right;
      int second = dl <= dr ? node.right : node.left;
      if (sp < 62) {
        stack[sp++] = second;
        stack[sp++] = first;
      }
    }
  }
}

float signed_distance_one(const Mesh& m, const V3& p) {
  ClosestHit hit;
  closest_point_bvh(m, p, &hit);
  if (hit.tri < 0) return 1e30f;
  const Tri& t = m.tris[hit.tri];
  V3 pn;
  switch (hit.feature) {
    case 0: pn = t.n; break;
    case 1: pn = t.en[0]; break;
    case 2: pn = t.en[1]; break;
    case 3: pn = t.en[2]; break;
    case 4: pn = t.vn[0]; break;
    case 5: pn = t.vn[1]; break;
    default: pn = t.vn[2]; break;
  }
  V3 d = p - hit.point;
  float dist = std::sqrt(hit.d2);
  return dot(d, pn) >= 0 ? dist : -dist;
}

bool ray_tri(const V3& o, const V3& dir, const Tri& t, float* out_t) {
  // Moller-Trumbore.
  V3 e1 = t.b - t.a, e2 = t.c - t.a;
  V3 h = cross(dir, e2);
  float det = dot(e1, h);
  if (std::abs(det) < 1e-12f) return false;
  float inv = 1.0f / det;
  V3 s = o - t.a;
  float u = dot(s, h) * inv;
  if (u < -1e-7f || u > 1.0f + 1e-7f) return false;
  V3 q = cross(s, e1);
  float v = dot(dir, q) * inv;
  if (v < -1e-7f || u + v > 1.0f + 1e-7f) return false;
  float tt = dot(e2, q) * inv;
  if (tt <= 1e-6f) return false;
  *out_t = tt;
  return true;
}

bool ray_aabb(const V3& o, const V3& inv_dir, const V3& lo, const V3& hi,
              float tmax) {
  float t1 = (lo.x - o.x) * inv_dir.x, t2 = (hi.x - o.x) * inv_dir.x;
  float tmin_ = std::min(t1, t2), tmax_ = std::max(t1, t2);
  t1 = (lo.y - o.y) * inv_dir.y;
  t2 = (hi.y - o.y) * inv_dir.y;
  tmin_ = std::max(tmin_, std::min(t1, t2));
  tmax_ = std::min(tmax_, std::max(t1, t2));
  t1 = (lo.z - o.z) * inv_dir.z;
  t2 = (hi.z - o.z) * inv_dir.z;
  tmin_ = std::max(tmin_, std::min(t1, t2));
  tmax_ = std::min(tmax_, std::max(t1, t2));
  return tmax_ >= std::max(tmin_, 0.0f) && tmin_ <= tmax;
}

void raycast_one(const Mesh& m, const V3& o, const V3& dir, float* out_t,
                 int* out_tri) {
  *out_t = -1.0f;
  *out_tri = -1;
  if (m.nodes.empty()) return;
  V3 inv{1.0f / (dir.x == 0 ? 1e-20f : dir.x),
         1.0f / (dir.y == 0 ? 1e-20f : dir.y),
         1.0f / (dir.z == 0 ? 1e-20f : dir.z)};
  float best = 1e30f;
  int stack[64];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    int ni = stack[--sp];
    const Node& node = m.nodes[ni];
    if (!ray_aabb(o, inv, node.lo, node.hi, best)) continue;
    if (node.left < 0) {
      for (int i = node.start; i < node.start + node.count; ++i) {
        int t = m.order[i];
        float tt;
        if (ray_tri(o, dir, m.tris[t], &tt) && tt < best) {
          best = tt;
          *out_tri = t;
        }
      }
    } else if (sp < 62) {
      stack[sp++] = node.left;
      stack[sp++] = node.right;
    }
  }
  if (*out_tri >= 0) *out_t = best;
}

struct LCG {
  uint64_t s;
  explicit LCG(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ull) {}
  float next() {
    s = s * 6364136223846793005ull + 1442695040888963407ull;
    return float((s >> 11) & ((1ull << 24) - 1)) / float(1 << 24);
  }
};

}  // namespace

extern "C" {

int mn_marching_cubes(const float* field, int nx, int ny, int nz, float iso,
                      const float* origin, const float* spacing,
                      float** out_verts, int* out_nverts, int** out_tris,
                      int* out_ntris) {
  MCResult r = marching_cubes_impl(field, nx, ny, nz, iso, origin, spacing);
  *out_nverts = int(r.verts.size() / 3);
  *out_ntris = int(r.tris.size() / 3);
  *out_verts = (float*)std::malloc(r.verts.size() * sizeof(float));
  *out_tris = (int*)std::malloc(r.tris.size() * sizeof(int));
  std::memcpy(*out_verts, r.verts.data(), r.verts.size() * sizeof(float));
  std::memcpy(*out_tris, r.tris.data(), r.tris.size() * sizeof(int));
  return 0;
}

void mn_free(void* p) { std::free(p); }

void* mn_mesh_build(const float* verts, int nv, const int* tris, int nt) {
  return mesh_build_impl(verts, nv, tris, nt);
}

void mn_mesh_free(void* handle) { delete reinterpret_cast<Mesh*>(handle); }

void mn_signed_distance(void* handle, const float* pts, int n, float* out) {
  Mesh* m = reinterpret_cast<Mesh*>(handle);
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    V3 p{pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
    out[i] = signed_distance_one(*m, p);
  }
}

void mn_unsigned_distance(void* handle, const float* pts, int n, float* out) {
  Mesh* m = reinterpret_cast<Mesh*>(handle);
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    V3 p{pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
    ClosestHit hit;
    closest_point_bvh(*m, p, &hit);
    out[i] = std::sqrt(hit.d2);
  }
}

void mn_closest_points(void* handle, const float* pts, int n, float* out_pts,
                       float* out_dist) {
  Mesh* m = reinterpret_cast<Mesh*>(handle);
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    V3 p{pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
    ClosestHit hit;
    closest_point_bvh(*m, p, &hit);
    out_pts[3 * i] = hit.point.x;
    out_pts[3 * i + 1] = hit.point.y;
    out_pts[3 * i + 2] = hit.point.z;
    out_dist[i] = std::sqrt(hit.d2);
  }
}

void mn_raycast(void* handle, const float* origins, const float* dirs, int n,
                float* out_t, int* out_tri) {
  Mesh* m = reinterpret_cast<Mesh*>(handle);
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    V3 o{origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
    V3 d{dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]};
    raycast_one(*m, o, normalized(d), &out_t[i], &out_tri[i]);
  }
}

void mn_sample_surface(void* handle, int n, uint64_t seed, float* out_pts,
                       float* out_normals) {
  Mesh* m = reinterpret_cast<Mesh*>(handle);
  LCG rng(seed);
  for (int i = 0; i < n; ++i) {
    float r = rng.next() * m->total_area;
    int t = int(std::lower_bound(m->cum_area.begin(), m->cum_area.end(), r) -
                m->cum_area.begin());
    if (t >= int(m->tris.size())) t = int(m->tris.size()) - 1;
    const Tri& tri = m->tris[t];
    float u = rng.next(), v = rng.next();
    if (u + v > 1) {
      u = 1 - u;
      v = 1 - v;
    }
    V3 p = tri.a + u * (tri.b - tri.a) + v * (tri.c - tri.a);
    out_pts[3 * i] = p.x;
    out_pts[3 * i + 1] = p.y;
    out_pts[3 * i + 2] = p.z;
    if (out_normals) {
      out_normals[3 * i] = tri.n.x;
      out_normals[3 * i + 1] = tri.n.y;
      out_normals[3 * i + 2] = tri.n.z;
    }
  }
}

}  // extern "C"

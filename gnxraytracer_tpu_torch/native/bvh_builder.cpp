// Native scene-build runtime: SAH BVH construction + PCG32 Halton
// permutation generation.
//
// The compute path of the package is PyTorch and CUDA; this library covers
// the host-side scene-build work where Python-loop costs would otherwise
// dominate set-up for large meshes: a 12-bucket surface-area-heuristic BVH
// build (pbrt's cost model) and the radical-inverse permutation generation
// of the Halton sampler.
//
// Build: g++ -O3 -shared -fPIC bvh_builder.cpp (native/__init__.py does it)
// ABI: plain C functions, consumed via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
  Vec3() : x(0), y(0), z(0) {}
  Vec3(float a, float b, float c) : x(a), y(b), z(c) {}
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return Vec3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return Vec3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}

struct Bounds {
  Vec3 lo{1e30f, 1e30f, 1e30f};
  Vec3 hi{-1e30f, -1e30f, -1e30f};
  void extend(const Vec3 &p) { lo = vmin(lo, p); hi = vmax(hi, p); }
  void extend(const Bounds &b) { lo = vmin(lo, b.lo); hi = vmax(hi, b.hi); }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Builder {
  const float *verts;
  const int32_t *tris;
  int leaf_size;
  std::vector<Bounds> prim_bounds;
  std::vector<Vec3> centroids;
  // output SoA
  std::vector<float> lo, hi;
  std::vector<int32_t> offset, nprims, axis, order;

  int new_node() {
    lo.insert(lo.end(), {0, 0, 0});
    hi.insert(hi.end(), {0, 0, 0});
    offset.push_back(0);
    nprims.push_back(0);
    axis.push_back(0);
    return (int)offset.size() - 1;
  }

  void set_bounds(int node, const Bounds &b) {
    lo[3 * node + 0] = b.lo.x;
    lo[3 * node + 1] = b.lo.y;
    lo[3 * node + 2] = b.lo.z;
    hi[3 * node + 0] = b.hi.x;
    hi[3 * node + 1] = b.hi.y;
    hi[3 * node + 2] = b.hi.z;
  }

  // Recursive SAH build over idx[first, last). Mirrors the 12-bucket SAH
  // cost model of the reference recursiveBuild.
  int build(std::vector<int32_t> &idx, int first, int last) {
    int me = new_node();
    Bounds b;
    for (int i = first; i < last; ++i) b.extend(prim_bounds[idx[i]]);
    set_bounds(me, b);
    int n = last - first;
    if (n <= leaf_size) {
      offset[me] = (int)order.size();
      nprims[me] = n;
      for (int i = first; i < last; ++i) order.push_back(idx[i]);
      return me;
    }
    Bounds cb;
    for (int i = first; i < last; ++i) cb.extend(centroids[idx[i]]);
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int dim = ext[1] > ext[0] ? (ext[2] > ext[1] ? 2 : 1) : (ext[2] > ext[0] ? 2 : 0);
    if (ext[dim] < 1e-12f) {
      // Degenerate (identical centroids): the reference emits one big leaf
      // (BVHAccel.cpp:231-246); our traversals test a fixed leaf_size
      // window, so split arbitrarily in half until leaves fit.
      int mid = first + n / 2;
      axis[me] = dim;
      nprims[me] = 0;
      build(idx, first, mid);
      int second = build(idx, mid, last);
      offset[me] = second;
      return me;
    }
    constexpr int NB = 12;
    int counts[NB] = {0};
    Bounds bb[NB];
    float c_lo = cb.lo[dim], inv = NB / ext[dim];
    auto bucket_of = [&](int prim) {
      int w = (int)((centroids[prim][dim] - c_lo) * inv);
      return std::min(w, NB - 1);
    };
    for (int i = first; i < last; ++i) {
      int w = bucket_of(idx[i]);
      counts[w]++;
      bb[w].extend(prim_bounds[idx[i]]);
    }
    float cost[NB - 1];
    for (int s = 0; s < NB - 1; ++s) {
      Bounds b0, b1;
      int c0 = 0, c1 = 0;
      for (int j = 0; j <= s; ++j)
        if (counts[j]) { b0.extend(bb[j]); c0 += counts[j]; }
      for (int j = s + 1; j < NB; ++j)
        if (counts[j]) { b1.extend(bb[j]); c1 += counts[j]; }
      float a0 = c0 ? b0.area() : 0.f, a1 = c1 ? b1.area() : 0.f;
      cost[s] = 1.f + (c0 * a0 + c1 * a1) / std::max(b.area(), 1e-12f);
    }
    int split = 0;
    for (int s = 1; s < NB - 1; ++s)
      if (cost[s] < cost[split]) split = s;
    // (no "SAH says leaf is cheaper" big-leaf branch: n > leaf_size here
    // and oversized leaves overflow the fixed leaf_size intersector
    // window — always split instead)
    auto mid_it = std::partition(idx.begin() + first, idx.begin() + last,
                                 [&](int p) { return bucket_of(p) <= split; });
    int mid = (int)(mid_it - idx.begin());
    if (mid == first || mid == last) {
      mid = first + n / 2;
      std::nth_element(idx.begin() + first, idx.begin() + mid,
                       idx.begin() + last, [&](int a2, int b2) {
                         return centroids[a2][dim] < centroids[b2][dim];
                       });
    }
    axis[me] = dim;
    nprims[me] = 0;
    build(idx, first, mid);
    int second = build(idx, mid, last);
    offset[me] = second;
    return me;
  }
};

}  // namespace

extern "C" {

// Returns node count; fills caller buffers (sized via bvh_max_nodes()).
// out_order must hold n_tris + leaf_size entries (padded with -1).
int gnx_build_bvh_sah(const float *verts, int n_verts, const int32_t *tris,
                      int n_tris, int leaf_size, float *out_lo, float *out_hi,
                      int32_t *out_offset, int32_t *out_nprims,
                      int32_t *out_axis, int32_t *out_order, int max_nodes,
                      int *out_order_len) {
  (void)n_verts;
  Builder b;
  b.verts = verts;
  b.tris = tris;
  b.leaf_size = leaf_size;
  b.prim_bounds.resize(n_tris);
  b.centroids.resize(n_tris);
  for (int t = 0; t < n_tris; ++t) {
    Bounds pb;
    for (int k = 0; k < 3; ++k) {
      const float *p = verts + 3 * tris[3 * t + k];
      pb.extend(Vec3(p[0], p[1], p[2]));
    }
    b.prim_bounds[t] = pb;
    b.centroids[t] = Vec3(0.5f * (pb.lo.x + pb.hi.x), 0.5f * (pb.lo.y + pb.hi.y),
                          0.5f * (pb.lo.z + pb.hi.z));
  }
  std::vector<int32_t> idx(n_tris);
  for (int i = 0; i < n_tris; ++i) idx[i] = i;
  b.build(idx, 0, n_tris);
  int n_nodes = (int)b.offset.size();
  if (n_nodes > max_nodes) return -1;
  std::memcpy(out_lo, b.lo.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(out_hi, b.hi.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(out_offset, b.offset.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(out_nprims, b.nprims.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(out_axis, b.axis.data(), sizeof(int32_t) * n_nodes);
  int olen = (int)b.order.size();
  int pad = (leaf_size - olen % leaf_size) % leaf_size;
  std::memcpy(out_order, b.order.data(), sizeof(int32_t) * olen);
  for (int i = 0; i < pad; ++i) out_order[olen + i] = -1;
  *out_order_len = olen + pad;
  return n_nodes;
}

// Exact replica of the reference PCG32 + Shuffle permutation generation
// (core/RNG.h defaults, core/Sampling.h:130, LowDiscrepancy.cpp:2459).
void gnx_halton_permutations(const int32_t *primes, int n_primes,
                             int32_t *out /* sum(primes) entries */) {
  uint64_t state = 0x853c49e6748fea9bULL;
  const uint64_t inc = 0xda3e39cb94b95bdbULL;
  const uint64_t mult = 0x5851f42d4c957f2dULL;
  auto next_u32 = [&]() -> uint32_t {
    uint64_t old = state;
    state = old * mult + inc;
    uint32_t xorshifted = (uint32_t)(((old >> 18u) ^ old) >> 27u);
    uint32_t rot = (uint32_t)(old >> 59u);
    return (xorshifted >> rot) | (xorshifted << ((~rot + 1u) & 31));
  };
  auto bounded = [&](uint32_t bound) -> uint32_t {
    uint32_t threshold = (~bound + 1u) % bound;
    while (true) {
      uint32_t r = next_u32();
      if (r >= threshold) return r % bound;
    }
  };
  int64_t off = 0;
  for (int i = 0; i < n_primes; ++i) {
    int n = primes[i];
    for (int j = 0; j < n; ++j) out[off + j] = j;
    for (int j = 0; j < n; ++j) {
      int other = j + (int)bounded((uint32_t)(n - j));
      std::swap(out[off + j], out[off + other]);
    }
    off += n;
  }
}

}  // extern "C"

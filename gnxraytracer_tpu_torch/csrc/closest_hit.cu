// Brute-force watertight casts of N rays against T triangles: the closest
// hit, and the any hit of shadow rays, from one template.
//
// The closest hit replaces the TPU kernel ops/pallas_intersect.py::_kernel
// of the JAX package (reached through pallas_closest_hit).  Same function:
// running best t seeded by t_max, zero-snapped edge functions, conservative
// delta_t, first triangle wins a tie (strict t < best_t); on a miss t =
// FLT_MAX, tri = 0, b = 0.  A lane with t_max <= 0 can never hit and stays
// a miss.  The any hit has no TPU counterpart (it is XLA code in the JAX
// package, intersect.any_triangle_hit): a lane is occluded when any
// triangle's full test is valid with t <= its own t_max; it leaves its loop
// at the first such triangle, and a lane with t_max <= 0 never tests.
//
// What bounds it on an H100: it moves N*(28 in + 21 out) bytes (closest) or
// N*(28 + 1) (any) plus the 36*T-byte table, and does its work per
// ray-triangle pair.  Built with --fmad=false (see watertight.cuh) every
// operation is its own instruction, so the floor is the instructions a
// pair at one instruction a lane a cycle: instruction issue bounds it, not
// memory (at the Cornell shape, N = 1M, T = 12, the ray I/O is 15 us at
// 3.35 TB/s).  The design cuts the instructions a pair:
//   * the axis permutation is chosen once a ray (word offsets kx, ky, kz
//     into a vertex) and the table is read through it, instead of two
//     selects for each of a pair's nine coordinates;
//   * a pair runs the cheap tests first, behind two branches: the edge
//     functions, signs and det != 0, then the t range; it enters the tail
//     (the IEEE division, delta_t, the barycentrics) only when it is still
//     a candidate.  In the Cornell box a ray's line crosses two or three of
//     the twelve triangles, so most pairs leave after the edges;
//   * a table that fits one shared-memory tile (Cornell: 432 bytes) is
//     staged once, in dynamic shared memory of its own size, and scanned by
//     an instantiation with no tile loop: nvcc gives that loop fewer
//     instructions a pair than the tiled one (70 against 79 on the reject
//     path; the shared memory's size makes no difference to the time).
//     Larger tables go through 1,024-triangle tiles.
// One ray a thread, ray, frame and running best in registers; every thread
// of a block reads the same triangle row, at most three neighbouring words
// a vertex (no bank conflict); each ray read once and each result written
// once; the ragged last block is masked, nothing is padded on the host.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

#include "watertight.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileTris = 1024;  // 36 KB of shared memory a tile

// Per-lane state of one cast: the running best (closest) or the occlusion
// flag (any hit).
struct Best {
  float t;  // closest: the running best, seeded by t_max; any: t_max
  int tri = 0;
  float b0 = 0.f, b1 = 0.f, b2 = 0.f;
  bool found = false;
};

// Triangles [first, first + count) of the staged table s_tri.  Returns
// false once an any-hit lane is occluded (its loop is over).
template <bool kAnyHit>
__device__ __forceinline__ bool scan(const gnx::PermFrame& f,
                                     const float* s_tri, int first, int count,
                                     Best& best) {
#pragma unroll 1
  for (int j = 0; j < count; ++j) {
    float x[3], y[3], zp[3];
    gnx::perm_vertices(f, s_tri + 9 * j, x, y, zp);
    gnx::Sheared s;
    const bool edges = gnx::watertight_edges(x, y, s);
    if (!edges) continue;
    const bool range = gnx::watertight_range(zp, f.sz, best.t, s);
    const bool cand = edges && range;
    if (!cand) continue;
    float t, c0, c1, c2;
    const bool tail = gnx::watertight_tail(s, t, c0, c1, c2);
    if (!(cand && tail)) continue;
    if (kAnyHit) {
      best.found = true;
      return false;
    }
    if (t < best.t) {
      best.t = t;
      best.tri = first + j;
      best.b0 = c0;
      best.b1 = c1;
      best.b2 = c2;
      best.found = true;
    }
  }
  return true;
}

template <bool kAnyHit, bool kTiled>
__device__ __forceinline__ void brute_force(
    const float* __restrict__ tri, int n_tri, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ t_max,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ b_out, uint8_t* __restrict__ flag_out, long long n) {
  extern __shared__ float s_tri[];  // rows of 9 floats: see launch_shape

  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = i < n;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  Best best;
  best.t = 0.f;
  if (in_range) {
    ox = o[3 * i + 0]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i + 0]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    best.t = t_max[i];
  }
  // closest: t must satisfy 0 < t <= best_t, so best_t <= 0 (or NaN) never
  // hits.  any hit: the plain version tests every lane but t_max <= 0.
  bool live = in_range && (kAnyHit ? !(best.t <= 0.0f) : (best.t > 0.0f));

  const gnx::PermFrame frame = gnx::make_perm_frame(ox, oy, oz, dx, dy, dz);

  if (kTiled) {
    for (int tile = 0; tile < n_tri; tile += kTileTris) {
      const int count = min(kTileTris, n_tri - tile);
      __syncthreads();  // the previous tile is no longer read
      for (int k = threadIdx.x; k < count * 9; k += kThreads)
        s_tri[k] = tri[(long long)tile * 9 + k];
      __syncthreads();
      if (live) live = scan<kAnyHit>(frame, s_tri, tile, count, best);
    }
  } else {
    for (int k = threadIdx.x; k < n_tri * 9; k += kThreads) s_tri[k] = tri[k];
    __syncthreads();
    if (live) scan<kAnyHit>(frame, s_tri, 0, n_tri, best);
  }

  if (!in_range) return;
  if (kAnyHit) {
    flag_out[i] = best.found ? 1 : 0;
    return;
  }
  t_out[i] = best.found ? best.t : FLT_MAX;
  tri_out[i] = best.tri;
  b_out[3 * i + 0] = best.b0;
  b_out[3 * i + 1] = best.b1;
  b_out[3 * i + 2] = best.b2;
  flag_out[i] = best.found ? 1 : 0;
}

template <bool kTiled>
__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ tri, int n_tri,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_max, float* __restrict__ t_out,
                   int* __restrict__ tri_out, float* __restrict__ b_out,
                   uint8_t* __restrict__ hit_out, long long n) {
  brute_force<false, kTiled>(tri, n_tri, o, d, t_max, t_out, tri_out, b_out,
                             hit_out, n);
}

template <bool kTiled>
__global__ void __launch_bounds__(kThreads)
brute_any_hit_kernel(const float* __restrict__ tri, int n_tri,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max,
                     uint8_t* __restrict__ occ_out, long long n) {
  brute_force<true, kTiled>(tri, n_tri, o, d, t_max, nullptr, nullptr,
                            nullptr, occ_out, n);
}

// Grid and dynamic shared memory of a launch, and whether it goes through
// tiles; false if n is too large.
bool launch_shape(int n_tri, long long n, unsigned& blocks, size_t& smem,
                  bool& tiled) {
  const long long b = (n + kThreads - 1) / kThreads;
  if (b > 2147483647LL) return false;
  blocks = (unsigned)b;
  tiled = n_tri > kTileTris;
  smem = sizeof(float) * 9 * (size_t)(tiled ? kTileTris : n_tri);
  return true;
}

}  // namespace

// Plain C entry points: device pointers, counts, and the CUDA stream to
// launch on.  Each returns the launch's cudaError_t (0 on success); neither
// synchronises nor allocates.  n_tri >= 1.
extern "C" int gnx_closest_hit(const float* tri, int n_tri, const float* o,
                               const float* d, const float* t_max, float* t_out,
                               int* tri_out, float* b_out, uint8_t* hit_out,
                               long long n, void* stream) {
  if (n <= 0) return 0;
  unsigned blocks;
  size_t smem;
  bool tiled;
  if (!launch_shape(n_tri, n, blocks, smem, tiled))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (tiled)
    closest_hit_kernel<true><<<blocks, kThreads, smem, s>>>(
        tri, n_tri, o, d, t_max, t_out, tri_out, b_out, hit_out, n);
  else
    closest_hit_kernel<false><<<blocks, kThreads, smem, s>>>(
        tri, n_tri, o, d, t_max, t_out, tri_out, b_out, hit_out, n);
  return (int)cudaGetLastError();
}

extern "C" int gnx_brute_any_hit(const float* tri, int n_tri, const float* o,
                                 const float* d, const float* t_max,
                                 uint8_t* occ_out, long long n, void* stream) {
  if (n <= 0) return 0;
  unsigned blocks;
  size_t smem;
  bool tiled;
  if (!launch_shape(n_tri, n, blocks, smem, tiled))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (tiled)
    brute_any_hit_kernel<true><<<blocks, kThreads, smem, s>>>(
        tri, n_tri, o, d, t_max, occ_out, n);
  else
    brute_any_hit_kernel<false><<<blocks, kThreads, smem, s>>>(
        tri, n_tri, o, d, t_max, occ_out, n);
  return (int)cudaGetLastError();
}

// Brute-force watertight closest hit of N rays against T triangles.
//
// Replaces the TPU kernel ops/pallas_intersect.py::_kernel of the JAX
// package (reached through pallas_closest_hit).  Same function: running best
// t seeded by t_max, zero-snapped edge functions, conservative delta_t,
// first triangle wins a tie (strict t < best_t); on a miss t = FLT_MAX,
// tri = 0, b = 0.  A lane with t_max <= 0 can never hit and stays a miss.
//
// What bounds it on an H100: it must move N*(28 in + 21 out) bytes plus the
// 36*T-byte table, and does about 150 float32 operations per ray-triangle
// pair.  At the Cornell shape (N = 1M, T = 12) that is 49 MB (15 us at
// 3.35 TB/s) against 1.9 GFLOP (27 us at 67 TFLOP/s): operations bound it,
// and ever more so as T grows.  The design therefore keeps the arithmetic
// in registers and the memory traffic at its minimum: one ray per thread,
// ray, permutation masks, shear and the running best hit in registers; the
// (T,9) table staged through shared memory in tiles that every thread of
// the block reads at the same address (a broadcast, no bank conflict); each
// ray read once and each hit record written once; the ragged last block is
// masked, nothing is padded on the host.  Lanes that cannot hit skip the
// triangle loop.
//
// The ray-triangle test and its exactness rules are in watertight.cuh, which
// csrc/wide_bvh.cu shares.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

#include "watertight.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileTris = 1024;  // 36 KB of shared memory per tile

__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ tri, int n_tri,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_max,
                   float* __restrict__ t_out, int* __restrict__ tri_out,
                   float* __restrict__ b_out, uint8_t* __restrict__ hit_out,
                   long long n) {
  __shared__ float s_tri[kTileTris * 9];

  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = i < n;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float best_t = 0.f;
  if (in_range) {
    ox = o[3 * i + 0]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i + 0]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    best_t = t_max[i];
  }
  // t must satisfy 0 < t <= best_t, so a lane with best_t <= 0 never hits
  const bool active = in_range && (best_t > 0.0f);

  const gnx::RayFrame frame = gnx::make_ray_frame(ox, oy, oz, dx, dy, dz);

  int best_tri = 0;
  float b0 = 0.f, b1 = 0.f, b2 = 0.f;
  bool hit = false;

  for (int tile = 0; tile < n_tri; tile += kTileTris) {
    const int count = min(kTileTris, n_tri - tile);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < count * 9; k += kThreads)
      s_tri[k] = tri[(long long)tile * 9 + k];
    __syncthreads();
    if (!active) continue;

    for (int j = 0; j < count; ++j) {
      float t, c0, c1, c2;
      const bool valid = gnx::watertight_hit(frame, s_tri + 9 * j, best_t, t,
                                             c0, c1, c2);
      if (valid && (t < best_t)) {
        best_t = t;
        best_tri = tile + j;
        b0 = c0;
        b1 = c1;
        b2 = c2;
        hit = true;
      }
    }
  }

  if (in_range) {
    t_out[i] = hit ? best_t : FLT_MAX;
    tri_out[i] = best_tri;
    b_out[3 * i + 0] = b0;
    b_out[3 * i + 1] = b1;
    b_out[3 * i + 2] = b2;
    hit_out[i] = hit ? 1 : 0;
  }
}

}  // namespace

// Plain C entry point: device pointers, counts, and the CUDA stream to
// launch on.  Returns the launch's cudaError_t (0 on success); it neither
// synchronises nor allocates.
extern "C" int gnx_closest_hit(const float* tri, int n_tri, const float* o,
                               const float* d, const float* t_max, float* t_out,
                               int* tri_out, float* b_out, uint8_t* hit_out,
                               long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  closest_hit_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tri, n_tri, o, d, t_max, t_out, tri_out, b_out, hit_out, n);
  return (int)cudaGetLastError();
}

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
// Exactness: a shared edge must give e == 0 for both triangles, which needs
// the two products of the edge function rounded separately.  The edge
// function uses __fmul_rn/__fsub_rn, which are never contracted, and the
// file is built with --fmad=false and without fast-math so that every other
// expression also rounds as the plain PyTorch version does (IEEE division).

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileTris = 1024;  // 36 KB of shared memory per tile

constexpr double kEps = 5.9604644775390625e-08;  // float32 epsilon / 2
constexpr float kGamma2 = (float)((2 * kEps) / (1.0 - 2 * kEps));
constexpr float kGamma3 = (float)((3 * kEps) / (1.0 - 3 * kEps));
constexpr float kGamma5 = (float)((5 * kEps) / (1.0 - 5 * kEps));
constexpr float kEdgeEps = (float)(4.0 * 1.1920929e-07);

__device__ __forceinline__ float edge_fn(float ax, float ay, float bx, float by) {
  const float p = __fmul_rn(ax, by);
  const float q = __fmul_rn(ay, bx);
  const float e = __fsub_rn(p, q);
  const bool tiny = fabsf(e) <= __fmul_rn(kEdgeEps, __fadd_rn(fabsf(p), fabsf(q)));
  return tiny ? 0.0f : e;
}

__device__ __forceinline__ float max3abs(float a, float b, float c) {
  return fmaxf(fmaxf(fabsf(a), fabsf(b)), fabsf(c));
}

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

  // permutation masks (kz = first largest |d| component) and shear
  const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  const bool m0 = (adx >= ady) && (adx >= adz);
  const bool m1 = (!m0) && (ady >= adz);
  const float dzp = m0 ? dx : (m1 ? dy : dz);
  const float dxp = m0 ? dy : (m1 ? dz : dx);
  const float dyp = m0 ? dz : (m1 ? dx : dy);
  const float sx = -dxp / dzp;
  const float sy = -dyp / dzp;
  const float sz = 1.0f / dzp;

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
      const float* q = s_tri + 9 * j;
      float x[3], y[3], z[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const float px = q[3 * v + 0] - ox;
        const float py = q[3 * v + 1] - oy;
        const float pz = q[3 * v + 2] - oz;
        const float xp = m0 ? py : (m1 ? pz : px);
        const float yp = m0 ? pz : (m1 ? px : py);
        const float zp = m0 ? px : (m1 ? py : pz);
        x[v] = xp + sx * zp;
        y[v] = yp + sy * zp;
        z[v] = zp;
      }
      const float e0 = edge_fn(x[1], y[1], x[2], y[2]);
      const float e1 = edge_fn(x[2], y[2], x[0], y[0]);
      const float e2 = edge_fn(x[0], y[0], x[1], y[1]);
      const bool neg = (e0 < 0.f) || (e1 < 0.f) || (e2 < 0.f);
      const bool pos = (e0 > 0.f) || (e1 > 0.f) || (e2 > 0.f);
      const float det = (e0 + e1) + e2;
      bool valid = !(neg && pos) && (det != 0.f);
      const float z0 = sz * z[0];
      const float z1 = sz * z[1];
      const float z2 = sz * z[2];
      const float t_scaled = (e0 * z0 + e1 * z1) + e2 * z2;
      const float lim = best_t * det;
      const bool bad = (det < 0.f)
          ? ((t_scaled >= 0.f) || (t_scaled < lim))
          : ((t_scaled <= 0.f) || (t_scaled > lim));
      valid = valid && !bad;
      const float inv_det = (det != 0.f) ? (1.0f / det) : 0.0f;
      const float t = t_scaled * inv_det;
      // conservative delta_t bound
      const float max_zt = max3abs(z0, z1, z2);
      const float max_xt = max3abs(x[0], x[1], x[2]);
      const float max_yt = max3abs(y[0], y[1], y[2]);
      const float delta_x = kGamma5 * (max_xt + max_zt);
      const float delta_y = kGamma5 * (max_yt + max_zt);
      const float delta_e = 2.0f * ((kGamma2 * max_xt * max_yt + delta_y * max_xt)
                                    + delta_x * max_yt);
      const float max_e = max3abs(e0, e1, e2);
      const float delta_t = 3.0f * ((kGamma3 * max_e * max_zt + delta_e * max_zt)
                                    + kGamma3 * max_zt * max_e) * fabsf(inv_det);
      valid = valid && (t > delta_t);

      if (valid && (t < best_t)) {
        best_t = t;
        best_tri = tile + j;
        b0 = e0 * inv_det;
        b1 = e1 * inv_det;
        b2 = e2 * inv_det;
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

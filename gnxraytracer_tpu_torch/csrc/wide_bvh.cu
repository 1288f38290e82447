// Closest hit and any hit of N rays against a width-8 BVH.
//
// Replaces the TPU kernel ops/pallas_wbvh.py::_make_wide_kernel of the JAX
// package in its two modes (reached through _call_wide from wide_closest_hit
// and wide_any_hit).  Same function: uint8 child boxes dequantized against
// one frame as lo + byte * scale, the slab test of _slab6 (safe inverse
// direction, far side widened by 1 + 2 * 7.2e-7, live-lane term t_best > 0),
// children visited near first in the slot order of the ray's direction
// octant, leaf rows of four packed triangles through the watertight test of
// watertight.cuh, strict t < t_best updates seeded by t_max (closest) or the
// first hit with t < t_max (any hit).  tid = -1 pads a short leaf and is
// inert; a lane with t_max <= 0 returns at once.
//
// What is not carried over is the TPU kernel's shape: a 2048-ray packet
// behind one shared cursor with scalar stacks, want-bit syncs, multi-pops
// and a leaf queue exists because a TPU has no per-lane control flow.  Here
// every ray walks alone: one ray per thread, a per-thread stack of node ids
// and leaf codes in local memory, children pushed far to near so that the
// nearest pops first and tightens t_best before the far ones are looked at.
// The visiting order is therefore per ray (its own octant), and the plain
// PyTorch version (kernels/wide_bvh.py) visits in the same order, so that
// ties in t resolve to the same triangle in both.
//
// What bounds it on an H100: it must move N * (28 in + 21 out) bytes, and
// does about 8 slab tests per visited node and 4 triangle tests per visited
// leaf row.  With tens of nodes a ray the operations bound it, but what a
// walk really waits for is the dependent chain of node fetches (one 128-byte
// record per step, then the next address), which neither bound counts.  The
// design keeps that chain short: a whole node is one cache line read with
// 16-byte loads, wide nodes cut the depth of the chain, and the records and
// leaf rows of a 100k-triangle mesh (a few MB) stay in the 50 MB L2.  The
// wrapper may sort the rays for coherence first; warp-wide node tests and
// persistent threads are left for later.
//
// Exactness: see watertight.cuh; built with --fmad=false, no fast-math.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>
#include <cstdio>

#include "watertight.cuh"

namespace {

constexpr int kThreads = 128;
// Entries of the per-thread stack.  A walk pops one entry and pushes at most
// 8, so a tree of depth D needs 7 * D + 1; the wrapper refuses a tree that
// needs more than this (gnx_wide_stack_cap), and the kernel traps rather
// than drop a subtree.
constexpr int kStackCap = 128;
constexpr int kRecInt4 = 8;      // one node record: 32 int32 words
constexpr int kTargetWord0 = 12;
constexpr int kOrderWord0 = 20;
constexpr int kLeafFloat4 = 9;   // one leaf row: 4 triangles x 9 floats
constexpr float kSlabWiden = (float)(1.0 + 2.0 * 7.2e-7);

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = (v < 0.f) ? -1e-20f : 1e-20f;
  return 1.0f / ((fabsf(v) < 1e-20f) ? tiny : v);
}

__device__ __forceinline__ float dequant(unsigned word, int byte, float lo,
                                         float scale) {
  return lo + (float)((word >> (8 * byte)) & 255u) * scale;
}

__device__ __forceinline__ int select8(const int (&a)[8], int i) {
  int r = a[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) r = (i == k) ? a[k] : r;
  return r;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
wide_bvh_kernel(const int4* __restrict__ rec, const float* __restrict__ frame,
                const float4* __restrict__ leafs, const int4* __restrict__ tid,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t_max,
                float* __restrict__ t_out, int* __restrict__ tri_out,
                float* __restrict__ b_out, uint8_t* __restrict__ flag_out,
                long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;

  const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float t_best = t_max[i];  // any-hit mode: stays t_max

  int best_tri = -1;
  float u = 0.f, v = 0.f;
  bool found = false;

  if (t_best > 0.0f) {
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    const int oct = (dx < 0.f ? 1 : 0) | (dy < 0.f ? 2 : 0) | (dz < 0.f ? 4 : 0);
    const gnx::RayFrame rf = gnx::make_ray_frame(ox, oy, oz, dx, dy, dz);
    const float fx = frame[0], fy = frame[1], fz = frame[2];
    const float sx = frame[3], sy = frame[4], sz = frame[5];
    const int* rec_words = reinterpret_cast<const int*>(rec);

    int stack[kStackCap];
    int sp = 0;
    stack[sp++] = 0;  // the root

    while (sp > 0) {
      const int e = stack[--sp];
      if (e < 0) {
        // ---- a leaf row: LEAF_SIZE triangles, in row order ----------------
        const long long row = -(long long)e - 1;
        float q[36];
#pragma unroll
        for (int k = 0; k < kLeafFloat4; ++k) {
          const float4 f4 = leafs[row * kLeafFloat4 + k];
          q[4 * k + 0] = f4.x; q[4 * k + 1] = f4.y;
          q[4 * k + 2] = f4.z; q[4 * k + 3] = f4.w;
        }
        const int4 id4 = tid[row];
        const int ids[4] = {id4.x, id4.y, id4.z, id4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (ids[k] < 0) continue;
          float t, b0, b1, b2;
          const bool valid = gnx::watertight_hit(rf, q + 9 * k, t_best, t,
                                                 b0, b1, b2);
          if (valid && (t < t_best)) {
            found = true;
            if (kAnyHit) {
              sp = 0;  // the first hit before t_max ends the walk
              break;
            }
            t_best = t;
            best_tri = ids[k];
            u = b1;
            v = b2;
          }
        }
      } else {
        // ---- a wide node: 8 quantized child boxes --------------------------
        const int4* r = rec + (long long)e * kRecInt4;
        const int4 w0 = r[0], w1 = r[1], w2 = r[2];
        const int4 g0 = r[kTargetWord0 / 4], g1 = r[kTargetWord0 / 4 + 1];
        const unsigned bw[12] = {
            (unsigned)w0.x, (unsigned)w0.y, (unsigned)w0.z, (unsigned)w0.w,
            (unsigned)w1.x, (unsigned)w1.y, (unsigned)w1.z, (unsigned)w1.w,
            (unsigned)w2.x, (unsigned)w2.y, (unsigned)w2.z, (unsigned)w2.w};
        const int tg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const unsigned order =
            (unsigned)rec_words[(long long)e * (4 * kRecInt4) + kOrderWord0 + oct];

        unsigned want = 0;
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const int wi = s >> 2, by = s & 3;
          const float lox = dequant(bw[0 + wi], by, fx, sx);
          const float loy = dequant(bw[2 + wi], by, fy, sy);
          const float loz = dequant(bw[4 + wi], by, fz, sz);
          const float hix = dequant(bw[6 + wi], by, fx, sx);
          const float hiy = dequant(bw[8 + wi], by, fy, sy);
          const float hiz = dequant(bw[10 + wi], by, fz, sz);
          const float tx0 = (lox - ox) * ix, tx1 = (hix - ox) * ix;
          const float ty0 = (loy - oy) * iy, ty1 = (hiy - oy) * iy;
          const float tz0 = (loz - oz) * iz, tz1 = (hiz - oz) * iz;
          const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                 fminf(tz0, tz1));
          const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                 fmaxf(tz0, tz1)) * kSlabWiden;
          const bool hit_box = (tn <= tf) && (tf > 0.f) && (tn < t_best)
                               && (t_best > 0.f);
          if (hit_box && tg[s] != 0) want |= 1u << s;
        }
        // far to near, so the nearest child pops first
#pragma unroll
        for (int j = 7; j >= 0; --j) {
          const int sl = (order >> (3 * j)) & 7;
          if ((want >> sl) & 1u) {
            if (sp >= kStackCap) {
              printf("wide_bvh_kernel: traversal stack overflow (ray %lld)\n", i);
              __trap();
            }
            stack[sp++] = select8(tg, sl);
          }
        }
      }
    }
  }

  if (kAnyHit) {
    flag_out[i] = found ? 1 : 0;
  } else {
    t_out[i] = found ? t_best : FLT_MAX;
    tri_out[i] = found ? best_tri : 0;
    b_out[3 * i + 0] = (1.0f - u) - v;
    b_out[3 * i + 1] = u;
    b_out[3 * i + 2] = v;
    flag_out[i] = found ? 1 : 0;
  }
}

template <bool kAnyHit>
int launch(const void* rec, const float* frame, const void* leafs,
           const void* tid, const float* o, const float* d, const float* t_max,
           float* t_out, int* tri_out, float* b_out, uint8_t* flag_out,
           long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  wide_bvh_kernel<kAnyHit><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int4*>(rec), frame, static_cast<const float4*>(leafs),
      static_cast<const int4*>(tid), o, d, t_max, t_out, tri_out, b_out,
      flag_out, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points: device pointers, the ray count, and the CUDA stream
// to launch on.  Each returns its launch's cudaError_t (0 on success); none
// synchronises or allocates.  rec: (NW, 32) int32, frame: (8,) float,
// leafs: (rows, 36) float, tid: (rows, 4) int32, all 16-byte aligned.

extern "C" int gnx_wide_stack_cap() { return kStackCap; }

extern "C" int gnx_wide_closest_hit(const void* rec, const float* frame,
                                    const void* leafs, const void* tid,
                                    const float* o, const float* d,
                                    const float* t_max, float* t_out,
                                    int* tri_out, float* b_out,
                                    uint8_t* hit_out, long long n,
                                    void* stream) {
  return launch<false>(rec, frame, leafs, tid, o, d, t_max, t_out, tri_out,
                       b_out, hit_out, n, stream);
}

extern "C" int gnx_wide_any_hit(const void* rec, const float* frame,
                                const void* leafs, const void* tid,
                                const float* o, const float* d,
                                const float* t_max, uint8_t* occ_out,
                                long long n, void* stream) {
  return launch<true>(rec, frame, leafs, tid, o, d, t_max, nullptr, nullptr,
                      nullptr, occ_out, n, stream);
}

// Closest hit and any hit of N rays against a binary threaded (miss-link)
// BVH.
//
// Replaces the TPU kernels ops/pallas_bvh.py::_make_kernel (closest hit) and
// ::_make_any_kernel (occlusion) of the JAX package, reached there through
// packet_closest_hit / packet_any_hit and, per treelet, treelet_closest_hit /
// treelet_any_hit.  Same function: from node `cur`, the slab test of
// _slab_want (safe inverse direction, far side widened by 1 + 2 * 7.2e-7,
// live-lane term t_best > 0); a wanted inner node sends the cursor to its
// first child in the near-first order of the direction octant, a wanted leaf
// tests its packed row of four triangles through the watertight test of
// watertight.cuh with strict t < t_best (closest, seeded by t_max) or stops
// at the first hit with t < t_max (any hit), and then, like a node that is
// not wanted, follows the octant's miss link; -1 ends the walk.  tid = -1
// pads a short leaf and is inert; a lane with t_max <= 0 returns at once.
//
// What is not carried over is the TPU kernel's shape.  There 1024 rays walk
// behind ONE scalar cursor, a node is visited if any of them wants it, the
// block takes the octant of its first ray, and a tree that does not fit the
// fast memory is cut into treelets that are walked one after the other.
// Here every ray walks alone with its own cursor and its own octant, over one
// table for the whole tree.  The walk needs no stack, so a thread's state is
// the cursor, the best hit and the ray: few registers, no local memory, many
// resident warps to hide the latency of the dependent loads.
//
// What bounds it on an H100: it must move N * (28 in + 21 out) bytes and the
// tables once, for about 25 operations a visited node and 4 x 150 a tested
// leaf row.  What it loads on the way, 40 bytes a node (a 32-byte box row and
// an 8-byte link pair) and 160 bytes a leaf row (144 + 16), comes from the L2
// cache and is no part of that bound.  Against the width-8 walk
// (csrc/wide_bvh.cu) it visits several times more nodes, each a dependent
// fetch, but a fetch is a third of the size, nothing is pushed or popped, and
// a binary node whose box is missed costs one test, not eight.  The tables of
// a 100k-triangle mesh (about 11.5 MB) stay in the 50 MB L2.  The visiting
// order is per ray (its own octant), and the plain PyTorch version
// (kernels/packet_bvh.py) visits in the same order, so that ties in t resolve
// to the same triangle in both.
//
// Termination: a threaded walk visits a node at most once, so n_nodes steps
// bound it; a table whose links do not thread a tree traps instead of
// spinning or returning a partial walk.
//
// Exactness: see watertight.cuh; built with --fmad=false, no fast-math.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>
#include <cstdio>

#include "watertight.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLeafFloat4 = 9;   // one leaf row: 4 triangles x 9 floats
constexpr float kSlabWiden = (float)(1.0 + 2.0 * 7.2e-7);

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = (v < 0.f) ? -1e-20f : 1e-20f;
  return 1.0f / ((fabsf(v) < 1e-20f) ? tiny : v);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
packet_bvh_kernel(const float4* __restrict__ nodes,
                  const int2* __restrict__ meta,
                  const float4* __restrict__ leafs,
                  const int4* __restrict__ tid,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max,
                  float* __restrict__ t_out, int* __restrict__ tri_out,
                  float* __restrict__ b_out, uint8_t* __restrict__ flag_out,
                  long long n, int n_nodes, int n_oct) {
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
    const int oct = (n_oct == 8)
        ? ((dx < 0.f ? 1 : 0) | (dy < 0.f ? 2 : 0) | (dz < 0.f ? 4 : 0)) : 0;
    const int2* links = meta + (long long)oct * n_nodes;
    const gnx::RayFrame rf = gnx::make_ray_frame(ox, oy, oz, dx, dy, dz);

    int cur = 0;  // the root
    int steps = 0;
    while (cur >= 0) {
      if (++steps > n_nodes) {
        printf("packet_bvh_kernel: more than %d steps in a tree of %d nodes "
               "(ray %lld)\n", n_nodes, n_nodes, i);
        __trap();
      }
      // lo.xyz hi.x | hi.yz pad pad, and this octant's (first, miss) pair
      const float4 r0 = nodes[2 * (long long)cur];
      const float4 r1 = nodes[2 * (long long)cur + 1];
      const int2 lk = links[cur];

      const float tx0 = (r0.x - ox) * ix, tx1 = (r0.w - ox) * ix;
      const float ty0 = (r0.y - oy) * iy, ty1 = (r1.x - oy) * iy;
      const float tz0 = (r0.z - oz) * iz, tz1 = (r1.y - oz) * iz;
      const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                             fminf(tz0, tz1));
      const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                             fmaxf(tz0, tz1)) * kSlabWiden;
      const bool want = (tn <= tf) && (tf > 0.f) && (tn < t_best)
                        && (t_best > 0.f);

      int nxt = lk.y;  // the miss link: also where a finished leaf goes on
      if (want) {
        if (lk.x >= 0) {
          nxt = lk.x;  // the nearer child
        } else {
          // ---- a leaf row: LEAF_SIZE triangles, in row order --------------
          const long long row = -(long long)lk.x - 1;
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
                nxt = -1;  // the first hit before t_max ends the walk
                break;
              }
              t_best = t;
              best_tri = ids[k];
              u = b1;
              v = b2;
            }
          }
        }
      }
      cur = nxt;
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
int launch(const void* nodes, const void* meta, const void* leafs,
           const void* tid, const float* o, const float* d, const float* t_max,
           float* t_out, int* tri_out, float* b_out, uint8_t* flag_out,
           long long n, int n_nodes, int n_oct, void* stream) {
  if (n <= 0) return 0;
  if (n_nodes < 1 || (n_oct != 1 && n_oct != 8))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  packet_bvh_kernel<kAnyHit><<<(unsigned)blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
      static_cast<const float4*>(nodes), static_cast<const int2*>(meta),
      static_cast<const float4*>(leafs), static_cast<const int4*>(tid), o, d,
      t_max, t_out, tri_out, b_out, flag_out, n, n_nodes, n_oct);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points: device pointers, the ray count, the tree's node count
// and number of link tables (8 per-octant orders, or 1), and the CUDA stream
// to launch on.  Each returns its launch's cudaError_t (0 on success); none
// synchronises or allocates.  nodes: (n_nodes, 8) float, meta: (n_oct,
// n_nodes, 2) int32, leafs: (rows, 36) float, tid: (rows, 4) int32, all
// 16-byte aligned.

extern "C" int gnx_packet_closest_hit(const void* nodes, const void* meta,
                                      const void* leafs, const void* tid,
                                      const float* o, const float* d,
                                      const float* t_max, float* t_out,
                                      int* tri_out, float* b_out,
                                      uint8_t* hit_out, long long n,
                                      int n_nodes, int n_oct, void* stream) {
  return launch<false>(nodes, meta, leafs, tid, o, d, t_max, t_out, tri_out,
                       b_out, hit_out, n, n_nodes, n_oct, stream);
}

extern "C" int gnx_packet_any_hit(const void* nodes, const void* meta,
                                  const void* leafs, const void* tid,
                                  const float* o, const float* d,
                                  const float* t_max, uint8_t* occ_out,
                                  long long n, int n_nodes, int n_oct,
                                  void* stream) {
  return launch<true>(nodes, meta, leafs, tid, o, d, t_max, nullptr, nullptr,
                      nullptr, occ_out, n, n_nodes, n_oct, stream);
}

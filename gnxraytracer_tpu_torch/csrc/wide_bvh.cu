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
// behind one shared cursor with scalar stacks, want-bit syncs and a leaf
// queue exists because a TPU has no per-lane control flow.  Here every ray
// walks alone, one ray per thread, in its own octant order; the plain
// PyTorch version (kernels/wide_bvh.py) visits in the same order, the frame
// test included, so that ties in t resolve to the same triangle in both and
// both count the same visits.
//
// What bounds it on an H100.  It must move N * (28 in + 21 out) bytes and
// the tree's tables once, and does 8 slab tests a visited node and 4
// triangle tests a leaf row: for 1M of the mesh path's rays 0.011-0.017 ms
// by bytes.  What it really waits for is the dependent chain of loads of
// each walk (ray, node record, next record) and the warp's longest walk: on
// the mesh path's bounce rays the first design read the rays and wrote a
// miss in 0.020 ms, added the root visit for 0.028, and spent the rest of its
// 0.34 ms on the few rays that walk below the root, their warps idle but for
// them (on rays that enter the tree a warp keeps about 16% of its lanes
// busy).  So the design is about latency, divergence and occupancy:
//   * Two passes.  Pass 1 (wide_triage_kernel), one thread a ray, reads the
//     ray, tests the frame's box (every child box lies inside it, and float
//     rounding is monotone) and writes the miss record of a ray that is dead
//     or misses it; the others go on a list, in a warp's order.  Pass 2
//     (wide_bvh_kernel) walks the listed rays, one thread each: its warps hold
//     only rays that enter the tree, neighbours in the list as in the image.
//     This is the coherence the host-side sort bought, at the cost of one
//     read of the rays, so the wrappers no longer sort.
//   * Node groups (Ylitie, Karras, Laine, HPG 2017).  A visited node leaves
//     ONE entry: its id and the mask of its wanted slots, in the ray's
//     octant order, not yet taken.  The next slot is the mask's lowest bit;
//     the rest stays as the current group, or goes on the stack when the
//     walk descends.  The visiting order is exactly that of pushing every
//     wanted child far to near, but the stack holds at most one entry a
//     level (the pack's stack_size, depth + 1) instead of 7, and it lives in
//     shared memory, one column per thread, where the first design kept 512
//     bytes a thread in local memory.
//   * Occupancy: __launch_bounds__(128, 5), 96 registers and 5 blocks (20
//     warps) an SM, no local memory but the trap's printf.
//   * Near and far planes picked by the ray's octant, not by min/max.
// Measured and left out (tools/bench_wide_bvh.py): persistent warps that
// take new rays as their lanes go idle (Aila and Laine, HPG 2009) walk rays
// that enter the tree at random 1.3x faster, but lose 5-20% on the mesh
// path's own rays, whose neighbours walk alike.  The node records and leaf
// rows of a 100k-triangle mesh (a few MB) stay in the 50 MB L2.
//
// Exactness: see watertight.cuh; built with --fmad=false, no fast-math.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>
#include <cstdio>

#include "watertight.cuh"

namespace {

constexpr int kThreads = 128;
// Blocks an SM holds: 5 keeps the walk in 96 registers with no spills (6,
// at 80 registers, spills a few bytes and is no faster).
constexpr int kMinBlocks = 5;
// Waves of blocks of the walk pass at most (a wave: as many blocks as the
// SMs hold at once).
constexpr int kWaves = 4;
constexpr unsigned kFull = 0xffffffffu;
// Entries of the per-thread stack at most: a stack of 96 entries of 4 bytes
// for each of 128 threads is the 48 KB of shared memory a block may take
// without opting in.  A launch takes the pack's own stack_size; the wrapper
// refuses a tree that needs more than this, and the kernel traps rather than
// drop a subtree.
constexpr int kMaxStack = 96;
constexpr int kRecWords = 32;    // one node record: 32 int32 words
constexpr int kRecInt4 = 8;
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

// The slab test of one box against the ray (origin o, safe inverse
// direction i), as _slab6 does it.
__device__ __forceinline__ bool slab_hit(float lox, float loy, float loz,
                                         float hix, float hiy, float hiz,
                                         float ox, float oy, float oz,
                                         float ix, float iy, float iz,
                                         float t_best) {
  const float tx0 = (lox - ox) * ix, tx1 = (hix - ox) * ix;
  const float ty0 = (loy - oy) * iy, ty1 = (hiy - oy) * iy;
  const float tz0 = (loz - oz) * iz, tz1 = (hiz - oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                         fminf(tz0, tz1));
  const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                         fmaxf(tz0, tz1)) * kSlabWiden;
  return (tn <= tf) && (tf > 0.f) && (tn < t_best) && (t_best > 0.f);
}

// The tables and rays of one launch.
struct Args {
  const int4* __restrict__ rec;
  const float4* __restrict__ leafs;
  const int4* __restrict__ tid;
  const float* __restrict__ o;
  const float* __restrict__ d;
  const float* __restrict__ t_max;
  float* __restrict__ t_out;
  int* __restrict__ tri_out;
  float* __restrict__ b_out;
  uint8_t* __restrict__ flag_out;
};

// One ray's walk: the ray, its best hit, its current node group (a node,
// the wanted slots not yet taken as a mask over positions of the octant
// order, that order word) and the depth of its stack of groups.
struct Walk {
  gnx::RayFrame rf;  // origin and watertight frame
  float ix, iy, iz;  // safe inverse direction
  int oct;
  float t_best, u, v;
  int best_tri;
  bool found;
  int node;
  unsigned mask, order;
  int sp;
  bool at_root;  // the root is the next entry
};

// Visits wide node `node`: the slab test of its 8 child boxes.  Returns the
// wanted, non-empty children as a mask over positions of the ray's octant
// order (bit j: the j-th nearest slot); `order` gets that order word.
__device__ __forceinline__ unsigned visit(const int4* __restrict__ rec,
                                          int node, const Walk& w,
                                          const float* fr, unsigned& order) {
  const int4* p = rec + (long long)node * kRecInt4;
  const int4 w0 = __ldg(p), w1 = __ldg(p + 1), w2 = __ldg(p + 2);
  const int4 g0 = __ldg(p + kTargetWord0 / 4);
  const int4 g1 = __ldg(p + kTargetWord0 / 4 + 1);
  order = (unsigned)__ldg(reinterpret_cast<const int*>(p) + kOrderWord0 + w.oct);
  const unsigned bw[12] = {
      (unsigned)w0.x, (unsigned)w0.y, (unsigned)w0.z, (unsigned)w0.w,
      (unsigned)w1.x, (unsigned)w1.y, (unsigned)w1.z, (unsigned)w1.w,
      (unsigned)w2.x, (unsigned)w2.y, (unsigned)w2.z, (unsigned)w2.w};
  const int tg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  unsigned want = 0;
  // The near and far planes by the ray's octant: with lo <= hi (bytes and
  // dequantization are monotone) (lo - o) * i is the smaller of the two t
  // exactly when i >= 0, so this is the min/max of _slab6 without them.
  unsigned nw[6], fw[6];  // near and far words: x, y, z for slots 0-3, 4-7
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int wi = 0; wi < 2; ++wi) {
      const bool neg = (w.oct >> k) & 1;
      nw[2 * k + wi] = neg ? bw[6 + 2 * k + wi] : bw[2 * k + wi];
      fw[2 * k + wi] = neg ? bw[2 * k + wi] : bw[6 + 2 * k + wi];
    }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int wi = s >> 2, by = s & 3;
    const float tnx = (dequant(nw[0 + wi], by, fr[0], fr[3]) - w.rf.ox) * w.ix;
    const float tfx = (dequant(fw[0 + wi], by, fr[0], fr[3]) - w.rf.ox) * w.ix;
    const float tny = (dequant(nw[2 + wi], by, fr[1], fr[4]) - w.rf.oy) * w.iy;
    const float tfy = (dequant(fw[2 + wi], by, fr[1], fr[4]) - w.rf.oy) * w.iy;
    const float tnz = (dequant(nw[4 + wi], by, fr[2], fr[5]) - w.rf.oz) * w.iz;
    const float tfz = (dequant(fw[4 + wi], by, fr[2], fr[5]) - w.rf.oz) * w.iz;
    const float tn = fmaxf(fmaxf(tnx, tny), tnz);
    const float tf = fminf(fminf(tfx, tfy), tfz) * kSlabWiden;
    const bool hit = (tn <= tf) && (tf > 0.f) && (tn < w.t_best)
                     && (w.t_best > 0.f);
    if (hit && tg[s] != 0) want |= 1u << s;
  }
  // slot mask -> position mask: a wanted slot stands at exactly one position
  unsigned pos = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) pos |= ((want >> ((order >> (3 * j)) & 7u)) & 1u) << j;
  return pos;
}

// Starts ray i: returns false if it is dead or misses the frame's box
// (every child box lies inside it), i.e. it is done; else its first step
// visits the root.
__device__ __forceinline__ bool start_ray(int i, const Args& a,
                                          const float* fr, Walk& w) {
  w.t_best = a.t_max[i];  // any-hit mode: stays t_max
  w.best_tri = -1;
  w.u = w.v = 0.f;
  w.found = false;
  w.mask = 0;
  w.sp = 0;
  w.at_root = true;
  if (!(w.t_best > 0.f)) return false;  // a dead lane: its ray is not read
  const long long i3 = 3ll * i;
  const float dx = a.d[i3 + 0], dy = a.d[i3 + 1], dz = a.d[i3 + 2];
  const float ox = a.o[i3 + 0], oy = a.o[i3 + 1], oz = a.o[i3 + 2];
  w.ix = safe_inv(dx);
  w.iy = safe_inv(dy);
  w.iz = safe_inv(dz);
  // the frame's box: bytes 0 and 255 on every axis
  if (!slab_hit(fr[0], fr[1], fr[2], fr[0] + 255.f * fr[3],
                fr[1] + 255.f * fr[4], fr[2] + 255.f * fr[5], ox, oy, oz,
                w.ix, w.iy, w.iz, w.t_best))
    return false;
  w.oct = (dx < 0.f ? 1 : 0) | (dy < 0.f ? 2 : 0) | (dz < 0.f ? 4 : 0);
  w.rf = gnx::make_ray_frame(ox, oy, oz, dx, dy, dz);
  return true;
}

// One entry of the walk: the next slot of the current group (or of the
// group on top of the stack), a wide node or a leaf row.  Returns whether
// anything is left to walk.
template <bool kAnyHit>
__device__ __forceinline__ bool step(int i, const Args& a,
                                     const float* fr, int* stack, int cap,
                                     Walk& w) {
  const int* rec_words = reinterpret_cast<const int*>(a.rec);
  int target = 0;  // the root
  if (w.at_root) {
    w.at_root = false;
  } else {
    if (w.mask == 0) {
      const int e = stack[(--w.sp) * kThreads];
      w.node = e >> 8;
      w.mask = (unsigned)e & 255u;
      w.order = (unsigned)__ldg(rec_words + (long long)w.node * kRecWords
                                + kOrderWord0 + w.oct);
    }
    const int j = __ffs(w.mask) - 1;
    w.mask &= w.mask - 1;
    const int slot = (w.order >> (3 * j)) & 7;
    target = __ldg(rec_words + (long long)w.node * kRecWords + kTargetWord0
                   + slot);
  }
  if (target >= 0) {
    // ---- a wide node: its wanted children become the current group ------
    unsigned child_order;
    const unsigned m = visit(a.rec, target, w, fr, child_order);
    if (m != 0) {
      if (w.mask != 0) {
        if (w.sp >= cap) {
          printf("wide_bvh_kernel: traversal stack overflow (ray %d)\n", i);
          __trap();
        }
        stack[(w.sp++) * kThreads] = (w.node << 8) | (int)w.mask;
      }
      w.node = target;
      w.mask = m;
      w.order = child_order;
    }
  } else {
    // ---- a leaf row: LEAF_SIZE triangles, in row order --------------------
    const long long row = -(long long)target - 1;
    float q[36];
#pragma unroll
    for (int k = 0; k < kLeafFloat4; ++k) {
      const float4 f4 = __ldg(a.leafs + row * kLeafFloat4 + k);
      q[4 * k + 0] = f4.x; q[4 * k + 1] = f4.y;
      q[4 * k + 2] = f4.z; q[4 * k + 3] = f4.w;
    }
    const int4 id4 = __ldg(a.tid + row);
    const int ids[4] = {id4.x, id4.y, id4.z, id4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (ids[k] < 0) continue;
      float t, b0, b1, b2;
      const bool valid = gnx::watertight_hit(w.rf, q + 9 * k, w.t_best, t,
                                             b0, b1, b2);
      if (valid && (t < w.t_best)) {
        w.found = true;
        if (kAnyHit) return false;  // the first hit before t_max ends it
        w.t_best = t;
        w.best_tri = ids[k];
        w.u = b1;
        w.v = b2;
      }
    }
  }
  return w.mask != 0 || w.sp != 0;
}

template <bool kAnyHit>
__device__ __forceinline__ void finish(int i, const Args& a,
                                       const Walk& w) {
  if (kAnyHit) {
    a.flag_out[i] = w.found ? 1 : 0;
  } else {
    a.t_out[i] = w.found ? w.t_best : FLT_MAX;
    a.tri_out[i] = w.found ? w.best_tri : 0;
    const long long i3 = 3ll * i;
    a.b_out[i3 + 0] = (1.0f - w.u) - w.v;
    a.b_out[i3 + 1] = w.u;
    a.b_out[i3 + 2] = w.v;
    a.flag_out[i] = w.found ? 1 : 0;
  }
}

// Pass 1 of a cast: one thread a ray.  A ray that is dead or misses the
// frame's box gets its miss record here; the others are listed for pass 2
// (in no particular order: each ray's result is its own).
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
wide_triage_kernel(Args a, const float* __restrict__ frame, long long n,
                   int* __restrict__ list,
                   unsigned long long* __restrict__ listed) {
  __shared__ float fr[8];
  if (threadIdx.x < 8) fr[threadIdx.x] = frame[threadIdx.x];
  __syncthreads();
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int i = (int)k;  // n <= 2^30
  Walk w;
  const bool walks = (k < n) && start_ray(i, a, fr, w);
  if (k < n && !walks) finish<kAnyHit>(i, a, w);
  const unsigned m = __ballot_sync(kFull, walks);
  if (m == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  unsigned long long base = 0;
  if (lane == leader) base = atomicAdd(listed, (unsigned long long)__popc(m));
  base = __shfl_sync(kFull, base, leader);
  if (walks) list[base + __popc(m & ((1u << lane) - 1u))] = (int)i;
}

// Pass 2: the walks of the rays pass 1 listed.
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
wide_bvh_kernel(Args a, const float* __restrict__ frame, int cap,
                const unsigned long long* __restrict__ listed,
                const int* __restrict__ list) {
  extern __shared__ int stack_smem[];
  __shared__ float fr[8];
  const long long n = (long long)*listed;
  if ((long long)blockIdx.x * kThreads >= n) return;  // a block with none
  if (threadIdx.x < 8) fr[threadIdx.x] = frame[threadIdx.x];
  __syncthreads();
  int* stack = stack_smem + threadIdx.x;  // entry k at stack[k * kThreads]
  Walk w;
  // one thread a ray; a grid of a few waves strides over a long list
  const int stride = gridDim.x * kThreads;
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < n; k += stride) {
    const int i = list[k];
    if (start_ray(i, a, fr, w))
      while (step<kAnyHit>(i, a, fr, stack, cap, w)) {}
    finish<kAnyHit>(i, a, w);
  }
}

// Blocks of pass 2: one thread a ray, but at most kWaves waves (a wave is
// as many blocks as the SMs hold at once): the host does not know how many
// rays pass 1 lists, and a block with none still costs its launch.
template <bool kAnyHit>
int walk_blocks(long long n, int cap, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wide_bvh_kernel<kAnyHit>, kThreads,
        (size_t)cap * kThreads * sizeof(int));
  if (err != cudaSuccess) return (int)err;
  *blocks = (n + kThreads - 1) / kThreads;
  const long long most = (long long)sms * per_sm * kWaves;
  if (most < *blocks) *blocks = most;
  if (*blocks < 1) *blocks = 1;
  return 0;
}

template <bool kAnyHit>
int launch(const Args& a, const float* frame, long long n, int cap,
           unsigned long long* listed, int* list, void* stream) {
  if (n <= 0) return 0;
  if (cap < 1 || cap > kMaxStack || n > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long ray_blocks = (n + kThreads - 1) / kThreads;
  wide_triage_kernel<kAnyHit><<<(unsigned)ray_blocks, kThreads, 0, st>>>(
      a, frame, n, list, listed);
  const cudaError_t err1 = cudaGetLastError();
  if (err1 != cudaSuccess) return (int)err1;
  long long blocks = 0;
  const int err = walk_blocks<kAnyHit>(n, cap, &blocks);
  if (err != 0) return err;
  wide_bvh_kernel<kAnyHit><<<(unsigned)blocks, kThreads,
                             (size_t)cap * kThreads * sizeof(int), st>>>(
      a, frame, cap, listed, list);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points: device pointers, the ray count (at most 2^30), the
// pack's stack size (entries a ray's stack may need, 1..gnx_wide_stack_cap()),
// a zeroed uint64 counter, an int32 scratch list of n entries, and the
// CUDA stream to launch on.  Each returns its launch's cudaError_t (0 on
// success); none synchronises or allocates.  rec: (NW, 32) int32, frame:
// (8,) float, leafs: (rows, 36) float, tid: (rows, 4) int32, all 16-byte
// aligned.

extern "C" int gnx_wide_stack_cap() { return kMaxStack; }

// The blocks the walk pass of a launch of n rays takes at most (a report for
// measurements).
extern "C" long long gnx_wide_blocks(int any_hit, long long n, int cap) {
  long long blocks = 0;
  const int err = any_hit ? walk_blocks<true>(n, cap, &blocks)
                          : walk_blocks<false>(n, cap, &blocks);
  return err != 0 ? -err : blocks;
}

extern "C" int gnx_wide_closest_hit(const void* rec, const float* frame,
                                    const void* leafs, const void* tid,
                                    const float* o, const float* d,
                                    const float* t_max, float* t_out,
                                    int* tri_out, float* b_out,
                                    uint8_t* hit_out, long long n, int cap,
                                    unsigned long long* listed, int* list,
                                    void* stream) {
  const Args a{static_cast<const int4*>(rec), static_cast<const float4*>(leafs),
               static_cast<const int4*>(tid), o, d, t_max, t_out, tri_out,
               b_out, hit_out};
  return launch<false>(a, frame, n, cap, listed, list, stream);
}

extern "C" int gnx_wide_any_hit(const void* rec, const float* frame,
                                const void* leafs, const void* tid,
                                const float* o, const float* d,
                                const float* t_max, uint8_t* occ_out,
                                long long n, int cap,
                                unsigned long long* listed, int* list,
                                void* stream) {
  const Args a{static_cast<const int4*>(rec), static_cast<const float4*>(leafs),
               static_cast<const int4*>(tid), o, d, t_max, nullptr, nullptr,
               nullptr, occ_out};
  return launch<true>(a, frame, n, cap, listed, list, stream);
}

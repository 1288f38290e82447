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
// table for the whole tree, and needs no stack.  The plain PyTorch version
// (kernels/packet_bvh.py) visits in the same order, so that ties in t
// resolve to the same triangle in both.
//
// What bounds it on an H100: it must move N * (28 in + 21 out) bytes and the
// tables once, for about 25 operations a visited node and 4 x 150 a tested
// leaf row; what it loads on the way (40 bytes a node, 160 a leaf row) comes
// from the L2 cache.  What it really waits for is each walk's chain of
// dependent loads and, in a warp, its longest walk: on the mesh path's rays
// most lanes are dead or miss the root, and the few that walk held their
// warps (16% of a warp's lane steps busy on the bounce rays).  So the design
// is about latency and divergence:
//   * Two passes, as csrc/wide_bvh.cu.  Pass 1 (packet_triage_kernel), one
//     thread a ray, reads the ray, makes the root's test (the walk's own
//     first step: the root's miss link is -1) and writes the miss record of
//     a ray that is dead or that the root does not want; the others go on a
//     list, a warp's rays together.  Pass 2 (packet_walk_kernel) walks the
//     listed rays from the root, one thread each, over a grid of a few
//     waves.  The wrappers no longer sort the rays.
//   * Leaf tests reject first: the edge functions and their signs, then the
//     t range, each behind a branch, and only a candidate pays the division,
//     delta_t and the barycentrics (the same operations in the same order).
//   * While-while (Aila and Laine, HPG 2009): a lane walks nodes until it
//     reaches a wanted leaf or the end of its walk, and the warp then tests
//     its lanes' leaves together, so leaf tests do not serialise against
//     node visits.  The order of a ray's visits is unchanged.
//   * Occupancy: __launch_bounds__(128, 8), 64 registers and 8 blocks (32
//     warps) an SM for the walk; the few bytes it spills cost less than the
//     latency the extra warps hide (tools/bench_packet_bvh.py).
// Measured and left out (tools/bench_packet_bvh.py): one 32-byte (octant,
// node) record a visit instead of the box row and the link pair (8 times the
// table, slower), near and far planes picked by the octant (no faster), and
// warps of pass 1 whose rays all enter the tree walking them there (faster
// when every ray enters, 1.6-1.8x slower on the mesh path's rays: pass 2
// waits for pass 1's longest walk).  A sparse cast (one lane in 32 alive)
// is slower than in one pass: its few walks share warps, whose lanes load
// from as many nodes.
//
// Termination: a threaded walk visits a node at most once, so n_nodes steps
// bound it; a table whose links do not thread a tree traps instead of
// spinning or returning a partial walk (pass 1 lists a ray that the root
// does not want if the root's miss link goes on, so that it traps too).
//
// Exactness: see watertight.cuh; built with --fmad=false, no fast-math.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>
#include <cstdio>

#include "watertight.cuh"

namespace {

constexpr int kThreads = 128;
// Blocks an SM holds at least: the walk's register budget (64).
constexpr int kMinBlocks = 8;
// Waves of blocks of the walk pass at most (a wave: as many blocks as the
// SMs hold at once).
constexpr int kWaves = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLeafFloat4 = 9;   // one leaf row: 4 triangles x 9 floats
constexpr float kSlabWiden = (float)(1.0 + 2.0 * 7.2e-7);

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = (v < 0.f) ? -1e-20f : 1e-20f;
  return 1.0f / ((fabsf(v) < 1e-20f) ? tiny : v);
}

// The tables and rays of one launch.
struct Args {
  const float4* __restrict__ nodes;  // (NN, 8) f32
  const int2* __restrict__ meta;     // (K, NN, 2) i32
  const float4* __restrict__ leafs;
  const int4* __restrict__ tid;
  const float* __restrict__ o;
  const float* __restrict__ d;
  const float* __restrict__ t_max;
  float* __restrict__ t_out;
  int* __restrict__ tri_out;
  float* __restrict__ b_out;
  uint8_t* __restrict__ flag_out;
  int n_nodes, n_oct;
};

// One visited node: its box and this octant's links.
struct Node {
  float lox, loy, loz, hix, hiy, hiz;
  int first, miss;
};

__device__ __forceinline__ Node fetch(const Args& a, int oct, int cur) {
  const float4 r0 = __ldg(a.nodes + 2 * (long long)cur);
  const float4 r1 = __ldg(a.nodes + 2 * (long long)cur + 1);
  const int2 lk = __ldg(a.meta + (long long)oct * a.n_nodes + cur);
  Node nd;
  nd.lox = r0.x; nd.loy = r0.y; nd.loz = r0.z;
  nd.hix = r0.w; nd.hiy = r1.x; nd.hiz = r1.y;
  nd.first = lk.x;
  nd.miss = lk.y;
  return nd;
}

// One ray: its frame, its octant and its best hit.
struct Ray {
  gnx::RayFrame rf;
  float ix, iy, iz;
  int oct;  // its link table: the direction's octant, or 0 for one table
  float t_best, u, v;
  int best_tri;
  bool found;
};

// The slab test of _slab_want.
__device__ __forceinline__ bool wants(const Node& nd, const Ray& r) {
  const float tx0 = (nd.lox - r.rf.ox) * r.ix, tx1 = (nd.hix - r.rf.ox) * r.ix;
  const float ty0 = (nd.loy - r.rf.oy) * r.iy, ty1 = (nd.hiy - r.rf.oy) * r.iy;
  const float tz0 = (nd.loz - r.rf.oz) * r.iz, tz1 = (nd.hiz - r.rf.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                         fminf(tz0, tz1));
  const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                         fmaxf(tz0, tz1)) * kSlabWiden;
  return (tn <= tf) && (tf > 0.f) && (tn < r.t_best) && (r.t_best > 0.f);
}

// Reads ray i (live: t_max > 0) into r.
__device__ __forceinline__ void load_ray(const Args& a, int i, Ray& r) {
  const long long i3 = 3ll * i;
  const float ox = a.o[i3 + 0], oy = a.o[i3 + 1], oz = a.o[i3 + 2];
  const float dx = a.d[i3 + 0], dy = a.d[i3 + 1], dz = a.d[i3 + 2];
  r.ix = safe_inv(dx);
  r.iy = safe_inv(dy);
  r.iz = safe_inv(dz);
  r.oct = (a.n_oct == 8)
      ? ((dx < 0.f ? 1 : 0) | (dy < 0.f ? 2 : 0) | (dz < 0.f ? 4 : 0)) : 0;
  r.rf = gnx::make_ray_frame(ox, oy, oz, dx, dy, dz);
}

// Leaf row `row`: its triangles in row order, strict t < t_best.  Returns
// true when the any-hit walk is over (its first hit before t_max).
template <bool kAnyHit>
__device__ __forceinline__ bool test_leaf(const Args& a, long long row,
                                          Ray& r) {
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
    float x[3], y[3], z[3];
    gnx::frame_vertices(r.rf, q + 9 * k, x, y, z);
    gnx::Sheared s;
    if (!gnx::watertight_edges(x, y, s)) continue;
    if (!gnx::watertight_range(z, r.rf.sz, r.t_best, s)) continue;
    float t, b0, b1, b2;
    if (gnx::watertight_tail(s, t, b0, b1, b2) && (t < r.t_best)) {
      r.found = true;
      if (kAnyHit) return true;
      r.t_best = t;
      r.best_tri = ids[k];
      r.u = b1;
      r.v = b2;
    }
  }
  return false;
}

__device__ __forceinline__ void too_many_steps(int n_nodes, int i) {
  printf("packet_bvh_kernel: more than %d steps in a tree of %d nodes "
         "(ray %d)\n", n_nodes, n_nodes, i);
  __trap();
}

// Ray i's walk from the root, while-while: nodes until a wanted leaf or the
// end of the walk, then the leaf (the warp's lanes test theirs together).
template <bool kAnyHit>
__device__ __forceinline__ void walk(const Args& a, int i, Ray& r) {
  int cur = 0;
  int steps = 0;
  while (cur >= 0) {
    long long row = -1;
    do {
      if (++steps > a.n_nodes) too_many_steps(a.n_nodes, i);
      const Node nd = fetch(a, r.oct, cur);
      const bool want = wants(nd, r);
      if (want && nd.first < 0) {
        row = -(long long)nd.first - 1;
        cur = nd.miss;  // where the walk goes on after the leaf
        break;
      }
      cur = want ? nd.first : nd.miss;
    } while (cur >= 0);
    if (row >= 0 && test_leaf<kAnyHit>(a, row, r)) cur = -1;
  }
}

template <bool kAnyHit>
__device__ __forceinline__ void finish(const Args& a, int i, const Ray& r) {
  if (kAnyHit) {
    a.flag_out[i] = r.found ? 1 : 0;
  } else {
    a.t_out[i] = r.found ? r.t_best : FLT_MAX;
    a.tri_out[i] = r.found ? r.best_tri : 0;
    const long long i3 = 3ll * i;
    a.b_out[i3 + 0] = (1.0f - r.u) - r.v;
    a.b_out[i3 + 1] = r.u;
    a.b_out[i3 + 2] = r.v;
    a.flag_out[i] = r.found ? 1 : 0;
  }
}

__device__ __forceinline__ void start(const Args& a, int i, Ray& r) {
  r.t_best = a.t_max[i];  // any-hit mode: stays t_max
  r.best_tri = -1;
  r.u = r.v = 0.f;
  r.found = false;
}

// Pass 1 of a cast: one thread a ray.  A ray that is dead, or that the root
// does not want (its miss link is -1, so that is the whole walk), gets its
// miss record here; the others are listed for pass 2, a warp's together.
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
packet_triage_kernel(Args a, long long n, int* __restrict__ list,
                     unsigned long long* __restrict__ listed) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int i = (int)k;  // n <= 2^30
  bool walks = false;
  if (k < n) {
    Ray r;
    start(a, i, r);
    if (r.t_best > 0.f) {  // a dead lane: its ray is not read
      load_ray(a, i, r);
      const Node root = fetch(a, r.oct, 0);
      walks = wants(root, r) || root.miss >= 0;
    }
    if (!walks) finish<kAnyHit>(a, i, r);
  }
  const unsigned m = __ballot_sync(kFull, walks);
  if (m == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  unsigned long long base = 0;
  if (lane == leader) base = atomicAdd(listed, (unsigned long long)__popc(m));
  base = __shfl_sync(kFull, base, leader);
  if (walks) list[base + __popc(m & ((1u << lane) - 1u))] = i;
}

// Pass 2: the walks of the rays pass 1 listed.
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
packet_walk_kernel(Args a, const unsigned long long* __restrict__ listed,
                   const int* __restrict__ list) {
  const long long n = (long long)*listed;
  if ((long long)blockIdx.x * kThreads >= n) return;  // a block with none
  // one thread a ray; a grid of a few waves strides over a long list
  const int stride = gridDim.x * kThreads;
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < n; k += stride) {
    const int i = list[k];
    Ray r;
    start(a, i, r);
    load_ray(a, i, r);
    walk<kAnyHit>(a, i, r);
    finish<kAnyHit>(a, i, r);
  }
}

// Blocks of pass 2: one thread a ray, but at most kWaves waves.
template <bool kAnyHit>
int walk_blocks(long long n, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, packet_walk_kernel<kAnyHit>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = (n + kThreads - 1) / kThreads;
  const long long most = (long long)sms * per_sm * kWaves;
  if (most < *blocks) *blocks = most;
  if (*blocks < 1) *blocks = 1;
  return 0;
}

template <bool kAnyHit>
int launch(const Args& a, long long n, unsigned long long* listed, int* list,
           void* stream) {
  if (n <= 0) return 0;
  if (a.n_nodes < 1 || (a.n_oct != 1 && a.n_oct != 8) || n > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long ray_blocks = (n + kThreads - 1) / kThreads;
  packet_triage_kernel<kAnyHit><<<(unsigned)ray_blocks, kThreads, 0, st>>>(
      a, n, list, listed);
  const cudaError_t err1 = cudaGetLastError();
  if (err1 != cudaSuccess) return (int)err1;
  long long blocks = 0;
  const int err = walk_blocks<kAnyHit>(n, &blocks);
  if (err != 0) return err;
  packet_walk_kernel<kAnyHit><<<(unsigned)blocks, kThreads, 0, st>>>(
      a, listed, list);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points: device pointers, the ray count (at most 2^30), the
// tree's node count and number of link tables (8 per-octant orders, or 1), a
// zeroed uint64 counter, an int32 scratch list of n entries, and the CUDA
// stream to launch on.  Each returns its launch's cudaError_t (0 on
// success); none synchronises or allocates.  nodes: (n_nodes, 8) float,
// meta: (n_oct, n_nodes, 2) int32, leafs: (rows, 36) float, tid: (rows, 4)
// int32, all 16-byte aligned.

// The blocks the walk pass of a launch of n rays takes at most (a report for
// measurements).
extern "C" long long gnx_packet_blocks(int any_hit, long long n) {
  long long blocks = 0;
  const int err = any_hit ? walk_blocks<true>(n, &blocks)
                          : walk_blocks<false>(n, &blocks);
  return err != 0 ? -err : blocks;
}

extern "C" int gnx_packet_closest_hit(const void* nodes, const void* meta,
                                      const void* leafs, const void* tid,
                                      const float* o,
                                      const float* d, const float* t_max,
                                      float* t_out, int* tri_out, float* b_out,
                                      uint8_t* hit_out, long long n,
                                      int n_nodes, int n_oct,
                                      unsigned long long* listed, int* list,
                                      void* stream) {
  const Args a{static_cast<const float4*>(nodes), static_cast<const int2*>(meta),
               static_cast<const float4*>(leafs),
               static_cast<const int4*>(tid), o, d, t_max, t_out, tri_out,
               b_out, hit_out, n_nodes, n_oct};
  return launch<false>(a, n, listed, list, stream);
}

extern "C" int gnx_packet_any_hit(const void* nodes, const void* meta,
                                  const void* leafs, const void* tid,
                                  const float* o,
                                  const float* d, const float* t_max,
                                  uint8_t* occ_out, long long n, int n_nodes,
                                  int n_oct, unsigned long long* listed,
                                  int* list, void* stream) {
  const Args a{static_cast<const float4*>(nodes), static_cast<const int2*>(meta),
               static_cast<const float4*>(leafs),
               static_cast<const int4*>(tid), o, d, t_max, nullptr, nullptr,
               nullptr, occ_out, n_nodes, n_oct};
  return launch<true>(a, n, listed, list, stream);
}

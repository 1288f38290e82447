// Backward of a per-lane gather of a small float parameter table,
// out = zeros(rows, C).index_put_((idx,), g, accumulate=True), bit-equal to
// PyTorch's CUDA index-put backward: the order-preserving sums, over lanes
// already grouped by table row (kernels/table_grad.py groups them with a
// stable sort of their row keys, as PyTorch's own backward sorts).
//
// It replaces no TPU kernel: the JAX package leaves the gather's transpose
// to XLA.  It was added because PyTorch's own kernel for it
// (indexing_backward_kernel_small_stride, after a radix sort of the
// indices) gives each distinct row to one thread a column, which walks the
// row's lanes through dependent loads: with a handful of rows and a million
// lanes that is a chain of 1e5-1e6 global-memory round trips a thread.
//
// The float sums keep PyTorch's order, so the result is the same bits:
//   * C >= 2 (PyTorch's small-stride and general kernels): out[r, c] is the
//     float32 chain ((+0 + g[l1, c]) + g[l2, c]) + ... over the lanes
//     l1 < l2 < ... with idx == r (the radix sort is stable);
//   * C == 1 (PyTorch's stride-1 kernel): lane k of a warp chains the
//     row's sorted elements k, k + 32, k + 64, ... over its whole passes of
//     32, the 32 chains meet by shuffling down 16, 8, 4, 2, 1, and lane 0
//     chains the remaining elements in order; out = +0 + that.
// No float is summed in any other order: no atomics, no other reduction.
//
// What bounds it on an H100: the chain of the row with most lanes, one
// dependent float add (about 4 cycles) an element; the bytes are far below.
// So one warp a row (and a group of up to four columns) streams its segment
// of each column through two tiles of 512 positions in shared memory: the
// whole warp copies the next tile in, coalesced, with cp.async while the
// chain lanes add the current one, four floats a read, so the copies land
// behind the adds.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kChainWarps = 2;  // warps (rows) a block
constexpr int kTile = 512;      // positions a warp stages at once
// a column's stride in the staged tile: 16-byte aligned for float4 reads,
// and the chain lanes' columns start 4 banks apart
constexpr int kPitch = kTile + 4;
constexpr int kColGroup = 4;  // columns a warp sums (C >= 2)
constexpr unsigned kAll = 0xffffffffu;

// Asynchronous 4-byte copies from global to shared memory (cp.async).
// Unlike a load into a register, which the compiler may move after the
// chain to save registers, the copy is issued here and lands while the
// chain runs; the "memory" clobbers keep the chain's reads on their side.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_issued() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// The first position of the sorted keys[0, n) whose key is at least r.
__device__ __forceinline__ long long lower_bound(const int* __restrict__ keys,
                                                 long long n, int r) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < r)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Positions [first, first + cnt) of columns [c0, c0 + ncol) of `sorted`
// into the tile (column c at tile + c * kPitch), coalesced.
__device__ __forceinline__ void fetch_tile(const float* __restrict__ sorted,
                                           long long n, int c0, int ncol,
                                           long long first, int cnt, int lane,
                                           float* tile) {
  for (int c = 0; c < ncol; ++c) {
    const float* src = sorted + (c0 + c) * n + first;
#pragma unroll 4
    for (int j = lane; j < cnt; j += 32)
      copy_async(tile + c * kPitch + j, src + j);
  }
}

// One warp a row r = blockIdx.x * kChainWarps + warp and column group
// blockIdx.y; row r's lanes are the positions of each column of `sorted`
// whose key is r, found by a binary search of the sorted keys.  See the
// note at the top for the two orders.  Each warp has two tiles: the next
// one lands while the chain runs over the current one.
template <bool kStride1>
__global__ void __launch_bounds__(32 * kChainWarps)
    chain_kernel(const float* __restrict__ sorted,
                 const int* __restrict__ keys, long long n, int rows,
                 int cols, float* __restrict__ out) {
  constexpr int kCols = kStride1 ? 1 : kColGroup;
  // kChainWarps x 2 tiles x kCols x kPitch
  extern __shared__ __align__(16) float s_tiles[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kChainWarps + warp;
  if (r >= rows) return;  // the whole warp
  const int c0 = blockIdx.y * kCols;
  const int ncol = cols - c0 < kCols ? cols - c0 : kCols;
  float* tiles_of_warp = s_tiles + warp * 2 * kCols * kPitch;
  long long start = 0, end = 0;
  if (lane == 0) {
    start = lower_bound(keys, n, r);
    end = lower_bound(keys, n, r + 1);
  }
  start = __shfl_sync(kAll, start, 0);
  end = __shfl_sync(kAll, end, 0);
  const int len = (int)(end - start);
  const int tiles = (len + kTile - 1) / kTile;
  // stride-1 order: positions below `full` go to the 32 strided chains
  const int full = kStride1 ? len / 32 * 32 : 0;

  if (tiles > 0) {
    fetch_tile(sorted, n, c0, ncol, start, len < kTile ? len : kTile, lane,
               tiles_of_warp);
    copies_issued();
    copies_landed();
  }
  float acc = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    const int lo = t * kTile;
    const float* tile = tiles_of_warp + (t & 1) * kCols * kPitch;
    if (t + 1 < tiles) {
      const int rest = len - lo - kTile;
      fetch_tile(sorted, n, c0, ncol, start + lo + kTile,
                 rest < kTile ? rest : kTile, lane,
                 tiles_of_warp + ((t + 1) & 1) * kCols * kPitch);
      copies_issued();
    }
    if (kStride1) {
      const int upto = full - lo < kTile ? full - lo : kTile;
      for (int e = 0; e * 32 < upto; ++e) acc += tile[e * 32 + lane];
    } else if (lane < ncol) {
      // four elements a shared-memory read, added one by one in order
      const float* col = tile + lane * kPitch;
      const int cnt = len - lo < kTile ? len - lo : kTile;
      const float4* col4 = reinterpret_cast<const float4*>(col);
#pragma unroll 16
      for (int q = 0; q < cnt / 4; ++q) {
        const float4 x = col4[q];
        acc += x.x;
        acc += x.y;
        acc += x.z;
        acc += x.w;
      }
      for (int j = cnt / 4 * 4; j < cnt; ++j) acc += col[j];
    }
    copies_landed();
  }
  if (kStride1) {
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(kAll, acc, off);
    if (lane == 0) {
      // the remaining elements all lie in the last tile, still staged
      const int lo = (tiles - 1) * kTile;
      const float* tile = tiles_of_warp + ((tiles - 1) & 1) * kPitch;
      for (int j = full; j < len; ++j) acc += tile[j - lo];
      out[(long long)r * cols + c0] = 0.0f + acc;
    }
  } else if (lane < ncol) {
    out[(long long)r * cols + c0 + lane] = 0.0f + acc;
  }
}

}  // namespace

// sorted (cols, n) float32, the gradient's columns over the lanes in the
// order of keys (n,) int32, each lane's row sorted stably (a key of rows or
// more is a lane left out); out (rows, cols) float32.
extern "C" int gnx_table_grad_chain(const float* sorted, const int* keys,
                                    long long n, int rows, int cols,
                                    float* out, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || rows < 1 || cols < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool stride1 = cols == 1;
  const dim3 grid((rows + kChainWarps - 1) / kChainWarps,
                  stride1 ? 1 : (cols + kColGroup - 1) / kColGroup);
  const size_t tile_bytes = (size_t)kChainWarps * 2 * kPitch *
                            (stride1 ? 1 : kColGroup) * sizeof(float);
  if (stride1)
    chain_kernel<true><<<grid, 32 * kChainWarps, tile_bytes, s>>>(
        sorted, keys, n, rows, cols, out);
  else
    chain_kernel<false><<<grid, 32 * kChainWarps, tile_bytes, s>>>(
        sorted, keys, n, rows, cols, out);
  return (int)cudaGetLastError();
}

// Pair expansion: per-triangle cover meta -> the (bin, triangle) pair
// list of the micro path's cells or of the tile path's flat layout, the
// scan of the cover counts included.
//
// Replaces the TPU kernel of the JAX package's backends/pallas_expand.py
// (_expand_kernel, launched by expand_cells) together with the scan that
// feeds it (blocked_cumsum_i32 there).
//
// Triangle t owns slots [starts[t], starts[t] + c[t]) (starts: exclusive
// cumsum of the cover counts); slot starts[t] + local covers the cell
// (cx, cy) = (x0 + local % rx, y0 + local / rx) of the triangle's cell
// rectangle, id (cy * ntx_t + cx / 16) * 16 + cx % 16, which is the
// row-major id cy * 16 ntx_t + cx. Slots at or past the total get the
// num_cells sentinel and triangle 0; no slot at or past pair_cap is
// written; the total is exact even past pair_cap.
//
// The entry, expand_rows_i32, takes the row width: 16 ntx_t for the micro
// path's cells, ntx for the tile path's flat layout, whose (tile,
// triangle) pairs have the ids cy * ntx + cx (binning.py
// bin_triangles_sort's tile_of_pair) and the num_tiles sentinel.
//
// What bounds it on an H100: memory. Each triangle's count is read (4
// bytes), the rect (12 bytes) only of each live triangle, and each slot's
// 8 bytes are written; the work is a few integer operations a slot.
//
// Design: two launches, each block owning a contiguous range of TRIS
// triangles.
// - expand_kernel_sums: each block sums its range's cover counts.
// - expand_kernel: each block adds up the block sums before its own (its
//   first slot, off_b) and all of them (the total) — a few hundred ints
//   read from L2 while its own range loads, so no third launch scans them
//   — and scans its range's counts in shared memory, staging the local
//   exclusive starts, rx, x0 and y0 there (those of culled triangles are
//   not read). Its pairs are the contiguous slots [off_b, off_b + sum_b):
//   the threads fill them with coalesced stores, each slot finding its owner
//   by a binary search of the staged starts (log2 TRIS steps in shared
//   memory, where the TPU kernel used a membership matmul and the earlier
//   kernel here searched 4 MB of global starts). A block whose triangles
//   own many cells loops over them with all its threads. Every block also
//   writes an equal share of the sentinel tail [min(total, pair_cap),
//   pair_cap), whose start only the device knows.
// No status words live across launches: the block sums are scratch the
// wrapper allocates for each call, written by the first launch before the
// second reads them in the same stream, so nothing needs clearing and two
// calls in flight share nothing.
//
// Exactness: integer arithmetic only. local >= 0 and rx >= 1, so C's
// truncating division equals floor division there; the cell id is written
// as cy * 16 ntx_t + cx, which equals the JAX package's
// (cy * ntx_t + cx // 16) * 16 + cx % 16 for any sign of cx (floor
// division and modulo recombine to cx).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;                 // triangles a thread scans
constexpr int TRIS = THREADS * ITEMS;    // triangles a block owns
constexpr int WARPS = THREADS / 32;
// Resident expansion blocks an SM (caps the registers at 32): the 977
// blocks of a million triangles run in one wave on 132 SMs, where at six
// an SM the last fifth waited for a second.
constexpr int MIN_BLOCKS = 8;

// Shared-memory index of scan item i, padded by one word every 32 so that
// a thread's ITEMS consecutive items sit on distinct banks across a warp.
__host__ __device__ constexpr int pad(int i) { return i + (i >> 5); }

// Block-wide sum of one int per thread (every thread gets it).
__device__ __forceinline__ int block_sum(int v, int* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // scratch may still be read from a previous call
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += scratch[w];
  return s;
}

__global__ void __launch_bounds__(THREADS) expand_kernel_sums(
    const int* __restrict__ c, int* __restrict__ sums, int T) {
  __shared__ int scratch[WARPS];
  const int t0 = blockIdx.x * TRIS;
  int v = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int t = t0 + k * THREADS + threadIdx.x;
    if (t < T) v += c[t];
  }
  v = block_sum(v, scratch);
  if (threadIdx.x == 0) sums[blockIdx.x] = v;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) expand_kernel(
    const int* __restrict__ c,       // (T,) cover counts
    const int* __restrict__ rx,      // (T,) cell-rect width
    const int* __restrict__ x0,      // (T,) cell-rect origin x
    const int* __restrict__ y0,      // (T,) cell-rect origin y
    const int* __restrict__ sums,    // (blocks,) cover counts a block
    int* __restrict__ total_out,     // () number of pairs
    int* __restrict__ cell_of_pair,  // (pair_cap,)
    int* __restrict__ tri_of_pair,   // (pair_cap,)
    int T, int blocks, int pair_cap, int row_width, int num_cells) {
  __shared__ int s_c[pad(TRIS)];
  __shared__ int s_start[TRIS];
  __shared__ int s_rx[TRIS];
  __shared__ int s_x0[TRIS];
  __shared__ int s_y0[TRIS];
  __shared__ int scratch[WARPS];
  const int b = blockIdx.x;
  const int t0 = b * TRIS;
  const int n = max(min(TRIS, T - t0), 0);  // triangles of this block

  // Stage the range, coalesced; counts past T are 0, and the rects of
  // culled triangles (c = 0) are never read. The block sums are loaded
  // alongside, and added up after the scan.
  int before = 0, all = 0;
  for (int j = threadIdx.x; j < blocks; j += THREADS) {
    const int s = sums[j];
    all += s;
    if (j < b) before += s;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = k * THREADS + threadIdx.x;
    const int ci = i < n ? c[t0 + i] : 0;
    s_c[pad(i)] = ci;
    if (ci > 0) {
      s_rx[i] = rx[t0 + i];
      s_x0[i] = x0[t0 + i];
      s_y0[i] = y0[t0 + i];
    }
  }
  __syncthreads();

  // Local exclusive scan: each thread its ITEMS consecutive items, the
  // threads' sums scanned across the warp and then across the warps.
  const int base = threadIdx.x * ITEMS;
  int items[ITEMS];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    items[k] = s_c[pad(base + k)];
    mine += items[k];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int run = incl - mine, sum_b = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int s = scratch[w];
    if (w < warp) run += s;
    sum_b += s;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    s_start[base + k] = run;
    run += items[k];
  }

  // The block's first slot and the total (block_sum's barriers also order
  // the starts just written before the fill reads them).
  const int off = block_sum(before, scratch);
  const int total = block_sum(all, scratch);
  if (b == 0 && threadIdx.x == 0) *total_out = total;

  // Fill the block's slots [off, off + sum_b), clipped to pair_cap.
  const int end = min(sum_b, pair_cap - off);
  for (int s = threadIdx.x; s < end; s += THREADS) {
    // The rightmost triangle whose start is <= s: the owner (triangles
    // with c = 0 share their start with the next one and are skipped;
    // those at the range's end start at sum_b > s).
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int mid = lo + ((hi - lo + 1) >> 1);
      if (s_start[mid] <= s) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int local = s - s_start[lo];
    const int w = max(s_rx[lo], 1);
    const int q = local / w;
    const int cx = s_x0[lo] + (local - q * w);
    const int cy = s_y0[lo] + q;
    cell_of_pair[off + s] = cy * row_width + cx;
    tri_of_pair[off + s] = t0 + lo;
  }

  // This block's share of the sentinel tail.
  const int tail = min(total, pair_cap);
  const int share = (pair_cap - tail + gridDim.x - 1) / gridDim.x;
  const int p1 = min(tail + (b + 1) * share, pair_cap);
  for (int p = tail + b * share + threadIdx.x; p < p1; p += THREADS) {
    cell_of_pair[p] = num_cells;
    tri_of_pair[p] = 0;
  }
}

}  // namespace

// sums: scratch of `blocks` ints, blocks = ceil(T / TRIS) (expand.TRIS);
// pair ids cy * row_width + cx.
extern "C" int expand_rows_i32(const void* c, const void* rx, const void* x0,
                               const void* y0, void* sums, void* total,
                               void* cell_of_pair, void* tri_of_pair, int T,
                               int blocks, int pair_cap, int row_width,
                               int num_cells, void* stream) {
  if (T < 0 || blocks != (T + TRIS - 1) / TRIS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0)
    expand_kernel_sums<<<blocks, THREADS, 0, s>>>((const int*)c,
                                                  (int*)sums, T);
  // At least one block, to write the total and the tail when T = 0.
  expand_kernel<<<blocks > 0 ? blocks : 1, THREADS, 0, s>>>(
      (const int*)c, (const int*)rx, (const int*)x0, (const int*)y0,
      (const int*)sums, (int*)total, (int*)cell_of_pair, (int*)tri_of_pair,
      T, blocks, pair_cap, row_width, num_cells);
  return (int)cudaGetLastError();
}

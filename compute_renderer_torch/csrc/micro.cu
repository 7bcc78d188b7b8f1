// Micro raster + shade of the mega-scene path: each 8x8 cell walks its own
// segment of the cell-sorted pair list; base, material, fused-texture
// (texf), visibility (vis) and mip-filtered texture (texf_mip) modes.
//
// Replaces the TPU kernel of the JAX package's backends/pallas_micro.py
// (_micro_kernel_wl with _raster_tile_micro, launched by
// raster_shade_micro; the full-grid _micro_kernel is this kernel fed an
// all-tiles work list).
//
// Two kinds of block in one launch, of sixteen warps each; a warp owns 64
// pixels of a cell, two a lane in one column:
//   - span blocks (the first of the grid): warp h takes the window
//     [h SPAN, (h + 1) SPAN) of the pair list and walks its intersection
//     with each cell of more than SPAN pairs — at most two, since such a
//     cell cannot fit inside a window; a cell is found by a 32-way search
//     of seg_start. A span folds each covered pixel into the cell's 64-bit
//     word, atomicMin((key << 32) | pair): the minimum word is the
//     (key, pair)-lexicographic minimum, the sequential walk's winner
//     (pallas_micro.py:23-26). The span that arrives last at the cell's
//     counter (after __threadfence) takes the words back with atomicExch,
//     restoring them and the counter to their clear values for the next
//     launch, and emits the cell's pixels. A covered key is never
//     KEY_CLEAR (0xFFFFFFFF is a NaN pattern; covered z is finite), so a
//     word left at all ones means that no pair covers the pixel;
//   - tile blocks: one per entry of the occupied-tile work list; an 8x128
//     tile is sixteen 8x8 cells side by side, and warp c walks cell c if
//     its segment holds at most SPAN pairs, then emits its pixels.
// A warp walks its range in pair order, CHUNK pairs a round,
// double-buffered: while round k is walked, round k+1's rows are in flight
// (cp.async of the four quads the walk reads, walk.cuh) and round k+2's
// pair ids are in registers. The coefficient rows are read in place at
// table[pair_tri[p]]: the P-sized pair stream the TPU kernel DMAs
// (pallas_micro.build_pair_coeffs) does not exist here. Per pair and pixel:
// three barycentrics and z as (A + B*dx) + C*dy, coverage min(bc) >=
// max(threshold, melt) with z finite, the u32 depth key, and a strict-<
// running minimum that remembers the absolute pair index. The epilogue
// (shade.cuh emit_pixel, the tile raster's) evaluates the winner's
// attributes from its row table[pair_tri[pair]] and shades (base,
// material: kd at columns 32:35) or writes a G-buffer (texf, texf_mip); in
// vis mode it writes the pair index, or PAIR_IDX_CLEAR where the key stayed
// clear (pallas_micro.py:507-510, :624-629). Only the cell's own 64 pixels
// are evaluated, so coverage outside a triangle's bbox (voxelize, mirage)
// clips to the 8x8 cell rectangles, as in the JAX package.
//
// What bounds it on an H100: by the roofline, memory (chip_smoke.py
// raster_bound: 0.0117-0.0269 ms on the structured scene by mode, the
// walked columns of each binned triangle). Counted at the card's peak
// rates, the walk itself (699,376 pairs x 64 samples) needs about 0.03 ms
// of instruction issue, and the gathered rows (a table larger than L2, two
// or three 32-byte sectors a pair) about 0.03 ms of DRAM time. Measured 0.075-0.092 ms there in every mode, against 1.03-1.14 ms
// for a warp per cell, whose densest (7,113 pairs) set the time; the time
// now grows with the pairs walked: 0.025 ms with every cell cut to 16
// pairs, 0.050 with every cell cut to SPAN (scripts/sweep_raster_constants
// .py --probe). SPAN 128 measured best of 32-512, and persistent warps
// behind one queue were slower (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// The grid is host-sized: every tile plus pair_cap / SPAN span warps; tile
// blocks past the occupied count and span warps past the list's end exit
// at once (no host synchronisation), and the wrapper pre-clears the
// outputs and keeps the words and counters.
//
// Exactness: built with -fmad=false and without fast math, the same op
// order as the eager torch twin; each barycentric is tested with >= so
// that a NaN fails (fminf would drop it); keys are __float_as_uint(z)
// compared unsigned, so -0.0 keys as 0x80000000.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "shade.cuh"
#include "walk.cuh"

namespace {

constexpr int CELLS = 16;  // 8x8 cells per 8x128 tile: one warp each
constexpr int THREADS = 32 * CELLS;
constexpr int CHUNK = 32;   // pairs staged per warp a round: one id a lane
constexpr int SPAN = 128;   // the longest range a warp walks
constexpr int STAGE = 2 * CHUNK * walk::QUADS;  // float4 per warp: 4 KB
constexpr size_t SMEM = (size_t)CELLS * STAGE * sizeof(float4);  // 64 KB
constexpr int MIN_BLOCKS = 2;  // resident blocks an SM: caps the registers
constexpr int PAIR_IDX_CLEAR = 0x7FFFFFFF;  // vis: no pair covers the pixel
constexpr unsigned long long WORD_CLEAR = ~0ull;
using walk::FULL;
using walk::QUADS;

struct Frame {
  const float* table;
  const int* pair_tri;
  const float* params;
  const float* lights;
  void* out;
  uint32_t* key;
  int row_stride, num_lights, ntx, width_padded;
  size_t plane;
};

// The samples of cell `cell`'s pixels q = lane + 32 j: column q % 8, row
// q / 8 (they share px).
struct Samples {
  float px, py[2];
  int ti, tj, c;  // tile row, tile column, cell of the tile
};

__device__ __forceinline__ Samples cell_samples(int cell, int lane,
                                                const Frame& f) {
  Samples s;
  const int tile = cell / CELLS;
  s.c = cell - tile * CELLS;
  s.ti = tile / f.ntx;
  s.tj = tile - s.ti * f.ntx;
  const float* params = f.params;
  const bool mirage = params[2] > 0.5f;
  const float amplitude = params[3];
  const float frequency = params[4];
  const float phase = params[5];
  const float time = params[6];
  const float y0 = (float)(s.ti * 8) + params[7];
  const float x0 = (float)(s.tj * 128 + s.c * 8);
  const float xs = (float)(lane & 7) + x0;
  s.px = mirage ? xs + amplitude * sinf(frequency * xs + time + phase) : xs;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float ys = (float)((lane >> 3) + 4 * j) + y0;
    s.py[j] = mirage ? ys + amplitude * cosf(frequency * ys + time + phase)
                     : ys;
  }
  return s;
}

// Walks pairs [lo, hi) of the list for the lane's two samples into
// best / winner (absolute pair indices), through the warp's two staging
// buffers.
__device__ __forceinline__ void walk_range(const Frame& f, int lo, int hi,
                                           const Samples& s, float cov_min,
                                           float4* stage, int lane,
                                           uint32_t best[2], int winner[2]) {
  const float4* table4 = reinterpret_cast<const float4*>(f.table);
  const int row_quads = f.row_stride / 4;
  const int n = hi - lo;
  auto pair_id = [&](int c) {
    const int i = c * CHUNK + lane;
    return i < n ? f.pair_tri[lo + i] : 0;
  };
  // Round c's rows into buffer c & 1: lane l copies quads l + 32 k.
  auto issue = [&](int c, int tri) {
    float4* buf = stage + (c & 1) * CHUNK * QUADS;
    const int m = n - c * CHUNK;
#pragma unroll
    for (int k = 0; k < CHUNK * QUADS / 32; ++k) {
      const int e = lane + 32 * k;
      const int r = e / QUADS;
      const int t = __shfl_sync(FULL, tri, r);
      if (r < m)
        walk::cp_async16(buf + e, table4 + (size_t)t * row_quads +
                                      walk::table_quad(e - r * QUADS));
    }
    walk::cp_async_commit();
  };

  const int rounds = (n + CHUNK - 1) / CHUNK;
  issue(0, pair_id(0));
  int next = pair_id(1);
  for (int c = 0; c < rounds; ++c) {
    issue(c + 1, next);  // an empty group past the last round
    next = pair_id(c + 2);
    walk::cp_async_wait<1>();
    __syncwarp();  // every lane's copies of round c landed
    const float4* rows = stage + (c & 1) * CHUNK * QUADS;
    const int m = min(CHUNK, n - c * CHUNK);
#pragma unroll 4
    for (int k = 0; k < m; ++k)
      walk::walk_row(rows + k * QUADS, s.px, s.py, cov_min,
                     lo + c * CHUNK + k, best, winner);
    __syncwarp();  // round c is consumed before its buffer is refilled
  }
}

// Emits the lane's two pixels of the cell from best / winner (pair
// indices, -1 for none).
template <int MODE>
__device__ __forceinline__ void emit_cell(const Frame& f, const Samples& s,
                                          int lane, const uint32_t best[2],
                                          const int winner[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t o = (size_t)(s.ti * 8 + (lane >> 3) + 4 * j) *
                         f.width_padded +
                     (size_t)(s.tj * 128 + s.c * 8 + (lane & 7));
    const float* row =
        (MODE == shade::MODE_VIS || winner[j] < 0)
            ? nullptr
            : f.table + (size_t)f.pair_tri[winner[j]] * f.row_stride;
    const int id = winner[j] < 0 ? PAIR_IDX_CLEAR : winner[j];
    shade::emit_pixel<MODE>(row, id, s.px, s.py[j], best[j], f.params,
                            f.lights, f.num_lights, f.out, f.key, o,
                            f.plane);
  }
}

// The cell whose segment holds pair p < the list's end: the last cell
// with seg_start <= p (an empty cell before it shares its start). A 32-way
// search, four rounds over 49,152 cells.
__device__ __forceinline__ int find_cell(const int* seg_start, int num_cells,
                                         int p, int lane) {
  int lo = 0, len = num_cells;  // seg_start[lo] <= p throughout
  while (len > 1) {
    const int step = (len + 31) / 32;
    const int probe = lo + lane * step;
    const unsigned le =
        __ballot_sync(FULL, lane * step < len && seg_start[probe] <= p);
    const int k = 31 - __clz(le);  // lane 0's probe is lo: le != 0
    lo += k * step;
    len = min(step, len - k * step);
  }
  return lo;
}

// A span: pairs [lo, hi) of long cell `cell` (start s, count n), folded
// into the cell's words; the last span to arrive emits the cell.
template <int MODE>
__device__ __forceinline__ void fold_span(const Frame& f, int cell, int s, int n,
                                     int lo, int hi, float cov_min,
                                     float4* stage, int lane,
                                     unsigned long long* words,
                                     int* arrivals) {
  const Samples smp = cell_samples(cell, lane, f);
  uint32_t best[2] = {shade::KEY_CLEAR, shade::KEY_CLEAR};
  int winner[2] = {-1, -1};
  walk_range(f, lo, hi, smp, cov_min, stage, lane, best, winner);
  unsigned long long* w = words + (size_t)cell * 64;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (best[j] != shade::KEY_CLEAR)
      atomicMin(w + lane + 32 * j, ((unsigned long long)best[j] << 32) |
                                       (unsigned)winner[j]);
  __threadfence();
  __syncwarp();
  int arrived = 0;
  if (lane == 0) arrived = atomicAdd(arrivals + cell, 1);
  arrived = __shfl_sync(FULL, arrived, 0);
  const int spans = (s + n - 1) / SPAN - s / SPAN + 1;
  if (arrived != spans - 1) return;
  __threadfence();  // the other spans' words are complete
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const unsigned long long v = atomicExch(w + lane + 32 * j, WORD_CLEAR);
    best[j] = v == WORD_CLEAR ? shade::KEY_CLEAR : (uint32_t)(v >> 32);
    winner[j] = v == WORD_CLEAR ? -1 : (int)(uint32_t)v;
  }
  if (lane == 0) arrivals[cell] = 0;
  emit_cell<MODE>(f, smp, lane, best, winner);
}

// A short cell: its segment walked by one warp, then emitted.
template <int MODE>
__device__ __forceinline__ void walk_cell(const Frame& f, int c, int s, int n,
                                     float cov_min, float4* stage,
                                     int lane) {
  const Samples smp = cell_samples(c, lane, f);
  uint32_t best[2] = {shade::KEY_CLEAR, shade::KEY_CLEAR};
  int winner[2] = {-1, -1};
  walk_range(f, s, s + n, smp, cov_min, stage, lane, best, winner);
  emit_cell<MODE>(f, smp, lane, best, winner);
}

// Window h of the pair list: [h SPAN, (h + 1) SPAN) against the long
// cells it meets (at most two).
template <int MODE>
__device__ __forceinline__ void window(const Frame& f, int h,
                                       const int* seg_start,
                                       const int* seg_count, int num_cells,
                                       int end, float cov_min, float4* stage,
                                       int lane, unsigned long long* words,
                                       int* arrivals) {
  const int p0 = h * SPAN;
  if (p0 >= end) return;
  const int p1 = min(p0 + SPAN, end);
  int c = find_cell(seg_start, num_cells, p0, lane);
  int s = seg_start[c];
  int n = seg_count[c];
  if (n > SPAN && p0 < s + n)
    fold_span<MODE>(f, c, s, n, p0, min(p1, s + n), cov_min, stage, lane, words,
               arrivals);
  if (p1 <= s + n) return;
  c = find_cell(seg_start, num_cells, p1 - 1, lane);
  s = seg_start[c];
  n = seg_count[c];
  if (n > SPAN)
    fold_span<MODE>(f, c, s, n, s, p1, cov_min, stage, lane, words, arrivals);
}

// Two kinds of block, of sixteen warps each: the span blocks first (warp
// h of them takes window h), then one tile block per entry of the
// occupied-tile work list (warp c takes the tile's cell c).
template <int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) micro_kernel(
    Frame f,
    const int* __restrict__ seg_start,  // (num_cells,)
    const int* __restrict__ seg_count,  // (num_cells,)
    const int* __restrict__ worklist,   // (num_tiles,) occupied ids first
    const int* __restrict__ num_work,   // () occupied count
    unsigned long long* __restrict__ words,  // (num_cells, 64) all ones
    int* __restrict__ arrivals,              // (num_cells,) zeros
    int num_cells, int span_blocks) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* stage = smem + warp * STAGE;
  const float cov_min = shade::coverage_min(f.params[0], f.params[1]);
  if ((int)blockIdx.x < span_blocks) {
    const int end = seg_start[num_cells - 1] + seg_count[num_cells - 1];
    window<MODE>(f, blockIdx.x * CELLS + warp, seg_start, seg_count,
                 num_cells, end, cov_min, stage, lane, words, arrivals);
    return;
  }
  const int w = blockIdx.x - span_blocks;
  if (w >= *num_work) return;
  const int c = worklist[w] * CELLS + warp;
  const int n = seg_count[c];
  if (n <= SPAN)  // a longer cell is the windows' to walk and emit
    walk_cell<MODE>(f, c, seg_start[c], n, cov_min, stage, lane);
}

template <int MODE>
int launch(dim3 grid, cudaStream_t stream, const Frame& f,
           const int* seg_start, const int* seg_count, const int* worklist,
           const int* num_work, unsigned long long* words, int* arrivals,
           int num_cells, int span_blocks) {
  const cudaError_t e = cudaFuncSetAttribute(
      micro_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  micro_kernel<MODE><<<grid, THREADS, SMEM, stream>>>(
      f, seg_start, seg_count, worklist, num_work, words, arrivals,
      num_cells, span_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int raster_shade_micro(
    const void* table, const void* pair_tri, const void* seg_start,
    const void* seg_count, const void* worklist, const void* num_work,
    const void* params, const void* lights, void* out, void* key,
    void* words, void* arrivals, int mode, int row_stride, int num_tiles,
    int num_lights, int ntx, int width_padded, int pair_cap, void* stream) {
  if (row_stride % 4 != 0 || ((uintptr_t)table & 15) != 0)
    return (int)cudaErrorMisalignedAddress;  // rows stage as float4
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const Frame f = {(const float*)table, (const int*)pair_tri,
                   (const float*)params, (const float*)lights, out,
                   (uint32_t*)key, row_stride, num_lights, ntx,
                   width_padded, (size_t)num_tiles * 8 * 128};
  const int num_cells = num_tiles * CELLS;
  const int span_warps = (pair_cap + SPAN - 1) / SPAN;
  const int span_blocks = (span_warps + CELLS - 1) / CELLS;
  const dim3 grid(span_blocks + num_tiles);
  cudaStream_t s = (cudaStream_t)stream;
#define MICRO_ARGS                                                           \
  grid, s, f, (const int*)seg_start, (const int*)seg_count,                 \
      (const int*)worklist, (const int*)num_work,                           \
      (unsigned long long*)words, (int*)arrivals, num_cells, span_blocks
  switch (mode) {
    case shade::MODE_BASE:
      return launch<shade::MODE_BASE>(MICRO_ARGS);
    case shade::MODE_MAT:
      return launch<shade::MODE_MAT>(MICRO_ARGS);
    case shade::MODE_TEXF:
      return launch<shade::MODE_TEXF>(MICRO_ARGS);
    case shade::MODE_VIS:
      return launch<shade::MODE_VIS>(MICRO_ARGS);
    case shade::MODE_TEXF_MIP:
      return launch<shade::MODE_TEXF_MIP>(MICRO_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MICRO_ARGS
}

// Micro raster + shade of the mega-scene path: each 8x8 cell walks its own
// segment of the cell-sorted pair list; base, material, fused-texture
// (texf), visibility (vis) and mip-filtered texture (texf_mip) modes.
//
// Replaces the TPU kernel of the JAX package's backends/pallas_micro.py
// (_micro_kernel_wl with _raster_tile_micro, launched by
// raster_shade_micro; the full-grid _micro_kernel is this kernel fed an
// all-tiles work list).
//
// Two kinds of block in one launch, of WARPS warps each; a warp owns 64
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
//     launch, and writes the cell's pixels. A covered key is never
//     KEY_CLEAR (0xFFFFFFFF is a NaN pattern; covered z is finite), so a
//     word left at all ones means that no pair covers the pixel;
//   - tile blocks: PARTS per entry of the occupied-tile work list; an 8x128
//     tile is sixteen 8x8 cells side by side, and warp w of part p walks
//     cell p WARPS + w if its segment holds at most SPAN pairs, then writes
//     its pixels.
// A warp walks its range in pair order, CHUNK pairs a round,
// double-buffered: while round k is walked, round k+1's rows are in flight
// (cp.async of the four quads the walk reads, walk.cuh) and round k+2's
// pair ids are in registers. The coefficient rows are read in place at
// table[pair_tri[p]]: the P-sized pair stream the TPU kernel DMAs
// (pallas_micro.build_pair_coeffs) does not exist here.
//
// The walk of a round culls before it tests. Lane l culls row l against
// the cell's four 4x4 quadrants and its sixteen 2x2 quads, a quad kept
// only inside a kept quadrant (cull_quads: walk.cuh's exact rectangle
// test, may_cover's float sequence with no margin; each rectangle is the
// NaN-aware min and max of its own samples, so mirage's moved samples and
// a negative coverage bound stay exact). The kept quads of the round are
// listed in the warp's shared memory, row by row, and dealt out one a
// lane: its four samples are tested with walk_row's float sequence (three
// barycentrics and z as (A + B*dx) + C*dy, coverage min(bc) >=
// max(threshold, melt) with z finite, the u32 depth key), and a covered
// sample folds atomicMin((key << 32) | pair) into the cell's 64 words in
// shared memory: the (key, pair)-lexicographic minimum, the strict-<
// walk's winner. The path adapts to what the cull finds: a row that keeps
// more than WIDE quads (a triangle large against the cell: close-ups,
// voxelize) is walked warp-wide, each lane's two samples into a running
// minimum in registers, merged with the words at the end. A cell walked
// by one warp writes its pixels from its words; a span folds them into
// the global words as above. The kernel adds the samples it tested (64
// for a row walked warp-wide) into the frame's accumulator
// (frame_counts.cuh): one reduction a block, one 64-bit atomicAdd.
//
// The walk writes each pixel's key and its winner, the pair index or
// PAIR_IDX_CLEAR where the key stayed clear (pallas_micro.py:507-510,
// :624-629): vis mode's output. The other modes' epilogue is a second
// kernel, micro_kernel_shade, one thread a pixel of the occupied tiles:
// shade.cuh's emit_pixel (the tile raster's) evaluates the winner's
// attributes from its row table[pair_tri[pair]] and shades (base,
// material: kd at columns 32:35) or writes a G-buffer (texf, texf_mip).
// Only the cell's own 64 pixels are evaluated, so coverage outside a
// triangle's bbox (voxelize, mirage) clips to the 8x8 cell rectangles, as
// in the JAX package.
//
// What bounds it on an H100: before the cull every pair cost 64 coverage
// tests, whatever its size (0.0565 ms on San Miguel's 327,695 pairs).
// San Miguel's triangles are mostly sub-pixel: a third of its pairs cover
// a sample, and the exact cull keeps 1.48 quads a pair, 5.9 samples
// tested a pair in place of 64. The samples alone did not set the time:
// about 3,000 warps are resident at once and each round waits on its
// latency chain, so the cull paid only once a round's kept quads were
// dealt out evenly (a lane's own quads cost the warp the most any lane
// kept), and once the shading, a third of the time and as costly in a
// warp's last microseconds as anywhere, left the walk for a kernel of its
// own, where it runs on every lane of the card at once. Then 0.0456 ms
// (0.030 walk, 0.016 shading), 0.050-0.078 on the structured scene in
// every mode, 12-34% under the old kernel; a frame of few pairs a cell
// (Suzanne under mirage, 4,496 pairs) is slower, 0.011 against 0.0085 ms
// (PERF.md; scripts/compare_micro.py measured WARPS, SPAN and WIDE; a
// third staging buffer was slower).
// The grid is host-sized: PARTS blocks a tile plus pair_cap / SPAN span
// warps; tile blocks past the occupied count and span warps past the
// list's end exit at once (no host synchronisation), and the wrapper
// pre-clears the outputs and keeps the words, counters and winners.
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

constexpr int CELLS = 16;  // 8x8 cells per 8x128 tile
constexpr int WARPS = 4;   // warps a block: one cell (or window) each
constexpr int PARTS = CELLS / WARPS;  // blocks a tile
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 32;   // pairs staged per warp a round: one id a lane
constexpr int SPAN = 128;   // the longest range a warp walks
constexpr int WIDE = 4;     // rows keeping more quads are walked warp-wide
constexpr int STAGE = 2 * CHUNK * walk::QUADS;  // float4 per warp: 4 KB
static_assert(WIDE < 8, "a row's item count is counted in three ballots");
// Per warp: its staging buffers, the cell's 64 words (32 float4), its
// sample geometry (Cell, 8 float4) and a round's quad items (CHUNK * WIDE
// u16, 16 float4).
constexpr int WARP_QUADS = STAGE + 32 + 8 + CHUNK * WIDE * 2 / 16;
constexpr size_t SMEM = (size_t)WARPS * WARP_QUADS * sizeof(float4);
constexpr int MIN_BLOCKS = 32 / WARPS;  // resident blocks an SM: 64 registers
constexpr int SHADE_THREADS = 256;  // the epilogue's threads a block
constexpr int SHADE_PARTS = 8 * 128 / SHADE_THREADS;  // its blocks a tile
constexpr int PAIR_IDX_CLEAR = 0x7FFFFFFF;  // vis: no pair covers the pixel
constexpr unsigned long long WORD_CLEAR = ~0ull;
#define QNAN __int_as_float(0x7fc00000)
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

// A cell's sample geometry, in the warp's shared memory (16-byte
// aligned): for quad column (row) k, columns (rows) 2k and 2k + 1, the
// NaN-aware min and max of their x (y); then the columns' x and the rows'
// y (a sample's position is its column's x and its row's y, mirage
// included).
struct Cell {
  float xl[4], xh[4], yl[4], yh[4];
  float px[8], py[8];
};

__device__ __forceinline__ float4 quad4(const float* v) {
  return *reinterpret_cast<const float4*>(v);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Quad bit b = 4 qy + qx: the quad of sample columns 2 qx, 2 qx + 1 and
// rows 2 qy, 2 qy + 1. Quadrant h = 2 hy + hx holds quad columns 2 hx,
// 2 hx + 1 and rows 2 hy, 2 hy + 1.
__device__ __forceinline__ unsigned quadrant_bits(int h) {
  return 0x33u << (2 * (h & 1) + 8 * (h >> 1));
}

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

// Writes the cell's geometry and clears its words (the warp's shared
// memory; the warp's last walk has finished reading both).
__device__ __forceinline__ void cell_setup(const Samples& s, int lane,
                                           Cell* g,
                                           unsigned long long* words) {
  if (lane < 8) g->px[lane] = s.px;
  if ((lane & 7) == 0) {
    g->py[lane >> 3] = s.py[0];
    g->py[(lane >> 3) + 4] = s.py[1];
  }
  words[lane] = WORD_CLEAR;
  words[lane + 32] = WORD_CLEAR;
  __syncwarp();
  if (lane < 8) {
    const float* v = lane < 4 ? g->px : g->py;
    const int k = lane & 3;
    (lane < 4 ? g->xl : g->yl)[k] = fminf(v[2 * k], v[2 * k + 1]);
    (lane < 4 ? g->xh : g->yh)[k] = fmaxf(v[2 * k], v[2 * k + 1]);
  }
  __syncwarp();
}

// The quads of the cell that the staged row (a, b, c, d) may cover:
// walk::may_cover against each quadrant's rectangle and each quad's, a
// quad kept only inside a kept quadrant. The same test, float for float,
// with the products shared. Per barycentric plane and quad column k,
// A + max(B*dxl, B*dxh); per quad row, max(C*dyl, C*dyh); their sum is
// the plane's corner value over the quad, and a quadrant's is the sum of
// the max over its columns and the max over its rows (rounding is
// monotone, and a quadrant's dx bounds are its quads' extremes: fminf and
// fmaxf of their float differences, NaN-bounded quads dropped as their
// samples are by the rectangle). A rectangle is cut where the least of the
// planes' corner values is below cov_min: fminf drops a NaN value, and a
// non-finite plane gives NaN. A rectangle whose differences are not all
// finite is never cut.
__device__ __forceinline__ unsigned cull_quads(const float4& a,
                                               const float4& b,
                                               const float4& c,
                                               const float4& d, const Cell& g,
                                               float cov_min) {
  const float4 xl = quad4(g.xl), xh = quad4(g.xh), yl = quad4(g.yl),
               yh = quad4(g.yh);
  float dxl[4], dxh[4], dyl[4], dyh[4];
  unsigned fx = 0, fy = 0;  // bit k: quad column (row) k's are finite
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dxl[k] = comp(xl, k) - d.z;
    dxh[k] = comp(xh, k) - d.z;
    dyl[k] = comp(yl, k) - d.w;
    dyh[k] = comp(yh, k) - d.w;
    fx |= (unsigned)(isfinite(dxl[k]) && isfinite(dxh[k])) << k;
    fy |= (unsigned)(isfinite(dyl[k]) && isfinite(dyh[k])) << k;
  }
  unsigned fq = 0;  // bit h: quadrant h's are finite
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int hx = h & 1, hy = h >> 1;
    fq |= (unsigned)(isfinite(fminf(dxl[2 * hx], dxl[2 * hx + 1])) &&
                     isfinite(fmaxf(dxh[2 * hx], dxh[2 * hx + 1])) &&
                     isfinite(fminf(dyl[2 * hy], dyl[2 * hy + 1])) &&
                     isfinite(fmaxf(dyh[2 * hy], dyh[2 * hy + 1])))
          << h;
  }
  const float plane[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
  float AX[3][4], Y[3][4];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float A = plane[3 * p], B = plane[3 * p + 1], C = plane[3 * p + 2];
    const bool finite = isfinite(A) && isfinite(B) && isfinite(C);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      AX[p][k] = finite ? A + fmaxf(B * dxl[k], B * dxh[k]) : QNAN;
      Y[p][k] = fmaxf(C * dyl[k], C * dyh[k]);
    }
  }
  unsigned cut = 0;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int qx = q & 3, qy = q >> 2;
    float m = AX[0][qx] + Y[0][qy];
    m = fminf(m, AX[1][qx] + Y[1][qy]);
    m = fminf(m, AX[2][qx] + Y[2][qy]);
    if (m < cov_min) cut |= 1u << q;
  }
  cut &= (fx * 0x1111u) & ((fy & 1u ? 0x000Fu : 0u) | (fy & 2u ? 0x00F0u : 0u) |
                           (fy & 4u ? 0x0F00u : 0u) | (fy & 8u ? 0xF000u : 0u));
  unsigned keep = ~cut & 0xFFFFu;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int hx = h & 1, hy = h >> 1;
    float m = QNAN;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      m = fminf(m, fmaxf(AX[p][2 * hx], AX[p][2 * hx + 1]) +
                       fmaxf(Y[p][2 * hy], Y[p][2 * hy + 1]));
    if (m < cov_min && ((fq >> h) & 1u)) keep &= ~quadrant_bits(h);
  }
  return keep;
}

// The four samples of quad `q` against the staged row, walk_row's float
// sequence; each covered sample folds (key, pair `id`) into its word.
__device__ __forceinline__ void test_quad(const float4* row, int q,
                                          const Cell& g, float cov_min,
                                          int id,
                                          unsigned long long* words) {
  const float4 a = row[0], b = row[1], c = row[2], d = row[3];
  const int col = 2 * (q & 3), r0 = 2 * (q >> 2);
  const float2 px = reinterpret_cast<const float2*>(g.px)[q & 3];
  const float2 py = reinterpret_cast<const float2*>(g.py)[q >> 2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float dx = (i ? px.y : px.x) - d.z;
    const float s1 = a.x + a.y * dx;
    const float s2 = a.w + b.x * dx;
    const float s3 = b.z + b.w * dx;
    const float sz = c.y + c.z * dx;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float dy = (j ? py.y : py.x) - d.w;
      const float bc1 = s1 + a.z * dy;
      const float bc2 = s2 + b.y * dy;
      const float bc3 = s3 + c.x * dy;
      const float z = sz + c.w * dy;
      if ((bc1 >= cov_min) && (bc2 >= cov_min) && (bc3 >= cov_min) &&
          isfinite(z))
        atomicMin(words + (r0 + j) * 8 + col + i,
                  ((unsigned long long)__float_as_uint(z) << 32) |
                      (unsigned)id);
    }
  }
}

// Walks pairs [lo, hi) of the list for the cell: the rows kept warp-wide
// into the lane's best / winner (absolute pair indices), the other rows'
// kept quads into the cell's words, through the warp's two staging
// buffers. Returns the samples the lane's rows had tested.
__device__ __forceinline__ int walk_range(const Frame& f, int lo, int hi,
                                          const Samples& s, const Cell& g,
                                          unsigned long long* words,
                                          float cov_min, float4* stage,
                                          int lane, uint32_t best[2],
                                          int winner[2]) {
  unsigned short* items =
      reinterpret_cast<unsigned short*>(stage + STAGE + 32 + 8);
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

  int tested = 0;
  const int rounds = (n + CHUNK - 1) / CHUNK;
  issue(0, pair_id(0));
  int next = pair_id(1);
  for (int c = 0; c < rounds; ++c) {
    issue(c + 1, next);  // an empty group past the last round
    next = pair_id(c + 2);
    walk::cp_async_wait<1>();
    __syncwarp();  // every lane's copies of round c landed
    const float4* rows = stage + (c & 1) * CHUNK * QUADS;
    const int base = lo + c * CHUNK;
    // Lane l culls row l of the round (a lane past the range keeps none).
    const float4* own = rows + lane * QUADS;
    const unsigned mask =
        lane < n - c * CHUNK
            ? cull_quads(own[0], own[1], own[2], own[3], g, cov_min)
            : 0u;
    const int kept = __popc(mask);
    const bool wide = kept > WIDE;
    tested += wide ? 64 : 4 * kept;
    for (unsigned w = __ballot_sync(FULL, wide); w != 0; w &= w - 1) {
      const int k = __ffs(w) - 1;
      walk::walk_row(rows + k * QUADS, s.px, s.py, cov_min, base + k, best,
                     winner);
    }
    // The narrow rows' quads, listed (row << 4 | quad) in lane order, then
    // dealt out one a lane: a lane's first item is the count of the lanes
    // below it, summed bit by bit over three ballots.
    const int count = wide ? 0 : kept;
    const unsigned below = (1u << lane) - 1u;
    int start = 0, total = 0;
#pragma unroll
    for (int bit = 0; bit < 3; ++bit) {
      const unsigned v = __ballot_sync(FULL, (count >> bit) & 1);
      start += __popc(v & below) << bit;
      total += __popc(v) << bit;
    }
    for (unsigned m = wide ? 0u : mask; m != 0; m &= m - 1)
      items[start++] = (unsigned short)((lane << 4) | (__ffs(m) - 1));
    __syncwarp();
    for (int i = lane; i < total; i += 32) {
      const int item = items[i];
      test_quad(rows + (item >> 4) * QUADS, item & 15, g, cov_min,
                base + (item >> 4), words);
    }
    __syncwarp();  // round c is consumed before its buffer is refilled
  }
  return tested;
}

// The lane's two pixels: the running minimum of the rows walked warp-wide
// merged with the cell's words (the other rows' fold).
__device__ __forceinline__ void merge_words(const unsigned long long* words,
                                            int lane, uint32_t best[2],
                                            int winner[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const unsigned long long mine =
        best[j] == shade::KEY_CLEAR
            ? WORD_CLEAR
            : ((unsigned long long)best[j] << 32) | (unsigned)winner[j];
    const unsigned long long v = min(mine, words[lane + 32 * j]);
    best[j] = v == WORD_CLEAR ? shade::KEY_CLEAR : (uint32_t)(v >> 32);
    winner[j] = v == WORD_CLEAR ? -1 : (int)(uint32_t)v;
  }
}

// Writes the lane's two pixels of the cell from best / winner (pair
// indices, -1 for none): the key, and the winner into f.out (vis mode's
// output, or the pair ids micro_kernel_shade reads), PAIR_IDX_CLEAR where
// the key stayed clear.
__device__ __forceinline__ void emit_cell(const Frame& f, const Samples& s,
                                          int lane, const uint32_t best[2],
                                          const int winner[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t o = (size_t)(s.ti * 8 + (lane >> 3) + 4 * j) *
                         f.width_padded +
                     (size_t)(s.tj * 128 + s.c * 8 + (lane & 7));
    const int id = winner[j] < 0 ? PAIR_IDX_CLEAR : winner[j];
    shade::emit_pixel<shade::MODE_VIS>(nullptr, id, s.px, s.py[j], best[j],
                                       f.params, f.lights, f.num_lights,
                                       f.out, f.key, o, f.plane);
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
// into the cell's global words; the last span to arrive emits the cell.
// Returns the samples the lane's rows tested.
__device__ __forceinline__ int fold_span(const Frame& f, int cell, int s,
                                         int n, int lo, int hi,
                                         float cov_min, float4* stage,
                                         int lane, unsigned long long* words,
                                         int* arrivals) {
  const Samples smp = cell_samples(cell, lane, f);
  Cell* g = reinterpret_cast<Cell*>(stage + STAGE + 32);
  unsigned long long* mine = reinterpret_cast<unsigned long long*>(stage +
                                                                   STAGE);
  cell_setup(smp, lane, g, mine);
  uint32_t best[2] = {shade::KEY_CLEAR, shade::KEY_CLEAR};
  int winner[2] = {-1, -1};
  const int tested = walk_range(f, lo, hi, smp, *g, mine, cov_min, stage,
                                lane, best, winner);
  merge_words(mine, lane, best, winner);
  __syncwarp();  // the words are read before the warp's next cell clears
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
  if (arrived != spans - 1) return tested;
  __threadfence();  // the other spans' words are complete
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const unsigned long long v = atomicExch(w + lane + 32 * j, WORD_CLEAR);
    best[j] = v == WORD_CLEAR ? shade::KEY_CLEAR : (uint32_t)(v >> 32);
    winner[j] = v == WORD_CLEAR ? -1 : (int)(uint32_t)v;
  }
  if (lane == 0) arrivals[cell] = 0;
  emit_cell(f, smp, lane, best, winner);
  return tested;
}

// A short cell: its segment walked by one warp, then emitted. Returns the
// samples the lane's rows tested.
__device__ __forceinline__ int walk_cell(const Frame& f, int c, int s, int n,
                                         float cov_min, float4* stage,
                                         int lane) {
  const Samples smp = cell_samples(c, lane, f);
  Cell* g = reinterpret_cast<Cell*>(stage + STAGE + 32);
  unsigned long long* words = reinterpret_cast<unsigned long long*>(stage +
                                                                    STAGE);
  cell_setup(smp, lane, g, words);
  uint32_t best[2] = {shade::KEY_CLEAR, shade::KEY_CLEAR};
  int winner[2] = {-1, -1};
  const int tested = walk_range(f, s, s + n, smp, *g, words, cov_min, stage,
                                lane, best, winner);
  merge_words(words, lane, best, winner);
  emit_cell(f, smp, lane, best, winner);
  return tested;
}

// Window h of the pair list: [h SPAN, (h + 1) SPAN) against the long
// cells it meets (at most two). Returns the samples the lane's rows tested.
__device__ __forceinline__ int window(const Frame& f, int h,
                                      const int* seg_start,
                                      const int* seg_count, int num_cells,
                                      int end, float cov_min, float4* stage,
                                      int lane, unsigned long long* words,
                                      int* arrivals) {
  const int p0 = h * SPAN;
  if (p0 >= end) return 0;
  const int p1 = min(p0 + SPAN, end);
  int tested = 0;
  int c = find_cell(seg_start, num_cells, p0, lane);
  int s = seg_start[c];
  int n = seg_count[c];
  if (n > SPAN && p0 < s + n)
    tested += fold_span(f, c, s, n, p0, min(p1, s + n), cov_min, stage,
                              lane, words, arrivals);
  if (p1 <= s + n) return tested;
  c = find_cell(seg_start, num_cells, p1 - 1, lane);
  s = seg_start[c];
  n = seg_count[c];
  if (n > SPAN)
    tested += fold_span(f, c, s, n, s, p1, cov_min, stage, lane, words,
                              arrivals);
  return tested;
}

// Two kinds of block, of WARPS warps each: the span blocks first (warp w
// of block b takes window b WARPS + w), then PARTS tile blocks per entry
// of the occupied-tile work list (warp w of part p takes the tile's cell
// p WARPS + w). A non-null acc (frame_counts.cuh) gains the samples the
// block tested.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) micro_kernel(
    Frame f,
    const int* __restrict__ seg_start,  // (num_cells,)
    const int* __restrict__ seg_count,  // (num_cells,)
    const int* __restrict__ worklist,   // (num_tiles,) occupied ids first
    const int* __restrict__ num_work,   // () occupied count
    unsigned long long* __restrict__ words,  // (num_cells, 64) all ones
    int* __restrict__ arrivals,              // (num_cells,) zeros
    long long* __restrict__ acc,             // (8,) or null
    int num_cells, int span_blocks) {
  extern __shared__ float4 smem[];
  __shared__ int block_tested[WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* stage = smem + warp * WARP_QUADS;
  const float cov_min = shade::coverage_min(f.params[0], f.params[1]);
  int tested = 0;
  if ((int)blockIdx.x < span_blocks) {
    const int end = seg_start[num_cells - 1] + seg_count[num_cells - 1];
    tested = window(f, blockIdx.x * WARPS + warp, seg_start, seg_count,
                          num_cells, end, cov_min, stage, lane, words,
                          arrivals);
  } else {
    const int w = ((int)blockIdx.x - span_blocks) / PARTS;
    if (w >= *num_work) return;  // the whole block
    const int c = worklist[w] * CELLS +
                  ((int)blockIdx.x - span_blocks) % PARTS * WARPS + warp;
    const int n = seg_count[c];
    if (n <= SPAN)  // a longer cell is the windows' to walk and emit
      tested = walk_cell(f, c, seg_start[c], n, cov_min, stage, lane);
  }
  if (acc == nullptr) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) tested += __shfl_xor_sync(FULL, tested, o);
  if (lane == 0) block_tested[warp] = tested;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long sum = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) sum += block_tested[k];
    if (sum != 0)
      atomicAdd((unsigned long long*)&acc[4], (unsigned long long)sum);
  }
}

// The epilogue of the shaded and G-buffer modes, one thread a pixel of the
// occupied tiles (SHADE_PARTS blocks a tile): the walk left each pixel's
// key and winning pair; the winner's attributes are evaluated from its row
// table[pair_tri[pair]] at the pixel's sample, placed as cell_samples
// places it, and shaded (base, material: kd at columns 32:35) or written
// to the G-buffer (texf, texf_mip) by shade.cuh's emit_pixel, the tile
// raster's. Pixels no pair covers keep the wrapper's cleared key and
// outputs: the background RGBA, or G-buffer planes left unwritten, which
// are undefined where the key is clear and which every reader masks.
template <int MODE>
__global__ void __launch_bounds__(SHADE_THREADS) micro_kernel_shade(
    Frame f,
    const int* __restrict__ ids,       // (Hp, Wp) the walk's winners
    const int* __restrict__ worklist,  // (num_tiles,) occupied ids first
    const int* __restrict__ num_work) {
  const int w = blockIdx.x / SHADE_PARTS;
  if (w >= *num_work) return;
  const int tile = worklist[w];
  const int p = (blockIdx.x % SHADE_PARTS) * SHADE_THREADS + threadIdx.x;
  const int ti = tile / f.ntx;
  const int tj = tile - ti * f.ntx;
  const int r = p >> 7;                // row of the 8x128 tile
  const int x = tj * 128 + (p & 127);  // frame column
  const size_t o = (size_t)(ti * 8 + r) * f.width_padded + x;
  const uint32_t best = f.key[o];
  if (best == shade::KEY_CLEAR) return;
  const int id = ids[o];
  const float* params = f.params;
  const bool mirage = params[2] > 0.5f;
  const float amplitude = params[3];
  const float frequency = params[4];
  const float phase = params[5];
  const float time = params[6];
  const float y0 = (float)(ti * 8) + params[7];
  const float xs = (float)(x & 7) + (float)(x & ~7);
  const float ys = (float)r + y0;
  const float px =
      mirage ? xs + amplitude * sinf(frequency * xs + time + phase) : xs;
  const float py =
      mirage ? ys + amplitude * cosf(frequency * ys + time + phase) : ys;
  shade::emit_pixel<MODE>(f.table + (size_t)f.pair_tri[id] * f.row_stride, id,
                          px, py, best, params, f.lights, f.num_lights, f.out,
                          f.key, o, f.plane);
}

// The walk into (key, winner) — vis mode's output, or the pair ids — and,
// in the other modes, the epilogue after it.
template <int MODE>
int launch(int num_tiles, int span_blocks, cudaStream_t stream,
           const Frame& f, const int* seg_start, const int* seg_count,
           const int* worklist, const int* num_work,
           unsigned long long* words, int* arrivals, int* ids,
           long long* acc, int num_cells) {
  const cudaError_t e = cudaFuncSetAttribute(
      micro_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  Frame walk = f;
  if constexpr (MODE != shade::MODE_VIS) walk.out = ids;
  micro_kernel<<<span_blocks + num_tiles * PARTS, THREADS, SMEM, stream>>>(
      walk, seg_start, seg_count, worklist, num_work, words, arrivals, acc,
      num_cells, span_blocks);
  if constexpr (MODE != shade::MODE_VIS)
    micro_kernel_shade<MODE><<<num_tiles * SHADE_PARTS, SHADE_THREADS, 0,
                               stream>>>(f, ids, worklist, num_work);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int raster_shade_micro(
    const void* table, const void* pair_tri, const void* seg_start,
    const void* seg_count, const void* worklist, const void* num_work,
    const void* params, const void* lights, void* out, void* key,
    void* words, void* arrivals, void* ids, void* acc, int mode,
    int row_stride, int num_tiles, int num_lights, int ntx, int width_padded,
    int pair_cap, void* stream) {
  if (row_stride % 4 != 0 || ((uintptr_t)table & 15) != 0)
    return (int)cudaErrorMisalignedAddress;  // rows stage as float4
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const Frame f = {(const float*)table, (const int*)pair_tri,
                   (const float*)params, (const float*)lights, out,
                   (uint32_t*)key, row_stride, num_lights, ntx,
                   width_padded, (size_t)num_tiles * 8 * 128};
  const int num_cells = num_tiles * CELLS;
  const int span_warps = (pair_cap + SPAN - 1) / SPAN;
  const int span_blocks = (span_warps + WARPS - 1) / WARPS;
  cudaStream_t s = (cudaStream_t)stream;
#define MICRO_ARGS                                                          \
  num_tiles, span_blocks, s, f, (const int*)seg_start,                     \
      (const int*)seg_count, (const int*)worklist, (const int*)num_work,   \
      (unsigned long long*)words, (int*)arrivals, (int*)ids,               \
      (long long*)acc, num_cells
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

// Raster + shade over the occupied framebuffer tiles (tile path), in the
// base, material, fused-texture (texf), visibility (vis, deferred
// texturing) and mip-filtered texture (texf_mip) modes.
//
// Replaces the TPU kernel of the JAX package's backends/pallas_raster.py
// (_raster_kernel_wl with _raster_tile, launched by raster_shade_tiles;
// the full-grid _raster_kernel is this kernel fed an all-tiles list).
//
// A block's unit of work is one (tile, span, sub-rectangle). A tile is cut
// into sub-rectangles of four 8x8 patches (16x16 in a tile of a multiple
// of 16 rows, 8x32 in an 8-row tile, so that every patch lies in the
// tile), one block each; the blocks own disjoint pixels. Warp w < 4 of a
// block's eight owns patch w, two pixels a lane in one column, for the
// culls; all eight walk and emit. A tile's list — row `tile` of the dense
// bin_rows, or pair_tri[seg_start : seg_start + seg_count] of the flat
// list — of at most TILE_SPAN triangles (tile_span.cuh) is walked whole
// by its blocks. In the flat layout, whose span list the bin sort writes
// (sort.cu), a longer list is cut into spans of TILE_SPAN list positions,
// one block a (span, sub-rectangle): span 0 is the work-list block's, and
// span k >= 1 that of its entry in the span list (whose blocks come first
// in the grid); the dense layout's lists are short by its own rule and
// are always walked whole. A block
// walks its positions CHUNK triangles a round, double-buffered: while
// round k is walked, round k+1's rows are in flight (cp.async of the four
// quads the walk reads, walk.cuh) and round k+2's ids are in registers.
// Each round:
//   1. one thread per staged triangle tests it against the block's sample
//      rectangle (walk::may_cover: a barycentric plane below cov_min at
//      the rectangle's highest corner, evaluated with the walk's own float
//      operations, so exactly); the survivors are compacted in list order
//      with ballots and popcounts;
//   2. each warp lists, in order, the survivors that may cover its patch;
//   3. the lists, patch after patch, are cut into one equal range a warp,
//      so that a patch crowded with small triangles is walked by all the
//      block's warps: per triangle and pixel the barycentrics and z as
//      (A + B*dx) + C*dy, the coverage test, the u32 depth key and a
//      strict-< running minimum in registers that remembers the list
//      position; where a warp's range leaves a patch, it folds each
//      pixel's minimum into the pixel's shared 64-bit word,
//      atomicMin((key << 32) | position) — the (key, position)-
//      lexicographic minimum is the sequential walk's winner (the lowest
//      list position wins ties).
// A span's positions are the tile list's own, so a span block folds its
// words into the pixels' global words (common.merge_scratch, a word a
// pixel of the tile, tile by tile) by the same 64-bit atomicMin, fences,
// and ticks the (tile, sub-rectangle)'s
// counter; the last of the tile's spans to arrive takes the merged words
// back with atomicExch (restoring them and the counter to clear for the
// next launch) and emits: the minimum over the spans is the minimum over
// the list, the sequential walk's winner, so the output is bitwise the
// whole walk's. A culled triangle covers no sample of the block or patch,
// so it could never have won: the output is the unculled walk's, bitwise.
// The epilogue reads each pixel's word, takes the winner's table row from
// the list, and (shade.cuh emit_pixel) evaluates its attributes and
// shades (base, material) or writes the G-buffer (texf, texf_mip); in vis
// mode it writes the table row itself (-1 where no triangle covers).
// Empty tiles never launch work: the wrapper pre-clears the outputs
// (background, -1 ids, cleared key), the JAX package's aliased-clear
// semantics; a G-buffer's planes are left unwritten there, undefined
// where the key is clear.
//
// What bounds it on an H100: by the roofline, bytes (the walked columns of
// each binned triangle, the winners' rows and the outputs;
// chip_smoke.py raster_bound: 0.0022-0.0148 ms on structured_scene_tex by
// mode). In practice, chains of dependent loads and barriers: a block
// stages, culls and walks its rounds one after another. With each list
// walked whole by 16x16 blocks, the heaviest tile's chain set the time (at
// 16x256 on structured_scene_tex that tile alone took 0.088 of the
// kernel's 0.094 ms), and at 8x128 half of every block lay outside its
// tile. On the structured_tex_aniso cell's frame (texf_mip, 8x128,
// longest list 1,163) that kernel took 0.0455 ms; lists cut to 256 alone
// gave 0.0410 and 8x32 blocks alone 0.0492 (the heavy chain twice as long
// a block). Spans with 8x32 blocks take 0.034-0.037, and cutting the lists
// to 256 or leaving out the four heaviest tiles no longer changes that
// (0.0320-0.0334): the blocks' own chains over about three waves of
// resident blocks set the time (one triangle a tile: 0.0137; no tile:
// 0.0041). Of the 8-row blocks 8x32 measured best (8x16 0.0462, 8x64
// 0.0444, 4 warps 0.0504-0.0522), and spans of 256 beat 512 (0.0462)
// (scripts/sweep_raster_constants.py --probe and --short; NVIDIA H100
// 80GB HBM3, 700 W; PERF.md). 16x16 blocks of eight warps measured best
// of eight shapes on 16-row tiles: 0.0476 ms on structured_scene_tex
// (mat), 0.0695 with each list walked whole. The grid has no host-side
// size: it is (ceil(pair_cap / TILE_SPAN) + num_tiles) x
// sub-rectangles blocks, the most spans and tiles there can be, and a
// block exits when its unit is past the span list's count and the
// occupied count, both on the device (no host synchronisation per
// frame); those blocks are the grid's last.
//
// Exactness: built with -fmad=false and without fast math, so each
// (A + B*dx) + C*dy is two roundings as in the eager torch twin. Coverage
// is (bc1>=t)&(bc2>=t)&(bc3>=t), which fails for a NaN barycentric exactly
// as the JAX min-then-compare does (fminf would drop the NaN and let
// degenerate triangles cover pixels). Keys are __float_as_uint(z) compared
// unsigned, so -0.0 keys as 0x80000000.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "shade.cuh"
#include "tile_span.cuh"
#include "walk.cuh"

namespace {

// A block's sub-rectangle of its tile: four 8x8 patches, 16x16 in a tile of
// a multiple of 16 rows, else 8x32 (an 8-row tile), so that every patch
// warp owns pixels. Two instantiations; the launcher picks by tile_h.
constexpr int SUB_H_TALL = 16;
constexpr int SUB_W_TALL = 16;
constexpr int SUB_H_SHORT = 8;
constexpr int SUB_W_SHORT = 32;
constexpr int PATCH = 8;  // a warp's patch: 8x8 pixels, two a lane
constexpr int WARPS = 8;  // warp w < PATCHES owns patch w; all walk
constexpr int THREADS = 32 * WARPS;
// Triangles staged a round, at most one a thread.
constexpr int CHUNK = THREADS < 256 ? THREADS : 256;
static_assert(TILE_SPAN % CHUNK == 0, "a span is whole rounds");
constexpr int MIN_BLOCKS = 4;  // resident blocks an SM: caps the registers
constexpr int MAX_TILE_PIXELS = 4096;
constexpr uint32_t KEY_CLEAR = shade::KEY_CLEAR;
constexpr unsigned long long WORD_CLEAR = ~0ull;
using walk::FULL;
using walk::QUADS;

template <int MODE, int SUB_H, int SUB_W>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) raster_kernel(
    const float* __restrict__ table,    // (T, row_stride) f32 rows
    const int* __restrict__ pair_data,  // dense (num_tiles, list_stride) | flat
    const int* __restrict__ seg_start,  // (num_tiles,)
    const int* __restrict__ seg_count,  // (num_tiles,)
    const int* __restrict__ worklist,   // (num_tiles,) occupied ids first
    const int* __restrict__ num_work,   // () occupied count
    const float* __restrict__ params,   // (11,) raster.shading_inputs
    const float* __restrict__ lights,   // (L, 8)
    void* __restrict__ out,             // (Hp, Wp) u32 | i32 | (C, Hp, Wp) f32
    uint32_t* __restrict__ key,         // (Hp, Wp)
    const int* __restrict__ spans,      // flat: [count, (tile, k) ...]
    unsigned long long* merge,          // flat: (Hp Wp,) all ones
    int* arrivals,                      // flat: (>= num_tiles nsub,) zeros
    int row_stride, int num_lights, int ntx, int tile_h, int tile_w,
    int width_padded, size_t plane, int dense, int list_stride, int nsx,
    int nsub) {
  constexpr int PATCHES_X = SUB_W / PATCH;
  constexpr int PATCHES = (SUB_H / PATCH) * PATCHES_X;
  static_assert(PATCHES <= WARPS, "a patch a warp at most");
  __shared__ float4 rows[2][CHUNK * QUADS];  // 32 KB
  // Per pixel of the block, patch-major: (key << 32) | list position.
  __shared__ unsigned long long words[PATCHES * 64];
  __shared__ int survivors[CHUNK];  // staged slots, in list order
  __shared__ unsigned short items[PATCHES][CHUNK];  // per patch: slots
  __shared__ int item_counts[PATCHES];
  __shared__ int warp_survivors[WARPS];
  __shared__ walk::Rect warp_rects[PATCHES];
  __shared__ float sample_x[PATCHES][PATCH];  // per patch: px of a column,
  __shared__ float sample_y[PATCHES][PATCH];  // py of a row
  __shared__ int last_span;

  // The block's unit of work: (tile, span, sub-rectangle). Unit u =
  // blockIdx.x / nsub: the span list's entries first (span k >= 1 of a
  // long list), then the work list's tiles (the whole list, or span 0 of
  // a long one); the blocks past both exit, at the end of the grid.
  const int u = blockIdx.x / nsub;
  const int sub = blockIdx.x - u * nsub;
  const int span_units = spans != nullptr ? spans[0] : 0;
  int tile, lo = 0;
  bool split;
  if (u < span_units) {
    tile = spans[1 + 2 * u];
    lo = spans[2 + 2 * u] * TILE_SPAN;
    split = true;
  } else {
    if (u - span_units >= *num_work) return;
    tile = worklist[u - span_units];
    split = !dense && seg_count[tile] > TILE_SPAN;  // span 0
  }
  const int count = seg_count[tile];
  const int n = split ? min(TILE_SPAN, count - lo) : count;  // walked
  const int* list = dense ? pair_data + (size_t)tile * list_stride
                          : pair_data + seg_start[tile];
  const int ti = tile / ntx;
  const int tj = tile - ti * ntx;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sy = sub / nsx;
  const int r0 = sy * SUB_H + (warp / PATCHES_X) * PATCH + (lane >> 3);
  const int col = (sub - sy * nsx) * SUB_W + (warp % PATCHES_X) * PATCH +
                  (lane & 7);

  const float cov_min = shade::coverage_min(params[0], params[1]);
  const bool mirage = params[2] > 0.5f;
  const float amplitude = params[3];
  const float frequency = params[4];
  const float phase = params[5];
  const float time = params[6];
  const float y0 = (float)(ti * tile_h) + params[7];
  const float x0 = (float)(tj * tile_w);

  // Pixel j of this lane (in its warp's patch): tile row r0 + 4 j, tile
  // column col (its samples share px). Rows and columns past the tile are
  // not emitted.
  const float xs = (float)col + x0;
  const float px =
      mirage ? xs + amplitude * sinf(frequency * xs + time + phase) : xs;
  float py[2];
  bool valid[2];
  const float nan = __int_as_float(0x7fc00000);
  walk::Rect rect = {nan, nan, nan, nan};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = r0 + 4 * j;
    const float ys = (float)r + y0;
    py[j] = mirage ? ys + amplitude * cosf(frequency * ys + time + phase)
                   : ys;
    valid[j] = warp < PATCHES && r < tile_h && col < tile_w;
    if (valid[j]) {
      rect.x0 = fminf(rect.x0, px);
      rect.x1 = fmaxf(rect.x1, px);
      rect.y0 = fminf(rect.y0, py[j]);
      rect.y1 = fmaxf(rect.y1, py[j]);
    }
  }
  const walk::Rect patch = walk::warp_rect(rect);
  const bool active = __any_sync(FULL, valid[0] || valid[1]);
  if (warp < PATCHES) {
#pragma unroll
    for (int j = 0; j < 2; ++j) words[warp * 64 + lane + 32 * j] = WORD_CLEAR;
    if (lane < PATCH) sample_x[warp][lane] = px;
    if ((lane & 7) == 0) {
      sample_y[warp][lane >> 3] = py[0];
      sample_y[warp][(lane >> 3) + 4] = py[1];
    }
    if (lane == 0) warp_rects[warp] = patch;
  }
  __syncthreads();
  walk::Rect block = warp_rects[0];
  for (int k = 1; k < PATCHES; ++k) {
    const walk::Rect o = warp_rects[k];
    block = {fminf(block.x0, o.x0), fmaxf(block.x1, o.x1),
             fminf(block.y0, o.y0), fmaxf(block.y1, o.y1)};
  }

  // Stages round c's rows into buffer c & 1: this thread's row is `id`.
  const float4* table4 = reinterpret_cast<const float4*>(table);
  const int row_quads = row_stride / 4;
  auto stage = [&](int c, int id) {
    if ((int)threadIdx.x < CHUNK && c * CHUNK + (int)threadIdx.x < n) {
#pragma unroll
      for (int q = 0; q < QUADS; ++q)
        walk::cp_async16(&rows[c & 1][threadIdx.x * QUADS + q],
                         table4 + (size_t)id * row_quads + walk::table_quad(q));
    }
    walk::cp_async_commit();
  };
  auto list_id = [&](int c) {
    const int i = c * CHUNK + threadIdx.x;
    return (int)threadIdx.x < CHUNK && i < n ? list[lo + i] : 0;
  };

  const int rounds = (n + CHUNK - 1) / CHUNK;
  stage(0, list_id(0));
  int next_id = list_id(1);
  for (int c = 0; c < rounds; ++c) {
    const int m = min(CHUNK, n - c * CHUNK);
    stage(c + 1, next_id);  // an empty group past the last round
    next_id = list_id(c + 2);
    walk::cp_async_wait<1>();  // this thread's copies of round c landed
    __syncthreads();  // and every thread's

    // 1. The block's cull, compacted in list order.
    const float4* staged = rows[c & 1];
    const bool keep = (int)threadIdx.x < m &&
                      walk::may_cover(staged + threadIdx.x * QUADS, block,
                                      cov_min);
    const unsigned ballot = __ballot_sync(FULL, keep);
    if (lane == 0) warp_survivors[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int k = 0; k < WARPS; ++k) {
      before += k < warp ? warp_survivors[k] : 0;
      total += warp_survivors[k];
    }
    if (keep)
      survivors[before + __popc(ballot & ((1u << lane) - 1u))] = threadIdx.x;
    __syncthreads();

    // 2. Each warp lists, in order, the survivors that may cover its patch.
    int listed = 0;
    if (active) {
      for (int g = 0; g < total; g += 32) {
        const int i = g + lane;
        const bool mine =
            i < total &&
            walk::may_cover(staged + survivors[i] * QUADS, patch, cov_min);
        const unsigned mask = __ballot_sync(FULL, mine);
        if (mine)
          items[warp][listed + __popc(mask & ((1u << lane) - 1u))] =
              (unsigned short)survivors[i];
        listed += __popc(mask);
      }
    }
    if (lane == 0 && warp < PATCHES) item_counts[warp] = listed;
    __syncthreads();

    // 3. The lists, patch after patch, cut into WARPS equal ranges: each
    // warp walks its range in order, keeps each pixel's (key, position)
    // minimum in registers, and folds it into the pixel's word when its
    // range moves to the next patch and at its end.
    int n_items = 0;
    for (int k = 0; k < PATCHES; ++k) n_items += item_counts[k];
    const int ilo = warp * n_items / WARPS;
    const int ihi = (warp + 1) * n_items / WARPS;
    if (ilo < ihi) {
      int p = 0, first = 0;  // the patch of item i, and its first item
      while (first + item_counts[p] <= ilo) first += item_counts[p++];
      float qx = sample_x[p][lane & 7];
      float qy[2] = {sample_y[p][lane >> 3], sample_y[p][(lane >> 3) + 4]};
      uint32_t best[2] = {KEY_CLEAR, KEY_CLEAR};
      int at[2] = {-1, -1};  // list positions
      auto fold = [&]() {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (best[j] != KEY_CLEAR)
            atomicMin(&words[p * 64 + lane + 32 * j],
                      ((unsigned long long)best[j] << 32) | (unsigned)at[j]);
          best[j] = KEY_CLEAR;
          at[j] = -1;
        }
      };
      for (int i = ilo; i < ihi; ++i) {
        if (i == first + item_counts[p]) {
          fold();
          do first += item_counts[p++]; while (i >= first + item_counts[p]);
          qx = sample_x[p][lane & 7];
          qy[0] = sample_y[p][lane >> 3];
          qy[1] = sample_y[p][(lane >> 3) + 4];
        }
        const int slot = items[p][i - first];
        walk::walk_row(staged + slot * QUADS, qx, qy, cov_min,
                       lo + c * CHUNK + slot, best, at);
      }
      fold();
    }
    __syncthreads();  // round c is consumed before its buffer is refilled
  }

  // --- epilogue (shade.cuh): resolve the winner's row, shade or emit ------
  // Every warp emits: e = warp, warp + WARPS, ... below 2 PATCHES is the
  // half j = e / PATCHES (pixels lane + 32 j) of patch p = e % PATCHES,
  // at its samples as staged in shared memory. Pixels past the tile are
  // not emitted.
  const int sub_r0 = sy * SUB_H;
  const int sub_c0 = (sub - sy * nsx) * SUB_W;
  auto locate = [&](int e, int& p, int& j, int& r, int& cl) {
    p = e % PATCHES;
    j = e / PATCHES;
    r = sub_r0 + (p / PATCHES_X) * PATCH + (lane >> 3) + 4 * j;
    cl = sub_c0 + (p % PATCHES_X) * PATCH + (lane & 7);
    return r < tile_h && cl < tile_w;
  };
  auto emit = [&](int p, int j, int r, int cl, unsigned long long v) {
    const uint32_t best = v == WORD_CLEAR ? KEY_CLEAR : (uint32_t)(v >> 32);
    const int winner = v == WORD_CLEAR ? -1 : list[(uint32_t)v];
    const size_t o = (size_t)(ti * tile_h + r) * width_padded +
                     (size_t)(tj * tile_w + cl);
    const float* row =
        winner < 0 ? nullptr : table + (size_t)winner * row_stride;
    shade::emit_pixel<MODE>(row, winner, sample_x[p][lane & 7],
                            sample_y[p][(lane >> 3) + 4 * j], best, params,
                            lights, num_lights, out, key, o, plane);
  };
  if (!split) {
    for (int e = warp; e < 2 * PATCHES; e += WARPS) {
      int p, j, r, cl;
      if (locate(e, p, j, r, cl))
        emit(p, j, r, cl, words[p * 64 + lane + 32 * j]);
    }
    return;
  }
  // A span: its words fold into the pixels' global words (a word a pixel
  // of the tile, the tiles one after another: any tile shape fits the
  // padded frame's words) by the same 64-bit minimum; the last of the
  // tile's spans to arrive at the sub-rectangle's counter takes the words
  // back, restores them and the counter to clear, and emits.
  auto global_word = [&](int r, int cl) {
    return merge + (size_t)tile * tile_h * tile_w + r * tile_w + cl;
  };
  for (int e = warp; e < 2 * PATCHES; e += WARPS) {
    int p, j, r, cl;
    if (!locate(e, p, j, r, cl)) continue;
    const unsigned long long v = words[p * 64 + lane + 32 * j];
    if (v != WORD_CLEAR) atomicMin(global_word(r, cl), v);
  }
  __threadfence();
  __syncthreads();
  int* counter = arrivals + (size_t)tile * nsub + sub;
  if (threadIdx.x == 0)
    last_span = atomicAdd(counter, 1) == (count - 1) / TILE_SPAN;
  __syncthreads();
  if (!last_span) return;
  __threadfence();  // the other spans' words are complete
  for (int e = warp; e < 2 * PATCHES; e += WARPS) {
    int p, j, r, cl;
    if (locate(e, p, j, r, cl))
      emit(p, j, r, cl, atomicExch(global_word(r, cl), WORD_CLEAR));
  }
  if (threadIdx.x == 0) *counter = 0;
}

struct Args {
  const float* table;
  const int *pair_data, *seg_start, *seg_count, *worklist, *num_work;
  const float *params, *lights;
  void* out;
  uint32_t* key;
  const int* spans;
  unsigned long long* merge;
  int* arrivals;
  int row_stride, num_lights, ntx, tile_h, tile_w, width_padded;
  size_t plane;
  int dense, list_stride, num_tiles, span_slots;
};

// One launch of the (SUB_H, SUB_W) instantiation in `mode`: a block per
// (unit, sub-rectangle), span_slots + num_tiles units at most.
template <int SUB_H, int SUB_W>
int launch(int mode, const Args& a, cudaStream_t s) {
  const int nsx = (a.tile_w + SUB_W - 1) / SUB_W;
  const int nsub = nsx * ((a.tile_h + SUB_H - 1) / SUB_H);
  const unsigned grid = (unsigned)(a.span_slots + a.num_tiles) * nsub;
#define RASTER_ARGS                                                          \
  a.table, a.pair_data, a.seg_start, a.seg_count, a.worklist, a.num_work,   \
      a.params, a.lights, a.out, a.key, a.spans, a.merge, a.arrivals,       \
      a.row_stride, a.num_lights, a.ntx, a.tile_h, a.tile_w,                \
      a.width_padded, a.plane, a.dense, a.list_stride, nsx, nsub
  switch (mode) {
    case shade::MODE_BASE:
      raster_kernel<shade::MODE_BASE, SUB_H, SUB_W><<<grid, THREADS, 0, s>>>(
          RASTER_ARGS);
      break;
    case shade::MODE_MAT:
      raster_kernel<shade::MODE_MAT, SUB_H, SUB_W><<<grid, THREADS, 0, s>>>(
          RASTER_ARGS);
      break;
    case shade::MODE_TEXF:
      raster_kernel<shade::MODE_TEXF, SUB_H, SUB_W><<<grid, THREADS, 0, s>>>(
          RASTER_ARGS);
      break;
    case shade::MODE_VIS:
      raster_kernel<shade::MODE_VIS, SUB_H, SUB_W><<<grid, THREADS, 0, s>>>(
          RASTER_ARGS);
      break;
    case shade::MODE_TEXF_MIP:
      raster_kernel<shade::MODE_TEXF_MIP, SUB_H, SUB_W>
          <<<grid, THREADS, 0, s>>>(RASTER_ARGS);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RASTER_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// spans: the flat layout's span list (1 + 2 span_slots ints: the count,
// then (tile, k) for each span k >= 1 of a list longer than TILE_SPAN;
// sort.cu, binning.span_list_plain), null with the dense layout; merge
// and arrivals (common.merge_scratch of the padded frame) likewise, and
// left clear.
extern "C" int raster_shade_tiles(
    const void* table, const void* pair_data, const void* seg_start,
    const void* seg_count, const void* worklist, const void* num_work,
    const void* params, const void* lights, void* out, void* key,
    const void* spans, void* merge, void* arrivals, int mode, int row_stride,
    int num_tiles, int num_lights, int ntx, int tile_h, int tile_w,
    int width_padded, int dense, int list_stride, int span_slots,
    void* stream) {
  if (tile_h * tile_w > MAX_TILE_PIXELS) return (int)cudaErrorInvalidValue;
  if (row_stride % 4 != 0 || ((uintptr_t)table & 15) != 0)
    return (int)cudaErrorMisalignedAddress;  // rows stage as float4
  const bool flat = !dense;
  if ((spans != nullptr) != flat || (merge != nullptr) != flat ||
      (arrivals != nullptr) != flat || (flat && span_slots <= 0))
    return (int)cudaErrorInvalidValue;  // the flat layout's spans alone
  if (num_tiles <= 0) return (int)cudaGetLastError();
  const Args a = {(const float*)table, (const int*)pair_data,
                  (const int*)seg_start, (const int*)seg_count,
                  (const int*)worklist, (const int*)num_work,
                  (const float*)params, (const float*)lights, out,
                  (uint32_t*)key, (const int*)spans,
                  (unsigned long long*)merge, (int*)arrivals, row_stride,
                  num_lights, ntx, tile_h, tile_w, width_padded,
                  (size_t)num_tiles * tile_h * tile_w, dense, list_stride,
                  num_tiles, flat ? span_slots : 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (tile_h % SUB_H_TALL == 0)
    return launch<SUB_H_TALL, SUB_W_TALL>(mode, a, s);
  return launch<SUB_H_SHORT, SUB_W_SHORT>(mode, a, s);
}

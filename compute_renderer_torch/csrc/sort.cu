// The stable bin sort of a pair list, with its segments and work list: the
// micro path's (8x8 cell, triangle) pairs and the tile path's flat layout
// of (tile, triangle) pairs.
//
// Replaces what the JAX package leaves to XLA inside its compiled step:
// backends/binning.py bin_cells_sort_meta (lax.sort of the cell ids
// carrying the triangle ids, then segments_from_sorted_cells) with
// pallas_micro.py occupied_worklist, and the sort and segments of
// binning.py bin_triangles_sort (lax.sort, two searchsorted, the exact
// corner-scatter counts under pair overflow) with pallas_raster.py
// occupied_worklist.
//
// Input: keys (pair_cap,) — the bin of each pair slot — and tris
// (pair_cap,), whose first n = min(total, pair_cap) slots are valid and in
// triangle order (expand.cu's contract; keys past n are the num_bins
// sentinel and are not read). Output, equal to the twin's
// (binning.bin_sort_plain):
// - pair_tri: on [0, n) the triangle ids in (bin, triangle) order — what
//   tris[torch.sort(keys, stable=True).indices] gives there; [n, pair_cap)
//   is not written;
// - seg_start (num_bins,): the exclusive scan of the bins' counts (the
//   left searchsorted of each bin in the sorted keys); seg_count: the
//   counts, clamped to cap;
// - group 16 (the micro layout, 16 cells a tile): tile_count, each tile's
//   16 counts summed, and win_start, the 16-aligned base of each tile's
//   first segment;
// - worklist (num_bins / group,): the ascending ids of the tiles whose
//   (clamped) count is above 0, padded with 0;
// - spans (group 1, when asked for: the flat tile layout's, which the
//   tile raster reads): [count, then count (bin, k) pairs], one for each
//   span k >= 1 of a bin whose clamped count is above TILE_SPAN
//   (tile_span.cuh), in bin order, zeros past them (write_bin: the spans
//   are scanned as the pairs are, over a third look-back word a tile);
// - scal = [pair_needed, tile_needed, total, k, most]: pair_needed is
//   total where it exceeds pair_cap, most the largest count (exact under
//   pair overflow: with the flat layout's rects given, counted over every
//   rect rather than the capped list), tile_needed most where it exceeds
//   cap, k the work list's length. (scal[0], scal[1]) is the frame's
//   overflow report; with an accumulator given, the same thread folds
//   scal into it (frame_counts.cuh).
//
// What bounds it on an H100: memory, and at a frame's few hundred
// thousand pairs the latency of its steps. The function must read each
// valid slot's key and triangle (8 B) and write its triangle (4 B), and
// write each bin's 8 B of segments and each tile's work-list entry: San
// Miguel's 327,695 pairs over 12,288 cells are about 4 MB, 1.2 us at
// 3.35 TB/s.
//
// Design: a stable counting sort, so that the order the pairs arrive in
// (triangle order) is kept rather than thrown away and rebuilt. A pair at
// slot p of bin b goes to seg_start[b] + (the pairs of bin b in slots
// before p): that is the stable sort's order by construction. The slots
// are cut into chunks of CHUNK (binning.SORT_CHUNK) and counted in table
// chunks of 1, 2 or 4 chunks (the fewest that keep the (table chunk,
// bin) table within TABLE_CELLS). Three launches in series, every one
// capturable (a memset and five before this design):
// 1. bin_sort_hist_kernel (a block a table chunk): the range [lo, hi] of
//    the table chunk's bins and its count of each bin of the range
//    (shared-memory atomics), written to its row of the table — only the
//    range, which triangle order keeps narrow; it also clears the scan's
//    look-back words (and the flat layout's exact counts and span list),
//    so that no memset is needed.
// 2. bin_sort_scan_kernel (a block a tile of SCAN_TILE bins, SCAN_GROUPS
//    threads a bin, each over a range of the table chunks): the bins'
//    counts (a row outside its range reads as 0), each bin's column
//    rewritten in place within the rows' ranges as its pairs in the table
//    chunks before; the pairs and occupied tiles before the tile by a
//    decoupled look-back over the tiles (single-pass scan; persistent
//    blocks, at most one an SM, take the tiles in order; the span list's
//    entries by a second one, in an instantiation of its own); then
//    seg_start, seg_count, the group extras, the work list and the span
//    entries; the last tile writes scal, the work list's padding and the
//    span count. Under pair overflow of the flat layout every block first
//    walks its share of the alive rects into the exact counts.
// 3. bin_sort_place_kernel (a block a chunk): the chunk sorted stably by
//    bin in shared memory — a least-significant-digit radix sort over the
//    bits of its hi - lo + 1, one or two passes of up to 8 bits, each
//    pass ranked with __match_any_sync within a warp's step, a running
//    count per (digit, warp) and an exclusive scan of the counts — then
//    each bin's base staged in shared memory (seg_start, plus the row of
//    its table chunk, plus its pairs among the table chunk's slots ahead
//    of the chunk, counted there) and each pair written at its bin's base
//    plus its rank among the chunk's pairs of that bin.
// A one-launch variant for the flat layout's short lists (a block a
// chunk, the blocks meeting at a counter between the steps) was built and
// measured no faster than these three launches (PERF.md), and dropped.
// No step sorts a segment, so the longest segment (7,113 pairs on
// structured_scene.obj) costs what any pairs cost.
//
// State: the look-back words (and the exact counts) are cleared by the
// first launch of each call; the ranges and the table are written before
// they are read; all are scratch the wrapper allocates for each call, so
// two calls in flight share nothing. Nothing reads back to the host.
//
// Exactness: integer arithmetic only; the rect walk of the exact counts
// uses c / max(rx, 1) rows as setup_from_meta does.

#include <cuda_runtime.h>

#include "frame_counts.cuh"
#include "tile_span.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 2048;                // binning.SORT_CHUNK
constexpr int THREADS = 256;               // bin_sort_place_kernel
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = CHUNK / THREADS;     // slots a thread in a chunk
// A table chunk is 1, 2 or 4 chunks (binning.sort_table_chunk): the
// fewest that keep the (table chunk, bin) table within TABLE_CELLS.
constexpr int MAX_FACTOR = 4;              // binning.SORT_MAX_FACTOR
constexpr int TABLE_CELLS = 1 << 21;       // binning.SORT_TABLE_CELLS
constexpr int HIST_THREADS = 1024;         // bin_sort_hist_kernel
constexpr int HIST_ITEMS = CHUNK * MAX_FACTOR / HIST_THREADS;
// Bins of a chunk's bases a place block stages in shared memory at once.
constexpr int BASE_STAGE = 8192;
constexpr int SCAN_TILE = 128;             // bins a scan block (16 | it)
constexpr int SCAN_THREADS = 1024;         // bin_sort_scan_kernel
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_GROUPS = SCAN_THREADS / SCAN_TILE;  // chunk ranges
constexpr int MAX_DIGITS = 256;            // 8 bits a radix pass
constexpr int HIST_WINDOW = 16384;         // bins a pass of the count
// The table chunks' ranges a scan block stages in shared memory.
constexpr int RANGE_STAGE = 1024;
// A sorted chunk's arrays in shared memory hold slot q at pad(q), one pad
// word every 32, so that a thread's ITEMS consecutive slots sit on
// distinct banks across a warp.
constexpr int PADDED = CHUNK + CHUNK / 32;
__host__ __device__ constexpr int pad(int q) { return q + (q >> 5); }
// The (digit, warp) counts of a radix pass sit at warp (digits + 1) +
// digit: a warp's leaders (distinct digits) hit distinct banks.
__host__ __device__ constexpr int cnt_at(int d, int w, int digits) {
  return w * (digits + 1) + d;
}
constexpr int CNT_WORDS = WARPS * (MAX_DIGITS + 1);
// Dynamic shared memory of the place kernel: the chunk's keys, triangles
// and places, the (digit, warp) counts, the warps' scan totals, the
// chunk's range and the staged bases.
constexpr int SORT_SMEM = (3 * PADDED + CNT_WORDS + WARPS + 2 + BASE_STAGE)
                          * 4;

// Inclusive warp scan of v.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The valid slots: min(total, pair_cap), at least 0.
__device__ __forceinline__ int valid_slots(const int* total, int pair_cap) {
  return max(min(*total, pair_cap), 0);
}

// A slot's bin, or -1 past the valid slots or out of range.
__device__ __forceinline__ int bin_of(const int* keys, int p, int n,
                                      int num_bins) {
  const int b = p < n ? keys[p] : -1;
  return (unsigned)b < (unsigned)num_bins ? b : -1;
}

// Pair overflow of the flat layout: the list holds only the first pair_cap
// pairs, and the retry needs every tile's whole count. Triangles t0,
// t0 + stride, ... below T each add one to every tile of their rect
// [x0, x0 + rx) x [y0, y0 + c / max(rx, 1)), clipped to the grid.
__device__ void walk_rects(const int* c, const int* rx, const int* x0,
                           const int* y0, int* exact, int T, int t0,
                           int stride, int num_bins, int ntx) {
  const int nty = num_bins / ntx;
  for (int t = t0; t < T; t += stride) {
    const int ct = c[t];
    if (ct <= 0) continue;
    const int w = rx[t], tx = x0[t], ty = y0[t];
    const int h = ct / max(w, 1);
    const int xa = max(tx, 0), xb = min(tx + w, ntx);
    const int ya = max(ty, 0), yb = min(ty + h, nty);
    for (int yy = ya; yy < yb; ++yy)
      for (int xx = xa; xx < xb; ++xx) atomicAdd(&exact[yy * ntx + xx], 1);
  }
}

// ---------------------------------------------------------------------------
// One block's scan of NT consecutive bins (a thread a bin)
// ---------------------------------------------------------------------------

struct BinScan {
  int start;     // the bin's pairs before it within the block's bins
  int occ_at;    // the occupied tiles before its tile within them
  int sum16;     // group 16: its tile's count
  bool occ;      // group 1: the bin; group 16: its tile, on its first bin
  int pairs;     // the block's bins' pairs
  int occupied;  // ... and occupied tiles
  int most;      // ... and largest count
};

// s_red: 3 * (NT / 32) ints. Every thread of the block calls it; cnt is 0
// for a thread past num_bins (a whole tile of 16 lies in or out).
template <int NT>
__device__ BinScan scan_bins(int cnt, int group, int cap, int* s_red) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  BinScan r;
  r.sum16 = cnt;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    r.sum16 += __shfl_xor_sync(FULL, r.sum16, o);
  const int occ = group == 16 ? ((lane & 15) == 0 && min(r.sum16, cap) > 0)
                              : min(cnt, cap) > 0;
  r.occ = occ;
  const int incl = warp_scan(cnt, lane), incl_occ = warp_scan(occ, lane);
  const int most = warp_max(cnt);
  if (lane == 31) {
    s_red[warp] = incl;
    s_red[NW + warp] = incl_occ;
  }
  if (lane == 0) s_red[2 * NW + warp] = most;
  __syncthreads();
  if (warp == 0) {
    const bool w = lane < NW;
    const int v = w ? s_red[lane] : 0, vo = w ? s_red[NW + lane] : 0;
    const int iv = warp_scan(v, lane), io = warp_scan(vo, lane);
    const int m = warp_max(w ? s_red[2 * NW + lane] : 0);
    __syncwarp();
    if (w) {
      s_red[lane] = iv - v;
      s_red[NW + lane] = io - vo;
    }
    if (lane == 31) {
      s_red[2 * NW] = iv;        // the block's pairs
      s_red[2 * NW + 1] = io;    // ... occupied tiles
      s_red[2 * NW + 2] = m;     // ... largest count
    }
  }
  __syncthreads();
  r.start = s_red[warp] + incl - cnt;
  r.occ_at = s_red[NW + warp] + incl_occ - occ;
  r.pairs = s_red[2 * NW];
  r.occupied = s_red[2 * NW + 1];
  r.most = s_red[2 * NW + 2];
  __syncthreads();  // s_red is rewritten by the next call
  return r;
}

// Bin b's outputs, its segment starting at start and its work-list entry
// (if any) at occ_at. With a span list (the flat tile layout), a bin whose
// clamped count c is above TILE_SPAN writes (b, k) for its spans k = 1 ..
// (c - 1) / TILE_SPAN at entries span_at, span_at + 1, ... of the list: the
// spans of the bins before it (scanned as the pairs are), so the entries
// lie in bin order.
__device__ __forceinline__ void write_bin(
    int b, int cnt, int start, int occ_at, const BinScan& r, int group,
    int cap, int* seg_start, int* seg_count, int* tile_count,
    int* win_start, int* worklist, int* spans, int span_at) {
  seg_start[b] = start;
  seg_count[b] = min(cnt, cap);
  if (spans != nullptr) {
    int* at = spans + 1 + 2 * span_at;
    for (int k = 1; k * TILE_SPAN < min(cnt, cap); ++k) {
      at[2 * k - 2] = b;
      at[2 * k - 1] = k;
    }
  }
  if (group == 16) {
    if ((b & 15) == 0) {
      tile_count[b >> 4] = r.sum16;
      win_start[b >> 4] = (start >> 4) << 4;  // start >= 0
    }
  }
  if (r.occ) worklist[occ_at] = group == 16 ? b >> 4 : b;
}

// The look-back word of a tile: a flag (1: the tile's own sums, 2: the
// sums of every tile up to it) over 31 bits of occupied tiles and 31 bits
// of pairs (each below 2^31: pairs <= pair_cap, tiles <= num_bins). A
// tile's largest count goes in a second word, flag 1; with a span list, its
// spans in a third (look_back).
__device__ __forceinline__ unsigned long long pack(unsigned long long flag,
                                                   int occ, int pairs) {
  return flag << 62 | (unsigned long long)occ << 31 | (unsigned)pairs;
}

// scal, the work list's padding and the span list's count, once the
// totals are known, and scal and the spans folded into acc; every thread
// of the block calls it.
__device__ void write_totals(const int* total, int pair_cap, int cap,
                             int most, int k, int num_tiles, int* worklist,
                             int* scal, int* spans, int span_count,
                             long long* acc) {
  for (int i = k + threadIdx.x; i < num_tiles; i += blockDim.x)
    worklist[i] = 0;
  if (threadIdx.x == 0) {
    const int all_pairs = *total;
    const bool over = all_pairs > pair_cap;
    scal[0] = over ? all_pairs : 0;
    scal[1] = most > cap ? most : 0;
    scal[2] = all_pairs;
    scal[3] = k;
    scal[4] = most;
    if (spans != nullptr) spans[0] = span_count;
    fold_counts(acc, scal[0], scal[1], all_pairs, k, most, span_count);
  }
}

// Exclusive scan of v over the block's threads (a thread a bin, in
// order), and the block's total; s: SCAN_WARPS + 1 ints. Every thread of
// the block calls it.
__device__ int block_scan(int v, int* s, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_scan(v, lane);
  if (lane == 31) s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < SCAN_WARPS ? s[lane] : 0;
    const int iw = warp_scan(w, lane);
    __syncwarp();
    if (lane < SCAN_WARPS) s[lane] = iw - w;
    if (lane == 31) s[SCAN_WARPS] = iw;
  }
  __syncthreads();
  const int out = s[warp] + incl - v;
  total = s[SCAN_WARPS];
  __syncthreads();  // s is rewritten by the next call
  return out;
}

// Decoupled look-back over one 31-bit sum a tile (a flag over the value,
// pack): warp `lane`s publish the tile's own sum, wait for and add the own
// sums of the tiles before it back to the nearest whose inclusive sum is
// out, and publish the inclusive sum. Returns the sum before the tile.
__device__ int look_back(unsigned long long* words, int tile, int own,
                         int lane) {
  if (lane == 0)
    *(volatile unsigned long long*)&words[tile] =
        pack(tile == 0 ? 2 : 1, 0, own);
  int before = 0;
  for (int j = tile - 1; j >= 0; j -= 32) {
    const int at = j - lane;
    unsigned long long w = pack(2, 0, 0);  // before tile 0: nothing
    if (at >= 0) {
      do {
        w = *(volatile unsigned long long*)&words[at];
      } while ((w >> 62) == 0);
    }
    const unsigned done = __ballot_sync(FULL, (w >> 62) == 2);
    const int stop = done ? __ffs(done) - 1 : 31;
    int v = lane <= stop ? (int)(w & 0x7fffffffu) : 0;
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) v += __shfl_xor_sync(FULL, v, sh);
    before += v;
    if (done) break;
  }
  if (lane == 0 && tile > 0)
    *(volatile unsigned long long*)&words[tile] = pack(2, 0, before + own);
  return before;
}

// ---------------------------------------------------------------------------
// The stable sort of one chunk in shared memory, and its placement
// ---------------------------------------------------------------------------

// Exclusive scan in place of the (digit, warp) counts in (digit, warp)
// order, THREADS threads, each a run of consecutive entries; s_warp:
// WARPS ints.
__device__ void scan_counts(unsigned* a, int digits, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = digits * WARPS;
  const int per = (len + THREADS - 1) / THREADS;
  const int i0 = threadIdx.x * per, i1 = min(i0 + per, len);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += a[cnt_at(i / WARPS, i % WARPS, digits)];
  const int incl = warp_scan(sum, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < WARPS ? s_warp[lane] : 0;
    const int iv = warp_scan(v, lane);
    __syncwarp();
    if (lane < WARPS) s_warp[lane] = iv - v;
  }
  __syncthreads();
  int run = s_warp[warp] + incl - sum;
  for (int i = i0; i < i1; ++i) {
    unsigned* at = &a[cnt_at(i / WARPS, i % WARPS, digits)];
    const unsigned x = *at;
    *at = run;
    run += x;
  }
}

// Sorts the chunk's m slots (keys[0, m), vals[0, m)) stably by key into
// s_key / s_val (slot q at pad(q), q < CHUNK), the keys rebased to lo: a
// key outside [lo, lo + span), and the CHUNK - m slots past the chunk,
// become span and sort last. LSD radix passes of D <= 8 bits over the
// bits of span; slot p of a pass is item (p / 32) % ITEMS of lane p % 32
// of warp p / (32 ITEMS), so that a warp's items in order, then the warps
// in order, are the slots in order, and the counts scanned in (digit,
// warp) order give each digit's run of a warp its place. Every thread of
// the block calls it; it ends synced.
__device__ void sort_chunk(const int* keys, const int* vals, int m, int lo,
                           int span, int* s_key, int* s_val,
                           unsigned* s_cnt, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int bits = 32 - __clz(span);  // span itself fits
  const int passes = (bits + 7) / 8;
  const int D = (bits + passes - 1) / passes;
  const int mask = (1 << D) - 1;
  const int digits = 1 << D;
  int k[ITEMS], v[ITEMS], r[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int p = (warp * ITEMS + i) * 32 + lane;
    const int key = (p < m ? keys[p] : lo - 1) - lo;
    k[i] = (unsigned)key < (unsigned)span ? key : span;
    v[i] = p < m ? vals[p] : 0;
  }
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * D;
    if (pass > 0) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int p = pad((warp * ITEMS + i) * 32 + lane);
        k[i] = s_key[p];
        v[i] = s_val[p];
      }
    }
    for (int i = threadIdx.x; i < WARPS * (digits + 1); i += THREADS)
      s_cnt[i] = 0;
    __syncthreads();  // also: every load above is done before the stores
    unsigned run[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      run[i] = __match_any_sync(FULL, (k[i] >> shift) & mask);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int leader = __ffs(run[i]) - 1;
      unsigned old = 0;
      if (lane == leader) {
        unsigned* at = &s_cnt[cnt_at((k[i] >> shift) & mask, warp, digits)];
        old = *at;
        *at = old + __popc(run[i]);
      }
      old = __shfl_sync(FULL, old, leader);
      r[i] = old + __popc(run[i] & below);
      __syncwarp();
    }
    __syncthreads();
    scan_counts(s_cnt, digits, s_warp);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int d = (k[i] >> shift) & mask;
      const int at = pad(s_cnt[cnt_at(d, warp, digits)] + r[i]);
      s_key[at] = k[i];
      s_val[at] = v[i];
    }
    __syncthreads();
  }
}

// Places the sorted chunk: slot q of rebased key b < span goes to
// out[base(b) + q - (the first slot of b's run)], through s_pos so that a
// warp's stores are of consecutive slots. base(b) is bin lo + b's segment
// start, plus its pairs in the table chunks before (row[lo + b]), plus
// its pairs among the before slots of its table chunk ahead of this
// chunk (prior[0, before)), staged in s_base BASE_STAGE bins at a time
// and read at the runs' starts. A thread
// walks ITEMS consecutive slots for the runs, carrying in the start of
// the run its first slot lies in (an exclusive max-scan over the block of
// each thread's last run start). Every thread of the block calls it.
__device__ void place_chunk(const int* s_key, const int* s_val, int* s_pos,
                            int* s_warp, int* s_base, int lo, int span,
                            const int* seg_start, const int* row,
                            const int* prior, int before, int* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = threadIdx.x * ITEMS;
  int key[ITEMS], at[ITEMS];
  bool start[ITEMS];
  int last = -1;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int q = q0 + j;
    key[j] = s_key[pad(q)];
    start[j] = q == 0 || s_key[pad(q - 1)] != key[j];
    if (start[j]) last = q;
    at[j] = 0;
  }
  int incl = last;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = max(incl, up);
  }
  if (lane == 31) s_warp[warp] = incl;
  // The bases of the runs that start in the thread's slots (and of the
  // run its first slot lies in).
  for (int w0 = 0; w0 < span; w0 += BASE_STAGE) {
    const int len = min(BASE_STAGE, span - w0);
    for (int i = threadIdx.x; i < len; i += THREADS)
      s_base[i] =
          __ldcg(&seg_start[lo + w0 + i]) + __ldcg(&row[lo + w0 + i]);
    __syncthreads();
    for (int p0 = 0; p0 < before; p0 += 16 * THREADS) {
      int k[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int p = p0 + u * THREADS + threadIdx.x;
        k[u] = p < before ? prior[p] - lo - w0 : -1;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if ((unsigned)k[u] < (unsigned)len) atomicAdd(&s_base[k[u]], 1);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if ((start[j] || j == 0) && (unsigned)(key[j] - w0) < (unsigned)len)
        at[j] = s_base[key[j] - w0];
    __syncthreads();  // s_base is rewritten by the next window
  }
  if (warp == 0) {
    const int v = lane < WARPS ? s_warp[lane] : -1;
    int iv = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(FULL, iv, o);
      if (lane >= o) iv = max(iv, up);
    }
    const int ex = __shfl_up_sync(FULL, iv, 1);
    __syncwarp();
    if (lane < WARPS) s_warp[lane] = lane == 0 ? -1 : ex;
  }
  __syncthreads();
  const int ex_lane = __shfl_up_sync(FULL, incl, 1);
  int first = max(s_warp[warp], lane == 0 ? -1 : ex_lane);
  int from = at[0];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int q = q0 + j;
    if (start[j]) {
      first = q;
      from = at[j];
    }
    s_pos[pad(q)] = key[j] < span ? from + (q - first) : -1;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < CHUNK; q += THREADS) {
    const int to = s_pos[pad(q)];
    if (to >= 0) out[to] = s_val[pad(q)];
  }
}

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(HIST_THREADS) bin_sort_hist_kernel(
    const int* __restrict__ keys, const int* __restrict__ total,
    int* __restrict__ ranges,   // (chunks, 2): [lo, hi] of each chunk
    int* __restrict__ table,    // (chunks, num_bins)
    int* __restrict__ clear,    // the scan's scratch, clear_len ints
    int clear_len, int pair_cap, int num_bins, int tchunk) {
  extern __shared__ int s_hist[];  // min(HIST_WINDOW, num_bins) bins
  __shared__ int s_range[2];
  for (int i = blockIdx.x * HIST_THREADS + threadIdx.x; i < clear_len;
       i += gridDim.x * HIST_THREADS)
    clear[i] = 0;
  const int n = valid_slots(total, pair_cap);
  const int c0 = blockIdx.x * tchunk;
  if (c0 >= n) return;  // the scan reads no row past the valid chunks
  const int lane = threadIdx.x & 31;
  const int m = min(tchunk, n - c0);
  if (threadIdx.x == 0) {
    s_range[0] = num_bins;
    s_range[1] = -1;
  }
  int b[HIST_ITEMS];
  int lo = num_bins, hi = -1;
#pragma unroll
  for (int i = 0; i < HIST_ITEMS; ++i) {
    b[i] = bin_of(keys + c0, i * HIST_THREADS + threadIdx.x, m, num_bins);
    if (b[i] >= 0) {
      lo = min(lo, b[i]);
      hi = max(hi, b[i]);
    }
  }
  lo = -warp_max(-lo);
  hi = warp_max(hi);
  __syncthreads();  // s_range is set
  if (lane == 0) {
    atomicMin(&s_range[0], lo);
    atomicMax(&s_range[1], hi);
  }
  __syncthreads();
  lo = s_range[0];
  hi = s_range[1];
  if (threadIdx.x == 0) {
    ranges[2 * blockIdx.x] = lo;
    ranges[2 * blockIdx.x + 1] = hi;
  }
  __syncthreads();  // every thread has the range before s_hist is cleared
  // The table chunk's counts over [lo, hi], HIST_WINDOW bins at a time.
  int* row = table + (size_t)blockIdx.x * num_bins;
  for (int w0 = lo; w0 <= hi; w0 += HIST_WINDOW) {
    const int len = min(HIST_WINDOW, hi + 1 - w0);
    for (int i = threadIdx.x; i < len; i += HIST_THREADS) s_hist[i] = 0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < HIST_ITEMS; ++i)
      if ((unsigned)(b[i] - w0) < (unsigned)len)
        atomicAdd(&s_hist[b[i] - w0], 1);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += HIST_THREADS)
      row[w0 + i] = s_hist[i];
    __syncthreads();  // s_hist is cleared for the next window
  }
}

// Whether bin b lies in table chunk c's range.
__device__ __forceinline__ bool in_range(const int* ranges, int c, int b) {
  return b >= ranges[2 * c] && b <= ranges[2 * c + 1];
}

// One tile of the scan: thread (g, i) is bin i of the tile over the g-th
// range of the valid table chunks; SPANS: with the span list (the flat
// tile layout), compiled out of the other layouts. Called by every thread
// of the block.
template <bool SPANS>
__device__ void scan_tile(
    int tile, int ntiles, int* table, const int* ranges, const int* total,
    const int* c, const int* rx, const int* x0, const int* y0, int* exact,
    unsigned long long* status, int* seg_start, int* seg_count,
    int* tile_count, int* win_start, int* worklist, int* spans, int* scal,
    long long* acc, int T, int pair_cap, int num_bins, int group, int cap,
    int ntx, int tchunk,
    int (*s_part)[SCAN_TILE], int* s_red, int* s_before, int* s_ranges,
    int* s_spans) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = valid_slots(total, pair_cap);
  const int nc = (n + tchunk - 1) / tchunk;
  const int i = threadIdx.x % SCAN_TILE, g = threadIdx.x / SCAN_TILE;
  const int b = tile * SCAN_TILE + i;
  const bool live = b < num_bins;
  const int per = (nc + SCAN_GROUPS - 1) / SCAN_GROUPS;
  const int c_lo = min(g * per, nc), c_hi = min(c_lo + per, nc);
  int* col = table + b;
  // The first 16 cells of the range, loaded beside the ranges (a cell
  // outside its chunk's range is read but counts 0).
  int first[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    first[j] = live && c_lo + j < c_hi ? col[(size_t)(c_lo + j) * num_bins]
                                       : 0;
  if (nc <= RANGE_STAGE) {
    for (int j = threadIdx.x; j < 2 * nc; j += SCAN_THREADS)
      s_ranges[j] = ranges[j];
    ranges = s_ranges;
  }
  __syncthreads();
  unsigned hit = 0;  // the first 16 cells' chunks whose range holds b
  int part = 0;
  if (live) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (c_lo + j < c_hi && in_range(ranges, c_lo + j, b)) {
        hit |= 1u << j;
        part += first[j];
      }
    for (int c0 = c_lo + 16; c0 < c_hi; ++c0)
      if (in_range(ranges, c0, b)) part += col[(size_t)c0 * num_bins];
  }
  s_part[g][i] = part;
  __syncthreads();
  int run = 0, cnt = 0;
  for (int h = 0; h < SCAN_GROUPS; ++h) {
    if (h < g) run += s_part[h][i];
    cnt += s_part[h][i];
  }
  // The bin's column, in place: within each chunk's range, the bin's
  // pairs in the table chunks before (its base there less its segment
  // start).
  if (live) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (hit >> j & 1) {
        col[(size_t)(c_lo + j) * num_bins] = run;
        run += first[j];
      }
    for (int c0 = c_lo + 16; c0 < c_hi; ++c0)
      if (in_range(ranges, c0, b)) {
        int* at = &col[(size_t)c0 * num_bins];
        const int v = *at;
        *at = run;
        run += v;
      }
  }
  // The first range's threads carry the tile's bins into the scan.
  const bool in = g == 0 && live;
  const bool rects = exact != nullptr && *total > pair_cap;
  if (rects) {
    walk_rects(c, rx, x0, y0, exact, T, tile * SCAN_THREADS + threadIdx.x,
               ntiles * SCAN_THREADS, num_bins, ntx);
    __threadfence();  // every thread's rects in before the tile publishes
  }
  const BinScan r =
      scan_bins<SCAN_THREADS>(in ? cnt : 0, group, cap, s_red);
  // The bin's spans past its first (the span list's entries), scanned.
  int span_total = 0;
  const int span_start =
      SPANS ? block_scan(in && min(cnt, cap) > TILE_SPAN
                             ? (min(cnt, cap) - 1) / TILE_SPAN : 0,
                         s_spans, span_total)
            : 0;
  const bool last = tile == ntiles - 1;
  // Warp 0 publishes the tile's sums, then looks back over the tiles
  // before it, a warp of them at a time, to the nearest whose inclusive
  // sums are out, adding the own sums of those on the way. In the last
  // tile warp 1 meanwhile takes the largest count over the tiles' words,
  // and with a span list warp 2 looks back over the tiles' spans.
  if (warp == 0) {
    if (lane == 0) {
      *(volatile unsigned long long*)&status[ntiles + tile] =
          pack(1, 0, r.most);
      *(volatile unsigned long long*)&status[tile] =
          pack(tile == 0 ? 2 : 1, r.occupied, r.pairs);
    }
    int pairs = 0, occ = 0;
    for (int j = tile - 1; j >= 0; j -= 32) {
      const int at = j - lane;
      unsigned long long w = pack(2, 0, 0);  // before tile 0: nothing
      if (at >= 0) {
        do {
          w = *(volatile unsigned long long*)&status[at];
        } while ((w >> 62) == 0);
      }
      const unsigned done = __ballot_sync(FULL, (w >> 62) == 2);
      const int stop = done ? __ffs(done) - 1 : 31;
      int p = lane <= stop ? (int)(w & 0x7fffffffu) : 0;
      int o = lane <= stop ? (int)((w >> 31) & 0x7fffffffu) : 0;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) {
        p += __shfl_xor_sync(FULL, p, sh);
        o += __shfl_xor_sync(FULL, o, sh);
      }
      pairs += p;
      occ += o;
      if (done) break;
    }
    if (lane == 0) {
      if (tile > 0)
        *(volatile unsigned long long*)&status[tile] =
            pack(2, occ + r.occupied, pairs + r.pairs);
      s_before[0] = pairs;
      s_before[1] = occ;
    }
  } else if (warp == 1 && last && !rects) {
    int most = r.most;
    for (int t = lane; t < ntiles - 1; t += 32) {
      unsigned long long w;
      do {
        w = *(volatile unsigned long long*)&status[ntiles + t];
      } while ((w >> 62) == 0);
      most = max(most, (int)(w & 0x7fffffffu));
    }
    most = warp_max(most);
    if (lane == 0) s_before[2] = most;
  } else if (SPANS && warp == 2) {
    const int before = look_back(status + 2 * ntiles, tile, span_total, lane);
    if (lane == 0) s_before[3] = before;
  }
  __syncthreads();
  if (in)
    write_bin(b, cnt, s_before[0] + r.start, s_before[1] + r.occ_at, r,
              group, cap, seg_start, seg_count, tile_count, win_start,
              worklist, SPANS ? spans : nullptr, s_before[3] + span_start);
  if (last) {
    int most = s_before[2];
    if (rects) {
      // Under pair overflow the largest exact count: every tile's rects
      // are in once every tile has published.
      __threadfence();
      most = 0;
      for (int j = threadIdx.x; j < num_bins; j += SCAN_THREADS)
        most = max(most, exact[j]);
      most = warp_max(most);
      if (lane == 0) s_red[warp] = most;
      __syncthreads();
      most = 0;
      for (int w = 0; w < SCAN_WARPS; ++w) most = max(most, s_red[w]);
    }
    write_totals(total, pair_cap, cap, most, s_before[1] + r.occupied,
                 num_bins / group, worklist, scal, SPANS ? spans : nullptr,
                 SPANS ? s_before[3] + span_total : 0, acc);
  }
  __syncthreads();  // the shared arrays are rewritten next tile
}

// Persistent blocks, no more than the card holds at once, each taking
// the tiles blockIdx.x, blockIdx.x + gridDim.x, ... in order: a tile's
// look-back then waits only on tiles whose blocks are running.
template <bool SPANS>
__global__ void __launch_bounds__(SCAN_THREADS) bin_sort_scan_kernel(
    int* __restrict__ table, const int* ranges,
    const int* __restrict__ total, const int* __restrict__ c,
    const int* __restrict__ rx, const int* __restrict__ x0,
    const int* __restrict__ y0,
    int* exact,                       // flat layout: (num_bins,), cleared
    unsigned long long* status,       // (2 ntiles,), cleared
    int* __restrict__ seg_start, int* __restrict__ seg_count,
    int* __restrict__ tile_count, int* __restrict__ win_start,
    int* __restrict__ worklist,
    int* spans,                       // SPANS: the span list, count 0
    int* __restrict__ scal,
    long long* acc,                   // (8,) or null: frame_counts.cuh
    int T, int pair_cap, int num_bins, int group, int cap, int ntx,
    int ntiles, int tchunk) {
  __shared__ int s_part[SCAN_GROUPS][SCAN_TILE];
  __shared__ int s_red[3 * SCAN_WARPS];
  __shared__ int s_before[4];
  __shared__ int s_spans[SPANS ? SCAN_WARPS + 1 : 1];
  __shared__ int s_ranges[2 * RANGE_STAGE];
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
    scan_tile<SPANS>(tile, ntiles, table, ranges, total, c, rx, x0, y0,
                     exact, status, seg_start, seg_count, tile_count,
                     win_start, worklist, spans, scal, acc, T, pair_cap,
                     num_bins, group, cap, ntx, tchunk, s_part, s_red,
                     s_before, s_ranges, s_spans);
}

// The chunk's range of bins [lo, hi] (hi < lo: none), every thread.
__device__ void chunk_range(const int* keys, int m, int num_bins,
                            int* s_range, int& lo, int& hi) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_range[0] = num_bins;
    s_range[1] = -1;
  }
  lo = num_bins;
  hi = -1;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int b = bin_of(keys, i * THREADS + threadIdx.x, m, num_bins);
    if (b >= 0) {
      lo = min(lo, b);
      hi = max(hi, b);
    }
  }
  lo = -warp_max(-lo);
  hi = warp_max(hi);
  __syncthreads();  // s_range is set
  if (lane == 0) {
    atomicMin(&s_range[0], lo);
    atomicMax(&s_range[1], hi);
  }
  __syncthreads();
  lo = s_range[0];
  hi = s_range[1];
  __syncthreads();  // s_range is read before anything reuses it
}

__global__ void __launch_bounds__(THREADS) bin_sort_place_kernel(
    const int* __restrict__ keys, const int* __restrict__ tris,
    const int* __restrict__ total, const int* __restrict__ table,
    const int* __restrict__ seg_start, int* __restrict__ pair_tri,
    int pair_cap, int num_bins, int tchunk) {
  extern __shared__ int smem[];
  int* s_key = smem;
  int* s_val = smem + PADDED;
  int* s_pos = smem + 2 * PADDED;
  unsigned* s_cnt = (unsigned*)(smem + 3 * PADDED);
  int* s_warp = smem + 3 * PADDED + CNT_WORDS;
  int* s_range = s_warp + WARPS;
  int* s_base = s_range + 2;
  const int n = valid_slots(total, pair_cap);
  const int c0 = blockIdx.x * CHUNK;
  if (c0 >= n) return;
  const int m = min(CHUNK, n - c0);
  int lo, hi;
  chunk_range(keys + c0, m, num_bins, s_range, lo, hi);
  if (hi < lo) return;  // no pair of the chunk lies in a bin
  sort_chunk(keys + c0, tris + c0, m, lo, hi - lo + 1, s_key, s_val, s_cnt,
             s_warp);
  // The table chunk this chunk lies in, and its slots ahead of it.
  const int tc = c0 / tchunk;
  place_chunk(s_key, s_val, s_pos, s_warp, s_base, lo, hi - lo + 1,
              seg_start, table + (size_t)tc * num_bins, keys + tc * tchunk,
              c0 - tc * tchunk, pair_tri);
}

unsigned chunks_of(int pair_cap, int chunk) {
  const int b = (pair_cap + chunk - 1) / chunk;
  return (unsigned)(b < 1 ? 1 : b);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// keys, tris: (pair_cap,) pairs; total: () pairs in all; c, rx, x0, y0:
// the flat layout's rect rows (T,) each, or null (the micro layout);
// scratch (binning.sort_scratch_ints): the look-back words (four ints a
// tile of SCAN_TILE bins, six with spans), the exact counts (num_bins
// ints, only with the rects) and with spans (group 1 only) the span list,
// its count and 2 ceil(pair_cap / TILE_SPAN) entries — cleared by the
// first launch — then each table chunk's [lo, hi] and the (table chunk,
// bin) table. tile_count and
// win_start (num_bins / 16,) only with group 16, else null; scal: 5 ints;
// acc: 8 long longs (frame_counts.cuh) or null.
extern "C" int bin_sort(const void* keys, const void* tris,
                        const void* total, const void* c, const void* rx,
                        const void* x0, const void* y0, void* scratch,
                        void* pair_tri, void* seg_start, void* seg_count,
                        void* tile_count, void* win_start, void* worklist,
                        void* scal, void* acc, int T, int pair_cap,
                        int num_bins, int group, int cap, int ntx, int spans,
                        void* stream) {
  const bool rects = c != nullptr;
  if (pair_cap < 0 || num_bins < 0 || T < 0 || cap < 0 ||
      (group != 1 && group != 16) || num_bins % group != 0 ||
      (group == 16) != (tile_count != nullptr) ||
      (spans && group != 1) ||
      (rects && (ntx <= 0 || num_bins % ntx != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = allow_smem(bin_sort_place_kernel, SORT_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int hist_bytes =
      4 * (num_bins < HIST_WINDOW ? (num_bins > 0 ? num_bins : 1)
                                  : HIST_WINDOW);
  e = allow_smem(bin_sort_hist_kernel, hist_bytes);
  if (e != cudaSuccess) return (int)e;
  // The scan's persistent blocks: one an SM holds them all at once.
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned chunks = chunks_of(pair_cap, CHUNK);
  const int tiles = num_bins > 0 ? (num_bins + SCAN_TILE - 1) / SCAN_TILE
                                 : 1;
  // The look-back words: two a tile, three with a span list.
  const int words = (spans ? 6 : 4) * tiles;
  const int span_ints =
      spans ? 1 + 2 * (int)chunks_of(pair_cap, TILE_SPAN) : 0;
  const int clear_len = words + (rects ? num_bins : 0) + span_ints;
  int tchunk = CHUNK;
  while (tchunk < CHUNK * MAX_FACTOR &&
         (long long)chunks_of(pair_cap, tchunk) * num_bins > TABLE_CELLS)
    tchunk *= 2;
  const unsigned tchunks = chunks_of(pair_cap, tchunk);
  int* base = (int*)scratch;
  unsigned long long* status = (unsigned long long*)base;
  int* exact = rects ? base + words : nullptr;
  int* span_list = spans ? base + words + (rects ? num_bins : 0) : nullptr;
  int* ranges = base + clear_len;
  int* table = ranges + 2 * tchunks;
  bin_sort_hist_kernel<<<tchunks, HIST_THREADS, hist_bytes, s>>>(
      (const int*)keys, (const int*)total, ranges, table, base, clear_len,
      pair_cap, num_bins, tchunk);
  auto scan = spans ? bin_sort_scan_kernel<true>
                    : bin_sort_scan_kernel<false>;
  scan<<<tiles < sms ? tiles : sms, SCAN_THREADS, 0, s>>>(
      table, ranges, (const int*)total, (const int*)c, (const int*)rx,
      (const int*)x0, (const int*)y0, exact, status, (int*)seg_start,
      (int*)seg_count, (int*)tile_count, (int*)win_start, (int*)worklist,
      span_list, (int*)scal, (long long*)acc, T, pair_cap, num_bins, group,
      cap, ntx, tiles, tchunk);
  bin_sort_place_kernel<<<chunks, THREADS, SORT_SMEM, s>>>(
      (const int*)keys, (const int*)tris, (const int*)total, table,
      (const int*)seg_start, (int*)pair_tri, pair_cap, num_bins, tchunk);
  return (int)cudaGetLastError();
}

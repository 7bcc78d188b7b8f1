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
// occupied_worklist. The port ran these as eager torch ops (a stable
// torch.sort, searchsorted, a reshape-sum, a cumsum and a scatter).
//
// Input: keys (pair_cap,) — the bin of each pair slot — and tris
// (pair_cap,), whose first n = min(total, pair_cap) slots are valid and in
// triangle order (expand.cu's contract; keys past n are the num_bins
// sentinel and are not read). Output, equal to the twin's
// (binning.bin_sort_plain):
// - pair_tri: on [0, n) the triangle ids in (bin, triangle) order — what
//   tris[torch.sort(keys, stable=True).indices] gives there; 0 on
//   [n, pair_cap);
// - seg_start (num_bins,): the exclusive scan of the bins' counts (the
//   left searchsorted of each bin in the sorted keys); seg_count: the
//   counts, clamped to cap;
// - group 16 (the micro layout, 16 cells a tile): tile_count, each tile's
//   16 counts summed, and win_start, the 16-aligned base of each tile's
//   first segment;
// - worklist (num_bins / group,): the ascending ids of the tiles whose
//   (clamped) count is above 0, padded with 0;
// - scal = [pair_needed, tile_needed, total, k, long segments]: pair_needed
//   is total where it exceeds pair_cap, tile_needed the largest count where
//   it exceeds cap (exact under pair overflow: with the flat layout's rects
//   given, counted over every rect rather than the capped list), k the
//   work list's length. (scal[0], scal[1]) is the frame's overflow report.
//
// What bounds it on an H100: memory. Each valid slot's key and triangle
// are read (8 B; the key twice, for the count and the scatter) and its
// triangle written and sorted in place (8 B), and each bin's 16 B of
// segments, cursor and work list written: San Miguel's 327,695 pairs over
// 12,288 cells move about 5 MB, 1.5 us at 3.35 TB/s. The work is a few
// integer operations a pair and a log^2 sorting network a segment.
//
// Design: five launches and one memset, every one capturable.
// 1. bin_sort_count_kernel: each valid slot adds one to its bin's count,
//    with one atomicAdd a run of equal keys in a warp (__match_any_sync).
//    Under pair overflow of the flat layout it also counts, per alive
//    triangle, every tile of its rect into the exact counts.
// 2. bin_sort_scan_kernel (one block; each thread scans 16 consecutive
//    bins — a micro tile — staged in shared memory so that device memory
//    is read and written coalesced): the exclusive scan of the counts into
//    seg_start and each bin's scatter cursor, the clamped counts, the
//    group extras, the work list, the chunks of the long segments (over
//    WARP_CAP pairs; one a BLOCK_CAP pairs) and scal.
// 3. bin_sort_scatter_kernel: each valid slot writes its triangle at its
//    bin's cursor, claimed with one atomicAdd a run of equal keys in a
//    warp; the order within a bin is whatever order the atomics took.
// 4. bin_sort_order_kernel (1,024 threads a block): sorts each segment by
//    triangle id, with bitonic networks that hold E = 1..8 slots a thread
//    in registers (a warp's stages are register swaps and shuffles, a
//    block's widest ones go through shared memory). The first LONG_BLOCKS
//    blocks take the long segments' chunks, one a block: a segment of up
//    to BLOCK_CAP pairs is sorted in place, the chunks of a longer one
//    into a scratch list at the same offsets. In the blocks after them
//    warp w of block i sorts bin 32 i + w when it holds 2..WARP_CAP pairs.
// 5. bin_sort_merge_kernel: each element of a segment longer than
//    BLOCK_CAP goes from its sorted chunk to its index there plus, in each
//    other chunk (staged in shared memory), the count of elements below
//    it: one pass, a block a chunk, with no merge tree.
// The segments' lengths spread the work: the micro path's densest cell
// holds 1,718 pairs on San Miguel and 7,113 on structured_scene.obj, the
// flat layout's heaviest tile 3,140 on structured_scene_tex.obj, against
// a mean of 27-57.
// Why this is the stable sort's order: a triangle covers a bin at most
// once, so the triangle ids within a segment are distinct, and a segment
// sorted by triangle id is the order in which the stable sort leaves
// them, whatever order the atomics took.
//
// State: the counts are cleared by the memset inside each call; the
// cursors and the chunk list are written by the scan, and the chunk
// scratch by the order kernel, before anything reads them; all are
// scratch the wrapper allocates for each call, so two calls in flight
// share nothing. Nothing reads back to the host.
//
// Exactness: integer arithmetic only; the rect walk of the exact counts
// uses c / max(rx, 1) rows as setup_from_meta does.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;               // count, scatter kernels
constexpr int SCAN_THREADS = 512;          // bin_sort_scan_kernel
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
// Consecutive bins a scan thread owns: one micro tile of 16 cells, so a
// tile's count is a thread's own sum; a round of the one block covers
// SCAN_BINS bins (San Miguel's 12,288 cells in two), staged in static
// shared memory (a round of 16,384 in dynamic shared memory measured
// slower on every frame: 7.3-9.9 against 3.9-9.6 us).
constexpr int SCAN_ITEMS = 16;
constexpr int SCAN_BINS = SCAN_THREADS * SCAN_ITEMS;
constexpr int ORDER_THREADS = 1024;        // bin_sort_order_kernel
constexpr int ORDER_WARPS = ORDER_THREADS / 32;
constexpr int WARP_CAP = 256;              // binning.SORT_WARP_CAP
constexpr int BLOCK_CAP = 2048;            // binning.SORT_BLOCK_CAP
constexpr int BLOCK_E = BLOCK_CAP / ORDER_THREADS;  // slots a thread: 2
// Blocks that take the long segments' chunks, launched first so that the
// longest sorts start at once: more than a frame has chunks (San Miguel
// 273), one each; those without one exit at once.
constexpr int LONG_BLOCKS = 1024;
constexpr int MERGE_THREADS = 1024;        // bin_sort_merge_kernel
constexpr int MERGE_BLOCKS = 264;
constexpr int SLOT_BLOCKS = 132 * 16;      // the slot loops' largest grid

// Inclusive warp scan of v.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

// The valid slots: min(total, pair_cap), at least 0.
__device__ __forceinline__ int valid_slots(const int* total, int pair_cap) {
  return max(min(*total, pair_cap), 0);
}

__global__ void __launch_bounds__(THREADS) bin_sort_count_kernel(
    const int* __restrict__ keys, const int* __restrict__ total,
    int* __restrict__ counts,      // (num_bins,), cleared by the memset
    const int* __restrict__ c,     // flat layout: (T,) meta rows, else null
    const int* __restrict__ rx, const int* __restrict__ x0,
    const int* __restrict__ y0,
    int* __restrict__ exact,       // flat layout: (num_bins,), cleared
    int pair_cap, int num_bins, int T, int ntx) {
  const int n = valid_slots(total, pair_cap);
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * THREADS;
  // Warp-uniform bounds, so that every lane joins the match.
  for (int base = blockIdx.x * THREADS + (threadIdx.x & ~31); base < n;
       base += stride) {
    const int p = base + lane;
    int b = p < n ? keys[p] : -1;
    if ((unsigned)b >= (unsigned)num_bins) b = -1;
    const unsigned run = __match_any_sync(FULL, b);
    if (b >= 0 && lane == __ffs(run) - 1) atomicAdd(&counts[b], __popc(run));
  }
  if (exact == nullptr || *total <= pair_cap) return;
  // Pair overflow: the list holds only the first pair_cap pairs, and the
  // retry needs every tile's whole count. Each alive triangle counts the
  // tiles of its rect [x0, x0 + rx) x [y0, y0 + c / max(rx, 1)), clipped
  // to the grid.
  const int nty = num_bins / ntx;
  for (int t = blockIdx.x * THREADS + threadIdx.x; t < T; t += stride) {
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

// The long-segment chunks of a bin of cnt pairs: none up to WARP_CAP (a
// warp sorts it whole), else one a BLOCK_CAP pairs.
__device__ __forceinline__ int chunks_of(int cnt) {
  return cnt > WARP_CAP ? (cnt + BLOCK_CAP - 1) / BLOCK_CAP : 0;
}

// Shared-memory index of a round's bin i, one pad word every 16: a
// thread's 16 consecutive bins then sit on distinct banks across a warp.
__host__ __device__ constexpr int pad16(int i) { return i + (i >> 4); }

__global__ void __launch_bounds__(SCAN_THREADS) bin_sort_scan_kernel(
    const int* __restrict__ counts, const int* __restrict__ exact,
    const int* __restrict__ total, int pair_cap, int num_bins, int group,
    int cap, int* __restrict__ seg_start, int* __restrict__ seg_count,
    int* __restrict__ cursor, int* __restrict__ tile_count,
    int* __restrict__ win_start, int* __restrict__ worklist,
    int* __restrict__ long_list, int* __restrict__ scal) {
  // A round's counts, then its segment starts, staged so that device
  // memory is read and written coalesced.
  __shared__ int s_bin[pad16(SCAN_BINS)];
  __shared__ int s_sum[32];
  __shared__ int s_occ[32];
  __shared__ int s_long[32];
  __shared__ int s_all[3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int num_tiles = num_bins / group;
  int carry = 0, carry_occ = 0, carry_long = 0, most = 0;
  for (int base = 0; base < num_bins; base += SCAN_BINS) {
    const int in_round = min(SCAN_BINS, num_bins - base);
    for (int i = threadIdx.x; i < SCAN_BINS; i += SCAN_THREADS)
      s_bin[pad16(i)] = i < in_round ? counts[base + i] : 0;
    __syncthreads();
    // This thread's bins [b0, b0 + SCAN_ITEMS): with group 16, one tile.
    const int i0 = threadIdx.x * SCAN_ITEMS;
    const int b0 = base + i0;
    int cnt[SCAN_ITEMS];
    int sum = 0, occ = 0, lng = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      cnt[k] = s_bin[pad16(i0 + k)];
      sum += cnt[k];
      lng += chunks_of(cnt[k]);
      most = max(most, cnt[k]);
      if (group == 1) occ += min(cnt[k], cap) > 0;
    }
    if (group == 16) occ = b0 < num_bins && min(sum, cap) > 0;
    // The block's exclusive scan of (pairs, occupied tiles, long bins):
    // within each warp, then warp 0 over the warps' totals.
    const int incl = warp_scan(sum, lane);
    const int incl_occ = warp_scan(occ, lane);
    const int incl_long = warp_scan(lng, lane);
    if (lane == 31) {
      s_sum[warp] = incl;
      s_occ[warp] = incl_occ;
      s_long[warp] = incl_long;
    }
    __syncthreads();
    if (warp == 0) {
      const bool w = lane < SCAN_WARPS;
      const int v = w ? s_sum[lane] : 0, vo = w ? s_occ[lane] : 0,
                vl = w ? s_long[lane] : 0;
      const int iv = warp_scan(v, lane), io = warp_scan(vo, lane),
                il = warp_scan(vl, lane);
      s_sum[lane] = iv - v;
      s_occ[lane] = io - vo;
      s_long[lane] = il - vl;
      if (lane == 31) {
        s_all[0] = iv;
        s_all[1] = io;
        s_all[2] = il;
      }
    }
    __syncthreads();
    int start = carry + s_sum[warp] + incl - sum;
    int at_occ = carry_occ + s_occ[warp] + incl_occ - occ;
    int at_long = carry_long + s_long[warp] + incl_long - lng;
    if (group == 16 && b0 < num_bins) {
      const int tile = b0 / 16;
      tile_count[tile] = sum;
      win_start[tile] = (start >> 4) << 4;  // start >= 0
      if (occ) worklist[at_occ] = tile;
    }
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      const int b = b0 + k;
      s_bin[pad16(i0 + k)] = start;
      if (b < num_bins) {
        for (int c = 0; c < chunks_of(cnt[k]); ++c, ++at_long) {
          long_list[2 * at_long] = b;
          long_list[2 * at_long + 1] = c;
        }
        if (group == 1 && min(cnt[k], cap) > 0) worklist[at_occ++] = b;
      }
      start += cnt[k];
    }
    __syncthreads();
    // Each bin's count is the next start less its own; the round's last
    // bin ends at the round's total.
    const int end_all = carry + s_all[0];
    for (int i = threadIdx.x; i < in_round; i += SCAN_THREADS) {
      const int b = base + i;
      const int st = s_bin[pad16(i)];
      const int next = i + 1 < in_round ? s_bin[pad16(i + 1)] : end_all;
      seg_start[b] = st;
      cursor[b] = st;
      seg_count[b] = min(next - st, cap);
    }
    carry += s_all[0];
    carry_occ += s_all[1];
    carry_long += s_all[2];
    __syncthreads();  // s_bin and the totals are rewritten next round
  }
  // The work list's padding: every slot past the occupied count is 0.
  for (int i = carry_occ + threadIdx.x; i < num_tiles; i += SCAN_THREADS)
    worklist[i] = 0;
  const int all_pairs = *total;
  const bool over = all_pairs > pair_cap;
  if (exact != nullptr && over) {
    most = 0;
    for (int b = threadIdx.x; b < num_bins; b += SCAN_THREADS)
      most = max(most, exact[b]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    most = max(most, __shfl_xor_sync(FULL, most, o));
  if (lane == 0) s_sum[warp] = most;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int w = 0; w < SCAN_WARPS; ++w) m = max(m, s_sum[w]);
    scal[0] = over ? all_pairs : 0;
    scal[1] = m > cap ? m : 0;
    scal[2] = all_pairs;
    scal[3] = carry_occ;
    scal[4] = carry_long;
  }
}

__global__ void __launch_bounds__(THREADS) bin_sort_scatter_kernel(
    const int* __restrict__ keys, const int* __restrict__ tris,
    const int* __restrict__ total, int* __restrict__ cursor,
    int* __restrict__ pair_tri, int pair_cap, int num_bins) {
  const int n = valid_slots(total, pair_cap);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int stride = gridDim.x * THREADS;
  for (int base = blockIdx.x * THREADS + (threadIdx.x & ~31); base < pair_cap;
       base += stride) {
    const int p = base + lane;
    int b = p < n ? keys[p] : -1;
    if ((unsigned)b >= (unsigned)num_bins) b = -1;
    const unsigned run = __match_any_sync(FULL, b);
    const int leader = __ffs(run) - 1;
    int slot = 0;
    if (b >= 0 && lane == leader) slot = atomicAdd(&cursor[b], __popc(run));
    slot = __shfl_sync(FULL, slot, leader);
    if (b >= 0) {
      pair_tri[slot + __popc(run & below)] = tris[p];
    } else if (p >= n && p < pair_cap) {
      pair_tri[p] = 0;
    }
  }
}

// Bitonic sorting networks over L = 32 E (a warp) or ORDER_THREADS E (a
// block) slots, each thread holding E consecutive ones (slot i = t E + e
// of thread t) in registers, padded with INT_MAX. Stage (k, j) pairs slot
// i with i ^ j, ascending where bit k of i is clear: for j < E both are
// the thread's own; for j < 32 E the partner is lane ^ (j / E) of the
// same warp (a shuffle); wider stages exchange through shared memory.

// Stage (k, j < E): the thread's own pairs.
template <int E>
__device__ __forceinline__ void stage_regs(int (&v)[E], int t, int k, int j) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e & j) continue;
    const int a = v[e], b = v[e | j];
    if ((a > b) == (((t * E + e) & k) == 0)) {
      v[e] = b;
      v[e | j] = a;
    }
  }
}

// Stage (k, E <= j < 32 E): one shuffle a slot; the lower slot of a pair
// keeps the smaller value in an ascending run, the larger in a
// descending one.
template <int E>
__device__ __forceinline__ void stage_lanes(int (&v)[E], int t, int k,
                                            int j) {
  const int d = j / E;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int o = __shfl_xor_sync(FULL, v[e], d);
    const int i = t * E + e;
    v[e] = ((i & j) == 0) == ((i & k) == 0) ? min(v[e], o) : max(v[e], o);
  }
}

// Sort seg[0, cnt), cnt <= 32 E, in one warp's registers.
template <int E>
__device__ void warp_sort(int* seg, int cnt, int lane) {
  int v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    v[e] = i < cnt ? seg[i] : INT_MAX;
  }
#pragma unroll
  for (int k = 2; k <= 32 * E; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < E) {
        stage_regs<E>(v, lane, k, j);
      } else {
        stage_lanes<E>(v, lane, k, j);
      }
    }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    if (i < cnt) seg[i] = v[e];
  }
}

// Shared-memory index of exchange slot i, one pad word every 32: a
// thread's E consecutive slots then sit on distinct banks across a warp.
__host__ __device__ constexpr int pad32(int i) { return i + (i >> 5); }

// Sort src[0, cnt), cnt <= ORDER_THREADS E, in the block's registers into
// dst[0, cnt) (src itself or not), with the shared memory s for the wide
// stages.
template <int E>
__device__ void block_sort(const int* src, int* dst, int cnt, int* s) {
  constexpr int L = ORDER_THREADS * E;
  const int t = threadIdx.x;
  int v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = t * E + e;
    v[e] = i < cnt ? src[i] : INT_MAX;
  }
#pragma unroll
  for (int k = 2; k <= L; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < E) {
        stage_regs<E>(v, t, k, j);
      } else if (j < 32 * E) {
        stage_lanes<E>(v, t, k, j);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) s[pad32(t * E + e)] = v[e];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = t * E + e;
          const int o = s[pad32(i ^ j)];
          v[e] = ((i & j) == 0) == ((i & k) == 0) ? min(v[e], o)
                                                  : max(v[e], o);
        }
        __syncthreads();  // s is rewritten by the next wide stage
      }
    }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = t * E + e;
    if (i < cnt) dst[i] = v[e];
  }
}

// A chunk of cnt <= BLOCK_CAP pairs: the smallest network that holds it.
__device__ void block_sort_any(const int* src, int* dst, int cnt, int* s) {
  if (cnt <= ORDER_THREADS) {
    block_sort<1>(src, dst, cnt, s);
  } else {
    block_sort<BLOCK_E>(src, dst, cnt, s);
  }
}

__global__ void __launch_bounds__(ORDER_THREADS) bin_sort_order_kernel(
    const int* __restrict__ counts, const int* __restrict__ seg_start,
    const int* __restrict__ long_list, const int* __restrict__ scal,
    int* pair_tri, int* other, int num_bins) {
  __shared__ int s[pad32(BLOCK_CAP)];  // the wide stages' exchange
  if ((int)blockIdx.x < LONG_BLOCKS) {
    // Chunk c of a long bin: sorted whole in place when the bin fits one
    // chunk, else into the merge's scratch at the same offsets.
    const int n_chunks = scal[4];
    for (int u = blockIdx.x; u < n_chunks; u += LONG_BLOCKS) {
      const int b = long_list[2 * u], c = long_list[2 * u + 1];
      const int cnt = counts[b];
      const int at = seg_start[b] + c * BLOCK_CAP;
      block_sort_any(pair_tri + at,
                     (cnt > BLOCK_CAP ? other : pair_tri) + at,
                     min(BLOCK_CAP, cnt - c * BLOCK_CAP), s);
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = (blockIdx.x - LONG_BLOCKS) * ORDER_WARPS + warp;
  if (b >= num_bins) return;
  const int cnt = counts[b];
  if (cnt < 2 || cnt > WARP_CAP) return;  // nothing to do, or long
  int* seg = pair_tri + seg_start[b];
  if (cnt <= 32) {
    warp_sort<1>(seg, cnt, lane);
  } else if (cnt <= 64) {
    warp_sort<2>(seg, cnt, lane);
  } else if (cnt <= 128) {
    warp_sort<4>(seg, cnt, lane);
  } else {
    warp_sort<8>(seg, cnt, lane);
  }
}

// The bins of more than BLOCK_CAP pairs, whose chunks the order kernel
// sorted into other: each element of chunk c goes to its index in the
// chunk plus, in every other chunk, the count of elements below it (the
// ids of a bin are distinct), into pair_tri. One block a chunk; each
// other chunk is staged in shared memory for the binary searches.
__global__ void __launch_bounds__(MERGE_THREADS) bin_sort_merge_kernel(
    const int* __restrict__ counts, const int* __restrict__ seg_start,
    const int* __restrict__ long_list, const int* __restrict__ scal,
    const int* __restrict__ other, int* __restrict__ pair_tri) {
  constexpr int PER = BLOCK_CAP / MERGE_THREADS;  // elements a thread
  __shared__ int s_run[BLOCK_CAP];
  const int n_chunks = scal[4];
  for (int u = blockIdx.x; u < n_chunks; u += gridDim.x) {
    const int b = long_list[2 * u], c = long_list[2 * u + 1];
    const int cnt = counts[b];
    if (cnt <= BLOCK_CAP) continue;  // block-uniform
    const int start = seg_start[b];
    const int* seg = other + start;
    const int chunks = (cnt + BLOCK_CAP - 1) / BLOCK_CAP;
    const int c0 = c * BLOCK_CAP, m = min(BLOCK_CAP, cnt - c0);
    int v[PER], pos[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = threadIdx.x + q * MERGE_THREADS;
      v[q] = j < m ? seg[c0 + j] : INT_MAX;
      pos[q] = j;
    }
    for (int d = 0; d < chunks; ++d) {
      if (d == c) continue;
      const int len = min(BLOCK_CAP, cnt - d * BLOCK_CAP);
      for (int i = threadIdx.x; i < len; i += MERGE_THREADS)
        s_run[i] = seg[d * BLOCK_CAP + i];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        int a = 0, e = len;  // elements of chunk d below v[q]
        while (a < e) {
          const int mid = (a + e) >> 1;
          if (s_run[mid] < v[q]) {
            a = mid + 1;
          } else {
            e = mid;
          }
        }
        pos[q] += a;
      }
      __syncthreads();  // s_run is rewritten by the next chunk
    }
#pragma unroll
    for (int q = 0; q < PER; ++q)
      if (threadIdx.x + q * MERGE_THREADS < m) pair_tri[start + pos[q]] = v[q];
  }
}

unsigned slot_blocks(int n) {
  const int b = (n + THREADS - 1) / THREADS;
  return (unsigned)(b < 1 ? 1 : b > SLOT_BLOCKS ? SLOT_BLOCKS : b);
}

}  // namespace

// keys, tris: (pair_cap,) pairs; total: () pairs in all. counts: scratch
// of num_bins ints, followed by num_bins more (the exact counts) when the
// rect rows c, rx, x0, y0 are given (the flat layout; null on the micro
// layout); cursor: scratch of num_bins ints; long_list: scratch of
// 2 (num_bins + pair_cap / BLOCK_CAP + 1) ints (the long segments'
// chunks, (bin, chunk) pairs); other: scratch of pair_cap ints.
// tile_count and win_start (num_bins / 16,) only with group 16, else null.
// scal: 5 ints. Five launches and a memset.
extern "C" int bin_sort(const void* keys, const void* tris,
                        const void* total, const void* c, const void* rx,
                        const void* x0, const void* y0, void* counts,
                        void* cursor, void* long_list, void* other,
                        void* pair_tri, void* seg_start,
                        void* seg_count, void* tile_count, void* win_start,
                        void* worklist, void* scal, int T, int pair_cap,
                        int num_bins, int group, int cap, int ntx,
                        void* stream) {
  const bool flat_rects = c != nullptr;
  if (pair_cap < 0 || num_bins < 0 || T < 0 || cap < 0 ||
      (group != 1 && group != 16) || num_bins % group != 0 ||
      (group == 16) != (tile_count != nullptr) ||
      (flat_rects && (ntx <= 0 || num_bins % ntx != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* cnt = (int*)counts;
  int* exact = flat_rects ? cnt + num_bins : nullptr;
  const cudaError_t e = cudaMemsetAsync(
      counts, 0, sizeof(int) * (size_t)num_bins * (flat_rects ? 2 : 1), s);
  if (e != cudaSuccess) return (int)e;
  bin_sort_count_kernel<<<slot_blocks(pair_cap > T ? pair_cap : T), THREADS,
                          0, s>>>(
      (const int*)keys, (const int*)total, cnt, (const int*)c,
      (const int*)rx, (const int*)x0, (const int*)y0, exact, pair_cap,
      num_bins, T, ntx);
  bin_sort_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(
      cnt, exact, (const int*)total, pair_cap, num_bins, group, cap,
      (int*)seg_start, (int*)seg_count, (int*)cursor, (int*)tile_count,
      (int*)win_start, (int*)worklist, (int*)long_list, (int*)scal);
  bin_sort_scatter_kernel<<<slot_blocks(pair_cap), THREADS, 0, s>>>(
      (const int*)keys, (const int*)tris, (const int*)total, (int*)cursor,
      (int*)pair_tri, pair_cap, num_bins);
  const int short_blocks = (num_bins + ORDER_WARPS - 1) / ORDER_WARPS;
  bin_sort_order_kernel<<<LONG_BLOCKS + short_blocks, ORDER_THREADS, 0, s>>>(
      cnt, (const int*)seg_start, (const int*)long_list, (const int*)scal,
      (int*)pair_tri, (int*)other, num_bins);
  bin_sort_merge_kernel<<<MERGE_BLOCKS, MERGE_THREADS, 0, s>>>(
      cnt, (const int*)seg_start, (const int*)long_list, (const int*)scal,
      (const int*)other, (int*)pair_tri);
  return (int)cudaGetLastError();
}

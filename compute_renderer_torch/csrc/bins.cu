// The tile path's binning stage and the frame's shading parameters: the
// work between the front end and the tile raster that the JAX package
// leaves to XLA inside its compiled step (backends/tpu.py render_frame).
//
// bin_tiles_dense replaces, for the dense layout, the JAX package's
// backends/binning.py setup_from_meta + bin_triangles_dense and
// backends/pallas_raster.py occupied_worklist. From the front end's meta
// rows (4, T) = [tile_x0, tile_y0, rx, c], row stride ld (a chunk of the
// frame's meta is read in place), it writes
// - bin_rows (num_tiles, C): row j lists, ascending, the alive triangles
//   (c > 0) whose tile rect [x0, x0 + rx) x [y0, y0 + c / max(rx, 1))
//   holds tile j; only the first C are stored, and every slot past the
//   count holds max(T - 1, 0), as the rank search's clamp gives;
// - seg_start (exclusive prefix sum of the counts), seg_count = min(count,
//   C), the occupied-tile work list (ascending ids, padded with 0);
// - scal = [pair_needed (0), tile_needed, total_pairs, k, most]: most is
//   the largest count, tile_needed most where it exceeds C, else 0;
//   (scal[0], scal[1]) is the frame's overflow report. With an
//   accumulator given, the thread that writes scal folds it in
//   (frame_counts.cuh).
//
// shading_params replaces the (11,) params and (L, 8) light rows that
// pallas_raster.py raster_shade_tiles and pallas_micro.py
// raster_shade_micro build before their pallas_call.
//
// What bounds them on an H100: neither moves enough to matter. Suzanne at
// 16x256 tiles reads 16 B of meta a triangle and writes 4 B x 192 x 128 of
// rows and 12 B a tile of segments and work list, about 121 KB (0.036 us
// at 3.35 TB/s); the parameters are 50 floats. Both are launch-bound.
//
// Design of bin_tiles_dense: two launches, no state between them.
// - bin_rows_kernel: one block a tile loops over the triangles in chunks
//   of its width, one meta column a thread. A warp ballot and __popc, with
//   the warps' totals in shared memory, give each covering triangle its
//   slot in ascending triangle order: deterministic, where the reference's
//   atomic slot claim (binning.wgsl:376-387) is not. Counting goes on past
//   C, so the count (and the overflow report's need) is exact. Each block
//   re-reads the meta (20 KB at Suzanne's size) from L2.
// - bin_scan_kernel: one block scans the counts into the segments, the
//   work list, the total and the maximum.
// The counts between them are scratch the wrapper allocates for each
// call, so nothing needs clearing and two calls in flight share nothing.
//
// Exactness: integer arithmetic only; c > 0 and max(rx, 1) >= 1 where the
// quotient is used, so C's truncating division is the twin's floor
// division. shading_params computes the twin's floats op for op: sinf
// (never the fast __sinf; built without fast math and with -fmad=false,
// so effect[1] * (0.5f + 0.5f * sinf(effect[5] + effect[2])) is not
// contracted) equals torch.sin on the card.

#include <cuda_runtime.h>
#include <math.h>

#include "frame_counts.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;               // bin_rows_kernel
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;         // bin_scan_kernel
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int PARAM_THREADS = 128;         // shading_params_kernel
constexpr float EFFECT_EDGE_MELT = 2.0f;   // core/effects.py
constexpr float EFFECT_VOXELIZE = 3.0f;
constexpr float EFFECT_MIRAGE = 4.0f;

__global__ void __launch_bounds__(THREADS) bin_rows_kernel(
    const int* __restrict__ meta,  // (4, ld) rows: x0, y0, rx, c
    size_t ld, int T, int ntx, int C,
    int* __restrict__ bin_rows,    // (num_tiles, C)
    int* __restrict__ counts) {    // (num_tiles,) scratch
  __shared__ int warp_total[WARPS];
  const int j = blockIdx.x;
  const int jx = j % ntx, jy = j / ntx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int* row = bin_rows + (size_t)j * C;
  int run = 0;  // covering triangles before this chunk
  for (int base = 0; base < T; base += THREADS) {
    const int t = base + threadIdx.x;
    bool cov = false;
    if (t < T) {
      const int c = meta[3 * ld + t];
      if (c > 0) {
        const int x0 = meta[t], y0 = meta[ld + t], rx = meta[2 * ld + t];
        const int ry = c / max(rx, 1);
        cov = jx >= x0 && jx < x0 + rx && jy >= y0 && jy < y0 + ry;
      }
    }
    const unsigned m = __ballot_sync(FULL, cov);
    if (lane == 0) warp_total[warp] = __popc(m);
    __syncthreads();
    int before = run, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int s = warp_total[w];
      if (w < warp) before += s;
      total += s;
    }
    if (cov) {
      const int slot = before + __popc(m & below);
      if (slot < C) row[slot] = t;
    }
    run += total;
    __syncthreads();  // warp_total is rewritten by the next chunk
  }
  const int fill = max(T - 1, 0);
  for (int s = min(run, C) + threadIdx.x; s < C; s += THREADS) row[s] = fill;
  if (threadIdx.x == 0) counts[j] = run;
}

// Inclusive warp scan of v.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

__global__ void __launch_bounds__(SCAN_THREADS) bin_scan_kernel(
    const int* __restrict__ counts, int num_tiles, int C,
    int* __restrict__ seg_start, int* __restrict__ seg_count,
    int* __restrict__ worklist, int* __restrict__ scal, long long* acc) {
  __shared__ int s_sum[SCAN_WARPS];
  __shared__ int s_occ[SCAN_WARPS];
  __shared__ int s_max[SCAN_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0, carry_occ = 0, most = 0;
  for (int base = 0; base < num_tiles; base += SCAN_THREADS) {
    const int j = base + threadIdx.x;
    const int cnt = j < num_tiles ? counts[j] : 0;
    const int occ = cnt > 0;
    const int incl = warp_scan(cnt, lane);
    const int incl_occ = warp_scan(occ, lane);
    if (lane == 31) {
      s_sum[warp] = incl;
      s_occ[warp] = incl_occ;
    }
    __syncthreads();
    int before = carry, before_occ = carry_occ, total = 0, total_occ = 0;
#pragma unroll
    for (int w = 0; w < SCAN_WARPS; ++w) {
      const int s = s_sum[w], so = s_occ[w];
      if (w < warp) {
        before += s;
        before_occ += so;
      }
      total += s;
      total_occ += so;
    }
    if (j < num_tiles) {
      seg_start[j] = before + incl - cnt;
      seg_count[j] = min(cnt, C);
      if (occ) worklist[before_occ + incl_occ - 1] = j;
    }
    carry += total;
    carry_occ += total_occ;
    most = max(most, cnt);
    __syncthreads();  // s_sum / s_occ are rewritten by the next chunk
  }
  // The work list's padding: every slot past the occupied count is 0.
  for (int i = carry_occ + threadIdx.x; i < num_tiles; i += SCAN_THREADS)
    worklist[i] = 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    most = max(most, __shfl_xor_sync(FULL, most, o));
  if (lane == 0) s_max[warp] = most;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int w = 0; w < SCAN_WARPS; ++w) m = max(m, s_max[w]);
    scal[0] = 0;
    scal[1] = m > C ? m : 0;
    scal[2] = carry;
    scal[3] = carry_occ;
    scal[4] = m;
    fold_counts(acc, 0, scal[1], carry, carry_occ, m);
  }
}

__global__ void __launch_bounds__(PARAM_THREADS) shading_params_kernel(
    const float* __restrict__ effect,  // (6,)
    const float* __restrict__ vpos,    // (>= 3,)
    const float* __restrict__ lpos,    // (L, 3)
    const float* __restrict__ lcol,    // (L, 3)
    const float* __restrict__ lint,    // (L,)
    float* __restrict__ params,        // (11,)
    float* __restrict__ lights,        // (L, 8)
    int L, int y_offset) {
  if (threadIdx.x == 0) {
    const float etype = effect[0];
    const float melt = effect[1] * (0.5f + 0.5f * sinf(effect[5] + effect[2]));
    params[0] = etype == EFFECT_VOXELIZE ? -effect[1] : 0.0f;
    params[1] = etype == EFFECT_EDGE_MELT ? melt : -INFINITY;
    params[2] = etype == EFFECT_MIRAGE ? 1.0f : 0.0f;
    params[3] = effect[1];
    params[4] = effect[2];
    params[5] = effect[3];
    params[6] = effect[5];
    params[7] = (float)y_offset;
    params[8] = vpos[0];
    params[9] = vpos[1];
    params[10] = vpos[2];
  }
  // A light row: [position (3), color (3), intensity, 0].
  for (int q = threadIdx.x; q < L * 8; q += PARAM_THREADS) {
    const int r = q >> 3, col = q & 7;
    lights[q] = col < 3   ? lpos[r * 3 + col]
                : col < 6 ? lcol[r * 3 + col - 3]
                : col == 6 ? lint[r]
                           : 0.0f;
  }
}

}  // namespace

// counts: scratch of num_tiles ints; seg_start, seg_count and worklist
// (num_tiles,), bin_rows (num_tiles, C), scal (5,), acc (8,) long longs
// (frame_counts.cuh) or null. Two launches.
extern "C" int bin_tiles_dense(const void* meta, void* counts,
                               void* bin_rows, void* seg_start,
                               void* seg_count, void* worklist, void* scal,
                               void* acc, int ld, int T, int ntx,
                               int num_tiles, int C, void* stream) {
  if (ld < 0 || T < 0 || ntx <= 0 || num_tiles < 0 || C < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (num_tiles > 0)
    bin_rows_kernel<<<num_tiles, THREADS, 0, s>>>(
        (const int*)meta, (size_t)ld, T, ntx, C, (int*)bin_rows,
        (int*)counts);
  bin_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(
      (const int*)counts, num_tiles, C, (int*)seg_start, (int*)seg_count,
      (int*)worklist, (int*)scal, (long long*)acc);
  return (int)cudaGetLastError();
}

extern "C" int shading_params(const void* effect, const void* vpos,
                              const void* lpos, const void* lcol,
                              const void* lint, void* params, void* lights,
                              int L, int y_offset, void* stream) {
  if (L < 0) return (int)cudaErrorInvalidValue;
  shading_params_kernel<<<1, PARAM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)effect, (const float*)vpos, (const float*)lpos,
      (const float*)lcol, (const float*)lint, (float*)params, (float*)lights,
      L, y_offset);
  return (int)cudaGetLastError();
}

// Micro raster + shade of the mega-scene path (base mode): each 8x8 cell
// walks its own segment of the cell-sorted pair list.
//
// Replaces the TPU kernel of the JAX package's backends/pallas_micro.py
// (_micro_kernel_wl with _raster_tile_micro, launched by
// raster_shade_micro; the full-grid _micro_kernel is this kernel fed an
// all-tiles work list).
//
// One block per entry of the occupied-tile work list; a tile is 8x128
// pixels, sixteen 8x8 cells side by side, and warp c of the block owns
// cell c: 64 pixels, two per lane. The warp walks pair_tri[seg_start :
// seg_start + seg_count] of its cell in pair order, CHUNK pairs at a time:
// it loads the chunk's triangle ids (one per lane, coalesced), stages the
// 32-float coefficient rows table[pair_tri[p]] in shared memory (16-byte
// loads, eight lanes per row), then every lane reads each row as a
// broadcast. The coefficient rows are read in place: the P-sized pair
// stream the TPU kernel DMAs (pallas_micro.build_pair_coeffs) does not
// exist here. Per pair and pixel: three barycentrics and z as
// (A + B*dx) + C*dy, coverage min(bc) >= max(threshold, melt) with z
// finite, the u32 depth key, a strict-< running minimum — pairs arrive in
// ascending order, so this is the (key, pair)-lexicographic winner of the
// TPU kernel's lane-group butterfly — and the winner's six attributes. The
// epilogue is shade.cuh's, the tile raster's. Only the cell's own 64
// pixels are evaluated, so coverage outside a triangle's bbox (voxelize,
// mirage) clips to the 8x8 cell rectangles, as in the JAX package.
//
// What bounds it on an H100: by the roofline, memory (a 128-byte row and a
// 4-byte id per pair, against ~30 float operations for each of the 64
// pixels); in practice the longest cell, since a warp walks its segment
// alone: the densest San Miguel cell holds ~13x the mean occupied cell's
// pairs. Balancing cells across warps is later work. The grid is every
// tile; blocks past the occupied count (read on the device, no host
// synchronisation) exit at once, and the wrapper pre-clears the outputs.
//
// Exactness: built with -fmad=false and without fast math, the same op
// order as the eager torch twin; each barycentric is tested with >= so
// that a NaN fails (fminf would drop it); keys are __float_as_uint(z)
// compared unsigned, so -0.0 keys as 0x80000000.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "shade.cuh"

namespace {

constexpr int CELLS = 16;  // 8x8 cells per 8x128 tile: one warp each
constexpr int THREADS = 32 * CELLS;
constexpr int ROW = 32;    // coefficient floats per triangle
constexpr int QUADS = ROW / 4;  // float4 per row
constexpr int CHUNK = 16;  // pairs staged per warp per round
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(THREADS) micro_kernel(
    const float4* __restrict__ table,    // (T, 32) f32 as (T, 8) float4
    const int* __restrict__ pair_tri,    // (pair_cap,) cell-sorted
    const int* __restrict__ seg_start,   // (num_cells,)
    const int* __restrict__ seg_count,   // (num_cells,)
    const int* __restrict__ worklist,    // (num_tiles,) occupied ids first
    const int* __restrict__ num_work,    // () occupied count
    const float* __restrict__ params,    // (11,) raster.shading_inputs
    const float* __restrict__ lights,    // (L, 8)
    uint32_t* __restrict__ rgba,         // (Hp, Wp)
    uint32_t* __restrict__ key,          // (Hp, Wp)
    int num_lights, int ntx, int width_padded) {
  __shared__ float4 rows[CELLS][CHUNK * QUADS];  // 32 KB

  const int w = blockIdx.x;
  if (w >= *num_work) return;
  const int tile = worklist[w];
  const int cell = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = seg_start[tile * CELLS + cell];
  const int n = seg_count[tile * CELLS + cell];
  const int ti = tile / ntx;
  const int tj = tile - ti * ntx;

  const float cov_min = shade::coverage_min(params[0], params[1]);
  const bool mirage = params[2] > 0.5f;
  const float amplitude = params[3];
  const float frequency = params[4];
  const float phase = params[5];
  const float time = params[6];
  const float y0 = (float)(ti * 8) + params[7];
  const float x0 = (float)(tj * 128 + cell * 8);

  // Pixel j of this lane: q = lane + 32 j, row q / 8, column q % 8.
  float px[2], py[2];
  uint32_t best[2];
  float attr[2][6];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = lane + 32 * j;
    const float xs = (float)(q & 7) + x0;
    const float ys = (float)(q >> 3) + y0;
    px[j] = xs;
    py[j] = ys;
    if (mirage) {
      px[j] = xs + amplitude * sinf(frequency * xs + time + phase);
      py[j] = ys + amplitude * cosf(frequency * ys + time + phase);
    }
    best[j] = shade::KEY_CLEAR;
#pragma unroll
    for (int c = 0; c < 6; ++c) attr[j][c] = 0.0f;
  }

  float4* stage = rows[cell];
  for (int base = 0; base < n; base += CHUNK) {
    const int m = min(CHUNK, n - base);
    const int my_tri = lane < m ? pair_tri[s + base + lane] : 0;
    __syncwarp();  // the previous chunk is fully consumed
#pragma unroll
    for (int k = 0; k < CHUNK * QUADS / 32; ++k) {
      const int e = lane + 32 * k;
      const int r = e / QUADS;
      const int t = __shfl_sync(FULL, my_tri, r);
      if (r < m) stage[e] = table[(size_t)t * QUADS + (e - r * QUADS)];
    }
    __syncwarp();
    for (int k = 0; k < m; ++k) {
      const float* row = reinterpret_cast<const float*>(stage + k * QUADS);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float dx = px[j] - row[30];
        const float dy = py[j] - row[31];
        const float bc1 = row[0] + row[1] * dx + row[2] * dy;
        const float bc2 = row[3] + row[4] * dx + row[5] * dy;
        const float bc3 = row[6] + row[7] * dx + row[8] * dy;
        const float z = row[9] + row[10] * dx + row[11] * dy;
        const bool covered = (bc1 >= cov_min) && (bc2 >= cov_min) &&
                             (bc3 >= cov_min) && isfinite(z);
        const uint32_t kz = covered ? __float_as_uint(z) : shade::KEY_CLEAR;
        if (kz < best[j]) {
          best[j] = kz;
#pragma unroll
          for (int c = 0; c < 6; ++c)
            attr[j][c] = row[12 + 3 * c] + row[13 + 3 * c] * dx +
                         row[14 + 3 * c] * dy;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = lane + 32 * j;
    const size_t o = (size_t)(ti * 8 + (q >> 3)) * width_padded +
                     (size_t)(tj * 128 + cell * 8 + (q & 7));
    key[o] = best[j];
    rgba[o] = best[j] == shade::KEY_CLEAR
                  ? shade::BACKGROUND
                  : shade::shade_rgba(attr[j][0], attr[j][1], attr[j][2],
                                      attr[j][3], attr[j][4], attr[j][5],
                                      params, lights, num_lights);
  }
}

}  // namespace

extern "C" int raster_shade_micro_base(
    const void* table, const void* pair_tri, const void* seg_start,
    const void* seg_count, const void* worklist, const void* num_work,
    const void* params, const void* lights, void* rgba, void* key,
    int num_tiles, int num_lights, int ntx, int width_padded, void* stream) {
  if (num_tiles > 0) {
    micro_kernel<<<num_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)table, (const int*)pair_tri, (const int*)seg_start,
        (const int*)seg_count, (const int*)worklist, (const int*)num_work,
        (const float*)params, (const float*)lights, (uint32_t*)rgba,
        (uint32_t*)key, num_lights, ntx, width_padded);
  }
  return (int)cudaGetLastError();
}

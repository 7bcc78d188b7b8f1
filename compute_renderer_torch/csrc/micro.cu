// Micro raster + shade of the mega-scene path: each 8x8 cell walks its own
// segment of the cell-sorted pair list; base, material, fused-texture
// (texf), visibility (vis) and mip-filtered texture (texf_mip) modes.
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
// it loads the chunk's triangle ids (one per lane, coalesced) and stages,
// from each row table[pair_tri[p]], only the four float4 the walk reads
// (columns 0..11: barycentrics and depth; 28..31: the anchor), eight
// lanes per two rows with 16-byte loads; then every lane reads each staged
// row as a broadcast. The coefficient rows are read in place: the P-sized
// pair stream the TPU kernel DMAs (pallas_micro.build_pair_coeffs) does
// not exist here. Per pair and pixel: three barycentrics and z as
// (A + B*dx) + C*dy, coverage min(bc) >= max(threshold, melt) with z
// finite, the u32 depth key, and a strict-< running minimum that remembers
// the winner's table row — pairs arrive in ascending order, so this is the
// (key, pair)-lexicographic winner of the TPU kernel's lane-group
// butterfly. The epilogue (shade.cuh emit_pixel, the tile raster's)
// evaluates the winner's attributes from its row and shades (base,
// material: kd at columns 32:35) or writes a G-buffer (texf, texf_mip). In
// vis mode the walk remembers the winner's absolute pair index instead of
// its row (the strict < never adopts a pair on the CLEAR == CLEAR tie), and
// the epilogue writes it, or PAIR_IDX_CLEAR where the key stayed clear
// (pallas_micro.py:507-510, :624-629). Only the cell's
// own 64 pixels are evaluated, so coverage outside a triangle's bbox
// (voxelize, mirage) clips to the 8x8 cell rectangles, as in the JAX
// package.
//
// What bounds it on an H100: by the roofline, memory (a row of 128, 140,
// 176 or 184 bytes and a 4-byte id per pair, against ~30 float operations
// for each of the 64 pixels); in practice the longest cell, since a warp
// walks its segment alone: the densest cell holds over ten times the mean
// occupied cell's pairs. Balancing cells across warps is later work. The
// grid is every tile; blocks past the occupied count (read on the device,
// no host synchronisation) exit at once, and the wrapper pre-clears the
// outputs. The table's row stride is a multiple of four floats (the
// material table's 35 columns sit at a stride of 36, texf_mip's 46 at 48),
// so rows load as float4; the staging takes 16 KB of shared memory in
// every mode.
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
constexpr int SQUADS = 4;  // staged float4 per row: columns 0..11, 28..31
constexpr int CHUNK = 16;  // pairs staged per warp per round
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int PAIR_IDX_CLEAR = 0x7FFFFFFF;  // vis: no pair covers the pixel

template <int MODE>
__global__ void __launch_bounds__(THREADS) micro_kernel(
    const float* __restrict__ table,     // (T, row_stride) f32 rows
    const int* __restrict__ pair_tri,    // (pair_cap,) cell-sorted
    const int* __restrict__ seg_start,   // (num_cells,)
    const int* __restrict__ seg_count,   // (num_cells,)
    const int* __restrict__ worklist,    // (num_tiles,) occupied ids first
    const int* __restrict__ num_work,    // () occupied count
    const float* __restrict__ params,    // (11,) raster.shading_inputs
    const float* __restrict__ lights,    // (L, 8)
    void* __restrict__ out,              // (Hp, Wp) u32 | i32 | (C, Hp, Wp) f32
    uint32_t* __restrict__ key,          // (Hp, Wp)
    int row_stride, int num_lights, int ntx, int width_padded,
    size_t plane) {
  __shared__ float4 rows[CELLS][CHUNK * SQUADS];  // 16 KB

  const int w = blockIdx.x;
  if (w >= *num_work) return;
  const int tile = worklist[w];
  const int cell = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = seg_start[tile * CELLS + cell];
  const int n = seg_count[tile * CELLS + cell];
  const int ti = tile / ntx;
  const int tj = tile - ti * ntx;
  const float4* table4 = reinterpret_cast<const float4*>(table);
  const int row_quads = row_stride / 4;

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
  int winner[2];  // the winner's table row (vis: pair index), -1 for none
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
    winner[j] = -1;
  }

  float4* stage = rows[cell];
  for (int base = 0; base < n; base += CHUNK) {
    const int m = min(CHUNK, n - base);
    const int my_tri = lane < m ? pair_tri[s + base + lane] : 0;
    __syncwarp();  // the previous chunk is fully consumed
#pragma unroll
    for (int k = 0; k < CHUNK * SQUADS / 32; ++k) {
      const int e = lane + 32 * k;
      const int r = e / SQUADS;
      const int q = e - r * SQUADS;
      const int t = __shfl_sync(FULL, my_tri, r);
      // Staged quads 0, 1, 2, 3 are the row's quads 0, 1, 2 and 7.
      if (r < m) stage[e] = table4[(size_t)t * row_quads + (q < 3 ? q : 7)];
    }
    __syncwarp();
    for (int k = 0; k < m; ++k) {
      const float* row = reinterpret_cast<const float*>(stage + k * SQUADS);
      const int t = __shfl_sync(FULL, my_tri, k);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float dx = px[j] - row[14];  // column 30
        const float dy = py[j] - row[15];  // column 31
        const float bc1 = row[0] + row[1] * dx + row[2] * dy;
        const float bc2 = row[3] + row[4] * dx + row[5] * dy;
        const float bc3 = row[6] + row[7] * dx + row[8] * dy;
        const float z = row[9] + row[10] * dx + row[11] * dy;
        const bool covered = (bc1 >= cov_min) && (bc2 >= cov_min) &&
                             (bc3 >= cov_min) && isfinite(z);
        const uint32_t kz = covered ? __float_as_uint(z) : shade::KEY_CLEAR;
        if (kz < best[j]) {
          best[j] = kz;
          winner[j] = MODE == shade::MODE_VIS ? s + base + k : t;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = lane + 32 * j;
    const size_t o = (size_t)(ti * 8 + (q >> 3)) * width_padded +
                     (size_t)(tj * 128 + cell * 8 + (q & 7));
    const float* row = (MODE == shade::MODE_VIS || winner[j] < 0)
                           ? nullptr
                           : table + (size_t)winner[j] * row_stride;
    const int id = winner[j] < 0 ? PAIR_IDX_CLEAR : winner[j];
    shade::emit_pixel<MODE>(row, id, px[j], py[j], best[j], params, lights,
                            num_lights, out, key, o, plane);
  }
}

}  // namespace

extern "C" int raster_shade_micro(
    const void* table, const void* pair_tri, const void* seg_start,
    const void* seg_count, const void* worklist, const void* num_work,
    const void* params, const void* lights, void* out, void* key, int mode,
    int row_stride, int num_tiles, int num_lights, int ntx, int width_padded,
    void* stream) {
  if (row_stride % 4 != 0 || ((uintptr_t)table & 15) != 0)
    return (int)cudaErrorMisalignedAddress;  // rows load as float4
  if (num_tiles > 0) {
    const size_t plane = (size_t)num_tiles * 8 * 128;
#define MICRO_ARGS                                                           \
  (const float*)table, (const int*)pair_tri, (const int*)seg_start,         \
      (const int*)seg_count, (const int*)worklist, (const int*)num_work,    \
      (const float*)params, (const float*)lights, out, (uint32_t*)key,      \
      row_stride, num_lights, ntx, width_padded, plane
    cudaStream_t s = (cudaStream_t)stream;
    switch (mode) {
      case shade::MODE_BASE:
        micro_kernel<shade::MODE_BASE><<<num_tiles, THREADS, 0, s>>>(
            MICRO_ARGS);
        break;
      case shade::MODE_MAT:
        micro_kernel<shade::MODE_MAT><<<num_tiles, THREADS, 0, s>>>(
            MICRO_ARGS);
        break;
      case shade::MODE_TEXF:
        micro_kernel<shade::MODE_TEXF><<<num_tiles, THREADS, 0, s>>>(
            MICRO_ARGS);
        break;
      case shade::MODE_VIS:
        micro_kernel<shade::MODE_VIS><<<num_tiles, THREADS, 0, s>>>(
            MICRO_ARGS);
        break;
      case shade::MODE_TEXF_MIP:
        micro_kernel<shade::MODE_TEXF_MIP><<<num_tiles, THREADS, 0, s>>>(
            MICRO_ARGS);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef MICRO_ARGS
  }
  return (int)cudaGetLastError();
}

// Raster + shade over the occupied framebuffer tiles (tile path), in the
// base, material, fused-texture (texf), visibility (vis, deferred
// texturing) and mip-filtered texture (texf_mip) modes.
//
// Replaces the TPU kernel of the JAX package's backends/pallas_raster.py
// (_raster_kernel_wl with _raster_tile, launched by raster_shade_tiles;
// the full-grid _raster_kernel is this kernel fed an all-tiles list).
//
// One block per entry of the occupied-tile work list; its threads own the
// tile's pixels (up to MAX_TILE_PIXELS, PIXELS_PER_THREAD each, a warp on
// 32 neighbouring pixels of a row so that every store is coalesced). The
// block walks the tile's triangle list — row `tile` of the dense bin_rows,
// or pair_tri[seg_start : seg_start + seg_count] of the flat list — in
// chunks of CHUNK triangles, staging in shared memory only the 14 columns
// the walk reads (barycentrics, depth, anchor); every thread then reads
// each staged row as a broadcast. Per triangle and pixel: three
// barycentrics and z as (A + B*dx) + C*dy, the coverage test, the u32
// depth key and a strict-< running minimum (the lowest triangle wins ties,
// as the list is in ascending triangle order) that remembers the winner's
// table row. The mode only changes the epilogue (shade.cuh emit_pixel):
// the winner's attributes are evaluated from its row there, then shaded
// (base, material) or written as the G-buffer (texf, texf_mip); in vis
// mode the winner's table row itself is written (-1 where no triangle
// covers), the id the walk already carries. Empty tiles never launch
// work: the wrapper pre-clears the outputs (background, -1 ids or zero
// G-buffer, cleared key), the JAX package's aliased-clear semantics.
//
// What bounds it on an H100: arithmetic in the walk, about 30 float
// operations per (triangle, pixel) pair, with nothing read from device
// memory in the inner loop. The grid has no host-side size: it is
// num_tiles blocks and each block exits when its index is past the
// occupied count, which stays on the device (no host synchronisation per
// frame). At the main path's scale only a few dozen tiles are occupied,
// so most SMs idle; splitting a tile across blocks is later work. The
// walk carries two registers a pixel whatever the mode (key and winner),
// so the texf modes' 14 or 16 attributes cost no registers in the loop.
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

namespace {

constexpr int THREADS = 512;
constexpr int PIXELS_PER_THREAD = 8;
constexpr int MAX_TILE_PIXELS = THREADS * PIXELS_PER_THREAD;  // 16 x 256
constexpr int SROW = 14;   // staged columns: 0..11 (bc, z) and 30, 31
constexpr int CHUNK = 64;  // triangles staged in shared memory per round
constexpr uint32_t KEY_CLEAR = shade::KEY_CLEAR;

__device__ __forceinline__ int staged_column(int c) {
  return c < 12 ? c : c + 18;  // 12 -> 30, 13 -> 31
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) raster_kernel(
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
    int row_stride, int num_lights, int ntx, int tile_h, int tile_w,
    int width_padded, size_t plane, int dense, int list_stride) {
  __shared__ float rows[CHUNK * SROW];
  __shared__ int ids[CHUNK];

  const int w = blockIdx.x;
  if (w >= *num_work) return;
  const int tile = worklist[w];
  const int count = seg_count[tile];
  const int* list = dense ? pair_data + (size_t)tile * list_stride
                          : pair_data + seg_start[tile];
  const int ti = tile / ntx;
  const int tj = tile - ti * ntx;
  const int npix = tile_h * tile_w;

  const float cov_min = shade::coverage_min(params[0], params[1]);
  const bool mirage = params[2] > 0.5f;
  const float amplitude = params[3];
  const float frequency = params[4];
  const float phase = params[5];
  const float time = params[6];
  const float y0 = (float)(ti * tile_h) + params[7];
  const float x0 = (float)(tj * tile_w);

  float px[PIXELS_PER_THREAD], py[PIXELS_PER_THREAD];
  uint32_t best[PIXELS_PER_THREAD];
  int winner[PIXELS_PER_THREAD];  // table row of the winner, -1 for none
#pragma unroll
  for (int j = 0; j < PIXELS_PER_THREAD; ++j) {
    const int p = threadIdx.x + j * THREADS;
    const int r = p / tile_w;
    const float xs = (float)(p - r * tile_w) + x0;
    const float ys = (float)r + y0;
    px[j] = xs;
    py[j] = ys;
    if (mirage) {
      px[j] = xs + amplitude * sinf(frequency * xs + time + phase);
      py[j] = ys + amplitude * cosf(frequency * ys + time + phase);
    }
    best[j] = KEY_CLEAR;
    winner[j] = -1;
  }

  for (int base = 0; base < count; base += CHUNK) {
    const int n = min(CHUNK, count - base);
    __syncthreads();  // the previous chunk is fully consumed
    if (threadIdx.x < n) ids[threadIdx.x] = list[base + threadIdx.x];
    for (int e = threadIdx.x; e < n * SROW; e += THREADS) {
      const int k = e / SROW;
      rows[e] = table[(size_t)list[base + k] * row_stride +
                      staged_column(e - k * SROW)];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* row = rows + k * SROW;
      const int t = ids[k];
#pragma unroll
      for (int j = 0; j < PIXELS_PER_THREAD; ++j) {
        const float dx = px[j] - row[12];
        const float dy = py[j] - row[13];
        const float bc1 = row[0] + row[1] * dx + row[2] * dy;
        const float bc2 = row[3] + row[4] * dx + row[5] * dy;
        const float bc3 = row[6] + row[7] * dx + row[8] * dy;
        const float z = row[9] + row[10] * dx + row[11] * dy;
        const bool covered = (bc1 >= cov_min) && (bc2 >= cov_min) &&
                             (bc3 >= cov_min) && isfinite(z);
        const uint32_t kz = covered ? __float_as_uint(z) : KEY_CLEAR;
        if (kz < best[j]) {
          best[j] = kz;
          winner[j] = t;
        }
      }
    }
  }

  // --- epilogue (shade.cuh): resolve the winner's row, shade or emit ------
#pragma unroll
  for (int j = 0; j < PIXELS_PER_THREAD; ++j) {
    const int p = threadIdx.x + j * THREADS;
    if (p >= npix) continue;
    const int r = p / tile_w;
    const size_t o = (size_t)(ti * tile_h + r) * width_padded +
                     (size_t)(tj * tile_w + (p - r * tile_w));
    const float* row =
        winner[j] < 0 ? nullptr : table + (size_t)winner[j] * row_stride;
    shade::emit_pixel<MODE>(row, winner[j], px[j], py[j], best[j], params,
                            lights, num_lights, out, key, o, plane);
  }
}

}  // namespace

extern "C" int raster_shade_tiles(
    const void* table, const void* pair_data, const void* seg_start,
    const void* seg_count, const void* worklist, const void* num_work,
    const void* params, const void* lights, void* out, void* key, int mode,
    int row_stride, int num_tiles, int num_lights, int ntx, int tile_h,
    int tile_w, int width_padded, int dense, int list_stride, void* stream) {
  if (tile_h * tile_w > MAX_TILE_PIXELS) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    const size_t plane = (size_t)num_tiles * tile_h * tile_w;
#define RASTER_ARGS                                                          \
  (const float*)table, (const int*)pair_data, (const int*)seg_start,        \
      (const int*)seg_count, (const int*)worklist, (const int*)num_work,    \
      (const float*)params, (const float*)lights, out, (uint32_t*)key,      \
      row_stride, num_lights, ntx, tile_h, tile_w, width_padded, plane,     \
      dense, list_stride
    cudaStream_t s = (cudaStream_t)stream;
    switch (mode) {
      case shade::MODE_BASE:
        raster_kernel<shade::MODE_BASE><<<num_tiles, THREADS, 0, s>>>(
            RASTER_ARGS);
        break;
      case shade::MODE_MAT:
        raster_kernel<shade::MODE_MAT><<<num_tiles, THREADS, 0, s>>>(
            RASTER_ARGS);
        break;
      case shade::MODE_TEXF:
        raster_kernel<shade::MODE_TEXF><<<num_tiles, THREADS, 0, s>>>(
            RASTER_ARGS);
        break;
      case shade::MODE_VIS:
        raster_kernel<shade::MODE_VIS><<<num_tiles, THREADS, 0, s>>>(
            RASTER_ARGS);
        break;
      case shade::MODE_TEXF_MIP:
        raster_kernel<shade::MODE_TEXF_MIP><<<num_tiles, THREADS, 0, s>>>(
            RASTER_ARGS);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef RASTER_ARGS
  }
  return (int)cudaGetLastError();
}

// Raster + shade over the occupied framebuffer tiles (tile path, base mode).
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
// chunks of CHUNK triangles whose 32-float coefficient rows it stages in
// shared memory; every thread then reads each row as a broadcast. Per
// triangle and pixel: three barycentrics and z as (A + B*dx) + C*dy, the
// coverage test, the u32 depth key, a strict-< running minimum (the lowest
// triangle wins ties, as the list is in ascending triangle order), and the
// six attributes of the winner. The epilogue shades (ambient + Lambert +
// pow32 Phong per light, gamma) and packs RGBA. Empty tiles never launch
// work: the wrapper pre-clears the outputs to the background and the
// cleared key, the JAX package's aliased-clear semantics.
//
// What bounds it on an H100: arithmetic in the walk, about 30 float
// operations per (triangle, pixel) pair, with nothing read from device
// memory in the inner loop. The grid has no host-side size: it is
// num_tiles blocks and each block exits when its index is past the
// occupied count, which stays on the device (no host synchronisation per
// frame). At the main path's scale only a few dozen tiles are occupied,
// so most SMs idle; splitting a tile across blocks is later work.
//
// Exactness: built with -fmad=false and without fast math, so each
// (A + B*dx) + C*dy is two roundings as in the eager torch twin. Coverage
// is (bc1>=t)&(bc2>=t)&(bc3>=t), which fails for a NaN barycentric exactly
// as the JAX min-then-compare does (fminf would drop the NaN and let
// degenerate triangles cover pixels). Keys are __float_as_uint(z) compared
// unsigned, so -0.0 keys as 0x80000000. Rounding is rintf (half to even,
// like jnp.round); the specular power is five squarings, not powf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "shade.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int PIXELS_PER_THREAD = 8;
constexpr int MAX_TILE_PIXELS = THREADS * PIXELS_PER_THREAD;  // 16 x 256
constexpr int ROW = 32;    // coefficient floats per triangle
constexpr int CHUNK = 64;  // triangles staged in shared memory per round
constexpr uint32_t KEY_CLEAR = shade::KEY_CLEAR;

__global__ void __launch_bounds__(THREADS) raster_kernel(
    const float* __restrict__ table,    // (T, 32)
    const int* __restrict__ pair_data,  // dense (num_tiles, row_stride) | flat
    const int* __restrict__ seg_start,  // (num_tiles,)
    const int* __restrict__ seg_count,  // (num_tiles,)
    const int* __restrict__ worklist,   // (num_tiles,) occupied ids first
    const int* __restrict__ num_work,   // () occupied count
    const float* __restrict__ params,   // (11,) raster.shading_inputs
    const float* __restrict__ lights,   // (L, 8)
    uint32_t* __restrict__ rgba,        // (Hp, Wp)
    uint32_t* __restrict__ key,         // (Hp, Wp)
    int num_lights, int ntx, int tile_h, int tile_w, int width_padded,
    int dense, int row_stride) {
  __shared__ float rows[CHUNK * ROW];

  const int w = blockIdx.x;
  if (w >= *num_work) return;
  const int tile = worklist[w];
  const int count = seg_count[tile];
  const int* list = dense ? pair_data + (size_t)tile * row_stride
                          : pair_data + seg_start[tile];
  const int ti = tile / ntx;
  const int tj = tile - ti * ntx;
  const int npix = tile_h * tile_w;

  const float threshold = params[0];
  const float melt = params[1];
  const float cov_min = shade::coverage_min(threshold, melt);
  const bool mirage = params[2] > 0.5f;
  const float amplitude = params[3];
  const float frequency = params[4];
  const float phase = params[5];
  const float time = params[6];
  const float y0 = (float)(ti * tile_h) + params[7];
  const float x0 = (float)(tj * tile_w);

  float px[PIXELS_PER_THREAD], py[PIXELS_PER_THREAD];
  uint32_t best[PIXELS_PER_THREAD];
  float attr[PIXELS_PER_THREAD][6];
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
#pragma unroll
    for (int c = 0; c < 6; ++c) attr[j][c] = 0.0f;
  }

  for (int base = 0; base < count; base += CHUNK) {
    const int n = min(CHUNK, count - base);
    __syncthreads();  // the previous chunk is fully consumed
    for (int e = threadIdx.x; e < n * ROW; e += THREADS) {
      const int k = e / ROW;
      rows[e] = table[(size_t)list[base + k] * ROW + (e - k * ROW)];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* row = rows + k * ROW;
#pragma unroll
      for (int j = 0; j < PIXELS_PER_THREAD; ++j) {
        const float dx = px[j] - row[30];
        const float dy = py[j] - row[31];
        const float bc1 = row[0] + row[1] * dx + row[2] * dy;
        const float bc2 = row[3] + row[4] * dx + row[5] * dy;
        const float bc3 = row[6] + row[7] * dx + row[8] * dy;
        const float z = row[9] + row[10] * dx + row[11] * dy;
        const bool covered = (bc1 >= cov_min) && (bc2 >= cov_min) &&
                             (bc3 >= cov_min) && isfinite(z);
        const uint32_t kz = covered ? __float_as_uint(z) : KEY_CLEAR;
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

  // --- shading epilogue (fragment.wgsl:50-93, shade.cuh) ------------------
#pragma unroll
  for (int j = 0; j < PIXELS_PER_THREAD; ++j) {
    const int p = threadIdx.x + j * THREADS;
    if (p >= npix) continue;
    const int r = p / tile_w;
    const size_t o = (size_t)(ti * tile_h + r) * width_padded +
                     (size_t)(tj * tile_w + (p - r * tile_w));
    key[o] = best[j];
    rgba[o] = best[j] == KEY_CLEAR
                  ? shade::BACKGROUND
                  : shade::shade_rgba(attr[j][0], attr[j][1], attr[j][2],
                                      attr[j][3], attr[j][4], attr[j][5],
                                      params, lights, num_lights);
  }
}

}  // namespace

extern "C" int raster_shade_tiles_base(
    const void* table, const void* pair_data, const void* seg_start,
    const void* seg_count, const void* worklist, const void* num_work,
    const void* params, const void* lights, void* rgba, void* key,
    int num_tiles, int num_lights, int ntx, int tile_h, int tile_w,
    int width_padded, int dense, int row_stride, void* stream) {
  if (tile_h * tile_w > MAX_TILE_PIXELS) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    raster_kernel<<<num_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)table, (const int*)pair_data, (const int*)seg_start,
        (const int*)seg_count, (const int*)worklist, (const int*)num_work,
        (const float*)params, (const float*)lights, (uint32_t*)rgba,
        (uint32_t*)key, num_lights, ntx, tile_h, tile_w, width_padded, dense,
        row_stride);
  }
  return (int)cudaGetLastError();
}

// Fused front end: vertex stage + triangle setup + anchored-affine
// coefficient rows, one thread per triangle, at tile or 8x8-cell
// granularity, written as the rasters' (T, R) table.
//
// Replaces the TPU kernel of the JAX package's backends/pallas_front.py
// (_front_kernel, launched by front_end) in its three modes: base (32
// coefficient rows), mat (35: the per-triangle kd appended) and texf (44:
// the uv affine triples, kd or ones, and the TextureInfo row appended;
// pallas_front.py:223-235); and in a fourth the JAX package builds with
// XLA ops because its front cannot see the frame's mip rows
// (tpu.py:213-217): texf_mip (46: as texf with the frame's (T, 5)
// common.mip_tri_rows block in place of the TextureInfo row).
//
// What bounds it on an H100: memory traffic. Each triangle reads 18 floats
// (corner-SoA positions and normals; mat adds 3 kd floats, texf 6 uv, 3 kd
// and 3 TextureInfo floats, texf_mip 5 mip floats in place of the last 3)
// and writes its table row and 4 meta ints — 216, 240, 312 or 328 bytes
// for ~300 float operations, far below the card's compute-to-bandwidth
// balance, so the kernel is a streaming pass.
//
// Output layout: the (T, R) table the two rasters read, with a row stride
// S = R rounded up to a multiple of 4 floats (32, 36, 44, 48) on a 16-byte
// aligned base (raster.kernel_table), so no copy sits between the front
// and the rasters. Meta stays (4, T), triangle-fastest.
//
// Design. One thread per triangle computes its row in registers. A warp
// storing rows straight to the table would touch 32 rows 4*S bytes apart
// per instruction, so the rows are first staged in shared memory, each
// thread writing its row as S/4 float4s, and the block's threads then
// copy the block's contiguous slice of the table (block triangles x S
// floats) out with coalesced 16-byte stores. The staging stride is padded
// to an odd number of float4s (32 -> 36, 48 -> 52 floats), so that the
// eight float4 writes of a quarter warp land on distinct banks. Blocks of
// 128 threads keep the largest staging area (128 x 52 floats, 26 KiB)
// under the 48 KiB static limit with eight blocks an SM; the tile path's
// 1,280 triangles are 10 blocks, where the launch itself dominates. Meta
// is stored directly, coalesced. The pad column of a row is written 0.
//
// Exactness: the arithmetic is the JAX package's op for op, in the same
// association: clip sums as (m0*x + m1*y) + (m2*z + m3), IEEE division,
// floor/ceil of IEEE quotients for the tile rect, a1 = 1 + 0*inv (NaN for
// degenerate triangles). Built with -fmad=false and without fast math, so
// no mul+add is contracted and the results equal the eager torch twin's.
// The kd, TextureInfo and mip rows are copied, not computed.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float EFFECT_WAVE = 1.0f;
constexpr float EFFECT_VOXELIZE = 3.0f;
constexpr int THREADS = 128;
constexpr int MODE_BASE = 0;  // raster.MODES
constexpr int MODE_MAT = 1;
constexpr int MODE_TEXF = 2;
constexpr int MODE_TEXF_MIP = 4;  // 3 is the rasters' vis (base table)

// Table columns R of a mode (raster.MODE_WIDTHS) and the row stride S.
__host__ __device__ constexpr int width_of(int mode) {
  return mode == MODE_BASE ? 32 : mode == MODE_MAT ? 35
         : mode == MODE_TEXF ? 44 : 46;
}
__host__ __device__ constexpr int stride_of(int mode) {
  return (width_of(mode) + 3) / 4 * 4;
}
// The staging stride: an odd number of float4s.
__host__ __device__ constexpr int padded(int s) {
  return (s / 4) % 2 ? s : s + 4;
}

// Triangle t's meta (stored) and its table row in v[0, S): the R columns,
// then 0 in the pad.
template <int MODE>
__device__ __forceinline__ void triangle_row(
    const float* __restrict__ pos, const float* __restrict__ nrm,
    const float* __restrict__ scal, const float* __restrict__ kd,
    const float* __restrict__ uv, const float* __restrict__ tex,
    int* __restrict__ meta, int t, int T, int width, int height, int tile_h,
    int tile_w, float (&v)[stride_of(MODE)]) {
  float m[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) m[r] = scal[r];
  const float etype = scal[16];
  const float amplitude = scal[17];
  const float frequency = scal[18];
  const float phase = scal[19];
  const float direction = scal[20];
  const bool is_wave = etype == EFFECT_WAVE;
  const bool vertical = direction < 0.5f;
  const bool horizontal = (direction >= 0.5f) && (direction < 1.5f);

  // --- vertex stage (common.vertex_stage) ---------------------------------
  float sx[3], sy[3], sz[3], sw[3], wld[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float x = pos[(3 * k + 0) * T + t];
    const float y = pos[(3 * k + 1) * T + t];
    const float z = pos[(3 * k + 2) * T + t];
    float wx = x, wy = y, wz = z;
    if (is_wave) {
      const float dy = amplitude * sinf(frequency * x + phase);
      const float dx = amplitude * sinf(frequency * y + phase);
      const float dist = sqrtf(x * x + y * y);
      const float dz = amplitude * sinf(frequency * dist + phase);
      if (horizontal) wx = x + dx;
      if (vertical) wy = y + dy;
      if (!(vertical || horizontal)) wz = z + dz;
    }
    const float cx = (m[0] * wx + m[1] * wy) + (m[2] * wz + m[3]);
    const float cy = (m[4] * wx + m[5] * wy) + (m[6] * wz + m[7]);
    const float cz = (m[8] * wx + m[9] * wy) + (m[10] * wz + m[11]);
    const float cw = (m[12] * wx + m[13] * wy) + (m[14] * wz + m[15]);
    const float ndc_x = cx / cw;
    const float ndc_y = cy / cw;
    sx[k] = (ndc_x + 1.0f) * 0.5f * (float)width;
    sy[k] = (1.0f - ndc_y) * 0.5f * (float)height;
    sz[k] = cz / cw;
    sw[k] = cw;
    wld[k][0] = wx;
    wld[k][1] = wy;
    wld[k][2] = wz;
  }
  const float v1x = sx[0], v1y = sy[0];
  const float v2x = sx[1], v2y = sy[1];
  const float v3x = sx[2], v3y = sy[2];

  // --- triangle setup (common.triangle_setup) -----------------------------
  const bool w_ok = !((sw[0] < 0.0f) || (sw[1] < 0.0f) || (sw[2] < 0.0f));
  // NaN corners make the triangle dead through `finite` below, and dead
  // triangles never read the bbox, so fminf/fmaxf dropping a NaN is safe.
  const float min_x = fminf(fminf(v1x, v2x), v3x);
  const float max_x = fmaxf(fmaxf(v1x, v2x), v3x);
  const float min_y = fminf(fminf(v1y, v2y), v3y);
  const float max_y = fmaxf(fmaxf(v1y, v2y), v3y);
  const bool on_screen = !((max_x < 0.0f) || (min_x >= (float)width) ||
                           (max_y < 0.0f) || (min_y >= (float)height));
  const float ax_e = v2x - v1x;
  const float ay_e = v2y - v1y;
  const float bx_e = v3x - v1x;
  const float by_e = v3y - v1y;
  const float cross_z = ax_e * by_e - ay_e * bx_e;
  const bool facing = (etype == EFFECT_VOXELIZE) || (cross_z < 0.0f);
  const bool finite = isfinite(v1x) && isfinite(v2x) && isfinite(v3x) &&
                      isfinite(v1y) && isfinite(v2y) && isfinite(v3y);
  bool alive = w_ok && on_screen && facing && finite;

  const float cb_min_x = alive ? fmaxf(min_x, 0.0f) : 0.0f;
  const float cb_min_y = alive ? fmaxf(min_y, 0.0f) : 0.0f;
  const float cb_max_x = alive ? fminf(max_x, (float)width - 1.0f) : 0.0f;
  const float cb_max_y = alive ? fminf(max_y, (float)height - 1.0f) : 0.0f;
  const int ntx = (width + tile_w - 1) / tile_w;
  const int nty = (height + tile_h - 1) / tile_h;
  const int tile_x0 = (int)fmaxf(floorf(cb_min_x / (float)tile_w), 0.0f);
  const int tile_y0 = (int)fmaxf(floorf(cb_min_y / (float)tile_h), 0.0f);
  int tile_x1 = (int)fminf(ceilf(cb_max_x / (float)tile_w), (float)ntx);
  int tile_y1 = (int)fminf(ceilf(cb_max_y / (float)tile_h), (float)nty);
  alive = alive && (tile_x1 > tile_x0) && (tile_y1 > tile_y0);
  if (!alive) {
    tile_x1 = tile_x0;
    tile_y1 = tile_y0;
  }
  const int rx = tile_x1 - tile_x0;
  const int ry = tile_y1 - tile_y0;
  meta[0 * T + t] = tile_x0;
  meta[1 * T + t] = tile_y0;
  meta[2 * T + t] = rx;
  meta[3 * T + t] = alive ? rx * ry : 0;

  // --- anchored-affine coefficients (raster.tri_table_columns) ------------
  const float bux = v2y - v1y;
  const float cux = -(v2x - v1x);
  const float buy = -(v3y - v1y);
  const float cuy = v3x - v1x;
  const float uz = (v3x - v1x) * (v2y - v1y) - (v2x - v1x) * (v3y - v1y);
  const float inv = 1.0f / uz;
  const float zero = 0.0f;
  const float a1 = 1.0f + zero * inv;  // NaN for degenerate uz
  const float b1 = -(bux + buy) * inv;
  const float c1 = -(cux + cuy) * inv;
  const float a2 = zero * inv;
  const float b2 = buy * inv;
  const float c2 = cuy * inv;
  const float a3 = zero * inv;
  const float b3 = bux * inv;
  const float c3 = cux * inv;

  int row = 0;
  auto put = [&](float x) { v[row++] = x; };
  auto combine = [&](float w1, float w2, float w3) {
    put(w1 * a1 + w2 * a2 + w3 * a3);
    put(w1 * b1 + w2 * b2 + w3 * b3);
    put(w1 * c1 + w2 * c2 + w3 * c3);
  };
  put(a1); put(b1); put(c1);
  put(a2); put(b2); put(c2);
  put(a3); put(b3); put(c3);
  combine(sz[0], sz[1], sz[2]);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)  // normals: rows (corner*3 + ch)
    combine(nrm[(0 + ch) * T + t], nrm[(3 + ch) * T + t],
            nrm[(6 + ch) * T + t]);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)  // world positions
    combine(wld[0][ch], wld[1][ch], wld[2][ch]);
  put(v1x);
  put(v1y);
  constexpr bool TEX = MODE == MODE_TEXF || MODE == MODE_TEXF_MIP;
  constexpr int NTEX = MODE == MODE_TEXF_MIP ? 5 : 3;
  if constexpr (TEX) {
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)  // uv: rows (corner*2 + ch)
      combine(uv[(0 + ch) * T + t], uv[(2 + ch) * T + t],
              uv[(4 + ch) * T + t]);
  }
  if constexpr (MODE != MODE_BASE) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      put(kd != nullptr ? kd[(size_t)3 * t + c] : 1.0f);
  }
  if constexpr (TEX) {
#pragma unroll
    for (int c = 0; c < NTEX; ++c) put(tex[(size_t)NTEX * t + c]);
  }
#pragma unroll
  for (int k = width_of(MODE); k < stride_of(MODE); ++k) v[k] = 0.0f;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) front_kernel(
    const float* __restrict__ pos,   // (3 corners * 3 comps, T)
    const float* __restrict__ nrm,   // (3 corners * 3 comps, T)
    const float* __restrict__ scal,  // view_proj row-major (16) + effect (6)
    const float* __restrict__ kd,    // (T, 3) or null (texf: ones)
    const float* __restrict__ uv,    // (3 corners * 2 comps, T), texf*
    const float* __restrict__ tex,   // (T, 3) TextureInfo | (T, 5) mip rows
    float* __restrict__ table,       // (T, S): rows of 32 | 35 | 44 | 46
    int* __restrict__ meta,          // (4, T): tile_x0, tile_y0, rx, c
    int T, int width, int height, int tile_h, int tile_w) {
  constexpr int S = stride_of(MODE);
  constexpr int Q = S / 4;  // float4s a row
  constexpr int SS = padded(S);
  __shared__ __align__(16) float stage[THREADS * SS];
  const int t0 = blockIdx.x * THREADS;
  const int t = t0 + threadIdx.x;
  const int rows = min(THREADS, T - t0);
  if (t < T) {
    float v[S];
    triangle_row<MODE>(pos, nrm, scal, kd, uv, tex, meta, t, T, width,
                       height, tile_h, tile_w, v);
    float4* mine = reinterpret_cast<float4*>(stage + threadIdx.x * SS);
#pragma unroll
    for (int k = 0; k < Q; ++k)
      mine[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                            v[4 * k + 3]);
  }
  __syncthreads();
  // The slice is 16-byte aligned: S % 4 == 0.
  float4* out = reinterpret_cast<float4*>(table + (size_t)t0 * S);
  for (int q = threadIdx.x; q < rows * Q; q += THREADS) {
    const int r = q / Q;
    out[q] = reinterpret_cast<const float4*>(stage + r * SS)[q - r * Q];
  }
}

}  // namespace

extern "C" int front_end(const void* pos, const void* nrm, const void* scal,
                         const void* kd, const void* uv, const void* tex,
                         void* table, void* meta, int mode, int T, int width,
                         int height, int tile_h, int tile_w, void* stream) {
  if ((mode == MODE_MAT && kd == nullptr) ||
      ((mode == MODE_TEXF || mode == MODE_TEXF_MIP) &&
       (uv == nullptr || tex == nullptr)) ||
      (reinterpret_cast<unsigned long long>(table) & 15))
    return (int)cudaErrorInvalidValue;
  if (T > 0) {
    const int blocks = (T + THREADS - 1) / THREADS;
#define FRONT_ARGS                                                          \
  (const float*)pos, (const float*)nrm, (const float*)scal,                \
      (const float*)kd, (const float*)uv, (const float*)tex, (float*)table, \
      (int*)meta, T, width, height, tile_h, tile_w
#define FRONT_LAUNCH(M)                                      \
  front_kernel<M><<<blocks, THREADS, 0, s>>>(FRONT_ARGS);  \
  break;
    cudaStream_t s = (cudaStream_t)stream;
    switch (mode) {
      case MODE_BASE: FRONT_LAUNCH(MODE_BASE)
      case MODE_MAT: FRONT_LAUNCH(MODE_MAT)
      case MODE_TEXF: FRONT_LAUNCH(MODE_TEXF)
      case MODE_TEXF_MIP: FRONT_LAUNCH(MODE_TEXF_MIP)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef FRONT_LAUNCH
#undef FRONT_ARGS
  }
  return (int)cudaGetLastError();
}

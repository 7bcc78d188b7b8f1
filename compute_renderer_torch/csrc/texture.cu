// The texture stages of a frame: the fused tails that sample the atlas and
// shade the rasters' G-buffers, the deferred tail that resolves, samples
// and shades the rasters' winner ids, and the per-frame mip rows. The JAX
// package fuses these with XLA ops inside its compiled step (no
// pl.pallas_call); eager torch ran them as 57-601 kernels a frame.
//
// texture_tail_kernel<FILTER, PACKED> replaces common.py fused_texture_tail
// (and its _texf_shade_epilogue), nearest or bilinear, over the (P, 3) f32
// pool or the u8-packed (P,) i32 pool (_pool_fetcher).
// texture_tail_mip_kernel<FILTER> replaces common.py fused_texture_tail_mip
// (_sample_mip_px), trilinear or anisotropic (MAX_ANISO = 4 taps), and
// adds the pixels it shaded from an image to the batch's accumulator
// (texture.textured_pixels_plain is the twins' count).
// deferred_tail_kernel<FILTER> replaces common.py resolve_attributes
// followed by textured_shade (sample_atlas or sample_atlas_mip, then
// shade), and tpu.py micro_vis_tail's pair -> triangle map; under a mip
// filter it reads the winner's row of mip_rows_kernel's output.
// mip_rows_kernel<FILTER> replaces vertex_stage -> uv_gradients ->
// mip_tri_rows, the (T, 5) [tid, lod, mu, mv, spread] rows of a frame.
// vertex_stage_kernel replaces common.py vertex_stage (the JAX package's
// common.py vertex_stage, tpu.py:691, and vertex_stage_soa, tpu.py:295),
// the per-vertex world and screen the deferred tail reads; both kernels
// run one vertex through the same vertex_screen.
//
// What bounds them on an H100: memory traffic. A tail reads a pixel's
// G-buffer planes (48-64 B with two lights) or its id, and its key, and
// writes 4 B of RGBA; the texel gathers mostly hit L2 (the atlases are a
// few MB). mip_rows reads a triangle's 3 indices, tex slot, and its
// corners' positions and uvs and writes 20 B; vertex_stage reads a
// vertex's 12 B and writes 28 B. The arithmetic is a few
// hundred float operations a pixel at most (anisotropic: 8 bilinear taps),
// far under the card's rate.
//
// Design: one thread a pixel (the tails), a triangle (mip_rows) or a
// vertex (vertex_stage), 256 to
// a block, every value in registers; no shared memory, no state between
// launches, no host synchronisation, so a frame's graph captures them.
// The G-buffer, id and key are read through their row strides, so the
// frame's window of the padded raster output is read in place.
//
// Exactness: each kernel follows its torch twin op for op, in the same
// association (the JAX package's order), with IEEE division and square
// root, floorf, truncating float -> int conversions (torch's .to(int32)),
// the divisor-signed remainder of torch.remainder, NaN-propagating
// max / min / clamp, and the lerp orders of the twins. Built with
// -fmad=false and without fast math, so nothing is contracted into an FMA;
// sinf / cosf / log2f / powf are the libm calls torch's kernels make. The
// shading is shade.cuh's (view_dir, light_terms, to_byte), the rasters'
// own arithmetic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "shade.cuh"

namespace {

constexpr int THREADS = 256;
// The filters (cuda.TEX_FILTERS order).
constexpr int NEAREST = 0;
constexpr int BILINEAR = 1;
constexpr int TRILINEAR = 2;
constexpr int ANISOTROPIC = 3;
constexpr int MAX_ANISO = 4;  // core/maths.py MAX_ANISO
// Anisotropic tap i's offset along the major axis: f32((i + 0.5) / 4) -
// f32(0.5) (common._sample_mip_px), exact in f32: -0.375, -0.125, 0.125,
// 0.375.
__device__ __forceinline__ float tap_offset(int i) {
  return ((float)i + 0.5f) / (float)MAX_ANISO - 0.5f;
}
constexpr float EFFECT_WAVE = 1.0f;  // core/effects.py
constexpr float EFFECT_MIRAGE = 4.0f;
constexpr uint32_t BACKGROUND = 0xFFFF0000u;  // RGBA (0, 0, 255, 255)
constexpr int NO_TRI = -1;                    // common.NO_TRI

// torch.remainder on ints: the result takes the divisor's sign.
__device__ __forceinline__ int remainder(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// NaN-propagating max / min (torch.maximum / minimum) and clamp.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// The texel fetches of common._pool_fetcher: a (P, 3) f32 row, or one
// u8-packed word unpacked as k / 255 in f32 (the loader's division).
struct RowPool {
  const float* __restrict__ texels;
  __device__ __forceinline__ void operator()(int i, float (&o)[3]) const {
    const float* p = texels + 3 * (size_t)i;
    o[0] = p[0];
    o[1] = p[1];
    o[2] = p[2];
  }
};

struct PackedPool {
  const int* __restrict__ packed;
  __device__ __forceinline__ void operator()(int i, float (&o)[3]) const {
    const int w = packed[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = (float)((w >> (8 * c)) & 0xFF) / 255.0f;
  }
};

// One bilinear tap at an {offset, width, height} level
// (common._bilinear_level_fetch): GL half-texel convention, repeat wrap,
// the index masked to 0 off `has`, the twins' lerp order.
template <class Fetch>
__device__ __forceinline__ void bilinear_level(const Fetch& fetch, int off,
                                               int tw, int th, float fu,
                                               float fv, bool has,
                                               float (&out)[3]) {
  const float pu = fu * (float)tw - 0.5f;
  const float pv = fv * (float)th - 0.5f;
  const float x0f = floorf(pu);
  const float y0f = floorf(pv);
  const float wx = pu - x0f;
  const float wy = pv - y0f;
  const int x0 = remainder((int)x0f, tw);
  const int y0 = remainder((int)y0f, th);
  const int x1 = remainder(x0 + 1, tw);
  const int y1 = remainder(y0 + 1, th);
  float t00[3], t10[3], t01[3], t11[3];
  fetch(has ? off + y0 * tw + x0 : 0, t00);
  fetch(has ? off + y0 * tw + x1 : 0, t10);
  fetch(has ? off + y1 * tw + x0 : 0, t01);
  fetch(has ? off + y1 * tw + x1 : 0, t11);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = t00[c] * (1.0f - wx) + t10[c] * wx;
    const float bot = t01[c] * (1.0f - wx) + t11[c] * wx;
    out[c] = top * (1.0f - wy) + bot * wy;
  }
}

// Nearest or bilinear repeat-wrap sample of one {off, tw, th} texture
// (the fused tail's and sample_atlas's arithmetic).
template <int FILTER, class Fetch>
__device__ __forceinline__ void sample_flat(const Fetch& fetch, int off,
                                            int tw, int th, float u, float v,
                                            bool has, float (&texel)[3]) {
  const float fu = u - floorf(u);
  const float fv = v - floorf(v);
  if (FILTER == NEAREST) {
    const int tx = min((int)(fu * (float)tw), tw - 1);
    const int ty = min((int)(fv * (float)th), th - 1);
    fetch(has ? off + ty * tw + tx : 0, texel);
  } else {
    bilinear_level(fetch, off, tw, th, fu, fv, has, texel);
  }
}

// The one per-pixel mip sampler (common._sample_mip_px) over a triangle's
// mip row (tid, lod, mu, mv, spread), shared by the fused and the
// deferred mip tails so that their images stay bitwise equal. Returns
// `has`; the texel is white where it is false.
template <int FILTER>
__device__ __forceinline__ bool sample_mip(const float* __restrict__ texels,
                                           const int* __restrict__ mips,
                                           int levels, int tid, float lod,
                                           float mu, float mv, float spread,
                                           float u, float v, bool flag,
                                           float (&texel)[3]) {
  const bool has = flag && tid >= 0;
  const int t0 = has ? tid : 0;
  // Masked pixels may carry a NaN lod: level 0 keeps their gathers in
  // range; their texel is replaced below.
  lod = has ? lod : 0.0f;
  const int l0 = (int)lod;
  const int l1 = min(l0 + 1, levels - 1);
  const float frac = lod - (float)l0;
  const int* r0 = mips + ((size_t)t0 * levels + l0) * 3;
  const int* r1 = mips + ((size_t)t0 * levels + l1) * 3;
  const RowPool fetch{texels};
  auto tap = [&](float ui, float vi, float(&o)[3]) {
    const float fu = ui - floorf(ui);
    const float fv = vi - floorf(vi);
    float a[3], b[3];
    bilinear_level(fetch, r0[0], r0[1], r0[2], fu, fv, has, a);
    bilinear_level(fetch, r1[0], r1[1], r1[2], fu, fv, has, b);
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = a[c] * (1.0f - frac) + b[c] * frac;
  };
  if (FILTER == TRILINEAR) {
    tap(u, v, texel);
  } else {
    for (int i = 0; i < MAX_ANISO; ++i) {
      const float s = tap_offset(i) * spread;
      float t[3];
      tap(u + mu * s, v + mv * s, t);
#pragma unroll
      for (int c = 0; c < 3; ++c) texel[c] = i == 0 ? t[c] : texel[c] + t[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) texel[c] = texel[c] / (float)MAX_ANISO;
  }
  if (!has) texel[0] = texel[1] = texel[2] = 1.0f;
  return has;
}

// The material epilogue (common._texf_shade_epilogue) of a covered pixel:
// ambient 0.1 kd, per light (diff kd + 0.5 spec) * color * intensity,
// clip, gamma 1/2.2, round; `terms(l, diff, spec)` gives light l's terms.
template <class Terms>
__device__ __forceinline__ uint32_t shade_pixel(const float (&kdt)[3], int L,
                                                const float* __restrict__ lc,
                                                const float* __restrict__ li,
                                                const Terms& terms) {
  const float gamma = (float)(1.0 / 2.2);
  float f[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) f[c] = 0.1f * kdt[c];
  for (int l = 0; l < L; ++l) {
    float diff, spec;
    terms(l, diff, spec);
    const float half = spec * 0.5f;
    const float intensity = li[l];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      f[c] = f[c] + (diff * kdt[c] + half) * lc[3 * l + c] * intensity;
  }
  return shade::to_byte(f[0], gamma) | (shade::to_byte(f[1], gamma) << 8) |
         (shade::to_byte(f[2], gamma) << 16) | 0xFF000000u;
}

// A pixel of an (H, W) frame window: its index p in the (H, W, 4) output
// and its coordinates; false past the end.
__device__ __forceinline__ bool pixel(int H, int W, int& p, int& x, int& y) {
  p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= H * W) return false;
  y = p / W;
  x = p - y * W;
  return true;
}

template <int FILTER, bool PACKED>
__global__ void __launch_bounds__(THREADS) texture_tail_kernel(
    const float* __restrict__ gbuf,    // (8 + 2L) planes, strides plane, grow
    const uint32_t* __restrict__ key,  // (H, W) at row stride krow
    const float* __restrict__ texels, const int* __restrict__ packed,
    const float* __restrict__ lc, const float* __restrict__ li,
    uint32_t* __restrict__ out, int H, int W, size_t plane, int grow,
    int krow, int L) {
  int p, x, y;
  if (!pixel(H, W, p, x, y)) return;
  if (key[(size_t)y * krow + x] == shade::KEY_CLEAR) {
    out[p] = BACKGROUND;
    return;
  }
  const float* g = gbuf + (size_t)y * grow + x;
  const float kd[3] = {g[2 * plane], g[3 * plane], g[4 * plane]};
  const int off = (int)g[5 * plane];
  const int tw = (int)g[6 * plane];
  const int th = (int)g[7 * plane];
  const bool has = tw > 0;
  // Untextured lanes carry zeros: size 1 keeps the index math finite.
  const int tws = has ? tw : 1;
  const int ths = has ? th : 1;
  float texel[3];
  if (PACKED)
    sample_flat<FILTER>(PackedPool{packed}, off, tws, ths, g[0], g[plane],
                        has, texel);
  else
    sample_flat<FILTER>(RowPool{texels}, off, tws, ths, g[0], g[plane], has,
                        texel);
  float kdt[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) kdt[c] = has ? kd[c] * texel[c] : kd[c];
  out[p] = shade_pixel(kdt, L, lc, li, [&](int l, float& d, float& s) {
    d = g[(shade::TEXF_BASE_CHANNELS + 2 * l) * plane];
    s = g[(shade::TEXF_BASE_CHANNELS + 2 * l + 1) * plane];
  });
}

// A non-null acc (frame_counts.cuh) gains the pixels shaded from an image
// (covered, and the winner's triangle has a texture): a block's count by
// __syncthreads_count, one 64-bit atomicAdd into acc[5] a block with any.
template <int FILTER>
__global__ void __launch_bounds__(THREADS) texture_tail_mip_kernel(
    const float* __restrict__ gbuf,  // (10 + 2L) planes
    const uint32_t* __restrict__ key, const float* __restrict__ texels,
    const int* __restrict__ mips,    // (M, levels, 3)
    const float* __restrict__ lc, const float* __restrict__ li,
    uint32_t* __restrict__ out, long long* __restrict__ acc, int H, int W,
    size_t plane, int grow, int krow, int L, int levels) {
  int p, x, y;
  bool has = false;
  if (pixel(H, W, p, x, y)) {
    if (key[(size_t)y * krow + x] == shade::KEY_CLEAR) {
      out[p] = BACKGROUND;
    } else {
      const float* g = gbuf + (size_t)y * grow + x;
      float texel[3];
      has = sample_mip<FILTER>(
          texels, mips, levels, (int)g[5 * plane], g[6 * plane],
          g[7 * plane], g[8 * plane], g[9 * plane], g[0], g[plane], true,
          texel);
      float kdt[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float kd = g[(2 + c) * plane];
        kdt[c] = has ? kd * texel[c] : kd;
      }
      out[p] = shade_pixel(kdt, L, lc, li, [&](int l, float& d, float& s) {
        d = g[(shade::TEXF_MIP_BASE_CHANNELS + 2 * l) * plane];
        s = g[(shade::TEXF_MIP_BASE_CHANNELS + 2 * l + 1) * plane];
      });
    }
  }
  // acc is the same for every thread of the block, so all reach the
  // barrier or none does.
  if (acc != nullptr) {
    const int n = __syncthreads_count(has);
    if (threadIdx.x == 0 && n > 0)
      atomicAdd((unsigned long long*)&acc[5], (unsigned long long)n);
  }
}

struct DeferredArgs {
  const int* ids;        // (H, W) winner ids at row stride id_row
  const uint32_t* key;   // (H, W) at key_row (micro path)
  const int* pair_tri;   // pair index -> triangle, or nullptr (tile path)
  const int* tri;        // (T, 3)
  const float* screen;   // (N, 4)
  const float* world;    // (N, 3)
  const float* normals;  // (N, 3)
  const float* uvs;      // (N, 2)
  const float* effect;   // (6,)
  const float* face_kd;  // (T, 3) or nullptr
  const int* face_tex;   // (T,)
  const float* texels;   // (P, 3): the atlas, or the mip pool
  const int* table;      // (M, 3) tex_table, or the (M, levels, 3) mips
  const float* rows;     // (T, 5) mip rows (mip filters)
  const float* vpos;     // (>= 3,)
  const float* lpos;     // (L, 3)
  const float* lc;       // (L, 3)
  const float* li;       // (L,)
  uint32_t* out;         // (H, W) RGBA words
  int H, W, id_row, key_row, L, levels, x_off, y_off;
};

template <int FILTER>
__global__ void __launch_bounds__(THREADS) deferred_tail_kernel(
    const DeferredArgs a) {
  int p, x, y;
  if (!pixel(a.H, a.W, p, x, y)) return;
  int best = a.ids[(size_t)y * a.id_row + x];
  if (a.pair_tri != nullptr)  // the winner's pair index -> its triangle
    best = a.key[(size_t)y * a.key_row + x] != shade::KEY_CLEAR
               ? a.pair_tri[best]
               : NO_TRI;
  if (best == NO_TRI) {
    a.out[p] = BACKGROUND;
    return;
  }
  // resolve_attributes: the sample (pixel_grid, mirage-warped) ...
  float px = (float)x + (float)a.x_off;
  float py = (float)y + (float)a.y_off;
  const float* e = a.effect;
  if (e[0] == EFFECT_MIRAGE) {
    const float off_x = e[1] * sinf(e[2] * px + e[5] + e[3]);
    const float off_y = e[1] * cosf(e[2] * py + e[5] + e[3]);
    px = px + off_x;
    py = py + off_y;
  }
  // ... the anchored affine coefficients from the winner's corners ...
  const int* t = a.tri + 3 * (size_t)best;
  const int i1 = t[0], i2 = t[1], i3 = t[2];
  const float v1x = a.screen[4 * (size_t)i1], v1y = a.screen[4 * (size_t)i1 + 1];
  const float v2x = a.screen[4 * (size_t)i2], v2y = a.screen[4 * (size_t)i2 + 1];
  const float v3x = a.screen[4 * (size_t)i3], v3y = a.screen[4 * (size_t)i3 + 1];
  const float bux = v2y - v1y;
  const float cux = -(v2x - v1x);
  const float buy = -(v3y - v1y);
  const float cuy = v3x - v1x;
  const float uz = (v3x - v1x) * (v2y - v1y) - (v2x - v1x) * (v3y - v1y);
  const float inv = 1.0f / uz;
  const float a1 = 1.0f + 0.0f * inv, b1 = -(bux + buy) * inv,
              c1 = -(cux + cuy) * inv;
  const float a2 = 0.0f * inv, b2 = buy * inv, c2 = cuy * inv;
  const float a3 = 0.0f * inv, b3 = bux * inv, c3 = cux * inv;
  const float dx = px - v1x;
  const float dy = py - v1y;
  // ... and each attribute at the sample (affine_combine order).
  auto interp = [&](const float* src, int n, int ch) {
    const float w1 = src[(size_t)n * i1 + ch];
    const float w2 = src[(size_t)n * i2 + ch];
    const float w3 = src[(size_t)n * i3 + ch];
    const float A = w1 * a1 + w2 * a2 + w3 * a3;
    const float B = w1 * b1 + w2 * b2 + w3 * b3;
    const float C = w1 * c1 + w2 * c2 + w3 * c3;
    return A + B * dx + C * dy;
  };
  const float u = interp(a.uvs, 2, 0), v = interp(a.uvs, 2, 1);
  const float nx = interp(a.normals, 3, 0), ny = interp(a.normals, 3, 1),
              nz = interp(a.normals, 3, 2);
  const float wx = interp(a.world, 3, 0), wy = interp(a.world, 3, 1),
              wz = interp(a.world, 3, 2);

  // textured_shade: kd, the atlas sample, the modulation ...
  float kd[3] = {1.0f, 1.0f, 1.0f};
  if (a.face_kd != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) kd[c] = a.face_kd[3 * (size_t)best + c];
  }
  float texel[3];
  bool has;
  if (FILTER == TRILINEAR || FILTER == ANISOTROPIC) {
    const float* r = a.rows + 5 * (size_t)best;
    has = sample_mip<FILTER>(a.texels, a.table, a.levels, (int)r[0], r[1],
                             r[2], r[3], r[4], u, v, true, texel);
  } else {
    const int tid = a.face_tex[best];
    has = tid >= 0;
    const int* row = a.table + 3 * (size_t)(has ? tid : 0);
    sample_flat<FILTER>(RowPool{a.texels}, row[0], row[1], row[2], u, v, has,
                        texel);
    if (!has) texel[0] = texel[1] = texel[2] = 1.0f;
  }
  float kdt[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) kdt[c] = has ? kd[c] * texel[c] : kd[c];
  // ... and shade (light_terms on the resolved normal and world).
  const float eye[11] = {0, 0, 0, 0, 0, 0, 0, 0, a.vpos[0], a.vpos[1],
                         a.vpos[2]};
  const shade::ViewDir vd = shade::view_dir(eye, wx, wy, wz);
  a.out[p] = shade_pixel(kdt, a.L, a.lc, a.li, [&](int l, float& d, float& s) {
    shade::light_terms(a.lpos + 3 * l, nx, ny, nz, wx, wy, wz, vd, d, s);
  });
}

// common.vertex_stage of one vertex: the wave (apply_wave_effect, sinf as
// torch.sin), the clip-space sums (m0 x + m1 y) + (m2 z + m3), the divides
// by cw and the screen mapping; world (3) and screen (4) =
// (x_px, y_px_flipped, ndc_z, clip_w).
__device__ __forceinline__ void vertex_screen(const float* __restrict__ vp,
                                              const float* __restrict__ effect,
                                              float x, float y, float z,
                                              int width, int height,
                                              float (&world)[3],
                                              float (&screen)[4]) {
  const float etype = effect[0], amplitude = effect[1],
              frequency = effect[2], phase = effect[3],
              direction = effect[4];
  const bool is_wave = etype == EFFECT_WAVE;
  const bool vertical = direction < 0.5f;
  const bool horizontal = (direction >= 0.5f) && (direction < 1.5f);
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
  const float cx = (vp[0] * wx + vp[1] * wy) + (vp[2] * wz + vp[3]);
  const float cy = (vp[4] * wx + vp[5] * wy) + (vp[6] * wz + vp[7]);
  const float cz = (vp[8] * wx + vp[9] * wy) + (vp[10] * wz + vp[11]);
  const float cw = (vp[12] * wx + vp[13] * wy) + (vp[14] * wz + vp[15]);
  const float ndc_x = cx / cw;
  const float ndc_y = cy / cw;
  world[0] = wx;
  world[1] = wy;
  world[2] = wz;
  screen[0] = (ndc_x + 1.0f) * 0.5f * (float)width;
  screen[1] = (1.0f - ndc_y) * 0.5f * (float)height;
  screen[2] = cz / cw;
  screen[3] = cw;
}

template <int FILTER>
__global__ void __launch_bounds__(THREADS) mip_rows_kernel(
    const float* __restrict__ positions,  // (N, 3)
    const int* __restrict__ tri,          // (T, 3)
    const float* __restrict__ uvs,        // (N, 2)
    const int* __restrict__ face_tex,     // (T,)
    const int* __restrict__ mips,         // (M, levels, 3)
    const float* __restrict__ vp,         // (4, 4) view_proj
    const float* __restrict__ effect,     // (6,)
    float* __restrict__ rows,             // (T, 5)
    int T, int levels, int width, int height) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= T) return;
  // vertex_stage on the three corners.
  float sx[3], sy[3], uv[3][2];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t i = (size_t)tri[3 * (size_t)t + k];
    float world[3], screen[4];
    vertex_screen(vp, effect, positions[3 * i], positions[3 * i + 1],
                  positions[3 * i + 2], width, height, world, screen);
    sx[k] = screen[0];
    sy[k] = screen[1];
    uv[k][0] = uvs[2 * i];
    uv[k][1] = uvs[2 * i + 1];
  }
  // uv_gradients (_uv_gradients_comps): degenerate triangles get 0.
  const float e2u = uv[1][0] - uv[0][0], e2v = uv[1][1] - uv[0][1];
  const float e3u = uv[2][0] - uv[0][0], e3v = uv[2][1] - uv[0][1];
  const float v1x = sx[0], v1y = sy[0], v2x = sx[1], v2y = sy[1],
              v3x = sx[2], v3y = sy[2];
  const float uz = (v3x - v1x) * (v2y - v1y) - (v2x - v1x) * (v3y - v1y);
  const bool big = fabsf(uz) > 1e-20f;
  const float safe = big ? uz : 1.0f;
  const float inv = big ? 1.0f / safe : 0.0f;
  const float db2_dx = -(v3y - v1y) * inv;
  const float db3_dx = (v2y - v1y) * inv;
  const float db2_dy = (v3x - v1x) * inv;
  const float db3_dy = -(v2x - v1x) * inv;
  const float g0 = e2u * db2_dx + e3u * db3_dx;  // du/dx
  const float g1 = e2v * db2_dx + e3v * db3_dx;  // dv/dx
  const float g2 = e2u * db2_dy + e3u * db3_dy;  // du/dy
  const float g3 = e2v * db2_dy + e3v * db3_dy;  // dv/dy
  // mip_tri_rows.
  const int tid = face_tex[t];
  const int* base = mips + (size_t)(tid >= 0 ? tid : 0) * levels * 3;
  const float tw0 = (float)base[1];
  const float th0 = (float)base[2];
  const float gx_u = g0 * tw0, gx_v = g1 * th0;
  const float gy_u = g2 * tw0, gy_v = g3 * th0;
  const float tiny = 1e-12f;
  const float rx = sqrtf(gx_u * gx_u + gx_v * gx_v);
  const float ry = sqrtf(gy_u * gy_u + gy_v * gy_v);
  const float top = (float)(levels - 1);
  float lod, mu = 0.0f, mv = 0.0f, spread = 0.0f;
  if (FILTER == TRILINEAR) {
    const float rho = nan_max(nan_max(rx, ry), tiny);
    lod = nan_clamp(log2f(rho), 0.0f, top);
  } else {
    const float pmax = nan_max(nan_max(rx, ry), tiny);
    const float pmin = nan_max(nan_min(rx, ry), tiny);
    const float n_eff = nan_clamp(pmax / pmin, 1.0f, (float)MAX_ANISO);
    lod = nan_clamp(log2f(pmax / n_eff), 0.0f, top);
    const bool x_major = rx >= ry;
    mu = x_major ? g0 : g2;
    mv = x_major ? g1 : g3;
    spread = 1.0f - 1.0f / n_eff;
  }
  float* r = rows + 5 * (size_t)t;
  r[0] = (float)tid;
  r[1] = lod;
  r[2] = mu;
  r[3] = mv;
  r[4] = spread;
}

// common.vertex_stage over the vertices: world (N, 3) and screen (N, 4),
// what the deferred tail reads.
__global__ void __launch_bounds__(THREADS) vertex_stage_kernel(
    const float* __restrict__ positions,  // (N, 3)
    const float* __restrict__ vp,         // (4, 4) view_proj
    const float* __restrict__ effect,     // (6,)
    float* __restrict__ world,            // (N, 3)
    float4* __restrict__ screen,          // (N, 4)
    int N, int width, int height) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;
  const size_t b = 3 * (size_t)i;
  float w[3], s[4];
  vertex_screen(vp, effect, positions[b], positions[b + 1], positions[b + 2],
                width, height, w, s);
  world[b] = w[0];
  world[b + 1] = w[1];
  world[b + 2] = w[2];
  screen[i] = make_float4(s[0], s[1], s[2], s[3]);
}

unsigned blocks(int n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// Fused nearest / bilinear tail: gbuf planes at (plane, grow) strides, key
// at row stride krow; `packed` (the u8 pool) or `texels`; out (H, W) words.
extern "C" int texture_tail(const void* gbuf, const void* key,
                            const void* texels, const void* packed,
                            const void* lc, const void* li, void* out, int H,
                            int W, int plane, int grow, int krow, int L,
                            int filter, void* stream) {
  if (H < 0 || W < 0 || L < 0 || (filter != NEAREST && filter != BILINEAR))
    return (int)cudaErrorInvalidValue;
  if (H * W == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define TAIL_ARGS                                                          \
  (const float*)gbuf, (const uint32_t*)key, (const float*)texels,          \
      (const int*)packed, (const float*)lc, (const float*)li,              \
      (uint32_t*)out, H, W, (size_t)plane, grow, krow, L
  const unsigned grid = blocks(H * W);
  if (filter == NEAREST) {
    if (packed) texture_tail_kernel<NEAREST, true><<<grid, THREADS, 0, s>>>(TAIL_ARGS);
    else texture_tail_kernel<NEAREST, false><<<grid, THREADS, 0, s>>>(TAIL_ARGS);
  } else {
    if (packed) texture_tail_kernel<BILINEAR, true><<<grid, THREADS, 0, s>>>(TAIL_ARGS);
    else texture_tail_kernel<BILINEAR, false><<<grid, THREADS, 0, s>>>(TAIL_ARGS);
  }
#undef TAIL_ARGS
  return (int)cudaGetLastError();
}

// Fused trilinear / anisotropic tail over the mip pool and its level table;
// acc: 7 long longs (frame_counts.cuh) or null.
extern "C" int texture_tail_mip(const void* gbuf, const void* key,
                                const void* texels, const void* mips,
                                const void* lc, const void* li, void* out,
                                void* acc, int H, int W, int plane, int grow,
                                int krow, int L, int levels, int filter,
                                void* stream) {
  if (H < 0 || W < 0 || L < 0 || levels < 1 ||
      (filter != TRILINEAR && filter != ANISOTROPIC))
    return (int)cudaErrorInvalidValue;
  if (H * W == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define MIP_ARGS                                                           \
  (const float*)gbuf, (const uint32_t*)key, (const float*)texels,          \
      (const int*)mips, (const float*)lc, (const float*)li, (uint32_t*)out, \
      (long long*)acc, H, W, (size_t)plane, grow, krow, L, levels
  const unsigned grid = blocks(H * W);
  if (filter == TRILINEAR)
    texture_tail_mip_kernel<TRILINEAR><<<grid, THREADS, 0, s>>>(MIP_ARGS);
  else
    texture_tail_mip_kernel<ANISOTROPIC><<<grid, THREADS, 0, s>>>(MIP_ARGS);
#undef MIP_ARGS
  return (int)cudaGetLastError();
}

// Deferred tail: pair_tri and face_kd may be null; `table` is the
// tex_table (nearest, bilinear) or the mip level table (with `rows`).
extern "C" int deferred_tail(
    const void* ids, const void* key, const void* pair_tri, const void* tri,
    const void* screen, const void* world, const void* normals,
    const void* uvs, const void* effect, const void* face_kd,
    const void* face_tex, const void* texels, const void* table,
    const void* rows, const void* vpos, const void* lpos, const void* lc,
    const void* li, void* out, int H, int W, int id_row, int key_row, int L,
    int levels, int x_off, int y_off, int filter, void* stream) {
  if (H < 0 || W < 0 || L < 0 || filter < NEAREST || filter > ANISOTROPIC ||
      (filter >= TRILINEAR && (rows == nullptr || levels < 1)))
    return (int)cudaErrorInvalidValue;
  if (H * W == 0) return (int)cudaSuccess;
  const DeferredArgs a{
      (const int*)ids,       (const uint32_t*)key,  (const int*)pair_tri,
      (const int*)tri,       (const float*)screen,  (const float*)world,
      (const float*)normals, (const float*)uvs,     (const float*)effect,
      (const float*)face_kd, (const int*)face_tex,  (const float*)texels,
      (const int*)table,     (const float*)rows,    (const float*)vpos,
      (const float*)lpos,    (const float*)lc,      (const float*)li,
      (uint32_t*)out,        H,                     W,
      id_row,                key_row,               L,
      levels,                x_off,                 y_off};
  const unsigned grid = blocks(H * W);
  cudaStream_t s = (cudaStream_t)stream;
  switch (filter) {
    case NEAREST: deferred_tail_kernel<NEAREST><<<grid, THREADS, 0, s>>>(a); break;
    case BILINEAR: deferred_tail_kernel<BILINEAR><<<grid, THREADS, 0, s>>>(a); break;
    case TRILINEAR: deferred_tail_kernel<TRILINEAR><<<grid, THREADS, 0, s>>>(a); break;
    default: deferred_tail_kernel<ANISOTROPIC><<<grid, THREADS, 0, s>>>(a); break;
  }
  return (int)cudaGetLastError();
}

// The frame's (T, 5) mip rows from the positions, trilinear or anisotropic.
extern "C" int mip_rows(const void* positions, const void* tri,
                        const void* uvs, const void* face_tex,
                        const void* mips, const void* vp, const void* effect,
                        void* rows, int T, int levels, int width, int height,
                        int filter, void* stream) {
  if (T < 0 || levels < 1 || (filter != TRILINEAR && filter != ANISOTROPIC))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
#define ROW_ARGS                                                            \
  (const float*)positions, (const int*)tri, (const float*)uvs,              \
      (const int*)face_tex, (const int*)mips, (const float*)vp,             \
      (const float*)effect, (float*)rows, T, levels, width, height
  if (filter == TRILINEAR)
    mip_rows_kernel<TRILINEAR><<<blocks(T), THREADS, 0, s>>>(ROW_ARGS);
  else
    mip_rows_kernel<ANISOTROPIC><<<blocks(T), THREADS, 0, s>>>(ROW_ARGS);
#undef ROW_ARGS
  return (int)cudaGetLastError();
}

// The per-vertex world and screen of the deferred tail; screen 16-byte
// aligned.
extern "C" int vertex_stage(const void* positions, const void* vp,
                            const void* effect, void* world, void* screen,
                            int N, int width, int height, void* stream) {
  if (N < 0 || ((size_t)screen & 15) != 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  vertex_stage_kernel<<<blocks(N), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)positions, (const float*)vp, (const float*)effect,
      (float*)world, (float4*)screen, N, width, height);
  return (int)cudaGetLastError();
}

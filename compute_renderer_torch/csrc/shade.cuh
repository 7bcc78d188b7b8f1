// The epilogues shared by the tile raster (raster.cu) and the micro raster
// (micro.cu): fragment.wgsl:50-93 as the JAX package evaluates it
// (pallas_raster._raster_tile, pallas_micro._raster_tile_micro), in five
// modes selected at compile time:
//
//   MODE_BASE  ambient 0.1, then per light a Lambert term and a pow32 x 0.5
//              Phong term (reflect(-l, n) as WGSL defines it), clip, gamma
//              1/2.2, round half to even (rintf, like jnp.round) and a
//              packed little-endian RGBA word;
//   MODE_MAT   the same with the winner's kd (table columns 32:35)
//              modulating ambient and diffuse, specular not
//              (pallas_micro.py:649-722, the tile kernel's branch);
//   MODE_TEXF  no shading: the fused-texture G-buffer
//              (pallas_raster._emit_texf_gbuffer) — u, v (affine columns
//              32:38), kd (38:41) and the TextureInfo row (41:44) copied,
//              then per light the same diff and spec as the shading;
//   MODE_VIS   deferred texturing: no shading, the winner's id (the tile
//              raster's table row, the micro raster's pair index) as an
//              int32; the wrapper's tail resolves and shades it;
//   MODE_TEXF_MIP  the mip-filtered G-buffer (common.TEXF_MIP_BASE_CHANNELS):
//              u, v as texf, the 8 flat columns 38:46 copied (kd, then the
//              frame's mip rows tid, lod, mu, mv, spread), then diff and
//              spec per light.
//
// The raster walks carry only each pixel's best key and the winner's table
// row; emit_pixel evaluates the winner's attributes from that row at the
// pixel, after the walk. (A + B*dx) + C*dy of the same operands gives the
// same float wherever it is evaluated, so this equals carrying the
// attributes through the walk, with 2 registers a pixel instead of 6-14.
// Exactness rests on the including file's build: -fmad=false and no fast
// math (sqrtf and / correctly rounded). The specular power is five
// squarings, not powf.

#pragma once

#include <math.h>
#include <stdint.h>

namespace shade {

constexpr uint32_t KEY_CLEAR = 0xFFFFFFFFu;
constexpr int MODE_BASE = 0;
constexpr int MODE_MAT = 1;
constexpr int MODE_TEXF = 2;
constexpr int MODE_VIS = 3;
constexpr int MODE_TEXF_MIP = 4;
constexpr int TEXF_BASE_CHANNELS = 8;      // common.TEXF_BASE_CHANNELS
constexpr int TEXF_MIP_BASE_CHANNELS = 10;  // common.TEXF_MIP_BASE_CHANNELS

__device__ __forceinline__ float clip01(float x) {
  // jnp.clip keeps a NaN; fminf/fmaxf alone would turn it into 0 or 1.
  return x != x ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float pow32(float s) {
  const float s2 = s * s;
  const float s4 = s2 * s2;
  const float s8 = s4 * s4;
  const float s16 = s8 * s8;
  return s16 * s16;
}

__device__ __forceinline__ uint32_t to_byte(float c, float gamma) {
  return (uint32_t)(int)rintf(powf(clip01(c), gamma) * 255.0f);
}

// The coverage bound max(threshold, melt), NaN-propagating like jnp.maximum
// (fmaxf would drop a NaN).
__device__ __forceinline__ float coverage_min(float threshold, float melt) {
  return (threshold != threshold || melt != melt) ? threshold + melt
                                                  : fmaxf(threshold, melt);
}

// The unit view direction eye - w; params[8:11] is the eye.
struct ViewDir {
  float x, y, z;
};

__device__ __forceinline__ ViewDir view_dir(const float* params, float wx,
                                            float wy, float wz) {
  float vdx = params[8] - wx;
  float vdy = params[9] - wy;
  float vdz = params[10] - wz;
  const float vnorm = sqrtf(vdx * vdx + vdy * vdy + vdz * vdz);
  return {vdx / vnorm, vdy / vnorm, vdz / vnorm};
}

// Lambert diff and pow32 Phong spec of one light row L = [position (3),
// color (3), intensity, 0] at world position w with normal n.
__device__ __forceinline__ void light_terms(const float* L, float nx,
                                            float ny, float nz, float wx,
                                            float wy, float wz, ViewDir v,
                                            float& diff, float& spec) {
  float ldx = L[0] - wx;
  float ldy = L[1] - wy;
  float ldz = L[2] - wz;
  const float lnorm = sqrtf(ldx * ldx + ldy * ldy + ldz * ldz);
  ldx = ldx / lnorm;
  ldy = ldy / lnorm;
  ldz = ldz / lnorm;
  const float d = nx * ldx + ny * ldy + nz * ldz;
  diff = d > 0.0f ? d : 0.0f;
  // reflect(-l, n) = -l - 2*dot(-l, n)*n (WGSL reflect)
  const float edotn = -(ldx * nx + ldy * ny + ldz * nz);
  const float rdx = -ldx - 2.0f * edotn * nx;
  const float rdy = -ldy - 2.0f * edotn * ny;
  const float rdz = -ldz - 2.0f * edotn * nz;
  float s = v.x * rdx + v.y * rdy + v.z * rdz;
  s = s > 0.0f ? s : 0.0f;
  spec = pow32(s);
}

// Packed RGBA of a covered pixel from the winner's attributes a =
// [nx, ny, nz, wx, wy, wz] and, with MAT, its kd.
template <bool MAT>
__device__ __forceinline__ uint32_t shade_rgba(const float* a,
                                               const float* kd,
                                               const float* params,
                                               const float* lights,
                                               int num_lights) {
  const float gamma = (float)(1.0 / 2.2);
  float cr, cg, cb;
  if (MAT) {
    cr = 0.1f * kd[0];
    cg = 0.1f * kd[1];
    cb = 0.1f * kd[2];
  } else {
    cr = cg = cb = 0.1f;
  }
  const ViewDir v = view_dir(params, a[3], a[4], a[5]);
  for (int li = 0; li < num_lights; ++li) {
    const float* L = lights + li * 8;
    float diff, spec;
    light_terms(L, a[0], a[1], a[2], a[3], a[4], a[5], v, diff, spec);
    if (MAT) {
      const float half = spec * 0.5f;
      cr = cr + (diff * kd[0] + half) * L[3] * L[6];
      cg = cg + (diff * kd[1] + half) * L[4] * L[6];
      cb = cb + (diff * kd[2] + half) * L[5] * L[6];
    } else {
      const float contrib = diff + spec * 0.5f;
      cr = cr + contrib * L[3] * L[6];
      cg = cg + contrib * L[4] * L[6];
      cb = cb + contrib * L[5] * L[6];
    }
  }
  return to_byte(cr, gamma) | (to_byte(cg, gamma) << 8) |
         (to_byte(cb, gamma) << 16) | 0xFF000000u;
}

// (A + B*dx) + C*dy of the affine triple at column c of a row.
__device__ __forceinline__ float affine(const float* row, int c, float dx,
                                       float dy) {
  return row[c] + row[c + 1] * dx + row[c + 2] * dy;
}

// Writes pixel o of the outputs from its best key, the winner's id and
// the winner's row (nullptr where no triangle covers it): the key, then by
// MODE the id into out (int32, vis), the packed RGBA into out (uint32_t)
// or the G-buffer planes into out (float, plane stride `plane`). The
// attributes are evaluated at the sample (px, py) the walk used. An
// uncovered pixel keeps the wrapper's pre-cleared output: the background,
// or G-buffer planes left unwritten (undefined where the key is clear; the
// fused tails mask by the key); in vis mode the caller passes the cleared
// id itself.
template <int MODE>
__device__ __forceinline__ void emit_pixel(const float* row, int id,
                                           float px, float py, uint32_t best,
                                           const float* params,
                                           const float* lights,
                                           int num_lights, void* out,
                                           uint32_t* key, size_t o,
                                           size_t plane) {
  key[o] = best;
  if (MODE == MODE_VIS) {
    static_cast<int*>(out)[o] = id;
    return;
  }
  if (row == nullptr) return;
  constexpr bool GBUF = MODE == MODE_TEXF || MODE == MODE_TEXF_MIP;
  // The first diff/spec plane, after u, v and the columns copied from 38:
  // kd and the TextureInfo row (texf) or kd and the mip rows (texf_mip).
  constexpr int BASE =
      MODE == MODE_TEXF_MIP ? TEXF_MIP_BASE_CHANNELS : TEXF_BASE_CHANNELS;
  constexpr int FLAT = BASE - 2;
  float a[6 + BASE];
  const float dx = px - row[30];
  const float dy = py - row[31];
#pragma unroll
  for (int c = 0; c < 6; ++c) a[c] = affine(row, 12 + 3 * c, dx, dy);
  if (GBUF) {
    a[6] = affine(row, 32, dx, dy);
    a[7] = affine(row, 35, dx, dy);
#pragma unroll
    for (int c = 0; c < FLAT; ++c) a[8 + c] = row[38 + c];
    float* g = static_cast<float*>(out) + o;
#pragma unroll
    for (int c = 0; c < BASE; ++c) g[c * plane] = a[6 + c];
    const ViewDir v = view_dir(params, a[3], a[4], a[5]);
    for (int li = 0; li < num_lights; ++li) {
      float diff, spec;
      light_terms(lights + li * 8, a[0], a[1], a[2], a[3], a[4], a[5], v,
                  diff, spec);
      g[(BASE + 2 * li) * plane] = diff;
      g[(BASE + 2 * li + 1) * plane] = spec;
    }
  } else {
    static_cast<uint32_t*>(out)[o] = shade_rgba<MODE == MODE_MAT>(
        a, row + 32, params, lights, num_lights);
  }
}

}  // namespace shade

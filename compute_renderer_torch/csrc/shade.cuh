// The shading epilogue shared by the tile raster (raster.cu) and the micro
// raster (micro.cu): fragment.wgsl:50-93 as the JAX package evaluates it
// (pallas_raster._raster_tile, pallas_micro._raster_tile_micro).
//
// Ambient 0.1, then per light a Lambert term and a pow32 x 0.5 Phong term
// (reflect(-l, n) as WGSL defines it), clip, gamma 1/2.2, round half to
// even (rintf, like jnp.round) and a packed little-endian RGBA word.
// Exactness rests on the including file's build: -fmad=false and no fast
// math. The specular power is five squarings, not powf.

#pragma once

#include <math.h>
#include <stdint.h>

namespace shade {

constexpr uint32_t KEY_CLEAR = 0xFFFFFFFFu;
constexpr uint32_t BACKGROUND = 0xFFFF0000u;  // blue, alpha 1

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

// Packed RGBA of a covered pixel from the winner's six attributes
// [nx, ny, nz, wx, wy, wz]; params[8:11] is the eye, lights (L, 8) rows
// [position (3), color (3), intensity, 0].
__device__ __forceinline__ uint32_t shade_rgba(float nx, float ny, float nz,
                                               float wx, float wy, float wz,
                                               const float* params,
                                               const float* lights,
                                               int num_lights) {
  const float gamma = (float)(1.0 / 2.2);
  float cr = 0.1f, cg = 0.1f, cb = 0.1f;
  float vdx = params[8] - wx;
  float vdy = params[9] - wy;
  float vdz = params[10] - wz;
  const float vnorm = sqrtf(vdx * vdx + vdy * vdy + vdz * vdz);
  vdx = vdx / vnorm;
  vdy = vdy / vnorm;
  vdz = vdz / vnorm;
  for (int li = 0; li < num_lights; ++li) {
    const float* L = lights + li * 8;
    float ldx = L[0] - wx;
    float ldy = L[1] - wy;
    float ldz = L[2] - wz;
    const float lnorm = sqrtf(ldx * ldx + ldy * ldy + ldz * ldz);
    ldx = ldx / lnorm;
    ldy = ldy / lnorm;
    ldz = ldz / lnorm;
    const float d = nx * ldx + ny * ldy + nz * ldz;
    const float diff = d > 0.0f ? d : 0.0f;
    // reflect(-l, n) = -l - 2*dot(-l, n)*n (WGSL reflect)
    const float edotn = -(ldx * nx + ldy * ny + ldz * nz);
    const float rdx = -ldx - 2.0f * edotn * nx;
    const float rdy = -ldy - 2.0f * edotn * ny;
    const float rdz = -ldz - 2.0f * edotn * nz;
    float s = vdx * rdx + vdy * rdy + vdz * rdz;
    s = s > 0.0f ? s : 0.0f;
    const float contrib = diff + pow32(s) * 0.5f;
    cr = cr + contrib * L[3] * L[6];
    cg = cg + contrib * L[4] * L[6];
    cb = cb + contrib * L[5] * L[6];
  }
  return to_byte(cr, gamma) | (to_byte(cg, gamma) << 8) |
         (to_byte(cb, gamma) << 16) | 0xFF000000u;
}

}  // namespace shade

// The walk shared by the tile raster (raster.cu) and the micro raster
// (micro.cu): asynchronous staging of the walked columns, the per-row test
// of two samples, and the tile raster's rectangle cull.
//
// Staged row: the four float4 of a table row that the walk reads — columns
// 0..11 (the barycentric and depth triples) and 28..31 — so the anchor
// (columns 30, 31) sits at staged floats 14 and 15. Rows sit at a stride of
// a multiple of 4 floats on a 16-byte aligned base (raster.kernel_table),
// so each quad is one 16-byte cp.async.
//
// Exactness rests on the including file's build (-fmad=false, no fast
// math): (A + B*dx) + C*dy is two roundings as in the eager torch twin, and
// the cull's corner value is the walk's own float sequence.

#pragma once

#include <math.h>
#include <stdint.h>

#include "shade.cuh"

namespace walk {

constexpr int QUADS = 4;  // staged float4 per row: columns 0..11, 28..31
constexpr unsigned FULL = 0xFFFFFFFFu;

// Table quad of staged quad q: 0, 1, 2, then 7 (columns 28..31).
__device__ __forceinline__ int table_quad(int q) { return q < 3 ? q : 7; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One staged row (four float4: columns 0..3, 4..7, 8..11, 28..31) against
// a lane's two samples, which share a column (so px, dx and each
// A + B*dx): the three barycentrics and z as (A + B*dx) + C*dy, coverage
// (each barycentric >= cov_min, so that a NaN fails, and z finite), the
// u32 depth key and a strict-< running minimum that remembers `id` (pairs
// arrive in ascending order: the lowest wins a tie).
__device__ __forceinline__ void walk_row(const float4* row, float px,
                                         const float py[2], float cov_min,
                                         int id, uint32_t best[2],
                                         int winner[2]) {
  const float4 a = row[0], b = row[1], c = row[2], d = row[3];
  const float dx = px - d.z;
  const float s1 = a.x + a.y * dx;
  const float s2 = a.w + b.x * dx;
  const float s3 = b.z + b.w * dx;
  const float sz = c.y + c.z * dx;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float dy = py[j] - d.w;
    const float bc1 = s1 + a.z * dy;
    const float bc2 = s2 + b.y * dy;
    const float bc3 = s3 + c.x * dy;
    const float z = sz + c.w * dy;
    const bool covered = (bc1 >= cov_min) && (bc2 >= cov_min) &&
                         (bc3 >= cov_min) && isfinite(z);
    const uint32_t kz = covered ? __float_as_uint(z) : shade::KEY_CLEAR;
    if (kz < best[j]) {
      best[j] = kz;
      winner[j] = id;
    }
  }
}

// The sample positions of a warp or block: min and max of px and py over
// its samples, NaN samples left out (they cover nothing: every
// barycentric of a NaN position is NaN). NaN bounds when every sample is.
struct Rect {
  float x0, x1, y0, y1;
};

__device__ __forceinline__ Rect warp_rect(Rect r) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    r.x0 = fminf(r.x0, __shfl_xor_sync(FULL, r.x0, s));
    r.x1 = fmaxf(r.x1, __shfl_xor_sync(FULL, r.x1, s));
    r.y0 = fminf(r.y0, __shfl_xor_sync(FULL, r.y0, s));
    r.y1 = fmaxf(r.y1, __shfl_xor_sync(FULL, r.y1, s));
  }
  return r;
}

// Whether the barycentric plane A + B*dx + C*dy stays below cov_min over
// the rectangle: its value at the rectangle's highest corner, evaluated
// with the walk's own float operations, (A + max(B*dxl, B*dxh)) +
// max(C*dyl, C*dyh), is below it. Rounding is monotone in each operand, so
// that value bounds every sample's own float barycentric exactly: no
// margin is needed, and none is taken. Never for a non-finite plane (a
// finite B times a finite dx is never NaN, so each max sees numbers).
__device__ __forceinline__ bool below(float a, float b, float c, float dxl,
                                      float dxh, float dyl, float dyh,
                                      float cov_min) {
  if (!(isfinite(a) && isfinite(b) && isfinite(c))) return false;
  return a + fmaxf(b * dxl, b * dxh) + fmaxf(c * dyl, c * dyh) < cov_min;
}

// False only when no sample of the rectangle can be covered by the staged
// row: when some barycentric plane stays below cov_min. dx is bracketed by
// the float differences of the rectangle's edges and the anchor (rounding
// is monotone), and so is every sample's own rounded dx. A NaN or infinite
// rectangle or anchor never culls, nor does a NaN maximum: the walk tests
// such rows, and they cover nothing. raster.cull_rect_plain is the same
// test in torch.
__device__ __forceinline__ bool may_cover(const float4* row, Rect r,
                                          float cov_min) {
  const float4 a = row[0], b = row[1], c = row[2], d = row[3];
  const float dxl = r.x0 - d.z;
  const float dxh = r.x1 - d.z;
  const float dyl = r.y0 - d.w;
  const float dyh = r.y1 - d.w;
  if (!(isfinite(dxl) && isfinite(dxh) && isfinite(dyl) && isfinite(dyh)))
    return true;
  return !(below(a.x, a.y, a.z, dxl, dxh, dyl, dyh, cov_min) ||
           below(a.w, b.x, b.y, dxl, dxh, dyl, dyh, cov_min) ||
           below(b.z, b.w, c.x, dxl, dxh, dyl, dyh, cov_min));
}

}  // namespace walk

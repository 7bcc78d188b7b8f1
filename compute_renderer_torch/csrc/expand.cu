// Pair expansion of the micro path: per-triangle cover meta -> the
// (cell, triangle) pair list, one thread per pair slot.
//
// Replaces the TPU kernel of the JAX package's backends/pallas_expand.py
// (_expand_kernel, launched by expand_cells).
//
// Triangle t owns slots [starts[t], starts[t] + c[t]) (starts: exclusive
// cumsum of the cover counts, computed by the wrapper). Thread p finds its
// owner by binary search — the rightmost t with starts[t] <= p, which is
// the owner whenever p < total (triangles with c = 0 share their start
// with the next live one, and the rightmost pick skips them) — then walks
// the owner's cell rectangle: local = p - starts[t], cx = x0 + local % rx,
// cy = y0 + local / rx, cell = (cy * ntx_t + cx / 16) * 16 + cx % 16.
// Slots at or past total get the num_cells sentinel and triangle 0.
//
// What bounds it on an H100: memory. Each slot writes 8 bytes; the
// search reads ~log2(T) starts, which stay in L2 (4 MB at 1M triangles)
// and in L1 for the first levels, shared by every thread. A thread per
// pair keeps the work even: a thread per triangle looping over its c[t]
// slots would serialise a block behind one large triangle. The TPU's
// interval-membership matmul exists to avoid a per-lane search, which a
// GPU thread does cheaply.
//
// Exactness: integer arithmetic only. local >= 0 and rx >= 1, so C's
// truncating division equals floor division there; the 16-column split
// uses an arithmetic shift and a mask, which are floor division and floor
// modulo for any sign, as the JAX package's // and %.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) expand_kernel(
    const int* __restrict__ starts,  // (T,) exclusive cumsum of c
    const int* __restrict__ rx,      // (T,) cell-rect width
    const int* __restrict__ x0,      // (T,) cell-rect origin x
    const int* __restrict__ y0,      // (T,) cell-rect origin y
    const int* __restrict__ total,   // () number of pairs
    int* __restrict__ cell_of_pair,  // (pair_cap,)
    int* __restrict__ tri_of_pair,   // (pair_cap,)
    int T, int pair_cap, int ntx_t, int num_cells) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pair_cap) return;
  if (p >= *total) {
    cell_of_pair[p] = num_cells;
    tri_of_pair[p] = 0;
    return;
  }
  // p < total implies T >= 1 and starts[0] = 0 <= p.
  int lo = 0, hi = T - 1;
  while (lo < hi) {
    const int mid = lo + ((hi - lo + 1) >> 1);
    if (starts[mid] <= p) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int local = p - starts[lo];
  const int w = max(rx[lo], 1);
  const int q = local / w;
  const int cx = x0[lo] + (local - q * w);
  const int cy = y0[lo] + q;
  cell_of_pair[p] = (cy * ntx_t + (cx >> 4)) * 16 + (cx & 15);
  tri_of_pair[p] = lo;
}

}  // namespace

extern "C" int expand_cells_i32(const void* starts, const void* rx,
                                const void* x0, const void* y0,
                                const void* total, void* cell_of_pair,
                                void* tri_of_pair, int T, int pair_cap,
                                int ntx_t, int num_cells, void* stream) {
  if (pair_cap > 0) {
    const int blocks = (pair_cap + THREADS - 1) / THREADS;
    expand_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)starts, (const int*)rx, (const int*)x0, (const int*)y0,
        (const int*)total, (int*)cell_of_pair, (int*)tri_of_pair, T,
        pair_cap, ntx_t, num_cells);
  }
  return (int)cudaGetLastError();
}

// The fold of one frame's binning (or one triangle chunk's) into the
// caller's accumulator, by the kernel that writes the frame's overflow
// report (bins.cu's bin_scan_kernel, sort.cu's bin_sort_scan_kernel).
// acc is 8 64-bit words that a batch of frames shares: [pair need, tile
// need, pairs, occupied tiles, samples, textured pixels, spans, longest
// list]: the needs, then the words summed over the frames, then the one
// folded by max. The needs fold by max, the pairs and the occupied tiles
// by sum, the longest list (the largest bin count, unmasked: a tile's
// triangles, or a micro cell's) by max (binning.fold_counts is the twins'
// fold). The fifth word is the micro raster's (micro.cu): the coverage
// samples it tested, one atomicAdd a block. The sixth is the mip texture
// tail's (texture.cu's texture_tail_mip_kernel): the pixels it shaded
// from an image, one atomicAdd a block. The seventh is the flat tile
// layout's (sort.cu's scan folds it here): the tile raster's span blocks
// beyond each tile's first, by sum. One thread calls fold_counts; a null
// acc folds nothing.
#pragma once

__device__ __forceinline__ void fold_counts(long long* acc, int pair_needed,
                                            int tile_needed, int pairs,
                                            int tiles, int most,
                                            int spans = 0) {
  if (acc == nullptr) return;
  atomicMax(&acc[0], (long long)pair_needed);
  atomicMax(&acc[1], (long long)tile_needed);
  atomicAdd((unsigned long long*)&acc[2], (unsigned long long)pairs);
  atomicAdd((unsigned long long*)&acc[3], (unsigned long long)tiles);
  if (spans != 0)
    atomicAdd((unsigned long long*)&acc[6], (unsigned long long)spans);
  atomicMax(&acc[7], (long long)most);
}

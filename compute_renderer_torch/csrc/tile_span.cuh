// The span of the flat tile layout: a tile whose (clamped) list holds more
// than TILE_SPAN triangles is walked by the tile raster (raster.cu) in
// spans of TILE_SPAN list positions, a block each, and the bin sort's scan
// (sort.cu) writes the list of those spans. binning.TILE_SPAN is the same
// length on the Python side.
#pragma once

constexpr int TILE_SPAN = 256;

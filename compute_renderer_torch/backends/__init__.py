"""Render backends of the port.

- ``cuda``: the tile path — fused front-end kernel, torch binning, and the
  raster + shade kernel over occupied framebuffer tiles
  (``front.py``, ``binning.py``, ``raster.py``; kernels in ``csrc/``).

The JAX package's ``xla`` and ``wgpu-faithful`` comparator backends are not
ported yet (ROADMAP).
"""

"""Golden-oracle NumPy rasterizer used as the ground truth for all backends.

The reference has no tests (SURVEY.md §4); its only oracle was visual A/B
against the wgpu hardware pipeline. This package is our substitute: a small,
direct NumPy emulation of the reference's custom-pipeline semantics
(binning.wgsl / rasteriser.wgsl / fragment.wgsl), against which the port's
comparators, its torch twins and, on the card, its CUDA kernels are
pixel-compared. A copy of the JAX package's ``golden/``; it imports no torch.
"""

from compute_renderer_torch.golden.rasterizer import render_golden  # noqa: F401

"""Render backends of the port.

- ``cuda``: the engine — the fused front-end kernel, binning, and the
  raster + shade kernels over occupied tiles or 8x8 cells (``front.py``,
  ``binning.py``, ``expand.py``, ``raster.py``, ``micro.py``; kernels in
  ``csrc/``). The JAX package's ``tpu`` backend.
- ``xla``: the brute-force comparator with the custom pipeline's
  semantics (every live triangle against every pixel of its rectangle,
  torch ops); the engine's frames equal its frames.
- ``wgpu-faithful``: the software model of the reference's hardware
  pipeline (near-plane clipping, pixel-center top-left rule,
  perspective-correct interpolation, float depth, sRGB, no effects),
  torch ops.

Backend names: ``cuda``; ``custom`` and ``tpu`` mean ``cuda``, ``wgpu``
means ``xla`` (``normalize_backend``).
"""

BACKENDS = ("xla", "cuda", "wgpu-faithful")
ALIASES = {"custom": "cuda", "tpu": "cuda", "wgpu": "xla"}


def normalize_backend(name: str) -> str:
    """The port's name of a backend name or alias."""
    return ALIASES.get(name, name)


def get_backend(name: str):
    name = normalize_backend(name)
    if name == "xla":
        from compute_renderer_torch.backends import xla

        return xla
    if name == "cuda":
        from compute_renderer_torch.backends import cuda

        return cuda
    if name == "wgpu-faithful":
        from compute_renderer_torch.backends import wgpu_faithful

        return wgpu_faithful
    raise ValueError(f"Unknown backend '{name}'. Available: {BACKENDS}")

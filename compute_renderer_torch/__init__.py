"""compute_renderer_torch — the PyTorch + CUDA port of the JAX package.

The same tile-based software rasterizer (vertex + setup, triangle-to-tile
binning, fused raster + Phong shade) for an NVIDIA H100: plain tensor code
is torch, and each Pallas kernel of the JAX package becomes a hand-written
CUDA kernel (``csrc/``) with a plain torch twin that CPU tensors run. The
module paths mirror the JAX package's so that each module's
counterpart is easy to find. This package never imports JAX.

Ported so far: the engine (``backends/cuda.py``: the tile and micro
paths in every kernel mode, materials, textures fused or deferred with
every filter, box-filter SSAA), the comparator backends
(``backends/xla.py``, ``backends/wgpu_faithful.py``), OBJ files loaded
from disk (the native parser, ``io/native.py``), and the entry points:
the CLI (``python3 -m compute_renderer_torch``), the headless loop and the
reference's benchmark suite (``bench/suite.py``), the multi-device
decompositions (``parallel/``: framebuffer stripes, sort-middle and frame
parallelism on ``torch.distributed``), the viewers (``app/window.py``, the
display window, and ``app/webview.py``, the HTTP viewer) and the NumPy
oracle (``golden/``). Nothing of the JAX package is left to port but its
compile cache, whose counterpart is ``_build.py``'s build directory.
"""

__version__ = "0.1.0"

from compute_renderer_torch.engine.scene import Scene, SceneConfig, CameraConfig  # noqa: F401
from compute_renderer_torch.engine.renderer import Renderer  # noqa: F401

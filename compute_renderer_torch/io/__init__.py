"""Asset IO: asset path resolution, the OBJ / MTL / texture loaders, the
synthesized structured scenes and procedural test meshes.

Mirrors the reference's model layer (src/model.rs, src/util.rs).
``Model.load`` reads OBJ files with the native C++ parser
(``io/native.py``; the pure-Python loader ``io/obj.py`` under
``CRT_DISABLE_NATIVE``) and falls back to the registered procedural
stand-ins.
"""

from compute_renderer_torch.io.assets import get_asset_path  # noqa: F401
from compute_renderer_torch.io.model import Model  # noqa: F401

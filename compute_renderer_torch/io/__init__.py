"""Asset IO: asset path resolution and procedural test meshes.

Mirrors the reference's model layer (src/model.rs, src/util.rs). The OBJ
loaders are not ported yet; ``Model.load`` resolves the registered
procedural stand-ins.
"""

from compute_renderer_torch.io.assets import get_asset_path  # noqa: F401
from compute_renderer_torch.io.model import Model  # noqa: F401

"""Model: the loaded-geometry wrapper (reference src/model.rs:10-14).

Resolution order for a model path:

1. a real file on disk (via asset search paths) -> the OBJ loader, which
   this package does not have yet (``NotImplementedError``);
2. a registered procedural stand-in (the reference's LFS benchmark assets are
   not shipped; see io/procedural.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from compute_renderer_torch.core.types import Mesh
from compute_renderer_torch.io import procedural
from compute_renderer_torch.io.assets import get_asset_path


@dataclass
class Model:
    mesh: Mesh
    source: str

    @staticmethod
    def load(path: str, materials: bool = False,
             textures: bool = False) -> "Model":
        """Resolve ``path`` to a procedural stand-in. ``materials`` and
        ``textures`` are accepted for signature parity; the stand-ins carry
        neither, so both leave the mesh plain."""
        del materials, textures
        try:
            resolved = get_asset_path(path)
        except FileNotFoundError:
            if path in procedural.PROCEDURAL_MODELS:
                return Model(mesh=procedural.make_model(path),
                             source=f"procedural:{path}")
            raise
        raise NotImplementedError(
            f"'{resolved}' is an OBJ file on disk; the OBJ loaders "
            "(io/obj.py, io/native.py) are not ported yet — ROADMAP queue 1, "
            "item 8"
        )

    @property
    def num_triangles(self) -> int:
        return self.mesh.num_triangles

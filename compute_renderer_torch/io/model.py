"""Model: the loaded-geometry wrapper (reference src/model.rs:10-14).

Resolution order for a model path:

1. a real file on disk (via asset search paths) -> the native C++ parser
   (``io/native.py``), or the pure-Python loader (``io/obj.py``) when
   ``CRT_DISABLE_NATIVE`` is set; the synthesized structured scenes are
   written on first use (``io/objgen.py``);
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
        """``materials=True`` (extension) resolves MTL diffuse colors into
        ``Mesh.face_kd``; ``textures=True`` (implies materials)
        additionally decodes map_Kd images into the flat atlas
        (``Mesh.face_tex``/``texels``/``tex_table``). Files parse natively
        (materials and textures included) unless ``CRT_DISABLE_NATIVE`` is
        set; the two loaders give the same arrays."""
        materials = materials or textures
        from compute_renderer_torch.io import objgen

        ensure = {
            objgen.STRUCTURED_NAME: objgen.ensure_structured_scene,
            objgen.STRUCTURED_TEX_NAME: objgen.ensure_textured_scene,
        }.get(path)
        try:
            resolved = get_asset_path(path)
            if ensure is not None:
                # A synthesized asset found on disk: run ensure_* against
                # its directory anyway, so that companion MTL / map_Kd
                # files an older synthesis lacks are refreshed.
                resolved = ensure(resolved.parent)
        except FileNotFoundError:
            if ensure is not None:
                # Synthesized on first use and cached on disk.
                resolved = ensure()
            elif path in procedural.PROCEDURAL_MODELS:
                return Model(mesh=procedural.make_model(path),
                             source=f"procedural:{path}")
            else:
                raise
        from compute_renderer_torch.io import native

        if native.enabled():
            return Model(mesh=native.load_obj(resolved, materials=materials,
                                              textures=textures),
                         source=str(resolved))
        from compute_renderer_torch.io.obj import load_obj

        return Model(mesh=load_obj(resolved, materials=materials,
                                   textures=textures),
                     source=str(resolved))

    @property
    def num_triangles(self) -> int:
        return self.mesh.num_triangles

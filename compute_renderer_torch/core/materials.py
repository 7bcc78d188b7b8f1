"""Material surface (reference H14, made live as an opt-in extension).

The reference defines ``MaterialInfo`` (ambient/specular/diffuse/shininess/
dissolve/optical_density) and atlas-style ``TextureInfo{offset,width,height}``
structs with defaults but never binds them to any pipeline
(custom_pipeline/util.rs:35-85) — materials from MTL files are loaded and
discarded (model.rs:24).

This build keeps the reference-faithful default (materials discarded) but
additionally wires the surface end-to-end behind an opt-in flag
(``load_obj(materials=True)`` / ``SceneConfig.enable_materials``): ``parse_mtl``
reads the MTL library, the OBJ loader resolves ``usemtl`` runs into a
per-triangle diffuse color, and the shading epilogues modulate ambient +
diffuse by it (csrc/shade.cuh, ``raster.shade_pixels``). The texture half
is live too (``load_obj(textures=True)`` / ``SceneConfig.enable_textures``):
every ``map_Kd`` image packs into one flat texel pool addressed by exactly
the ``TextureInfo{offset,width,height}`` rows below (io/textures.py),
sampled at the interpolated uv (``common.fused_texture_tail``).

A copy of the JAX package's ``core/materials.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from compute_renderer_torch.core.maths import F32


@dataclass
class MaterialInfo:
    ambient: np.ndarray = field(
        default_factory=lambda: np.array([0.1, 0.1, 0.1], dtype=F32)
    )
    specular: np.ndarray = field(
        default_factory=lambda: np.array([0.5, 0.5, 0.5], dtype=F32)
    )
    diffuse: np.ndarray = field(
        default_factory=lambda: np.array([0.8, 0.8, 0.8], dtype=F32)
    )
    shininess: float = 32.0
    dissolve: float = 1.0
    optical_density: float = 1.0
    # Texture extension: map_Kd filename (relative to the MTL's directory),
    # None when the material has no diffuse map.
    diffuse_map: str | None = None


@dataclass
class TextureInfo:
    """Atlas-style texture record: offset into a flat texel pool + extent.

    Mirrors the reference's unbound struct (custom_pipeline/util.rs:75-85);
    this build wires it live — ``Mesh.tex_table`` rows are exactly these
    fields, built by io/textures.build_atlas and consumed by
    backends/common.sample_atlas."""

    offset: int = 0
    width: int = 0
    height: int = 0


# map_* option flags and how many arguments each consumes (MTL spec);
# -o/-s/-t officially take "u [v] [w]" — handled by consuming numeric
# tokens greedily (up to 3) so filenames are never eaten.
_MAP_OPT_ARGC = {
    "-blendu": 1, "-blendv": 1, "-cc": 1, "-clamp": 1, "-imfchan": 1,
    "-texres": 1, "-bm": 1, "-boost": 1, "-mm": 2,
}
_MAP_OPT_VEC = {"-o", "-s", "-t"}


def _map_filename(parts: list) -> str | None:
    """Extract the filename from a ``map_Kd [options] file`` statement.
    Returns None when only options are present (malformed line)."""
    i = 1
    n = len(parts)
    while i < n:
        tok = parts[i]
        if tok in _MAP_OPT_VEC:
            i += 1
            taken = 0
            while i < n and taken < 3:
                try:
                    float(parts[i])
                except ValueError:
                    break
                i += 1
                taken += 1
        elif tok in _MAP_OPT_ARGC:
            i += 1 + _MAP_OPT_ARGC[tok]
        else:
            # First non-option token starts the filename (names may
            # contain spaces — join the rest).
            return " ".join(parts[i:])
    return None


def parse_mtl(path) -> dict:
    """Parse a Wavefront MTL library into {name: MaterialInfo}.

    Covers the fields ``MaterialInfo`` mirrors from the reference
    (custom_pipeline/util.rs:35-60): Ka/Kd/Ks color triples, Ns shininess,
    d / Tr dissolve (Tr = 1 - d), Ni optical density — plus ``map_Kd``
    (the texture extension: filename into ``diffuse_map``, option flags
    skipped). Other unknown statements (illum, other map_*, ...) are
    skipped; statements before the first ``newmtl`` are ignored. Missing
    fields keep ``MaterialInfo`` defaults."""
    materials: dict = {}
    cur = None
    with open(Path(path), "r", errors="replace") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "newmtl":
                cur = MaterialInfo()
                materials[" ".join(parts[1:])] = cur
            elif cur is None:
                continue
            elif tag == "Ka" and len(parts) >= 4:
                cur.ambient = np.array(parts[1:4], dtype=F32)
            elif tag == "Kd" and len(parts) >= 4:
                cur.diffuse = np.array(parts[1:4], dtype=F32)
            elif tag == "Ks" and len(parts) >= 4:
                cur.specular = np.array(parts[1:4], dtype=F32)
            elif tag == "Ns" and len(parts) >= 2:
                cur.shininess = float(parts[1])
            elif tag == "d" and len(parts) >= 2:
                cur.dissolve = float(parts[1])
            elif tag == "Tr" and len(parts) >= 2:
                cur.dissolve = 1.0 - float(parts[1])
            elif tag == "Ni" and len(parts) >= 2:
                cur.optical_density = float(parts[1])
            elif tag == "map_Kd" and len(parts) >= 2:
                cur.diffuse_map = _map_filename(parts)
    return materials

"""Pure-Python OBJ loader with the reference's tobj load semantics.

The reference loads OBJ files via tobj with ``triangulate: true,
single_index: true`` (src/model.rs:24-30):

- **triangulate**: polygon faces fan-triangulated as (v0, v_i, v_i+1);
- **single_index**: each distinct (position, texcoord, normal) index triple
  becomes one output vertex, deduplicated *per sub-mesh*;
- sub-meshes split on ``o``/``g`` statements; the reference then concatenates
  them with index offsetting (src/model.rs:109-121);
- MTL materials are loaded but **discarded** (src/model.rs:24 binds them to
  ``_m_materials``) — by default we match that and skip ``mtllib``/``usemtl``;
  ``materials=True`` (an extension beyond the reference) resolves them into a
  per-triangle diffuse color (``Mesh.face_kd``) via ``core.materials.parse_mtl``;
- the V texture coordinate is flipped: ``v -> 1 - v`` (src/model.rs:64);
- missing normals/texcoords are zero-filled (src/model.rs:61-75).

Negative (relative) OBJ indices are supported per the OBJ spec.

A copy of the JAX package's ``io/obj.py`` (this package never imports
that one). ``Model.load`` parses with the native parser
(``io/native.py``) unless ``CRT_DISABLE_NATIVE`` is set; this loader is
its oracle.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from compute_renderer_torch.core.maths import F32
from compute_renderer_torch.core.types import Mesh


def _parse_face_vertex(token: str, nv: int, nvt: int, nvn: int):
    """Parse 'v', 'v/vt', 'v//vn', 'v/vt/vn' into 0-based (vi, ti, ni) with
    -1 for absent. Negative indices are relative to the current array end."""
    parts = token.split("/")
    vi = int(parts[0])
    vi = vi - 1 if vi > 0 else nv + vi
    ti = -1
    ni = -1
    if len(parts) > 1 and parts[1] != "":
        ti = int(parts[1])
        ti = ti - 1 if ti > 0 else nvt + ti
    if len(parts) > 2 and parts[2] != "":
        ni = int(parts[2])
        ni = ni - 1 if ni > 0 else nvn + ni
    return (vi, ti, ni)


class _SubMesh:
    """Accumulates one sub-mesh's faces with per-sub-mesh triple dedup."""

    def __init__(self):
        self.triple_to_idx = {}
        self.triples = []  # list of (vi, ti, ni)
        self.indices = []
        self.tri_mtl = []  # material name (or None) per emitted triangle

    def add_corner(self, triple):
        idx = self.triple_to_idx.get(triple)
        if idx is None:
            idx = len(self.triples)
            self.triple_to_idx[triple] = idx
            self.triples.append(triple)
        self.indices.append(idx)
        return idx

    def empty(self) -> bool:
        return not self.indices


def load_obj(path, materials: bool = False, textures: bool = False) -> Mesh:
    """Load an OBJ file into a single concatenated SoA Mesh.

    ``materials=False`` (default) matches the reference exactly: MTL
    libraries are discarded (src/model.rs:24). ``materials=True`` — the
    opt-in extension — parses ``mtllib`` libraries (relative to the OBJ's
    directory) and resolves ``usemtl`` runs into a per-triangle diffuse
    color ``Mesh.face_kd``; faces without a (resolvable) material get
    white (1, 1, 1), the identity under the material shading extension.

    ``textures=True`` (implies ``materials``) additionally decodes every
    referenced ``map_Kd`` image into one flat atlas (``Mesh.texels`` /
    ``Mesh.tex_table``, the reference's TextureInfo layout) and records the
    per-triangle texture slot in ``Mesh.face_tex`` (-1 = untextured)."""
    materials = materials or textures
    path = Path(path)
    positions = []  # raw v records
    texcoords = []  # raw vt records
    normals = []  # raw vn records

    submeshes = []
    current = _SubMesh()
    mtl_lib = {}  # name -> MaterialInfo, merged across mtllib statements
    cur_mtl = None  # active usemtl name

    with open(path, "r", errors="replace") as f:
        for line in f:
            # Comments can trail any statement (the native parser stops at
            # '#' mid-line; match it).
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vt":
                u = float(parts[1])
                v = float(parts[2]) if len(parts) > 2 else 0.0
                texcoords.append((u, v))
            elif tag == "vn":
                normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag in ("o", "g"):
                # New sub-mesh boundary (tobj splits models per object/group).
                if not current.empty():
                    submeshes.append(current)
                    current = _SubMesh()
            elif tag == "f":
                nv, nvt, nvn = len(positions), len(texcoords), len(normals)
                corners = [
                    _parse_face_vertex(tok, nv, nvt, nvn) for tok in parts[1:]
                ]
                # Fan triangulation (tobj `triangulate: true`).
                for i in range(1, len(corners) - 1):
                    for triple in (corners[0], corners[i], corners[i + 1]):
                        current.add_corner(triple)
                    current.tri_mtl.append(cur_mtl)
            elif materials and tag == "mtllib" and len(parts) > 1:
                # Library paths are relative to the OBJ's directory; a
                # missing/unreadable library degrades to default colors.
                from compute_renderer_torch.core.materials import parse_mtl

                for name in parts[1:]:
                    try:
                        mtl_lib.update(parse_mtl(path.parent / name))
                    except OSError:
                        pass
            elif materials and tag == "usemtl":
                cur_mtl = " ".join(parts[1:]) if len(parts) > 1 else None
            # s / l / p (and mtllib/usemtl when materials=False): ignored
            # (materials discarded, reference src/model.rs:24).
    if not current.empty():
        submeshes.append(current)

    pos_arr = np.asarray(positions, dtype=F32).reshape(-1, 3)
    tex_arr = np.asarray(texcoords, dtype=F32).reshape(-1, 2)
    nrm_arr = np.asarray(normals, dtype=F32).reshape(-1, 3)

    meshes = []
    for sm in submeshes:
        n = len(sm.triples)
        p = np.zeros((n, 3), dtype=F32)
        t = np.zeros((n, 2), dtype=F32)
        nr = np.zeros((n, 3), dtype=F32)
        # Per-sub-mesh "has texcoords at all" flag: the reference checks
        # mesh.texcoords.is_empty() (src/model.rs:61-65) and applies the V
        # flip to the (possibly zero-filled) value, so a corner missing its
        # vt in a sub-mesh that has some vt records flips 0 -> 1.
        has_tex = any(ti >= 0 for (_, ti, _) in sm.triples)
        for out_i, (vi, ti, ni) in enumerate(sm.triples):
            # Bounds-check like ti/ni: a malformed index (e.g. 'f 0' or an
            # over-negative relative index) must zero-fill, matching the
            # JAX package's native parser (objparse.cpp) — not wrap via
            # Python negative indexing.
            if 0 <= vi < pos_arr.shape[0]:
                p[out_i] = pos_arr[vi]
            if has_tex:
                # Out-of-range indices zero-fill (like the native parser and
                # tobj); the V flip then maps the filled 0 to 1.
                if 0 <= ti < tex_arr.shape[0]:
                    t[out_i, 0] = tex_arr[ti, 0]
                    t[out_i, 1] = F32(1.0) - tex_arr[ti, 1]  # V flip (model.rs:64)
                else:
                    t[out_i] = (0.0, 1.0)
            if 0 <= ni < nrm_arr.shape[0]:
                nr[out_i] = nrm_arr[ni]
        face_kd = None
        if materials:
            face_kd = np.ones((len(sm.tri_mtl), 3), dtype=F32)
            for ti, name in enumerate(sm.tri_mtl):
                info = mtl_lib.get(name) if name is not None else None
                if info is not None:
                    face_kd[ti] = info.diffuse
        meshes.append(
            Mesh(
                positions=p,
                normals=nr,
                uvs=t,
                indices=np.asarray(sm.indices, dtype=np.uint32),
                face_kd=face_kd,
            )
        )

    mesh = Mesh.concatenate(meshes)
    if not textures:
        return mesh

    # Texture pass: one atlas for the whole OBJ. Each distinct map_Kd file
    # gets one slot (materials sharing a file share the slot); triangles
    # inherit their material's slot, -1 when it has no (resolvable) map.
    from compute_renderer_torch.io.textures import build_atlas

    slot_by_file: dict = {}
    slot_by_mtl: dict = {}
    for name, info in mtl_lib.items():
        if info.diffuse_map is None:
            continue
        f = str(path.parent / info.diffuse_map)
        if f not in slot_by_file:
            slot_by_file[f] = len(slot_by_file)
        slot_by_mtl[name] = slot_by_file[f]
    if not slot_by_file:
        return mesh

    face_tex = np.full((mesh.num_triangles,), -1, dtype=np.int32)
    ti = 0
    for sm in submeshes:
        for name in sm.tri_mtl:
            if name in slot_by_mtl:
                face_tex[ti] = slot_by_mtl[name]
            ti += 1
    assert ti == mesh.num_triangles
    texels, tex_table = build_atlas(list(slot_by_file))
    return Mesh(
        positions=mesh.positions,
        normals=mesh.normals,
        uvs=mesh.uvs,
        indices=mesh.indices,
        face_kd=mesh.face_kd,
        face_tex=face_tex,
        texels=texels,
        tex_table=tex_table,
    )

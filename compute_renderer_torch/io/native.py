"""ctypes binding to the native C++ OBJ parser (``native/objparse.cpp``).

The parser implements the same contract as ``io/obj.py`` (tobj
triangulate + single_index semantics), which is its correctness oracle:
the two give the same arrays (tests/test_torch_native.py). It is the
port's copy of the JAX package's parser, built at first use into
``build/host_libs/`` by ``_build.host_library`` (a failed build raises
with the compiler's output). ``CRT_DISABLE_NATIVE`` set to a non-empty
value turns it off: ``Model.load`` then parses in Python.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from compute_renderer_torch.core.maths import F32
from compute_renderer_torch.core.types import Mesh

_LIB = None


def _load():
    """The loaded library, built first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from compute_renderer_torch import _build

    lib = ctypes.CDLL(str(_build.host_library("objparse")))
    lib.crt_load_obj.restype = ctypes.c_void_p
    lib.crt_load_obj.argtypes = [ctypes.c_char_p]
    lib.crt_mesh_counts.restype = None
    lib.crt_mesh_counts.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.crt_mesh_fill.restype = None
    lib.crt_mesh_fill.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.crt_mesh_free.restype = None
    lib.crt_mesh_free.argtypes = [ctypes.c_void_p]
    lib.crt_mesh_counts2.restype = None
    lib.crt_mesh_counts2.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.crt_mesh_fill_mtl.restype = None
    lib.crt_mesh_fill_mtl.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p,
        ctypes.c_char_p,
    ]
    _LIB = lib
    return _LIB


def enabled() -> bool:
    """Whether ``Model.load`` parses natively: unless
    ``CRT_DISABLE_NATIVE`` is set to a non-empty value."""
    return not os.environ.get("CRT_DISABLE_NATIVE")


def load_obj(path, materials: bool = False, textures: bool = False) -> Mesh:
    """Parse with the native library; semantics identical to
    ``io.obj.load_obj``. ``materials``/``textures`` resolve the recorded
    usemtl slots against the MTL libraries in Python (``parse_mtl`` +
    ``build_atlas``, per material), with the per-triangle arrays produced
    by table lookups instead of the Python loader's loop per triangle."""
    materials = materials or textures
    lib = _load()
    handle = lib.crt_load_obj(str(path).encode())
    if not handle:
        raise IOError(f"native OBJ parse failed for {path}")
    try:
        nverts = ctypes.c_int64()
        nindices = ctypes.c_int64()
        lib.crt_mesh_counts(handle, ctypes.byref(nverts),
                            ctypes.byref(nindices))
        nv, ni = nverts.value, nindices.value
        positions = np.empty((nv, 3), dtype=F32)
        normals = np.empty((nv, 3), dtype=F32)
        uvs = np.empty((nv, 2), dtype=F32)
        indices = np.empty((ni,), dtype=np.uint32)
        lib.crt_mesh_fill(
            handle,
            positions.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            normals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            uvs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        if not materials:
            return Mesh(positions, normals, uvs, indices)

        ntris = ctypes.c_int64()
        names_len = ctypes.c_int64()
        libs_len = ctypes.c_int64()
        lib.crt_mesh_counts2(handle, ctypes.byref(ntris),
                             ctypes.byref(names_len), ctypes.byref(libs_len))
        tri_slots = np.empty((ntris.value,), dtype=np.int32)
        names_buf = ctypes.create_string_buffer(max(names_len.value, 1))
        libs_buf = ctypes.create_string_buffer(max(libs_len.value, 1))
        lib.crt_mesh_fill_mtl(
            handle,
            tri_slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            names_buf, libs_buf,
        )
        slot_names = (
            names_buf.raw[:names_len.value].decode("utf-8", "replace")
            .split("\n") if names_len.value else []
        )
        lib_names = (
            libs_buf.raw[:libs_len.value].decode("utf-8", "replace")
            .split("\n") if libs_len.value else []
        )
    finally:
        lib.crt_mesh_free(handle)
    face_kd, face_tex, texels, tex_table = _resolve_materials(
        Path(path).parent, lib_names, slot_names, tri_slots, textures
    )
    return Mesh(positions, normals, uvs, indices, face_kd=face_kd,
                face_tex=face_tex, texels=texels, tex_table=tex_table)


def _resolve_materials(obj_dir, lib_names, slot_names, tri_slots, textures):
    """MTL / texture resolution over interned material slots, as
    ``io.obj.load_obj`` resolves each triangle: the mtllib dicts merged in
    encounter order, unresolvable names white, one atlas slot per
    distinct map_Kd file in the merged dict's order. The per-triangle
    work is two gathers from the (S+1)-row slot tables (row 0 = no
    material)."""
    from compute_renderer_torch.core.materials import parse_mtl

    mtl_lib = {}
    for name in lib_names:
        try:
            mtl_lib.update(parse_mtl(obj_dir / name))
        except OSError:
            pass

    S = len(slot_names)
    kd_table = np.ones((S + 1, 3), dtype=F32)
    texslot_table = np.full((S + 1,), -1, dtype=np.int32)

    slot_by_file: dict = {}
    slot_by_mtl: dict = {}
    for name, info in mtl_lib.items():
        if info.diffuse_map is None:
            continue
        f = str(obj_dir / info.diffuse_map)
        if f not in slot_by_file:
            slot_by_file[f] = len(slot_by_file)
        slot_by_mtl[name] = slot_by_file[f]

    for s, name in enumerate(slot_names):
        info = mtl_lib.get(name)
        if info is not None:
            kd_table[s + 1] = info.diffuse
        if name in slot_by_mtl:
            texslot_table[s + 1] = slot_by_mtl[name]

    face_kd = kd_table[tri_slots + 1]
    if not textures or not slot_by_file:
        return face_kd, None, None, None

    from compute_renderer_torch.io.textures import build_atlas

    face_tex = texslot_table[tri_slots + 1]
    texels, tex_table = build_atlas(list(slot_by_file))
    return face_kd, face_tex, texels, tex_table

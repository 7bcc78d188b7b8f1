"""The port's native C++ OBJ parser (``io/native.py``,
``native/objparse.cpp``) against the port's pure-Python loader
(``io/obj.py``, its oracle) and the JAX package's Python loader
(``compute_renderer_tpu.io.obj.load_obj``), on the cases of
tests/test_native.py:92-224, materials and textures included.

Tolerance: bitwise — every array (positions, normals, uvs, indices,
face_kd, face_tex, texels, tex_table) equal. Also: ``Model.load`` parses
natively unless ``CRT_DISABLE_NATIVE`` is set, and a failed build raises
with the compiler's output.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent

CASES = {
    "basic": """
v 0 0 0
v 1 0 0
v 0 1 0
vn 0 0 1
vt 0 0
vt 1 0
vt 0 1
f 1/1/1 2/2/1 3/3/1
""",
    "quad_fan": """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3 4
""",
    "dedup": """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
f 1//1 2//1 3//1
f 1//1 3//1 4//1
""",
    "negative_indices": """
v 0 0 0
v 1 0 0
v 0 1 0
f -3 -2 -1
""",
    "multi_object": """
o first
v 0 0 0
v 1 0 0
v 0 1 0
f 1 2 3
g second
v 0 0 1
v 1 0 1
v 0 1 1
f 4 5 6
""",
    "mixed_vt": """
v 0 0 0
v 1 0 0
v 0 1 0
vt 0.5 0.25
f 1/1 2 3
""",
    "comments_and_mtl": """
# a comment
mtllib foo.mtl
usemtl bar
v 0 0 0
v 1 0 0
v 0 1 0
s off
f 1 2 3
""",
    "trailing_comments_oor": """
v 0 0 0
v 1 0 0
v 0 1 0
vt 0.5 0.5
f 1/1 2/9 3 # trailing comment
""",
}

FIELDS = ("positions", "normals", "uvs", "indices", "face_kd", "face_tex",
          "texels", "tex_table")


def _loaders():
    from compute_renderer_tpu.io.obj import load_obj as jax_load
    from compute_renderer_torch.io import native
    from compute_renderer_torch.io.obj import load_obj as py_load

    return native.load_obj, py_load, jax_load


def _assert_same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def _check(path, **kw):
    nat_load, py_load, jax_load = _loaders()
    nat = nat_load(path, **kw)
    _assert_same(nat, py_load(path, **kw))
    _assert_same(nat, jax_load(path, **kw))
    return nat


@pytest.mark.parametrize("name", list(CASES))
def test_native_matches_python(tmp_path, name):
    p = tmp_path / f"{name}.obj"
    p.write_text(CASES[name])
    nat = _check(p)
    assert nat.num_triangles >= 1
    if name == "trailing_comments_oor":
        # vt index 9 is out of range -> zero-filled -> V flip gives (0, 1).
        np.testing.assert_array_equal(nat.uvs[1], [0.0, 1.0])


def _write_obj(mesh, path):
    sys.path.insert(0, str(ROOT / "scripts"))
    from bench_obj_parse import write_obj

    return write_obj(mesh, path)


def test_native_matches_python_large(tmp_path):
    # A procedural mesh round-tripped through OBJ text.
    from compute_renderer_torch.io import procedural

    m = procedural.icosphere(3)
    lines = [f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}" for p in m.positions]
    lines += [f"vn {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}" for n in m.normals]
    lines += [f"vt {uv[0]:.9g} {uv[1]:.9g}" for uv in m.uvs]
    for a, b, c in m.indices.reshape(-1, 3):
        lines.append(f"f {a+1}/{a+1}/{a+1} {b+1}/{b+1}/{b+1} "
                     f"{c+1}/{c+1}/{c+1}")
    p = tmp_path / "sphere.obj"
    p.write_text("\n".join(lines) + "\n")
    assert _check(p).num_triangles == m.num_triangles


def test_native_matches_python_at_scale(tmp_path):
    # San-Miguel-class text at reduced size (65k triangles, ~7 MB), in
    # the OBJ writer's format of scripts/bench_obj_parse.py.
    from compute_renderer_torch.io import procedural

    m = procedural.uv_sphere(nu=256, nv=128)
    p = tmp_path / "big.obj"
    assert _write_obj(m, p) > 5.0
    assert _check(p).num_triangles == m.num_triangles


def _write_material_scene(tmp_path, with_map=True):
    from compute_renderer_torch.io.textures import write_ppm

    (tmp_path / "lib.mtl").write_text(
        "newmtl red\nKd 0.8 0.1 0.1\n"
        + ("map_Kd tex.ppm\n" if with_map else "")
        + "newmtl two words\nKd 0.1 0.8 0.2\n"
        "newmtl blue\nKd 0.2 0.2 0.9\n"
        + ("map_Kd tex.ppm\n" if with_map else "")
    )
    if with_map:
        write_ppm(tmp_path / "tex.ppm",
                  np.arange(12, dtype=np.uint8).reshape(2, 2, 3))
    p = tmp_path / "mat.obj"
    p.write_text(
        """
mtllib lib.mtl missing.mtl
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
vt 0 0
vt 1 0
vt 0 1
usemtl red
f 1/1 2/2 3/3
usemtl  two   words # comment
f 2/2 4/1 3/3
o next
usemtl ghost
f 1/1 2/2 4/3
usemtl
f 1 2 3
usemtl red
f 1/1 2/2 3/3 4/1
"""
    )
    return p


@pytest.mark.parametrize("textures", [False, True])
def test_native_materials_match_python(tmp_path, textures):
    # usemtl runs (multi-word names, comments, re-use across sub-meshes,
    # a bare usemtl, unresolvable names) and the map_Kd atlas, a quad fan
    # emitting two triangles of one material.
    p = _write_material_scene(tmp_path, with_map=textures)
    nat = _check(p, materials=True, textures=textures)
    assert len(np.unique(nat.face_kd, axis=0)) >= 3
    if textures:
        assert (nat.face_tex >= 0).any() and (nat.face_tex == -1).any()
    else:
        assert nat.face_tex is None


def test_structured_build_matches_python(tmp_path):
    # A small build of the synthesized structured scene with its MTL and
    # map_Kd images (every face-token form, three materials).
    from compute_renderer_torch.io import objgen

    path = tmp_path / "structured_small.obj"
    objgen.write_structured_obj(path, terrain_n=12, statue_nu=10,
                                statue_nv=8, ruins=4,
                                mtl_text=objgen._STRUCTURED_MTL)
    objgen._write_shared_textures(tmp_path)
    nat = _check(path, textures=True)
    assert nat.has_textures and nat.texels.shape[0] > 0


def test_model_load_parses_natively_unless_disabled(tmp_path, monkeypatch):
    from compute_renderer_torch.io import model, native, obj

    p = tmp_path / "quad.obj"
    p.write_text(CASES["quad_fan"])
    calls = []
    real_native, real_py = native.load_obj, obj.load_obj
    monkeypatch.setattr(native, "load_obj",
                        lambda *a, **k: calls.append("native")
                        or real_native(*a, **k))
    monkeypatch.setattr(obj, "load_obj",
                        lambda *a, **k: calls.append("python")
                        or real_py(*a, **k))
    monkeypatch.delenv("CRT_DISABLE_NATIVE", raising=False)
    a = model.Model.load(str(p))
    monkeypatch.setenv("CRT_DISABLE_NATIVE", "1")
    b = model.Model.load(str(p))
    assert calls == ["native", "python"]
    _assert_same(a.mesh, b.mesh)
    assert a.source == b.source == str(p)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    # A build that fails raises (with what the compiler printed): no
    # silent fall-back to the Python parse.
    from compute_renderer_torch import _build

    bad = tmp_path / "native"
    bad.mkdir()
    (bad / "objparse.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "NATIVE", bad)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "libs")
    with pytest.raises(RuntimeError, match="objparse.cpp"):
        _build.host_library("objparse")
    assert not list((tmp_path / "libs").glob("*.so"))


def test_library_is_keyed_by_source(tmp_path, monkeypatch):
    # The built library is named by a hash of its source and flags, and a
    # second call reuses it.
    from compute_renderer_torch import _build

    first = _build.host_library("objparse")
    assert first.exists() and first.parent == _build.HOST_BUILD_DIR
    assert _build.host_library("objparse") == first
    src = tmp_path / "native"
    src.mkdir()
    (src / "objparse.cpp").write_text(
        (_build.NATIVE / "objparse.cpp").read_text() + "\n// changed\n")
    monkeypatch.setattr(_build, "NATIVE", src)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "libs")
    other = _build.host_library("objparse")
    assert other.exists() and other.name != first.name

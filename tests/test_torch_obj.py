"""The port's OBJ / MTL / texture loaders (io/obj.py, core/materials.py,
io/textures.py, io/objgen.py, io/model.py) against the JAX package's.

Both sides are numpy, so every array is held bitwise: positions, normals,
uvs, indices, face_kd, face_tex, texels and tex_table. The structured
scenes are small ``write_structured_obj`` builds in ``tmp_path``: they
carry every face-token form (``v/vt/vn``, ``v//vn``, bare ``v``, negative
indices), ``o``/``g`` sub-meshes, quads, ``usemtl`` runs and the map_Kd
atlas."""

import numpy as np
import pytest

from tests.torch_parity import port, tpu  # noqa: F401 (fixtures)

MESH_FIELDS = ("positions", "normals", "uvs", "indices", "face_kd",
               "face_tex", "texels", "tex_table")


def _assert_meshes_equal(a, b):
    for field in MESH_FIELDS:
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), field
        if x is not None:
            assert x.dtype == y.dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)


def _loaders():
    from compute_renderer_torch.io import obj as port_obj
    from compute_renderer_tpu.io import obj as jax_obj

    return jax_obj.load_obj, port_obj.load_obj


def _write_small_structured(directory, textured):
    """A small structured build (both packages' objgen write the same
    bytes; this one is the port's) with the textured or plain MTL."""
    from compute_renderer_torch.io import objgen

    path = directory / "s.obj"
    mtl = (objgen._STRUCTURED_MTL if textured
           else "newmtl ground\nKd 0.35 0.45 0.20\n"
                "newmtl marble\nKd 0.85 0.85 0.80\n")  # no "stone": white
    stats = objgen.write_structured_obj(
        path, terrain_n=12, statue_nu=10, statue_nv=6, ruins=4,
        mtl_text=mtl)
    objgen._write_shared_textures(directory)
    return path, stats


@pytest.mark.parametrize("materials,textures", [
    (False, False), (True, False), (False, True), (True, True)])
def test_structured_build_bitwise(tmp_path, materials, textures):
    path, stats = _write_small_structured(tmp_path, textured=True)
    load_jax, load_port = _loaders()
    a = load_jax(path, materials=materials, textures=textures)
    b = load_port(path, materials=materials, textures=textures)
    _assert_meshes_equal(a, b)
    assert b.num_triangles == stats["triangles"]
    assert (b.face_kd is not None) == (materials or textures)
    assert b.has_textures == textures


@pytest.mark.parametrize("scene", ["structured", "structured_tex"])
def test_textured_load_keeps_the_materials_kd(tmp_path, scene):
    # A scene loaded once with textures serves its materials row too: the
    # face_kd of the textured load is the materials-only load's, for both
    # structured scenes' MTL libraries.
    from compute_renderer_torch.io import objgen
    from compute_renderer_torch.io.obj import load_obj

    if scene == "structured":
        path, _ = _write_small_structured(tmp_path, textured=True)
    else:
        path = objgen.ensure_textured_scene(tmp_path)
    kd = load_obj(path, materials=True).face_kd
    tex = load_obj(path, textures=True)
    assert tex.has_textures and (tex.face_tex >= 0).any()
    assert (tex.face_tex < 0).any()  # the untextured "stone" faces
    np.testing.assert_array_equal(tex.face_kd, kd)


def test_missing_material_is_white(tmp_path):
    # "stone" is used by the ruins but absent from this MTL: its faces get
    # identity white, like the banner's faces, which have no usemtl.
    path, _ = _write_small_structured(tmp_path, textured=False)
    load_jax, load_port = _loaders()
    a = load_jax(path, materials=True)
    b = load_port(path, materials=True)
    _assert_meshes_equal(a, b)
    white = (b.face_kd == 1.0).all(axis=1)
    assert white.sum() >= 4 * 12 + 2  # ruins' boxes + the banner quad
    assert not white.all()


@pytest.mark.parametrize("text", [
    # v//vn: normals without texcoords
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n",
    # bare v, a quad (fan triangulation)
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n",
    # negative (relative) indices and v/vt with a V flip
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nvt 0 0.25\nvt 1 0.5\nvt 1 1\n"
    "f -3/-3 -2/-2 -1/-1\n",
    # sub-meshes with per-sub-mesh dedup, trailing comments, a missing vt
    "o a\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.5 0.5\nf 1/1 2 3 # c\n"
    "g b\nf 1/1 2 3\n",
    # usemtl naming a material the library lacks, and an unreadable lib
    "mtllib nowhere.mtl\nusemtl ghost\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
])
def test_face_forms_bitwise(tmp_path, text):
    path = tmp_path / "t.obj"
    path.write_text(text)
    load_jax, load_port = _loaders()
    for kw in ({}, {"materials": True}, {"textures": True}):
        _assert_meshes_equal(load_jax(path, **kw), load_port(path, **kw))


def test_map_kd_atlas_bitwise(tmp_path):
    # Two materials share one image (one slot), one names a missing file
    # (a 1x1 white slot, with a warning), one has no map (-1).
    from compute_renderer_torch.io import textures

    rng = np.random.default_rng(3)
    textures.write_ppm(tmp_path / "a.ppm",
                       rng.integers(0, 256, (5, 7, 3), dtype=np.uint8))
    (tmp_path / "lib.mtl").write_text(
        "newmtl red\nKd 0.9 0.1 0.1\nmap_Kd -s 1 1 a.ppm\n"
        "newmtl red2\nKd 0.5 0.5 0.5\nmap_Kd a.ppm\n"
        "newmtl lost\nKd 1 1 1\nmap_Kd missing.ppm\n"
        "newmtl plain\nKd 0.2 0.3 0.4\n")
    faces = "".join(f"usemtl {m}\nf 1/1 2/2 3/3\n"
                    for m in ("red", "red2", "lost", "plain"))
    path = tmp_path / "t.obj"
    path.write_text("mtllib lib.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                    "vt 0 0\nvt 1 0\nvt 0 1\n" + faces)
    load_jax, load_port = _loaders()
    with pytest.warns(UserWarning, match="missing.ppm"):
        b = load_port(path, textures=True)
    with pytest.warns(UserWarning):
        a = load_jax(path, textures=True)
    _assert_meshes_equal(a, b)
    assert b.face_tex.tolist() == [0, 0, 1, -1]
    assert b.tex_table.tolist() == [[0, 7, 5], [35, 1, 1]]


def test_parse_mtl_and_images(port, tpu, tmp_path):
    from compute_renderer_torch.core import materials as pm
    from compute_renderer_torch.io import textures as pt
    from compute_renderer_tpu.core import materials as jm
    from compute_renderer_tpu.io import textures as jt

    lib = tmp_path / "lib.mtl"
    lib.write_text("Kd 1 1 1\nnewmtl a b\nKa 0.1 0.2 0.3\nKd 0.4 0.5 0.6\n"
                   "Ks 0.7 0.8 0.9\nNs 10\nd 0.5\nNi 1.4\n"
                   "map_Kd -bm 2 -o 0.1 0.2 my tex.ppm\n"
                   "newmtl c\nTr 0.25\nillum 2\n")
    a, b = jm.parse_mtl(lib), pm.parse_mtl(lib)
    assert list(a) == list(b) == ["a b", "c"]
    for name in a:
        for f in ("ambient", "specular", "diffuse"):
            np.testing.assert_array_equal(getattr(a[name], f),
                                          getattr(b[name], f))
        for f in ("shininess", "dissolve", "optical_density", "diffuse_map"):
            assert getattr(a[name], f) == getattr(b[name], f)
    assert b["a b"].diffuse_map == "my tex.ppm"
    img = np.random.default_rng(4).random((6, 9, 3)).astype(np.float32)
    pt.write_ppm(tmp_path / "p6.ppm", img)
    (tmp_path / "p3.ppm").write_bytes(
        b"P3\n# comment\n2 1\n15\n0 15 3  7 7 7\n")
    for name in ("p6.ppm", "p3.ppm"):
        np.testing.assert_array_equal(jt.load_image(tmp_path / name),
                                      pt.load_image(tmp_path / name))
    paths = [tmp_path / "p6.ppm", tmp_path / "p3.ppm", tmp_path / "p6.ppm"]
    for x, y in zip(jt.build_atlas(paths), pt.build_atlas(paths)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_non_ppm_without_pillow_names_the_format(tmp_path, monkeypatch):
    import sys

    from compute_renderer_torch.io import textures

    png = tmp_path / "t.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(16))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=r"t\.png.*PNG.*Pillow"):
        textures.load_image(png)


def test_objgen_writes_the_same_files(tmp_path):
    from compute_renderer_torch.io import objgen as po
    from compute_renderer_tpu.io import objgen as jo

    kw = dict(terrain_n=8, statue_nu=6, statue_nv=4, ruins=3)
    a = jo.write_structured_obj(tmp_path / "a.obj", mtl_name="a.mtl", **kw)
    b = po.write_structured_obj(tmp_path / "b.obj", mtl_name="a.mtl", **kw)
    assert a == b
    assert (tmp_path / "a.obj").read_bytes() == (tmp_path / "b.obj").read_bytes()
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jo._write_shared_textures(tmp_path / "j")
    po._write_shared_textures(tmp_path / "p")
    for name in ("structured_ground.ppm", "structured_marble.ppm"):
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "p" / name).read_bytes()


@pytest.mark.parametrize("materials,textures", [(True, False), (False, True)])
def test_model_load_structured_name_bitwise(tmp_path, monkeypatch, materials,
                                            textures):
    # Model.load of the structured scene's own name: a small build with the
    # current header, found in the working directory, goes through the
    # ensure_* hook (which refreshes the MTL and the map_Kd images) and
    # the loader, as the full 1,023,442-triangle scene does.
    from compute_renderer_torch.io import objgen
    from compute_renderer_torch.io.model import Model as PortModel
    from compute_renderer_tpu.io.model import Model as JaxModel

    monkeypatch.chdir(tmp_path)
    objgen.write_structured_obj(tmp_path / objgen.STRUCTURED_NAME,
                                terrain_n=10, statue_nu=8, statue_nv=6,
                                ruins=3)
    b = PortModel.load(objgen.STRUCTURED_NAME, materials=materials,
                       textures=textures)
    assert "map_Kd" in (tmp_path / "structured_scene.mtl").read_text()
    assert (tmp_path / "structured_ground.ppm").exists()
    a = JaxModel.load(objgen.STRUCTURED_NAME, materials=materials,
                      textures=textures)
    _assert_meshes_equal(a.mesh, b.mesh)
    assert b.mesh.has_textures == textures
    assert b.source.endswith(objgen.STRUCTURED_NAME)

"""A configuration that carries textures: the structured OBJ part, written
by the frozen generator (``reference/objscene.py``) and loaded by the
program's own loader, and the reference's material and texture shading.

- the textured reference against the port's NumPy oracle
  (``compute_renderer_torch.golden.render_golden``) in each filter and
  with materials alone, on a small structured scene and on a seeded
  scene of wrapped uvs and odd-sized images;
- the generator's files equal to the port's objgen's, and its arrays and
  images equal to what ``Model.load(..., textures=True)`` reads from them;
- a whole small run of the 36k build at 96x72, trilinear, reads
  ``correct``, and reads not correct with the program's filter forced to
  ``nearest`` or its Kd dropped, or with the bfloat16 control in its place;
- the base frames of the three cells' small versions equal, bit for bit,
  to those of the reference before it learnt textures
  (``base_render.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from frame_bench import harness
from frame_bench.reference import camera as cam
from frame_bench.reference import objscene
from frame_bench.reference import render as ref
from frame_bench.tests import base_render, fb_small

W, H = 64, 48
# The small textured run's limit: between the program's 0 and the
# faults' and the control's readings (planted faults 308 and 622, the
# bfloat16 control 840-895 at 96x72 on three seeds).
SMALL_BAD_PX = 100
SPAWN = [13.566635, 4.0, 24.0]
MODES = ["materials", "nearest", "bilinear", "trilinear", "anisotropic"]


def lights():
    return harness.load_json("configs", "san_miguel")["lights"]


def structured(tmp_path, mtl="structured", ground_px=64, marble_px=20,
               terrain_n=40):
    return objscene.ObjScene(tmp_path, {
        "kind": objscene.KIND, "terrain_n": terrain_n, "statue_nu": 30,
        "statue_nv": 16, "ruins": 20, "mtl": mtl, "ground_px": ground_px,
        "marble_px": marble_px})


def seeded(seed=20261018):
    """A displaced sphere seen from outside, with seeded uvs far outside
    [0, 1], seeded Kd, and two seeded images of odd sides, a third of the
    faces without one."""
    from frame_bench.reference import geometry

    rng = np.random.default_rng(seed)
    pos, nrm, _, idx = geometry.uv_sphere(20, 10, 1.0)
    uvs = rng.uniform(-2.0, 3.0, (pos.shape[0], 2)).astype(np.float32)
    tri = idx.astype(np.int64).reshape(-1, 3)
    face_kd = rng.uniform(0.2, 1.0, (tri.shape[0], 3)).astype(np.float32)
    face_image = rng.integers(-1, 2, tri.shape[0]).astype(np.int32)
    images = [rng.uniform(0, 1, (37, 23, 3)).astype(np.float32),
              rng.uniform(0, 1, (5, 16, 3)).astype(np.float32)]
    return pos, nrm, uvs, tri, face_kd, face_image, images


def oracle(pos, nrm, uvs, tri, pose, mode, face_kd, face_image, images):
    from compute_renderer_torch.golden import render_golden
    from compute_renderer_torch.io.textures import trilinear_tex_arrays

    vpos, vp = pose.matrices(W / H)
    kw = {"face_kd": face_kd}
    if mode != "materials":
        table, off = [], 0
        for img in images:
            table.append((off, img.shape[1], img.shape[0]))
            off += img.shape[0] * img.shape[1]
        texels = np.concatenate([i.reshape(-1, 3) for i in images])
        table = np.array(table, np.int32)
        pool, mips = trilinear_tex_arrays(texels, table)
        mipped = mode in ("trilinear", "anisotropic")
        kw.update(face_tex=face_image, tex_filter=mode, tex_table=table,
                  texels=pool if mipped else texels, tex_mips=mips)
    light = lights()
    with np.errstate(all="ignore"):
        return render_golden(
            pos, nrm, uvs, tri.reshape(-1).astype(np.uint32), vp, vpos,
            np.array([l["position"] for l in light], np.float32),
            np.array([l["color"] for l in light], np.float32),
            np.array([l["intensity"] for l in light], np.float32),
            np.zeros(6, np.float32), W, H, **kw)


def reference(pos, nrm, uvs, tri, pose, mode, face_kd, face_image, images):
    extra = {"face_kd": face_kd}
    if mode != "materials":
        extra.update(uvs=uvs, face_image=face_image, images=images)
    scene = ref.Scene(pos, nrm, tri, "cpu", **extra)
    vpos, vp = pose.matrices(W / H)
    return ref.render(scene, vpos, vp, lights(), W, H,
                      tex_filter="nearest" if mode == "materials" else mode
                      ).numpy()


def scene_and_poses(kind, tmp_path):
    if kind == "structured":
        s = structured(tmp_path)
        arrays = (s.positions, s.normals, s.uvs, s.tri, s.face_kd,
                  s.face_image, s.images)
        poses = []
        for k, (dx, dy) in enumerate([(0, 0), (-300, -200), (150, -100)]):
            pose = cam.Pose.first_person([SPAWN[0], SPAWN[1] - k,
                                          SPAWN[2] - 6 * k])
            pose.mouse(dx, dy)
            poses.append(pose)
        return arrays, poses
    return seeded(), [cam.Pose.orbit(d, yaw, 0.0, (0.0, 0.0, 0.0))
                      for d, yaw in ((2.2, 0.0), (1.6, 130.0), (3.5, 250.0))]


@pytest.mark.parametrize("kind", ["structured", "seeded"])
@pytest.mark.parametrize("mode", MODES)
def test_textured_reference_equals_oracle(tmp_path, kind, mode):
    arrays, poses = scene_and_poses(kind, tmp_path)
    covered = 0
    for pose in poses:
        got = reference(*arrays[:4], pose, mode, *arrays[4:])
        want = oracle(*arrays[:4], pose, mode, *arrays[4:])
        diff = np.abs(got.astype(int) - want.astype(int)).max(axis=-1)
        # At most one LSB: torch's and NumPy's float32 pow and log2 may
        # round apart; coverage, winners and texels agree exactly.
        assert diff.max() <= 1, (kind, mode, int(diff.max()))
        assert (diff > 0).sum() <= 4
        covered += int((want[..., :3] != [0, 0, 255]).any(axis=-1).sum())
    assert covered > 0.1 * W * H * len(poses)


@pytest.mark.parametrize("kind", ["structured", "seeded"])
def test_the_filters_differ(tmp_path, kind):
    arrays, poses = scene_and_poses(kind, tmp_path)
    frames = {m: np.concatenate([reference(*arrays[:4], p, m, *arrays[4:])
                                 for p in poses]) for m in MODES}
    for i, a in enumerate(MODES):
        for b in MODES[i + 1:]:
            assert not np.array_equal(frames[a], frames[b]), (a, b)


@pytest.mark.parametrize("mtl,loader", [("structured", "native"),
                                        ("structured_tex", "native"),
                                        ("structured_tex", "python")])
def test_generator_arrays_equal_the_loaders(tmp_path, monkeypatch, mtl,
                                            loader):
    from compute_renderer_torch.io.model import Model

    if loader == "python":
        monkeypatch.setenv("CRT_DISABLE_NATIVE", "1")
    s = structured(tmp_path, mtl=mtl, ground_px=48, marble_px=20)
    mesh = Model.load(str(s.path), textures=True).mesh
    corners = mesh.indices.reshape(-1, 3)
    assert mesh.num_triangles == s.tri.shape[0]
    for mine, theirs in ((s.positions, mesh.positions),
                         (s.normals, mesh.normals), (s.uvs, mesh.uvs)):
        assert np.array_equal(mine[s.tri].view(np.uint32),
                              theirs[corners].view(np.uint32))
    assert np.array_equal(s.face_kd, mesh.face_kd)
    assert np.array_equal(s.face_image, mesh.face_tex)
    assert len(s.images) == len(mesh.tex_table) == 2
    for img, (off, w, h) in zip(s.images, mesh.tex_table):
        assert img.shape == (h, w, 3)
        assert np.array_equal(img.reshape(-1, 3), mesh.texels[off:off + w * h])
    # The scene has each kind of face: textured, untextured, no uvs.
    assert set(np.unique(s.face_image)) == {-1, 0, 1}


def test_generator_writes_objgens_files(tmp_path):
    from compute_renderer_torch.io import objgen

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    structured(tmp_path / "a", mtl="structured_tex", ground_px=64,
               marble_px=32)
    objgen.write_structured_obj(
        tmp_path / "b" / objscene.OBJ_NAME, terrain_n=40, statue_nu=30,
        statue_nv=16, ruins=20, mtl_name=objscene.MTL_NAME,
        mtl_text=objscene.MTL_TEXTS["structured_tex"])
    objgen._write_shared_textures(tmp_path / "b")
    names = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "a").iterdir())
    for name in names:
        assert ((tmp_path / "a" / name).read_bytes()
                == (tmp_path / "b" / name).read_bytes()), name
    assert objgen.OBJGEN_VERSION == objscene.OBJGEN_VERSION
    assert objgen._STRUCTURED_MTL == objscene.MTL_TEXTS["structured"]


def short_mix(mix):
    mix.update(batch=4)
    mix["camera"]["period_s"] = 0.25


def run_textured(**kwargs):
    return fb_small.run("structured_tex.batch", cfg=fb_small.textured(),
                        traffic_changes=short_mix, bad_px=SMALL_BAD_PX,
                        **kwargs)


def test_textured_run_is_correct():
    result, numbers = run_textured()
    assert result["correct"] is True, numbers
    assert numbers["bad_px"][0] == 0
    assert result["attempted"] > 0


def nearest_filter(monkeypatch):
    from compute_renderer_torch.engine.scene import Scene

    orig = Scene.renderer_options

    def broken(self):
        options = orig(self)
        options.pop("tex_filter", None)
        return options

    monkeypatch.setattr(Scene, "renderer_options", broken)


def dropped_kd(monkeypatch):
    from compute_renderer_torch.io.model import Model

    orig = Model.load

    def broken(*args, **kwargs):
        model = orig(*args, **kwargs)
        model.mesh = dataclasses.replace(
            model.mesh, face_kd=np.ones_like(model.mesh.face_kd))
        return model

    monkeypatch.setattr(Model, "load", staticmethod(broken))


def control_in_place(monkeypatch):
    from compute_renderer_torch.engine.renderer import Renderer

    orig = Renderer.render_batch_device
    cfg = fb_small.textured()

    def control(self, seq, *args, **kwargs):
        out = orig(self, seq, *args, **kwargs)
        arrays = harness.build_scene(cfg)
        arrays.remove_files()
        scene = harness.reference_scene(cfg, arrays, "cpu")
        for k, u in enumerate(seq):
            out[k] = ref.render(scene, u.view_position, u.view_proj,
                                cfg["lights"], self.width, self.height,
                                dtype=torch.bfloat16,
                                tex_filter=cfg["tex_filter"])
        return out

    monkeypatch.setattr(Renderer, "render_batch_device", control)


@pytest.mark.parametrize("fault", [nearest_filter, dropped_kd,
                                   control_in_place])
def test_textured_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, numbers = run_textured()
    assert result["correct"] is False, numbers
    assert numbers["bad_px"][0] > numbers["bad_px"][1]


def test_written_files_are_removed(monkeypatch):
    made = []
    orig = harness.build_scene

    def spy(config):
        arrays = orig(config)
        made.append(arrays.directory)
        return arrays

    monkeypatch.setattr(harness, "build_scene", spy)
    run_textured()
    assert made and not made[0].exists()


def test_shading_needs_an_obj_part():
    cfg = fb_small.config("suzanne")
    cfg["shading"] = "textures"
    with pytest.raises(ValueError):
        harness.build_scene(cfg)
    cfg["shading"] = "glossy"
    with pytest.raises(ValueError):
        harness.build_scene(cfg)


def cell_poses(cell):
    config_name, traffic_name = cell.split(".")
    cfg = fb_small.config(config_name)
    mix = fb_small.traffic(traffic_name)
    dt = float(mix["dt"])
    if mix["loop"] == "batch":
        path = cam.LookAround(mix["camera"], cfg["camera"], dt, 2_600_000_009)
        return cfg, [path.pose(path.pose_index(j)) for j in (0, 5, 13, 22)]
    path = cam.interactive_path(mix["camera"], cfg["camera"], dt,
                                2_600_000_009)
    ticks = [0, 9, 17, 30]
    got = path.poses(ticks)
    return cfg, [got[g] for g in ticks]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["san_miguel.batch", "suzanne.batch",
                                  "san_miguel.viewer"])
def test_base_frames_are_unchanged(cell, dtype):
    cfg, poses = cell_poses(cell)
    arrays = harness.build_scene(cfg)
    scene = harness.reference_scene(cfg, arrays, "cpu")
    old = base_render.Scene(arrays[0], arrays[1], arrays[3], "cpu")
    w, h = cfg["width"], cfg["height"]
    for pose in poses:
        vpos, vp = pose.matrices(w / h)
        new = ref.render(scene, vpos, vp, cfg["lights"], w, h,
                         cell=cfg["cell"], dtype=dtype,
                         tex_filter=cfg.get("tex_filter", "nearest"))
        want = base_render.render(old, vpos, vp, cfg["lights"], w, h,
                                  cell=cfg["cell"], dtype=dtype)
        assert torch.equal(new, want)
        assert (want[..., 2] != 255).any()

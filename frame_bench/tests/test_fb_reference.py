"""The plain reference against the port's NumPy oracle
(``compute_renderer_torch.golden.render_golden``, the per-triangle
emulation of the reference renderer's shaders) at small sizes, in the two
kinds of scene the cells render: many sub-pixel triangles (San Miguel's
terrain and statue, the micro path's class) and a few large ones
(Suzanne's icosphere, the tile path's class)."""

import numpy as np
import pytest
import torch

from frame_bench.reference import camera as cam
from frame_bench.reference import geometry
from frame_bench.reference import render as ref
from frame_bench.tests import fb_small

W, H = 64, 48


def golden(arrays, pose, lights):
    from compute_renderer_torch.golden import render_golden

    pos, nrm, uvs, idx = arrays
    vpos, vp = pose.matrices(W / H)
    return render_golden(
        pos, nrm, uvs, idx, vp, vpos,
        np.array([l["position"] for l in lights], np.float32),
        np.array([l["color"] for l in lights], np.float32),
        np.array([l["intensity"] for l in lights], np.float32),
        np.zeros(6, np.float32), W, H)


def poses(name):
    if name == "suzanne":
        return [cam.Pose.orbit(2.0, yaw, 0.0, (0.0, 0.0, 0.0))
                for yaw in (0.0, 77.0, 200.0)]
    out = []
    for k, (dx, dy) in enumerate([(0.0, 0.0), (-350.0, -80.0),
                                  (120.0, -150.0)]):
        pose = cam.Pose.first_person([13.566635, 2.6288567 + k,
                                      10.243919 - 2.0 * k])
        pose.mouse(dx, dy)
        out.append(pose)
    return out


@pytest.mark.parametrize("name", ["san_miguel", "suzanne"])
def test_reference_equals_oracle(name):
    cfg = fb_small.config(name)
    arrays = geometry.build(cfg["geometry"])
    scene = ref.Scene(arrays[0], arrays[1], arrays[3], "cpu")
    covered = 0
    for pose in poses(name):
        vpos, vp = pose.matrices(W / H)
        got = ref.render(scene, vpos, vp, cfg["lights"], W, H).numpy()
        want = golden(arrays, pose, cfg["lights"])
        diff = np.abs(got.astype(int) - want.astype(int)).max(axis=-1)
        # At most one LSB: torch's and NumPy's float32 pow may round the
        # gamma apart; coverage and the winners agree exactly.
        assert diff.max() <= 1, (name, int(diff.max()))
        covered += int((want[..., :3] != [0, 0, 255]).any(axis=-1).sum())
    assert covered > 0.1 * W * H * 3


@pytest.mark.parametrize("budget", [1, 97, 1 << 23])
def test_blocks_do_not_change_the_frame(budget):
    cfg = fb_small.config("san_miguel")
    arrays = geometry.build(cfg["geometry"])
    scene = ref.Scene(arrays[0], arrays[1], arrays[3], "cpu")
    vpos, vp = poses("san_miguel")[1].matrices(W / H)
    base = ref.render(scene, vpos, vp, cfg["lights"], W, H)
    got = ref.render(scene, vpos, vp, cfg["lights"], W, H, budget=budget)
    assert torch.equal(base, got)


def test_ties_go_to_the_lower_triangle():
    # Two copies of one quad: every covered pixel's depth ties, and the
    # first copy's triangles win; a copy with other normals would shade
    # otherwise.
    pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                   np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    lights = [{"position": [0.0, 0.0, 2.0], "color": [1.0, 1.0, 1.0],
               "intensity": 1.0}]
    pose = cam.Pose.first_person([0.0, 0.0, 2.0])
    vpos, vp = pose.matrices(W / H)
    one = ref.Scene(pos, nrm, idx, "cpu")
    two = ref.Scene(np.concatenate([pos, pos]),
                    np.concatenate([nrm, -nrm]),
                    np.concatenate([idx, idx + 4]), "cpu")
    a = ref.render(one, vpos, vp, lights, W, H)
    b = ref.render(two, vpos, vp, lights, W, H)
    assert torch.equal(a, b)
    assert (a[..., 2] != 255).any()

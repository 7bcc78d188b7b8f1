"""What the benchmark loads: no module whose top-level name is JAX's or
the JAX package's, in the reference or in a whole run, and nothing of the
program in the reference."""

import json
import subprocess
import sys

from frame_bench import harness

ROOT = str(harness.ROOT)


def loaded_after(code):
    script = (f"import sys; sys.path.insert(0, {ROOT!r})\n{code}\n"
              "import json; print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program_or_jax():
    top = loaded_after(
        "from frame_bench.reference import camera, geometry, objscene, render\n"
        "from frame_bench import trace\n"
        "import tempfile, torch\n"
        "s = render.Scene(*[a for i, a in enumerate(geometry.build("
        "[{'kind': 'icosphere', 'subdivisions': 1}])) if i != 2], 'cpu')\n"
        "vpos, vp = camera.Pose.first_person([0, 0, 3]).matrices(4 / 3)\n"
        "render.render(s, vpos, vp, [], 32, 24)\n"
        "o = objscene.ObjScene(tempfile.mkdtemp(), {'kind': 'structured_obj', "
        "'terrain_n': 4, 'statue_nu': 6, 'statue_nv': 4, 'ruins': 2})\n"
        "t = render.Scene(o.positions, o.normals, o.tri, 'cpu', uvs=o.uvs, "
        "face_kd=o.face_kd, face_image=o.face_image, images=o.images)\n"
        "o.remove_files()\n"
        "render.render(t, vpos, vp, [], 32, 24, tex_filter='anisotropic')")
    assert not top & {"compute_renderer_torch", *harness.BANNED}


def test_a_run_loads_no_jax():
    top = loaded_after(
        "from frame_bench.tests import fb_small\n"
        "result, _ = fb_small.run('suzanne.batch', seconds=0.2)\n"
        "assert result['correct']")
    assert "compute_renderer_torch" in top
    assert not top & set(harness.BANNED)

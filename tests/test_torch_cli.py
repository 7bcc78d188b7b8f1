"""The port's entry points on the CPU: the CLI (``cli.py``, its flags,
aliases and error exits as the JAX package's, plus ``--device``), the
headless loop and its PNG writer (``app/headless.py``), the collector and
system sampler (``bench/collector.py``, ``bench/sysmon.py``; the cases of
tests/test_bench.py:21-160), and the suite (``bench/suite.py``): its 21
rows field by field against the JAX package's, ``run_scene`` and
``run_suite`` at 64x48 with ``device="cpu"``. Without a card the default
``--device cuda`` exits non-zero. And no module of the port imports JAX
or the JAX package.

Tolerances: the collector's metrics within 1e-6 (float sums of a few
frame times); everything else exact.
"""

import dataclasses
import json
import os
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48


def parse(argv):
    from compute_renderer_torch import cli

    return cli.build_parser().parse_args(argv)


def _config(argv):
    from compute_renderer_torch import cli

    return cli.scene_config_from_args(parse(argv))


def _run(args, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def read_png(path):
    """(H, W, 4) u8 from an 8-bit RGBA PNG file (``decode_png``)."""
    with open(path, "rb") as fh:
        return decode_png(fh.read())


def decode_png(data):
    """(H, W, 4) u8 from the bytes of an 8-bit RGBA PNG with filter 0 rows
    (what the minimal writer emits), with the standard library alone."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
            assert body[8:10] == b"\x08\x06"
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 4)


# -- the parser -------------------------------------------------------------

def test_defaults_match_reference():
    args = parse([])
    assert (args.width, args.height) == (1024, 768)
    assert args.model_path == "suzanne.obj"
    assert args.camera_mode == "first-person"
    assert args.backend_type == "custom"
    assert args.device == "cuda"
    assert args.frames == 1 and args.output == "frame.png"


def test_parser_matches_jax():
    # The same options, defaults and subcommands as the JAX package's
    # parser; the port adds --device alone.
    from compute_renderer_tpu import cli as jax_cli
    from compute_renderer_torch import cli

    def options(parser):
        out = {}
        for a in parser._actions:
            if a.option_strings:
                out[tuple(a.option_strings)] = (a.default, a.choices, a.type)
            elif a.choices:
                out[a.dest] = {name: options(sub)
                               for name, sub in a.choices.items()}
        return out

    ours = options(cli.build_parser())
    theirs = options(jax_cli.build_parser())
    assert ours.pop(("--device",)) == ("cuda", ("cuda", "cpu"), str)
    assert set(ours) == set(theirs)
    for k in theirs:
        if k == ("--version", "-V"):
            continue
        if k == "command":
            assert ours[k] == theirs[k]
        else:
            assert ours[k][:2] == theirs[k][:2], k
            assert (ours[k][2] is None) == (theirs[k][2] is None), k


def test_scene_config_defaults():
    from compute_renderer_torch.core.camera import CameraMode

    cfg = _config([])
    assert cfg.model_path == "suzanne.obj"
    assert cfg.normalized_backend() == "cuda"
    assert cfg.camera_config.mode is CameraMode.FIRST_PERSON
    assert cfg.camera_config.position == (13.566635, 2.6288567, 10.243919)
    assert cfg.effect is None
    assert len(cfg.lights) == 2


@pytest.mark.parametrize("name,norm", [
    ("custom", "cuda"), ("tpu", "cuda"), ("wgpu", "xla"), ("xla", "xla"),
    ("wgpu-faithful", "wgpu-faithful")])
def test_backend_aliases(name, norm):
    assert _config(["--backend-type", name]).normalized_backend() == norm


def test_invalid_backend_exits():
    with pytest.raises(SystemExit):
        _config(["--backend-type", "vulkan"])


@pytest.mark.parametrize("effect", ["wave", "voxelize", "edge_melt",
                                    "mirage", "none"])
def test_effect_construction(effect):
    from compute_renderer_torch.core import effects as fx

    argv = ["effect", "--effect", effect]
    if effect == "wave":
        argv += ["--param1", "0.5", "--param2", "2", "--param3", "1.5",
                 "--param4", "2"]
    cfg = _config(argv)
    if effect == "none":
        assert cfg.effect is None
        return
    kind = {"wave": fx.EFFECT_WAVE, "voxelize": fx.EFFECT_VOXELIZE,
            "edge_melt": fx.EFFECT_EDGE_MELT,
            "mirage": fx.EFFECT_MIRAGE}[effect]
    assert cfg.effect.kind == kind
    if effect == "wave":
        assert cfg.effect.direction is fx.WaveDirection.RADIAL
        assert cfg.effect.amplitude == 0.5


@pytest.mark.parametrize("argv", [
    ["effect", "--effect", "explode"],
    ["effect", "--effect", "wave", "--param4", "7"]])
def test_invalid_effect_exits(argv):
    with pytest.raises(SystemExit):
        _config(argv)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_benchmarks_invalid_offset(device):
    from compute_renderer_torch import cli

    assert cli.main(["--device", device, "benchmarks", "--offset", "99"]) == 1


@pytest.mark.parametrize("frames", [1, 2])
def test_interactive_without_display_falls_back(frames, tmp_path, capsys,
                                                monkeypatch):
    # No display here: --interactive says so and renders headlessly.
    from compute_renderer_torch import cli

    monkeypatch.delenv("DISPLAY", raising=False)
    out = tmp_path / "i.png"
    rc = cli.main(["--device", "cpu", "--width", str(W), "--height", str(H),
                   "--interactive", "--frames", str(frames), "--output",
                   str(out)])
    assert rc == 0
    assert "Falling back to headless." in capsys.readouterr().err
    paths = ([out] if frames == 1 else
             [tmp_path / f"i_{i:04d}.png" for i in range(frames)])
    for p in paths:
        assert read_png(p).shape == (H, W, 4)


@pytest.mark.parametrize("backend", ["custom", "xla"])
def test_web_serves_frame_and_quits(backend, capsys):
    # --web 0 on a thread: the printed URL serves the page and a PNG frame
    # of the requested size; POST /quit ends main() with 0.
    import threading
    import urllib.request

    from compute_renderer_torch import cli

    rc = []
    t = threading.Thread(target=lambda: rc.append(cli.main(
        ["--device", "cpu", "--width", str(W), "--height", str(H),
         "--backend-type", backend, "--web", "0"])), daemon=True)
    t.start()
    out, deadline = "", time.monotonic() + 120
    while ("http://" not in out and t.is_alive()
           and time.monotonic() < deadline):
        out += capsys.readouterr().out
        time.sleep(0.05)
    url = out[out.index("http://"):].split()[0]
    with urllib.request.urlopen(url, timeout=30) as r:
        assert b"/frame" in r.read()
    with urllib.request.urlopen(url + "frame?since=0", timeout=30) as r:
        assert int(r.headers["X-Frame-No"]) >= 1
        img = decode_png(r.read())
    assert img.shape == (H, W, 4) and (img[..., 2] != 255).any()
    urllib.request.urlopen(urllib.request.Request(
        url + "quit", data=b"{}", method="POST"), timeout=30).read()
    t.join(timeout=60)
    assert not t.is_alive() and rc == [0]


# -- headless runs -----------------------------------------------------------

def test_headless_render_end_to_end(tmp_path):
    from compute_renderer_torch import cli

    out = tmp_path / "out.png"
    rc = cli.main(["--device", "cpu", "--width", str(W), "--height", str(H),
                   "--backend-type", "xla", "--camera-mode", "orbit",
                   "--frames", "1", "--output", str(out)])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (H, W, 4)
    assert (img[..., 2] != 255).any()  # something covers the blue


def _no_pil():
    try:
        import PIL  # noqa: F401
    except ImportError:
        return True
    return False


def _pil_read(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGBA"))


@pytest.mark.parametrize("backend", ["cuda", "xla", "wgpu-faithful"])
def test_headless_multi_frame(tmp_path, backend):
    from compute_renderer_torch.app.headless import run_headless
    from compute_renderer_torch.engine.scene import CameraConfig, SceneConfig

    cfg = SceneConfig(backend_type=backend,
                      camera_config=CameraConfig(distance=3.0))
    paths = run_headless(cfg, W, H, frames=3,
                         output=str(tmp_path / "f.png"), dt=0.1,
                         device="cpu")
    assert [p.name for p in paths] == ["f_0000.png", "f_0001.png",
                                       "f_0002.png"]
    assert all(p.exists() for p in paths)


def test_headless_png_without_pillow(tmp_path, monkeypatch):
    # The card's machine has no Pillow: PNGs need none (a decode with zlib
    # alone gives the frame back), and a GIF output raises a clear error.
    from compute_renderer_torch.app import headless
    from compute_renderer_torch.engine.scene import CameraConfig, SceneConfig

    monkeypatch.setitem(sys.modules, "PIL", None)
    cfg = SceneConfig(camera_config=CameraConfig(distance=3.0))
    (path,) = headless.run_headless(cfg, W, H, frames=1,
                                    output=str(tmp_path / "m.png"), dt=0.1,
                                    device="cpu")
    img = read_png(path)
    assert img.shape == (H, W, 4) and (img[..., 2] != 255).any()
    with pytest.raises(RuntimeError, match="Pillow"):
        headless.run_headless(cfg, W, H, frames=2,
                              output=str(tmp_path / "a.gif"), device="cpu")


def test_png_writer_minimal(tmp_path):
    # write_png's file and encode_png's bytes at the web viewer's zlib
    # level decode to the frame, with zlib alone and with Pillow.
    from compute_renderer_torch.app.headless import encode_png, write_png

    rgba = np.random.default_rng(3).integers(0, 256, (5, 7, 4),
                                             dtype=np.uint8)
    p = tmp_path / "m.png"
    write_png(p, rgba)
    np.testing.assert_array_equal(read_png(p), rgba)
    np.testing.assert_array_equal(decode_png(encode_png(rgba, level=1)),
                                  rgba)
    if not _no_pil():
        np.testing.assert_array_equal(_pil_read(p), rgba)


def test_headless_gif_output(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    from compute_renderer_torch.app.headless import run_headless
    from compute_renderer_torch.engine.scene import CameraConfig, SceneConfig

    out = tmp_path / "anim.gif"
    written = run_headless(SceneConfig(camera_config=CameraConfig(
        distance=3.0)), W, H, frames=3, output=str(out), dt=1 / 30.0,
        device="cpu")
    assert written == [out]
    with Image.open(out) as im:
        assert im.format == "GIF" and getattr(im, "n_frames", 1) == 3


def _skip_on_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")


def test_cli_default_device_fails_without_card(tmp_path):
    # No card here: the default --device cuda exits non-zero with the
    # renderer's error, for a render and for the suite; nothing is
    # rendered on the CPU by itself.
    _skip_on_card()
    out = tmp_path / "f.png"
    r = _run(["-m", "compute_renderer_torch.cli", "--width", str(W),
              "--height", str(H), "--output", str(out)])
    assert r.returncode != 0 and "NVIDIA GPU" in r.stderr
    assert not out.exists()
    r = _run(["-m", "compute_renderer_torch", "benchmarks", "--max-frames",
              "1"])
    assert r.returncode != 0 and "torch.cuda.is_available()" in r.stderr


def test_cli_without_jax(tmp_path):
    # --help and a CPU render work where `import jax` fails, and the run
    # loads nothing of the JAX package.
    fake = tmp_path / "nojax"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text(
        "raise ImportError('jax is not installed here')\n")
    env = {"PYTHONPATH": f"{fake}{os.pathsep}{ROOT}"}
    r = _run(["-m", "compute_renderer_torch.cli", "--help"], env)
    assert r.returncode == 0 and "--device" in r.stdout
    out = tmp_path / "f.png"
    code = (
        "import sys\n"
        "from compute_renderer_torch import cli\n"
        f"rc = cli.main(['--device', 'cpu', '--width', '{W}', '--height',"
        f" '{H}', '--frames', '2', '--output', {str(out)!r}])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'compute_renderer_tpu')]\n"
        "assert rc == 0 and not bad, (rc, bad)\n"
    )
    r = _run(["-c", code], env)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "f_0000.png").exists()
    assert (tmp_path / "f_0001.png").exists()


def test_no_module_of_the_port_imports_jax():
    # Import every module of the package in a fresh process: neither jax
    # nor the JAX package may load.
    code = (
        "import pkgutil, importlib, sys\n"
        "import compute_renderer_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'compute_renderer_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'compute_renderer_tpu')]\n"
        "assert len(names) > 30 and not bad, (len(names), bad)\n"
        "print(len(names))\n"
    )
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    for dirpath, _, files in os.walk(os.path.join(ROOT,
                                                  "compute_renderer_torch")):
        for f in files:
            if f.endswith((".py", ".cpp", ".cu", ".cuh")):
                text = open(os.path.join(dirpath, f)).read()
                for needle in ("import jax", "from jax",
                               "compute_renderer_tpu"):
                    assert needle not in text, (f, needle)


# -- the collector and sampler ----------------------------------------------

def collector_with_times(times, n_tris=1000, n_pix=10000):
    from compute_renderer_torch.bench.collector import PerformanceCollector

    c = PerformanceCollector("test", 0, benchmark_duration_secs=None,
                             num_triangles=n_tris, num_pixels=n_pix)
    c.frame_times = list(times)
    return c


def test_avg_fps_is_reciprocal_mean():
    d = collector_with_times([0.01, 0.02, 0.03]).calculate_metrics()
    assert abs(d.avg_fps - 1.0 / 0.02) < 1e-6
    assert abs(d.ms_per_frame - 20.0) < 1e-6


def test_percentile_tails():
    # 100 frames: 99 at 10 ms, 1 at 100 ms.
    d = collector_with_times([0.01] * 99 + [0.1]).calculate_metrics()
    assert abs(d.min_fps - 1.0 / 0.028) < 1e-6
    assert abs(d.fps_5_percent_low - 1.0 / 0.028) < 1e-6
    assert abs(d.fps_1_percent_low - 10.0) < 1e-6
    assert abs(d.max_fps - 100.0) < 1e-6
    assert d.tail_source == "per-frame"


def test_throughput_metrics_and_json():
    d = collector_with_times([0.001], n_tris=1_000_000,
                             n_pix=786_432).calculate_metrics()
    assert abs(d.mtri_per_s - 1000.0) < 1e-6
    assert abs(d.mpix_per_s - 786.432) < 1e-6
    data = json.loads(d.to_json())
    assert data["frames"] == 1 and "ms_per_frame" in data
    assert collector_with_times([]).calculate_metrics().avg_fps == 0.0


def test_collector_fields_match_jax():
    from compute_renderer_tpu.bench.collector import PerformanceData as J
    from compute_renderer_torch.bench.collector import PerformanceData as P

    assert [(f.name, f.default) for f in dataclasses.fields(P)] == \
        [(f.name, f.default) for f in dataclasses.fields(J)]


def test_warmup_and_duration():
    from compute_renderer_torch.bench.collector import PerformanceCollector

    c = PerformanceCollector("w", 0, benchmark_duration_secs=0.05,
                             warmup_secs=10.0)
    c.update()
    assert not c.update() and c.frame_times == []
    c = PerformanceCollector("d", 0, benchmark_duration_secs=0.0,
                             warmup_secs=0.0)
    c.update()
    time.sleep(0.01)
    assert c.update() is True


def test_update_batch_records_frames():
    from compute_renderer_torch.bench.collector import PerformanceCollector

    c = PerformanceCollector("b", 0, benchmark_duration_secs=None,
                             warmup_secs=0.0)
    c.update_batch(4, 0.2)  # the first call primes the start
    time.sleep(0.01)
    c.update_batch(4, 0.2)
    assert len(c.frame_times) == 4 and abs(c.frame_times[0] - 0.05) < 1e-9
    d = c.calculate_metrics()
    assert abs(d.avg_fps - 20.0) < 1e-6 and d.tail_source == "per-batch(4)"


@pytest.mark.parametrize("native", [True, False])
def test_sysmon(monkeypatch, native):
    from compute_renderer_torch.bench import sysmon

    monkeypatch.setattr(sysmon, "_LIB", None)
    if native:
        monkeypatch.delenv("CRT_DISABLE_NATIVE", raising=False)
    else:
        monkeypatch.setenv("CRT_DISABLE_NATIVE", "1")
    assert (sysmon._load() is None) == (not native)
    assert sysmon.process_rss_bytes() > 10 * 2**20
    sysmon.global_cpu_percent()
    assert 0.0 <= sysmon.global_cpu_percent() <= 100.0


# -- the suite ----------------------------------------------------------------

def test_suite_configs_match_jax():
    # The 21 rows in the JAX package's order, field by field, the engine
    # named cuda where the JAX package says tpu.
    from compute_renderer_tpu.bench.suite import (
        benchmark_scene_configs as jax_configs,
    )
    from compute_renderer_torch.bench.suite import benchmark_scene_configs

    ours, theirs = benchmark_scene_configs(30.0), jax_configs(30.0)
    assert len(ours) == len(theirs) == 21
    mapped = {"tpu": "cuda"}
    for a, b in zip(ours, theirs):
        assert a.normalized_backend() == mapped.get(b.normalized_backend(),
                                                    b.normalized_backend())
        for f in dataclasses.fields(b):
            if f.name in ("backend_type", "camera_config", "effect"):
                continue
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert a.effect is None and b.effect is None
        ca, cb = a.camera_config, b.camera_config
        for f in dataclasses.fields(cb):
            va, vb = getattr(ca, f.name), getattr(cb, f.name)
            if f.name == "mode":
                va, vb = va.name, vb.name
            assert va == vb, f.name
        assert a.scene_name() == b.scene_name().replace("tpu Pipeline",
                                                        "cuda Pipeline")
    assert [s.normalized_backend() for s in ours[12:16]] == \
        ["wgpu-faithful"] * 4


@pytest.mark.parametrize("index,batch", [(4, 2), (5, 1), (14, 1)])
def test_run_scene_smoke(index, batch):
    from compute_renderer_torch.bench.suite import (
        benchmark_scene_configs, run_scene,
    )

    cfg = benchmark_scene_configs(0.0)[index]
    r = run_scene(cfg, W, H, scene_index=index, warmup_secs=0.0,
                  max_frames=3, batch=batch, device="cpu")
    assert r["frames"] >= 1 and r["ms_per_frame"] > 0
    assert r["backend"] == cfg.normalized_backend()
    assert r["overflow"] is False
    assert r["num_triangles"] == 1280 and (r["width"], r["height"]) == (W, H)
    assert r["tail_source"] == ("per-frame" if batch == 1
                                else f"per-batch({batch})")


def test_suite_batches_engine_rows_only(tmp_path):
    from compute_renderer_torch.bench.suite import run_suite

    out = tmp_path / "suite.json"
    rows = run_suite(width=W, height=H, offset=4, duration_secs=0.05,
                     max_frames=2, batch=4, limit=2, json_path=str(out),
                     device="cpu")
    assert [r["backend"] for r in rows] == ["cuda", "xla"]
    assert [r["batch"] for r in rows] == [4, 1]
    assert all(r["dispatch_overhead_ms"] > 0 for r in rows)
    assert json.loads(out.read_text()) == rows


def test_run_suite_needs_card_unless_cpu():
    from compute_renderer_torch.bench.suite import (
        measure_dispatch_overhead_ms, run_suite,
    )

    _skip_on_card()
    with pytest.raises(RuntimeError, match="is_available"):
        run_suite(width=W, height=H, max_frames=1)
    assert 0.0 < measure_dispatch_overhead_ms(samples=3, device="cpu") \
        < 10_000.0

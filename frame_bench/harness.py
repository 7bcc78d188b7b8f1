"""One run of one cell: set-up, the timed window, the traced window, and
the check against the reference.

Everything that belongs to a configuration, a traffic mix, a layer or a
metric is a file found by its name (``configs/<name>.json``,
``traffic/<name>.json``, ``layers/<name>.json``, ``metrics/<name>.py``,
``limits/<cell>.json``); this module holds what all cells share:

- the program's side: the configuration's geometry (``reference/
  geometry.py``) handed to ``compute_renderer_torch``'s ``Scene`` and
  ``Renderer``, or its OBJ part (``reference/objscene.py``) written to a
  temporary directory and loaded through the program's ``Model.load``
  with the materials or textures its ``shading`` names and its
  ``tex_filter``; the camera driven through the program's ``Camera``
  with the inputs of the mix's path (``reference/camera.py``);
- two loops, chosen by the mix's ``"loop"``: ``batch`` (frames submitted
  ``batch`` at a time through ``render_batch_device(check=False)``, one
  ``fence_pending()`` a batch, frames left on the device) and ``tick``
  (the viewers' tick, ``app/webview.py`` ``tick`` without the PNG: the
  camera, ``scene.update``, ``render_batch_device([u], check=False)``
  into ``app.window.FramePipe``, presented when ``fetch`` returns; every
  ``flush_interval`` ticks ``flush_overflow()``, and on overflow
  ``pipe.reset()`` and a checked ``render``);
- frames sampled at instants drawn from the seed, compared after the
  window with the reference's frames of the same poses.

Nothing compiles in the window: set-up renders one whole period of the
path through the checked path (capacities, calibration, the tile tuner,
every graph capture) and then runs the timed loop itself for a while.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from frame_bench import trace as trace_mod
from frame_bench.reference import camera as cam
from frame_bench.reference import geometry
from frame_bench.reference import objscene

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Modules that must not be loaded by the process that prints the result:
# JAX and the JAX package the port was made from (whole top-level names).
BANNED = ("jax", "jaxlib", "flax", "compute_renderer_tpu")
# The range that bounds the traced window; the loops' own ranges inside
# it label the device's idle gaps.
WINDOW_SPAN = "frame_bench.window"
# A configuration's "shading": the program's loader flags for each.
SHADINGS = {"base": {}, "materials": {"materials": True},
            "textures": {"textures": True}}


def load_json(kind, name):
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED))


def build_scene(config):
    """The configuration's geometry: the parts' arrays (positions,
    normals, uvs, indices), or for an OBJ part its ``objscene.ObjScene``,
    whose files lie in a new temporary directory until ``remove_files``."""
    parts = config["geometry"]
    shading = config.get("shading", "base")
    if shading not in SHADINGS:
        raise ValueError(f"shading {shading!r}: one of {list(SHADINGS)}")
    if not objscene.is_obj(parts):
        if shading != "base":
            raise ValueError(f"shading {shading!r} needs an OBJ part")
        return geometry.build(parts)
    directory = tempfile.mkdtemp(prefix="frame_bench_")
    try:
        return objscene.ObjScene(directory, parts[0])
    except BaseException:
        shutil.rmtree(directory, ignore_errors=True)
        raise


def reference_scene(config, arrays, device):
    """The reference's scene of ``build_scene``'s geometry, with the Kd
    and images that the configuration's ``shading`` uses."""
    from frame_bench.reference import render as ref

    if not isinstance(arrays, objscene.ObjScene):
        return ref.Scene(arrays[0], arrays[1], arrays[3], device=device)
    shading = config.get("shading", "base")
    extra = {}
    if shading != "base":
        extra["face_kd"] = arrays.face_kd
    if shading == "textures":
        extra.update(uvs=arrays.uvs, face_image=arrays.face_image,
                     images=arrays.images)
    return ref.Scene(arrays.positions, arrays.normals, arrays.tri,
                     device=device, **extra)


class Program:
    """The program under test, built from a configuration: its scene, its
    renderer, and the camera driven with the path's inputs."""

    def __init__(self, config, arrays, device):
        from compute_renderer_torch.core.camera import Camera
        from compute_renderer_torch.core.types import Mesh
        from compute_renderer_torch.engine.renderer import Renderer
        from compute_renderer_torch.engine.scene import Scene
        from compute_renderer_torch.io.model import Model

        self.Camera = Camera
        self.width, self.height = config["width"], config["height"]
        self.aspect = self.width / self.height
        self.spawn = config["camera"]["spawn"]
        self.scene = Scene()
        if isinstance(arrays, objscene.ObjScene):
            # The user's path: native parse, MTL, image decode, atlas.
            self.scene.add_model(Model.load(
                str(arrays.path), **SHADINGS[config.get("shading", "base")]))
            self.scene.texture_filter = config.get("tex_filter", "nearest")
        else:
            self.scene.add_model(Model(mesh=Mesh(*arrays),
                                       source=f"frame_bench:{config['name']}"))
        for light in config["lights"]:
            self.scene.add_light(light["position"], light["color"],
                                 light["intensity"])
        self.scene.add_camera(Camera.first_person(self.spawn, self.aspect))
        self.scene.set_active_camera(0)
        self.renderer = Renderer(self.scene.mesh, self.width, self.height,
                                 device=device,
                                 **self.scene.renderer_options())

    def set_camera(self, camera):
        self.scene.cameras[self.scene.active_camera] = camera

    def look(self, dx, dy, dt):
        """The uniforms of the spawn turned by the mouse offsets."""
        camera = self.Camera.first_person(self.spawn, self.aspect)
        camera.process_mouse(dx, dy)
        self.set_camera(camera)
        return self.scene.update(dt)

    def start_path(self, path):
        if isinstance(path, cam.Orbit):
            camera = self.Camera.orbit(path.distance, path.yaw0, 0.0,
                                       path.target, self.aspect)
            camera.orbit_speed = path.speed
            self.set_camera(camera)

    def drive(self, path, g, dt):
        """Tick ``g``'s camera update, as the viewers make it: the mouse
        events, ``update_over_time``, then the keys held."""
        reset, dx, keys = path.tick(g)
        if reset:
            self.set_camera(self.Camera.first_person(self.spawn,
                                                     self.aspect))
        camera = self.scene.get_active_camera()
        if dx is not None:
            camera.process_mouse(dx, 0.0)
        camera.update_over_time(dt)
        camera.process_keyboard(set(keys), dt)

    def close(self):
        self.renderer.close()
        self.renderer = None
        self.scene = None


class Sampler:
    """Which frames to keep: ``count`` instants drawn from the seed as
    fractions of the window, each with a seeded pick inside its batch."""

    def __init__(self, seed, count, batch):
        rng = np.random.default_rng([int(seed), 7])
        self.due = sorted(rng.uniform(0.0, 0.98, count).tolist())
        self.picks = rng.integers(batch, size=count).tolist()
        self.taken = 0

    def want(self, progress):
        """The picks inside this unit of the samples due by ``progress``
        (a fraction of the window)."""
        picks = []
        while self.taken < len(self.due) and progress >= self.due[self.taken]:
            picks.append(self.picks[self.taken])
            self.taken += 1
        return picks


def _noop_span(_name):
    return contextlib.nullcontext()


# -- the batch loop --------------------------------------------------------

class BatchLoop:
    """Frames rendered back to back, ``batch`` a submission."""

    def __init__(self, program, traffic, config, seed):
        self.p = program
        self.dt = float(traffic["dt"])
        self.batch = int(traffic["batch"])
        self.path = cam.LookAround(traffic["camera"], config["camera"],
                                   self.dt, seed)
        self.uniforms = [program.look(dx, dy, self.dt)
                         for dx, dy in self.path.offsets]
        self.j = 0

    def setup(self, samples):
        r = self.p.renderer
        P, B = self.path.period, self.batch
        # The sampled frames' slots, made before the window.
        self.keep = torch.empty((samples, self.p.height, self.p.width, 4),
                                dtype=torch.uint8, device=r.device)
        for b in range(-(-P // B)):
            r.render_batch_device([self.uniforms[(b * B + k) % P]
                                   for k in range(B)])
        r.fence_pending()
        for _ in range(4):
            self._submit()
            r.fence_pending()
            self.j += B
        r.flush_overflow()

    def _submit(self):
        return self.p.renderer.render_batch_device(
            [self.uniforms[self.path.pose_index(self.j + k)]
             for k in range(self.batch)], check=False)

    def run(self, stop, sampler, span=_noop_span):
        """Batches until ``stop(elapsed, frames)``; returns the window's
        record. Sampled frames stay on the device until the window ends."""
        r = self.p.renderer
        clock = time.perf_counter
        samples, flags, ends = [], [], []
        frames_done = 0
        t0 = clock()
        now = t0
        while True:
            with span("frame_bench.submit"):
                frames = self._submit()
                flags.append(r.take_overflow())
            self._keep(frames, sampler.want(stop.progress(now - t0,
                                                          frames_done)),
                       samples)
            with span("frame_bench.fence"):
                r.fence_pending()
            frames_done += self.batch
            now = clock()
            ends.append(now - t0)
            if stop(now - t0, frames_done):
                # Samples not yet due come from the last batch, after the
                # window's clock has stopped.
                self._keep(frames, sampler.want(1.0), samples)
                self.j += self.batch
                break
            self.j += self.batch
        r.flush_overflow()
        bad = torch.stack(flags).cpu().numpy().any(axis=1)
        return {"seconds": now - t0, "frames": frames_done,
                "failed": int(bad.sum()) * self.batch, "samples": samples,
                "ends": ends, "unit": self.batch}

    def _keep(self, frames, picks, samples):
        for pick in picks:
            slot = self.keep[len(samples)]
            slot.copy_(frames[pick])
            samples.append((self.path.pose_index(self.j + pick), slot))

    def reference_poses(self, ids):
        return {i: self.path.pose(i) for i in ids}


# -- the viewer tick -------------------------------------------------------

class TickLoop:
    """The viewers' tick: one frame presented a tick, one frame behind."""

    def __init__(self, program, traffic, config, seed):
        from compute_renderer_torch.app.window import FramePipe

        self.p = program
        self.dt = float(traffic["dt"])
        self.flush = int(traffic["flush_interval"])
        self.warm = int(traffic["warm_ticks"])
        self.path = cam.interactive_path(traffic["camera"], config["camera"],
                                         self.dt, seed)
        self.pipe = FramePipe(program.renderer.device)
        self.g = 0
        self.inflight = []  # ticks of the frames in the pipe, oldest first

    def setup(self, samples):
        p = self.p
        p.start_path(self.path)
        for _ in range(self.path.period):
            p.drive(self.path, self.g, self.dt)
            p.renderer.render(p.scene.update(self.dt))
            self.g += 1
        for _ in range(self.path.phase):
            p.drive(self.path, self.g, self.dt)
            self.g += 1
        self.ticks_since_flush = 0
        stop = Stop(units=self.warm)
        self.run(stop, Sampler(0, 0, 1))

    def run(self, stop, sampler, span=_noop_span):
        """Ticks until ``stop(elapsed, ticks)``; returns the window's record
        with the interval between consecutive presents and the host spans
        around ``fetch`` and around each flush tick."""
        p, r, pipe = self.p, self.p.renderer, self.pipe
        clock = time.perf_counter
        samples, presents, waits, flushes = [], [], [], []
        failed = ticks = 0
        t0 = clock()
        last = t0
        while True:
            with span("frame_bench.camera"):
                p.drive(self.path, self.g, self.dt)
                u = p.scene.update(self.dt)
            self.ticks_since_flush += 1
            frame = None
            if self.ticks_since_flush >= self.flush:
                self.ticks_since_flush = 0
                with span("frame_bench.flush"):
                    tf = clock()
                    if r.flush_overflow():
                        failed += self.flush
                        pipe.reset()
                        self.inflight = []
                        frame, shown = r.render(u), self.g
                    flushes.append(clock() - tf)
            if frame is None:
                with span("frame_bench.submit"):
                    pipe.push(r.render_batch_device([u], check=False))
                    self.inflight.append(self.g)
                with span("frame_bench.fetch"):
                    tw = clock()
                    frame = pipe.fetch()
                    waits.append(clock() - tw)
                shown = self.inflight[0]
                if len(self.inflight) > 1:
                    del self.inflight[0]
            now = clock()
            presents.append(now - last)
            last = now
            ticks += 1
            done = stop(now - t0, ticks)
            due = sampler.want(1.0 if done else stop.progress(now - t0, ticks))
            if due:
                kept = np.array(frame)
                samples += [(shown, kept)] * len(due)
            self.g += 1
            if done:
                break
        if r.flush_overflow():
            failed += self.ticks_since_flush
        return {"seconds": last - t0, "frames": ticks, "failed": failed,
                "samples": samples, "intervals": presents, "waits": waits,
                "flushes": flushes,
                "ends": np.cumsum(presents).tolist(), "unit": 1}

    def reference_poses(self, ids):
        return self.path.poses(ids)


LOOPS = {"batch": BatchLoop, "tick": TickLoop}


class Stop:
    """The end of a window: after ``seconds`` of host clock, or after
    ``units`` frames or ticks."""

    def __init__(self, seconds=None, units=None):
        self.seconds = seconds
        self.units = units

    def __call__(self, elapsed, units):
        if self.seconds is not None:
            return elapsed >= self.seconds
        return units >= self.units

    def progress(self, elapsed, units):
        if self.seconds is not None:
            return elapsed / self.seconds
        return units / self.units


# -- the traced window -----------------------------------------------------

def traced_window(loop, units):
    """The loop for ``units`` frames or ticks under ``torch.profiler``
    (host and device), its host steps in named ranges; returns the reduced
    trace (``trace.Trace``) and the window's record."""
    from torch.profiler import ProfilerActivity, profile, record_function

    # CUPTI stays set up between sessions: torch keeps it for CUDA graphs,
    # and the renderer replays graphs.
    os.environ["TEARDOWN_CUPTI"] = "0"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            record = loop.run(Stop(units=units), Sampler(0, 0, 1),
                              span=record_function)
            loop.p.renderer.fence_pending()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    return trace_mod.Trace(events, WINDOW_SPAN), record


# -- the run ---------------------------------------------------------------

class Context:
    """What a metric reader reads: the configuration, the timed window's
    record, set-up's seconds, and (traced runs) the reduced trace and the
    traced window's record."""

    def __init__(self, config, record, setup_s, trace=None, traced=None):
        self.config = config
        self.record = record
        self.setup_s = setup_s
        self.trace = trace
        self.traced = traced

    def layer(self, name):
        return load_json("layers", name)["kernels"]

    @staticmethod
    def peaks():
        return load_json(".", "peaks")


def read_metric(name, ctx):
    """The value of metric ``name`` (``metrics/<name>.py``'s ``read``), or
    None where it finds nothing to read."""
    import importlib.util

    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "frame_bench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def cell_metrics(bench, cell_name, kind):
    """The metrics of ``bench[kind]`` that this cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def compare(loop, record, arrays, expected, config, limits, device):
    """The check: each of the ``expected`` sampled frames against the
    reference's frame of its pose. Returns ({number: (value, limit)},
    correct)."""
    from frame_bench.reference import render as ref

    samples = record["samples"]
    poses = loop.reference_poses([i for i, _ in samples])
    W, H = config["width"], config["height"]
    scene = reference_scene(config, arrays, device)
    worst = 0
    for pose_id, frame in samples:
        vpos, vp = poses[pose_id].matrices(W / H)
        expect = ref.render(scene, vpos, vp, config["lights"], W, H,
                            cell=config["cell"],
                            tex_filter=config.get("tex_filter", "nearest"))
        got = torch.as_tensor(frame).to(expect.device)
        worst = max(worst, bad_pixels(got, expect))
    numbers = {"bad_px": (worst, limits["bad_px"]),
               "failed_frames": (record["failed"], 0),
               "unchecked_samples": (expected - len(samples), 0)}
    correct = all(value <= limit for value, limit in numbers.values())
    return numbers, correct


def bad_pixels(got, expect):
    """Pixels whose largest channel differs by more than 2 (of 255)."""
    diff = (got.to(torch.int16) - expect.to(torch.int16)).abs()
    return int((diff.amax(dim=-1) > 2).sum())


def run(cell_name, seed, seconds, trace, *, bench=None, config=None,
        traffic=None, limits=None, device="cuda", t_start=None, units=None):
    """One run of a cell. Returns (result dict, check numbers); the
    configuration, mix and limits are read by name unless given. With
    ``units`` the timed window ends after that many frames or ticks in
    place of ``seconds`` (the CPU tests, whose pace follows the load)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or load_bench()
    cell = next(c for c in bench["workloads"] if c["name"] == cell_name)
    config = config or load_json("configs", cell["config"])
    traffic = traffic or load_json("traffic", cell["traffic"])
    limits = limits or load_json("limits", cell_name)
    dev = torch.device(device)

    marks = [("start", time.perf_counter())]
    arrays = build_scene(config)
    marks.append(("geometry", time.perf_counter()))
    try:
        program = Program(config, arrays, dev)
    finally:
        if isinstance(arrays, objscene.ObjScene):
            arrays.remove_files()
    marks.append(("renderer", time.perf_counter()))
    loop = LOOPS[traffic["loop"]](program, traffic, config, seed)
    samples = int(traffic["samples"])
    loop.setup(samples)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("path", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    print("frame_bench: set-up seconds "
          + ", ".join(f"{name} {t - t_start:.3f}" for name, t in marks),
          file=sys.stderr)

    sampler = Sampler(seed, samples, int(traffic.get("batch", 1)))
    record = loop.run(Stop(seconds=seconds) if units is None
                      else Stop(units=units), sampler)
    traced = tr = None
    if trace:
        tr, traced = traced_window(loop, int(traffic["trace_units"]))
    found = banned_modules()
    if found:
        raise SystemExit(f"frame_bench: {found} loaded by the run")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    per_second = np.bincount(np.asarray(record["ends"], dtype=int),
                             minlength=1) * record["unit"]
    print(f"frame_bench: frames in each second of the window "
          f"{per_second.tolist()}", file=sys.stderr)
    print(f"frame_bench: tile {program.renderer.options.get('tile_h')}x"
          f"{program.renderer.options.get('tile_w')}, pair_cap "
          f"{program.renderer.options.get('pair_cap')}, tuner "
          f"{program.renderer.tile_timings}", file=sys.stderr)
    program.close()
    del program
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers, correct = compare(loop, record, arrays, samples, config,
                               limits, dev)
    ctx = Context(config, record, setup_s, tr, traced)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell_name, kind):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": record["frames"],
              "failed": record["failed"], "metrics": metrics}
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s()
        result["breakdown"] = tr.breakdown()
    return result, numbers

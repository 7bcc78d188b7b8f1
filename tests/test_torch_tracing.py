"""The port's spans and counters (``compute_renderer_torch/tracing.py``).

On the CPU: the host stages' spans under ``torch.profiler``; no
``record_function`` off a session; the binning's fold of each frame (or
triangle chunk) into a batch's accumulator, against the frames' own
reports, on every binning layout; the host counters at calibration,
retry and tuning. The ``cuda``-marked tests hold the kernels' fold to the
twins' and count captures, replays and the frames of a traced batch on
the card."""

import json

import numpy as np
import pytest

from tests.torch_parity import cuda_device, port  # noqa: F401 (fixtures)

W, H = 64, 48
DT = 1.0 / 60.0
PROGRAM_SPANS = ("renderer.pack", "renderer.upload", "renderer.replay",
                 "scene.update", "pipe.push", "pipe.fetch")


def _scene(port, model="suzanne.obj", width=W, height=H):
    cfg = port.scene.SceneConfig(
        model_path=model, camera_config=port.scene.CameraConfig(distance=3.0))
    return port.scene.Scene.from_config(cfg, width, height)


def _advance(scene, n):
    out = []
    for _ in range(n):
        scene.get_active_camera().update_over_time(0.2)
        out.append(scene.update(DT))
    return out


def _user_spans(prof, tmp_path):
    """The names of the trace's ``user_annotation`` events."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


# --------------------------------------------------------------------------
# Spans
# --------------------------------------------------------------------------

def test_program_spans_in_a_profile(port, tmp_path):
    # A CPU renderer's batch and a viewer tick through FramePipe, under a
    # profiler session: each host stage is one user range of the trace.
    from compute_renderer_torch.app.window import FramePipe

    s = _scene(port)
    r = port.renderer.Renderer(s.mesh, W, H, device="cpu",
                               **s.renderer_options())
    pipe = FramePipe("cpu")
    with _profile() as prof:
        r.render_batch_device(_advance(s, 3), check=False)
        pipe.push(r.render_batch_device([s.update(DT)], check=False))
        frame = pipe.fetch()
        assert not r.flush_overflow()
    names = _user_spans(prof, tmp_path)
    for name in PROGRAM_SPANS + ("renderer.flush",):
        assert name in names, (name, sorted(set(names)))
    # One replay span a batch, never one a frame.
    assert names.count("renderer.replay") == 2
    assert frame.shape == (H, W, 4)


def test_rare_stage_spans_in_a_profile(port, tmp_path):
    # Calibration (micro path) and a retry (a pinned pair capacity that
    # the frame outgrows) run in their own spans.
    s = _scene(port)
    u = s.update(DT)
    with _profile() as prof:
        port.renderer.Renderer(s.mesh, W, H, device="cpu", path="micro",
                               **s.renderer_options()).render(u)
        port.renderer.Renderer(s.mesh, W, H, device="cpu", path="micro",
                               pair_cap=16, **s.renderer_options()).render(u)
    names = _user_spans(prof, tmp_path)
    assert "renderer.calibrate" in names and "renderer.retry" in names


def test_span_off_a_session_is_the_shared_null_context(port, monkeypatch):
    # Off a profiler session a span is one flag check: the same null
    # context every time, and no record_function is made anywhere on the
    # render path (batch, checked frame, viewer pipe, flush).
    import contextlib

    import torch

    from compute_renderer_torch.app.window import FramePipe

    made = []

    def counted(name, *args, **kwargs):
        made.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    tr = port.tracing
    assert not tr.recording()
    assert tr.span("a") is tr.span("b")
    assert isinstance(tr.span("a"), contextlib.nullcontext)
    s = _scene(port)
    r = port.renderer.Renderer(s.mesh, W, H, device="cpu",
                               **s.renderer_options())
    pipe = FramePipe("cpu")
    r.render_batch_device(_advance(s, 2), check=False)
    r.render(s.update(DT))
    pipe.push(r.render_batch_device([s.update(DT)], check=False))
    pipe.fetch()
    r.flush_overflow()
    assert made == []


def test_span_under_a_session_is_a_record_function(port):
    import torch

    with _profile():
        assert port.tracing.recording()
        span = port.tracing.span("renderer.pack")
        assert isinstance(span, torch.profiler.record_function)
    assert not port.tracing.recording()


# --------------------------------------------------------------------------
# The fold of each frame's binning into the batch's accumulator
# --------------------------------------------------------------------------

def _expected(reports, samples=0):
    """The fold of per-frame (or per-chunk) bin dicts: needs maxed, pairs
    and occupied tiles summed; then the micro raster's ``samples``, no
    textured pixels (no frame here runs the mip texture tail), the flat
    layout's span list entries summed (none in the dense and micro
    layouts), and the longest bin list maxed."""
    need = np.max([r["overflow"].numpy() for r in reports], axis=0)
    pairs = sum(int(r["total_pairs"]) for r in reports)
    tiles = sum(int(r["k"]) for r in reports)
    most = max(int(r["most"]) for r in reports)
    spans = sum(int(r["spans"][0]) for r in reports if "spans" in r)
    return [int(need[0]), int(need[1]), pairs, tiles, samples, 0, spans,
            most]


def _metas(port, scene, n, tile, width=W, height=H):
    """The front's meta rows of ``n`` animated frames at ``tile``."""
    t = port.torch
    out = []
    for u in _advance(scene, n):
        tri = t.from_numpy(scene.mesh.indices.astype(np.int32))
        tri = tri.reshape(-1, 3)
        pos = t.from_numpy(np.asarray(scene.mesh.positions, np.float32))
        nrm = t.from_numpy(np.asarray(scene.mesh.normals, np.float32))
        _, meta = port.front.front_end(
            port.cuda.corner_soa(pos, tri), port.cuda.corner_soa(nrm, tri),
            t.from_numpy(np.asarray(u.view_proj, np.float32)),
            t.from_numpy(np.asarray(u.effect, np.float32)), width=width,
            height=height, tile_h=tile[0], tile_w=tile[1])
        out.append(meta)
    return out


def _acc(port, device="cpu"):
    return port.torch.zeros((port.binning.ACC_WORDS,),
                            dtype=port.torch.int64, device=device)


@pytest.mark.parametrize("layout", ["dense", "flat"])
@pytest.mark.parametrize("caps", ["roomy", "overflow"])
def test_tile_fold_matches_the_frames(port, monkeypatch, layout, caps):
    # Three frames' bin_tiles_meta into one accumulator: the needs are the
    # largest of the frames' overflow reports, the pairs and occupied
    # tiles their sums; under overflow the needs are nonzero.
    b = port.binning
    if layout == "flat":
        monkeypatch.setattr(b, "DENSE_BINNING_OP_LIMIT", 0)
    s = _scene(port)
    ntx, nty = (W + 15) // 16, (H + 15) // 16
    pc, tc = (100_000, 2048) if caps == "roomy" else (64, 8)
    acc = _acc(port)
    reports = [b.bin_tiles_meta(meta, ntx, nty, pc, tc, acc)
               for meta in _metas(port, s, 3, (16, 16))]
    assert {r["layout"] for r in reports} == {layout}
    want = _expected(reports)
    assert acc.tolist() == want
    assert want[2] > 0 and want[3] > 0
    assert (caps == "overflow") == (want[0] > 0 or want[1] > 0)


def test_micro_fold_matches_the_frames(port):
    b = port.binning
    s = _scene(port)
    ntx, nty = (W + 127) // 128, (H + 7) // 8
    acc = _acc(port)
    reports = []
    for meta in _metas(port, s, 3, (8, 8)):
        reports.append(b.bin_cells_sort_meta(meta[3], meta[2], meta[0],
                                             meta[1], ntx, nty, 4096, acc))
    assert acc.tolist() == _expected(reports)
    assert reports[0]["layout"] == "micro" and acc[2] > 0


def _record_micro(port, monkeypatch):
    """The argument lists of every ``micro.raster_shade_micro`` call from
    now on."""
    fn, calls = port.micro.raster_shade_micro, []

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    monkeypatch.setattr(port.micro, "raster_shade_micro", recorded)
    return calls


def _culled_samples(port, calls):
    """The samples the micro kernel's culled walk tests in these calls,
    from the walk's own decomposition
    (``micro.raster_shade_micro_culled_plain``)."""
    total = 0
    for args, kw in calls:
        table, pair_tri, starts, counts, _, eff, vpos, lwp, lc, li = args
        params, lights = port.raster.shading_inputs(
            eff, vpos, lwp, lc, li, kw.get("y_offset", 0))
        stats = {}
        port.micro.raster_shade_micro_culled_plain(
            table, pair_tri, starts, counts, params, lights,
            height_padded=kw["height_padded"],
            width_padded=kw["width_padded"], mode=kw["mode"], stats=stats)
        total += stats["samples"]
    return total


@pytest.mark.parametrize("path,tri_chunk", [("tile", 300), ("micro", 0)])
def test_frame_fold_matches_its_binning(port, monkeypatch, path, tri_chunk):
    # cuda.render_frame folds every chunk of a chunked tile frame (and the
    # micro frame's one binning): max of the needs, sum of the pairs and
    # occupied tiles; its own overflow report is the needs' maximum. The
    # micro raster adds the samples its culled walk tests; the tile
    # raster adds none.
    b = port.binning
    name = "bin_tiles_meta" if path == "tile" else "bin_cells_sort_meta"
    fn, reports = getattr(b, name), []

    def recorded(*args, **kwargs):
        reports.append(fn(*args, **kwargs))
        return reports[-1]

    monkeypatch.setattr(b, name, recorded)
    calls = _record_micro(port, monkeypatch)
    s = _scene(port)
    r = port.renderer.Renderer(s.mesh, W, H, device="cpu", path=path,
                               **s.renderer_options())
    t = port.torch
    u = s.update(DT)
    packed, L = r.pack_uniforms(u)
    vpos, vp, eff, lwp, lc, li = port.renderer.unpack_uniforms(
        t.from_numpy(packed), L)
    acc = _acc(port)
    _, _, overflow = port.cuda.render_frame(
        r.positions, r.normals, r.tri, vp, vpos, lwp, lc, li, eff, width=W,
        height=H, path=path, tri_chunk=tri_chunk, pair_cap=4096, acc=acc)
    assert len(reports) == (-(-r.num_triangles // tri_chunk)
                            if tri_chunk else 1)
    assert len(calls) == (path == "micro")
    assert acc.tolist() == _expected(reports, _culled_samples(port, calls))
    assert (acc[4] > 0) == (path == "micro")
    assert overflow.tolist() == acc[:2].tolist()


def test_batch_frame_counts_while_recording(port, monkeypatch):
    # A traced batch adds its frames, pairs and occupied tiles to
    # frame_counts(); an untraced one adds nothing.
    tr = port.tracing
    b = port.binning
    s = _scene(port)
    r = port.renderer.Renderer(s.mesh, W, H, device="cpu",
                               **s.renderer_options())
    batch = _advance(s, 3)
    tr.reset()
    r.render_batch_device(batch, check=False)
    assert tr.frame_counts() == {"frames": 0, "pairs": 0, "tiles": 0}
    fn, reports = b.bin_tiles_meta, []

    def recorded(*args, **kwargs):
        reports.append(fn(*args, **kwargs))
        return reports[-1]

    monkeypatch.setattr(b, "bin_tiles_meta", recorded)
    with _profile():
        r.render_batch_device(batch, check=False)
        r.render_batch_device(batch[:1], check=False)
    _, _, pairs, tiles, _, _, spans, _ = _expected(reports)
    assert tr.frame_counts() == {"frames": 4, "pairs": pairs, "tiles": tiles,
                                 "samples": 0, "textured": 0,
                                 "spans": spans}
    assert not r.flush_overflow()
    tr.reset()
    assert tr.frame_counts()["frames"] == 0
    assert "samples" not in tr.frame_counts()


def test_batch_spans_while_recording(port, monkeypatch):
    # A traced tile batch on the flat layout adds its span blocks (the
    # span list's entries, here at a span of 4 so that the 64x48 frame's
    # lists split) to frame_counts()["spans"]; a traced micro batch adds
    # no "spans" key.
    tr = port.tracing
    b = port.binning
    monkeypatch.setattr(b, "DENSE_BINNING_OP_LIMIT", 0)
    monkeypatch.setattr(b, "TILE_SPAN", 4)
    s = _scene(port)
    r = port.renderer.Renderer(s.mesh, W, H, device="cpu", path="tile",
                               **s.renderer_options())
    batch = _advance(s, 3)
    r.render_batch_device(batch)  # the capacities settle
    fn, reports = b.bin_tiles_meta, []

    def recorded(*args, **kwargs):
        reports.append(fn(*args, **kwargs))
        return reports[-1]

    monkeypatch.setattr(b, "bin_tiles_meta", recorded)
    tr.reset()
    with _profile():
        r.render_batch_device(batch, check=False)
    assert {x["layout"] for x in reports} == {"flat"}
    spans = _expected(reports)[6]
    assert tr.frame_counts()["spans"] == spans > 0
    tr.reset()
    assert "spans" not in tr.frame_counts()
    m = port.renderer.Renderer(s.mesh, W, H, device="cpu", path="micro",
                               **s.renderer_options())
    m.render_batch_device(batch)
    with _profile():
        m.render_batch_device(batch, check=False)
    assert tr.frame_counts()["frames"] == 3
    assert "spans" not in tr.frame_counts()


def test_micro_batch_samples_engage_the_cull(port, monkeypatch):
    # A traced micro batch of sub-pixel triangles (the 1,280-triangle
    # stand-in at 64x48): frame_counts() gains the samples the culled walk
    # tested, at most a quarter of the 64 a pair of the walk without it.
    tr = port.tracing
    s = _scene(port)
    r = port.renderer.Renderer(s.mesh, W, H, device="cpu", path="micro",
                               **s.renderer_options())
    batch = _advance(s, 3)
    r.render_batch_device(batch)  # the pair capacity settles
    calls = _record_micro(port, monkeypatch)
    tr.reset()
    with _profile():
        r.render_batch_device(batch, check=False)
    counts = tr.frame_counts()
    assert counts["frames"] == 3 and len(calls) == 3
    assert counts["samples"] == _culled_samples(port, calls)
    assert 0 < counts["samples"] <= 64 * counts["pairs"] // 4


def test_add_frames_takes_counts_with_or_without_samples(port):
    # The renderer adds (pairs, tiles, samples); a caller with pairs and
    # tiles alone adds no samples, and frame_counts() then has none.
    t = port.torch
    tr = port.tracing
    tr.reset()
    tr.add_frames(t.tensor([600, 10], dtype=t.int64), 2)
    assert tr.frame_counts() == {"frames": 2, "pairs": 600, "tiles": 10}
    tr.add_frames(t.tensor([400, 20, 3000], dtype=t.int64), 2)
    assert tr.frame_counts() == {"frames": 4, "pairs": 1000, "tiles": 30,
                                 "samples": 3000}
    tr.reset()
    assert tr.frame_counts() == {"frames": 0, "pairs": 0, "tiles": 0}


def test_add_frames_folds_peaks_by_max(port):
    # The longest list folds by max across batches; counts and keys of
    # frame_counts() are as without it; reset() clears it.
    t = port.torch
    tr = port.tracing
    tr.reset()
    tr.add_frames(t.tensor([600, 10], dtype=t.int64), 2)
    assert tr.frame_peaks() == {}
    tr.add_frames(t.tensor([400, 20, 3000], dtype=t.int64), 2,
                  peaks=t.tensor([41], dtype=t.int64))
    tr.add_frames(t.tensor([100, 5, 7], dtype=t.int64), 1,
                  peaks=t.tensor([17], dtype=t.int64))
    assert tr.frame_peaks() == {"list": 41}
    assert tr.frame_counts() == {"frames": 5, "pairs": 1100, "tiles": 35,
                                 "samples": 3007}
    tr.reset()
    assert tr.frame_peaks() == {}
    tr.add_frames(t.tensor([1, 1], dtype=t.int64), 1,
                  peaks=t.tensor([3], dtype=t.int64))
    assert tr.frame_peaks() == {"list": 3}
    tr.reset()


@pytest.mark.parametrize("layout", ["dense", "flat"])
def test_batch_frame_peaks_while_recording(port, monkeypatch, layout):
    # A traced tile batch folds the longest tile list of its frames into
    # frame_peaks(): the largest count of any frame's bins, before the
    # tile cap; an untraced batch folds nothing.
    tr = port.tracing
    b = port.binning
    if layout == "flat":
        monkeypatch.setattr(b, "DENSE_BINNING_OP_LIMIT", 0)
    s = _scene(port)
    r = port.renderer.Renderer(s.mesh, W, H, device="cpu", path="tile",
                               **s.renderer_options())
    batch = _advance(s, 3)
    tr.reset()
    r.render_batch_device(batch, check=False)
    assert tr.frame_peaks() == {}
    fn, reports, grids = b.bin_tiles_meta, [], []

    def recorded(meta, ntx, nty, *args, **kwargs):
        grids.append((meta.clone(), ntx, nty))
        reports.append(fn(meta, ntx, nty, *args, **kwargs))
        return reports[-1]

    monkeypatch.setattr(b, "bin_tiles_meta", recorded)
    with _profile():
        r.render_batch_device(batch, check=False)
    assert {rep["layout"] for rep in reports} == {layout}
    # Each frame's tiles counted from its rects (the corner scatter).
    longest = max(int(b.exact_tile_counts(b.setup_from_meta(m), ntx,
                                          nty).max())
                  for m, ntx, nty in grids)
    assert tr.frame_peaks() == {"list": longest} and longest > 0
    assert longest == _expected(reports)[7]
    assert not r.flush_overflow()
    tr.reset()


# --------------------------------------------------------------------------
# Host counters
# --------------------------------------------------------------------------

class _Event:
    """A stand-in for a CUDA event: pending until waited on."""

    def __init__(self, done):
        self.done = done
        self.waited = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True


def test_stage_counters_tick_on_growth_and_wait(port):
    # The staging buffers: two, used in turn; stage.grows ticks where a
    # buffer is made or outgrown (to the next power of two rows),
    # stage.waits where a refill finds its last batch's event pending.
    tr = port.tracing
    tr.reset()
    assert tr.count("stage.grows") == tr.count("stage.waits") == 0
    stage = port.renderer.Staging(pin=False)
    grows = []
    rows = []
    for K, P in ((64, 40), (3, 40), (1, 40), (64, 40), (2, 47), (64, 33)):
        rows.append(stage.take(K, P))
        assert rows[-1].shape == (K, P)
        grows.append(tr.count("stage.grows"))
    assert grows == [1, 2, 2, 3, 4, 4]
    # Unchanged buffers hand out their own rows again.
    assert rows[2].data_ptr() == rows[0].data_ptr()
    assert rows[5].data_ptr() == rows[3].data_ptr()
    # A refill waits only on a pending event of its own buffer.
    pending, done = _Event(False), _Event(True)
    stage.take(4, 40)
    stage.staged(pending)
    stage.take(4, 40)
    stage.staged(done)
    assert tr.count("stage.waits") == 0
    stage.take(4, 40)
    assert pending.waited == 1 and tr.count("stage.waits") == 1
    stage.take(4, 40)
    assert done.waited == 0 and tr.count("stage.waits") == 1
    assert tr.count("stage.grows") == 4


def test_cpu_batches_stage_nothing(port):
    # The CPU (and eager) batches pack a whole stack: no staging buffer.
    tr = port.tracing
    s = _scene(port)
    r = port.renderer.Renderer(s.mesh, W, H, device="cpu",
                               **s.renderer_options())
    tr.reset()
    r.render_batch_device(_advance(s, 2), check=False)
    r.render_batch_device(_advance(s, 1))
    assert tr.count("stage.grows") == tr.count("stage.waits") == 0
    assert not r.flush_overflow()


def test_counters_tick_on_calibrate_retry_and_tune(port):
    tr = port.tracing
    s = _scene(port)
    u = s.update(DT)
    tr.reset()
    assert set(tr.EVENTS) <= set(tr.counters())
    # Calibration: the micro path settles its pair capacity once.
    r = port.renderer.Renderer(s.mesh, W, H, device="cpu", path="micro",
                               **s.renderer_options())
    r.render(u)
    r.render(u)
    assert tr.count("calibrations") == 1 and tr.count("retries") == 0
    # A retry: a pinned pair capacity the frame outgrows grows once.
    r = port.renderer.Renderer(s.mesh, W, H, device="cpu", path="micro",
                               pair_cap=16, **s.renderer_options())
    r.render(u)
    assert tr.count("retries") == 1 and tr.count("calibrations") == 1
    # The tile tuner (on the card it runs by itself; here it is called).
    r = port.renderer.Renderer(s.mesh, W, H, device="cpu",
                               **s.renderer_options())
    r._tune_tile([u])
    assert tr.count("tunes") == 1
    assert set(r.tile_timings) == set(port.cuda.TILE_CANDIDATES)
    # The CPU replays no graph and launches no kernel.
    assert tr.count("replays") == tr.count("captures") == 0
    assert not any(k.startswith("launches.") for k in tr.counters())
    counts = tr.counters()
    counts["tunes"] = 99  # a copy
    assert tr.count("tunes") == 1
    tr.reset()
    assert tr.counters() == dict.fromkeys(tr.EVENTS, 0)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "flat"])
@pytest.mark.parametrize("caps", ["roomy", "overflow"])
def test_card_tile_fold_matches_twins(port, cuda_device, monkeypatch, layout,
                                      caps):
    # The kernels' fold (bin_scan_kernel; the flat layout's
    # bin_sort_scan_kernel) equals the twins' on the same metas.
    b = port.binning
    if layout == "flat":
        monkeypatch.setattr(b, "DENSE_BINNING_OP_LIMIT", 0)
    s = _scene(port, width=256, height=192)
    ntx, nty = 1, 12
    pc, tc = (100_000, 2048) if caps == "roomy" else (64, 8)
    metas = _metas(port, s, 4, (16, 256), 256, 192)
    got, want = _acc(port, cuda_device), _acc(port)
    launches = port.tracing.count("launches.bin_tiles_meta")
    for meta in metas:
        b.bin_tiles_meta(meta.to(cuda_device), ntx, nty, pc, tc, got)
        b.bin_tiles_meta(meta, ntx, nty, pc, tc, want)
    assert got.cpu().tolist() == want.tolist()
    dense = port.tracing.count("launches.bin_tiles_meta") - launches
    assert dense == (len(metas) if layout == "dense" else 0)


@pytest.mark.cuda
def test_card_micro_fold_matches_twins(port, cuda_device):
    b = port.binning
    s = _scene(port, width=256, height=192)
    got, want = _acc(port, cuda_device), _acc(port)
    for meta in _metas(port, s, 4, (8, 8), 256, 192):
        rows = (meta[3], meta[2], meta[0], meta[1])
        b.bin_cells_sort_meta(*(m.to(cuda_device) for m in rows), 2, 24,
                              8192, got)
        b.bin_cells_sort_meta(*rows, 2, 24, 8192, want)
    assert got.cpu().tolist() == want.tolist() and want[2] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["tile", "micro"])
def test_card_graph_batch_counts(port, cuda_device, path):
    # A replayed batch: one capture, K replays, and (traced) the same
    # frames, pairs and occupied tiles as the CPU twins' batch.
    tr = port.tracing
    s = _scene(port, width=256, height=192)
    batch = _advance(s, 4)
    counts = {}
    for device in ("cpu", cuda_device):
        r = port.renderer.Renderer(s.mesh, 256, 192, device=device,
                                   path=path, tile_autotune=False,
                                   **s.renderer_options())
        r.render_batch_device(batch)  # capacities settle; the capture
        tr.reset()
        r.render_batch_device(batch, check=False)
        assert tr.count("captures") == 0
        assert tr.count("replays") == (4 if device != "cpu" else 0)
        with _profile():
            r.render_batch_device(batch, check=False)
        counts[str(device)] = tr.frame_counts()
        assert not r.flush_overflow()
        r.close()
    assert counts["cpu"] == counts[str(cuda_device)]
    assert counts["cpu"]["frames"] == 4 and counts["cpu"]["pairs"] > 0


@pytest.mark.cuda
def test_card_capture_and_drop_counters(port, cuda_device):
    tr = port.tracing
    s = _scene(port, width=256, height=192)
    r = port.renderer.Renderer(s.mesh, 256, 192, device=cuda_device,
                               tile_autotune=False, **s.renderer_options())
    tr.reset()
    r.render(s.update(DT))
    assert tr.count("captures") == 1 and tr.count("replays") == 1
    r.close()
    assert tr.count("graph_drops") == 1


@pytest.mark.cuda
def test_card_staged_batch_spans(port, cuda_device, tmp_path):
    # On the card a batch packs and uploads each frame inside its one
    # replay span; the spans keep the names the benchmark reads.
    s = _scene(port, width=256, height=192)
    r = port.renderer.Renderer(s.mesh, 256, 192, device=cuda_device,
                               tile_autotune=False, **s.renderer_options())
    batch = _advance(s, 4)
    r.render_batch_device(batch)  # capacities settle; the capture
    with _profile() as prof:
        r.render_batch_device(batch, check=False)
        r.fence_pending()
    names = _user_spans(prof, tmp_path)
    assert names.count("renderer.replay") == 1
    assert names.count("renderer.pack") == 4
    assert names.count("renderer.upload") == 4
    assert not r.flush_overflow()
    r.close()

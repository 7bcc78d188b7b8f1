"""A run whose timed path is broken underneath comes out not correct, and
so does one with the control in the program's place.
The harness's look for a card is skipped (the program runs its CPU
twins); everything else is a whole run at a small size. Each fault a cell
can have: a step that returns its state unchanged (the batch: the same
frames again; the viewer: the pipe presents a frame it presented
before), half of a batch left out (the batch loop; the viewer's batch
is one frame), and an answer altered where it is produced. The cells run
on one card, so no exchange between cards can be left out.

The control is the reference computed in bfloat16, the precision below
the configurations' float32, rendering the program's own uniforms in
place of its frames; it runs at the cells' full 1024x768 frame, where
its readings lie far above the limits (its readings at the cells' full
geometry on the card: PERF.md)."""

import pytest
import torch

from frame_bench.reference import render as ref

from compute_renderer_torch.app.window import FramePipe
from compute_renderer_torch.engine.renderer import Renderer
from frame_bench import harness
from frame_bench.tests import fb_small


def stale_batches(monkeypatch):
    orig = Renderer.render_batch_device
    first = {}

    def broken(self, seq, *args, **kwargs):
        out = orig(self, seq, *args, **kwargs)
        first.setdefault(len(seq), out.clone())
        return first[len(seq)].clone()

    monkeypatch.setattr(Renderer, "render_batch_device", broken)


def half_batches(monkeypatch):
    orig = Renderer.render_batch_device

    def broken(self, seq, *args, **kwargs):
        out = orig(self, seq, *args, **kwargs)
        out[len(seq) // 2:] = 0
        return out

    monkeypatch.setattr(Renderer, "render_batch_device", broken)


def altered_frames(monkeypatch):
    orig = Renderer.render_batch_device

    def broken(self, seq, *args, **kwargs):
        out = orig(self, seq, *args, **kwargs)
        out[:, :32, :32, 0] += 3
        return out

    monkeypatch.setattr(Renderer, "render_batch_device", broken)


def stale_present(monkeypatch):
    orig = FramePipe.fetch
    last = {}

    def broken(self):
        frame = orig(self).copy()
        shown = last.get("frame", frame)
        last["frame"] = frame
        return shown

    monkeypatch.setattr(FramePipe, "fetch", broken)


def control_in_place(monkeypatch):
    orig = Renderer.render_batch_device

    def control(self, seq, *args, **kwargs):
        out = orig(self, seq, *args, **kwargs)
        scene = ref.Scene(self.mesh.positions, self.mesh.normals,
                          self.mesh.indices, "cpu")
        u = seq[0]
        lights = [{"position": p.tolist(), "color": c.tolist(),
                   "intensity": float(i)} for p, c, i in
                  zip(u.light_world_pos, u.light_color, u.light_intensity)]
        for k, u in enumerate(seq):
            out[k] = ref.render(scene, u.view_position, u.view_proj, lights,
                                self.width, self.height,
                                dtype=torch.bfloat16)
        return out

    monkeypatch.setattr(Renderer, "render_batch_device", control)


def run_small(cell):
    """A small run of the cell. The viewer's window is one loop of the
    small walk, counted in ticks, with 12 samples: a window of seconds
    holds 1-4 ticks on a loaded CPU, too few to show a stale present
    whose frame lags the pose by one tick of a straight walk, and a
    loop's turns show it whatever the load."""
    config_name, traffic_name = cell.split(".")
    traffic = fb_small.traffic(traffic_name)
    limits = harness.load_json("limits", cell)
    units = None
    if traffic["loop"] == "tick":
        traffic["samples"] = 12
        units = sum(seg["ticks"]
                    for seg in traffic["camera"]["walk"]["segments"])
    return harness.run(cell, 2_500_000_003, 0.5, 0,
                       bench=fb_small.bench(cell),
                       config=fb_small.config(config_name), traffic=traffic,
                       limits=limits, device="cpu", units=units)


@pytest.mark.parametrize("cell,fault", [
    ("san_miguel.batch", stale_batches),
    ("san_miguel.batch", half_batches),
    ("san_miguel.batch", altered_frames),
    ("suzanne.batch", altered_frames),
    ("san_miguel.viewer", stale_present),
    ("san_miguel.viewer", altered_frames),
])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    result, numbers = run_small(cell)
    assert result["correct"] is False, numbers
    assert numbers["bad_px"][0] > numbers["bad_px"][1]


@pytest.mark.parametrize("cell", ["san_miguel.batch", "suzanne.batch",
                                  "san_miguel.viewer"])
def test_sound_run_is_correct(cell):
    result, numbers = run_small(cell)
    assert result["correct"] is True, numbers


def short_mix(mix):
    mix["samples"] = 2
    if mix["loop"] == "batch":
        mix.update(batch=2)
        mix["camera"]["period_s"] = 0.1
    else:
        mix["warm_ticks"] = 2


@pytest.mark.parametrize("cell", ["san_miguel.batch", "suzanne.batch",
                                  "san_miguel.viewer"])
def test_control_is_not_correct(monkeypatch, cell):
    control_in_place(monkeypatch)
    result, numbers = fb_small.run(
        cell, seconds=0.1, full_frame=True, traffic_changes=short_mix,
        bad_px=harness.load_json("limits", cell)["bad_px"])
    assert result["correct"] is False, numbers
    assert numbers["bad_px"][0] > numbers["bad_px"][1]

"""Renderer: geometry upload + the per-frame render step, in torch.

Counterpart of the JAX package's ``engine/renderer.py`` (the reference's
CustomRenderer orchestration, src/custom_pipeline/renderer.rs:105-157),
tile and micro paths, with the material and texture extensions in every
mode: fused nearest / bilinear, fused trilinear / anisotropic over a mip
pool, and deferred (``tex_mode="deferred"``, and any atlas of 2^24
texels or more). Geometry is uploaded once — corner-SoA, and a mesh's
kd, texture slots, atlas (the mip pool and its level table, built on the
host, under a mip filter), uvs, uv corners and TextureInfo rows
included, by ``cuda.mesh_ext_tensors``, which makes the JAX engine's
texture decisions (engine/renderer.py:122-191); a frame is one packed
uniform buffer in, ``cuda.render_frame`` on the renderer's device, and the
frame's overflow report out.

The compiled step. The JAX engine jits a frame (``_get_step``) and a
K-frame ``lax.scan`` (``_get_batch_step``). Here, on a CUDA device, a
frame is captured once into a ``torch.cuda.CUDAGraph`` per key (the
uniforms' light count, the frame size, the path, the mode and the
options: tile shape and capacities) and replayed for every frame after:
one graph launch in place of the frame's 65-780 eager launches. The
graph reads the uniforms from a static input buffer and leaves the frame
in static outputs, which the renderer copies out, so no returned frame
aliases them. A batch costs the host three calls a frame (the frame's
uniforms copied up into the input buffer, the replay, the frame into the
output stack), and packs each frame's uniforms into a row of a pinned
staging buffer (``Staging``) just before its copy, so the card starts on
the first frame while the host packs the rest. The overflow maximum is
taken inside the graph, as the scan's loop carry takes it: the binning's
last kernel folds each frame's needs, pairs and occupied tiles into the
graph's static accumulator (``cuda.render_frame``'s ``acc``) with the
frame's longest bin list, the micro raster the coverage samples it tested,
and the mip texture tail the pixels it shaded from an image. On the CPU
frames run eagerly through the kernels' twins, which fold alike. A capture
that fails raises: there is no eager fall-back on the card (``eager=True``
asks for the eager loop).

Tracing (``tracing``): the host stages run in spans (``renderer.pack``,
``renderer.upload``, ``renderer.replay``, ``renderer.capture``,
``renderer.calibrate``, ``renderer.tune``, ``renderer.retry``,
``renderer.flush``), which cost one flag check off a profiler session;
captures, graph drops, retries, calibrations, tunings, replays and the
staging buffer's growths and waits tick ``tracing.counters()``, and the
kernels' launch counters there count the wrappers' calls (the eager
warm-up and the capture of a graph tick them, its replays do not). On
the card a batch packs and uploads in one ``renderer.pack`` and one
``renderer.upload`` span a frame, inside its ``renderer.replay``; on the
CPU, eagerly and for a comparator, the batch's stack is packed and
uploaded before it. While a profiler session records, each batch adds
its frames, pairs, occupied tiles and samples to
``tracing.frame_counts()``, and in the texf_mip mode its textured pixels,
and folds its longest bin list into ``tracing.frame_peaks()``.

On the micro path the pair capacity settles to the first checked frame's
measured need (``_maybe_calibrate``), and a tile path whose per-tile list
outgrows ``cuda.MAX_TILE_CAP`` falls back to the micro path
(``_switch_to_micro``), as in the JAX engine. On the card the tile path's
tile shape is timed per scene and size over ``cuda.TILE_CANDIDATES``
(``_maybe_tune_tile``). Each of these, and ``resize``, drops the cached
graphs.

The comparator backends (``backends/xla.py``, ``backends/wgpu_faithful.py``)
render through the same methods, eagerly and frame by frame on the
renderer's device (no graph, no capacities, no overflow: the report is
always zero), as the JAX engine runs them (engine/renderer.py:336-337,
586-597). Materials and textures apply to the engine and ``xla`` (the mip
pool built on the host under a mip filter); ``wgpu-faithful`` models the
reference's material-less pipeline and ignores them. ``effect_kind`` and
the tile tuning are the engine's alone.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from compute_renderer_torch import tracing
from compute_renderer_torch.backends import (
    binning, cuda, front, get_backend, normalize_backend,
)
from compute_renderer_torch.core.effects import EFFECT_MIRAGE, EFFECT_VOXELIZE
from compute_renderer_torch.engine.scene import FrameUniforms

_TILE_OPTIONS = ("tile_h", "tile_w", "pair_cap", "tile_cap", "tri_chunk",
                 "path")
# The options each backend's render_frame takes from the renderer.
_BACKEND_OPTIONS = {"cuda": _TILE_OPTIONS,
                    "xla": ("tile_h", "tile_w", "chunk"),
                    "wgpu-faithful": ("chunk", "depth_format")}


def packed_size(L: int) -> int:
    """The floats of one frame's packed uniforms at ``L`` lights."""
    return 26 + 7 * L


def pack_into(row, uniforms: FrameUniforms) -> None:
    """Write ``uniforms`` into ``row``, a float32 array of
    ``packed_size(L)`` floats (a row of the caller's buffer), field by
    field: float64 fields round to float32 as ``astype`` rounds them.
    ``unpack_uniforms`` is its inverse."""
    L = uniforms.light_world_pos.shape[0]
    o = 26
    row[0:4] = np.ravel(uniforms.view_position)
    row[4:20] = np.ravel(uniforms.view_proj)
    row[20:26] = np.ravel(uniforms.effect)
    row[o:o + 3 * L] = np.ravel(uniforms.light_world_pos)
    row[o + 3 * L:o + 6 * L] = np.ravel(uniforms.light_color)
    row[o + 6 * L:o + 7 * L] = np.ravel(uniforms.light_intensity)


def unpack_uniforms(packed, L: int):
    """Inverse of ``pack_into``: split the per-frame f32 buffer into
    (view_position, view_proj, effect, light_pos, light_color,
    light_intensity)."""
    vpos = packed[0:4]
    vp = packed[4:20].reshape(4, 4)
    eff = packed[20:26]
    o = 26
    lwp = packed[o:o + 3 * L].reshape(L, 3)
    lc = packed[o + 3 * L:o + 6 * L].reshape(L, 3)
    li = packed[o + 6 * L:o + 7 * L]
    return vpos, vp, eff, lwp, lc, li


def box_downsample(rgba, s: int):
    """SSAA resolve: average s x s pixel blocks of an (H*s, W*s, 4) u8
    frame down to (H, W, 4); f32 mean + round-half-up."""
    if s == 1:
        return rgba
    H = rgba.shape[0] // s
    W = rgba.shape[1] // s
    x = rgba.to(torch.float32).reshape(H, s, W, s, 4).mean(dim=(1, 3))
    return torch.floor(x + 0.5).to(torch.uint8)


@dataclass
class FrameGraph:
    """One captured frame: replaying ``graph`` renders the uniforms in
    ``packed`` into ``rgba`` (H, W, 4) u8, ``key`` (rh, rw) u32 and
    ``overflow`` (2,) i32, and its binning folds the frame into ``acc``
    (7,) i64: the batch's running maximum of the needs, then its sums of
    pairs, occupied tiles, (the micro raster's) samples and (the mip
    texture tail's) textured pixels, then its longest bin list. All five
    tensors are static: the graph reads and writes them in place at every
    replay."""

    graph: torch.cuda.CUDAGraph
    packed: torch.Tensor
    rgba: torch.Tensor
    key: torch.Tensor
    overflow: torch.Tensor
    acc: torch.Tensor


class Staging:
    """The card's batches' uniform rows: two float32 (cap, P) host
    buffers, pinned where ``pin``, used in turn. ``take`` hands out the
    next buffer's first K rows of P floats, once the event its last batch
    left with ``staged`` has fired (a refill that has to wait ticks
    ``stage.waits``); a buffer grows, to the next power of two rows at or
    above K (``stage.grows``), only where K or P outgrows it."""

    def __init__(self, pin: bool):
        self._pin = pin
        self._bufs = [None, None]
        self._events = [None, None]
        self._turn = 0

    def take(self, K: int, P: int) -> torch.Tensor:
        """The next buffer's (K, P) rows, free to be written."""
        i = self._turn
        self._turn ^= 1
        event = self._events[i]
        if event is not None and not event.query():
            tracing.tick("stage.waits")
            event.synchronize()
        buf = self._bufs[i]
        if buf is None or K > buf.shape[0] or P > buf.shape[1]:
            cap, width = 1 << (K - 1).bit_length(), P
            if buf is not None:
                cap, width = max(cap, buf.shape[0]), max(P, buf.shape[1])
            buf = self._bufs[i] = torch.empty((cap, width),
                                              dtype=torch.float32,
                                              pin_memory=self._pin)
            tracing.tick("stage.grows")
        return buf[:K, :P]

    def staged(self, event) -> None:
        """Keep the rows last taken until ``event``, recorded behind
        their last copy, has fired."""
        self._events[self._turn ^ 1] = event


class Renderer:
    """``Renderer(mesh, width, height)`` renders ``Mesh`` geometry on
    ``device``: ``"cuda"`` (the default) runs the hand-written kernels,
    each frame a replayed CUDA graph, and raises where there is no card;
    ``device="cpu"`` runs their plain torch twins eagerly. The path (tile
    or micro) follows ``cuda.resolve_path``; a mesh's ``face_kd`` selects
    the material mode and its textures a texture mode
    (``cuda.frame_mode``): ``tex_filter`` "nearest", "bilinear",
    "trilinear" or "anisotropic", ``tex_mode`` "fused" (the default) or
    "deferred". ``effect_kind`` is the scene's static effect class (an
    ``EFFECT_*`` code, None when the effect may change), as
    ``Scene.renderer_options`` gives it; it decides whether the tile shape
    may be tuned (``tile_autotune``, on by default). ``backend`` is
    "cuda" (the engine; "custom" and "tpu" name it too), "xla" (the
    brute-force comparator; "wgpu" names it) or "wgpu-faithful"; the
    comparators take ``chunk`` (and xla ``tile_h`` / ``tile_w``,
    wgpu-faithful ``depth_format``) as options."""

    def __init__(self, mesh, width: int, height: int, backend: str = "cuda",
                 *, device="cuda", **options):
        self.backend_name = normalize_backend(backend)
        self.backend = get_backend(self.backend_name)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Renderer(device='cuda') needs an NVIDIA GPU with CUDA; pass "
                "device='cpu' to run the plain torch twins")
        self.width = int(width)
        self.height = int(height)
        self.ssaa = int(options.pop("ssaa", 1))
        if self.ssaa < 1:
            raise ValueError(f"ssaa must be >= 1, got {self.ssaa}")
        # Checked once, where the mesh's texture inputs are built.
        self._tex_options = {"tex_filter": options.pop("tex_filter",
                                                       "nearest"),
                             "tex_mode": options.pop("tex_mode", "fused")}
        self.effect_kind = options.pop("effect_kind", None)
        self._tile_autotune = bool(options.pop("tile_autotune", True))
        if not self.engine:
            # The engine's static hints; the comparators run every effect.
            self.effect_kind = None
            self._tile_autotune = False
        accepted = _BACKEND_OPTIONS[self.backend_name]
        unknown = set(options) - set(accepted)
        if unknown:
            raise NotImplementedError(
                f"renderer options {sorted(unknown)} are not options of the "
                f"{self.backend_name} backend (it takes {sorted(accepted)}, "
                "ssaa, tex_filter, tex_mode, effect_kind and tile_autotune)")
        self.options = options
        self._graphs: dict = {}
        # Settle-to-need pair capacity (micro path): once per scene and
        # size, unless the caller pinned pair_cap.
        self._user_pair_cap = "pair_cap" in options
        self._calibrate_pair_cap = not self._user_pair_cap
        self._user_tile = "tile_h" in options or "tile_w" in options
        self._tile_tuned = self._user_tile or not self._tile_autotune
        # The tuner's best seconds per candidate shape, once it has run.
        self.tile_timings: dict = {}
        self._pending_overflow = None
        self._stage = Staging(pin=self.device.type == "cuda")
        self._upload(mesh)

    def _upload(self, mesh) -> None:
        self.mesh = mesh

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        self.positions = dev(mesh.positions)
        self.normals = dev(mesh.normals)
        self.tri = dev(mesh.indices.astype(np.int32),
                       torch.int32).reshape(-1, 3)
        self.num_triangles = int(self.tri.shape[0])
        if not self.engine:
            self.uvs = dev(mesh.uvs)
            self.ext = {}
            if self.backend_name == "xla":
                self.ext = self.backend.mesh_ext_tensors(
                    mesh, self.tri, self.device,
                    self._tex_options["tex_filter"])
            return
        # Corner-SoA geometry (3 corners, 3 comps, T), gathered ONCE: the
        # indices are static per mesh, so the per-frame front end streams
        # contiguous rows with no gather.
        self.pos_soa = cuda.corner_soa(self.positions, self.tri)
        self.nrm_soa = cuda.corner_soa(self.normals, self.tri)
        # Material / texture inputs, static per mesh like the corner SoA
        # (the mip pool is built here, once per mesh).
        self.ext = cuda.mesh_ext_tensors(mesh, self.tri, self.device,
                                         **self._tex_options)
        self.mode = cuda.frame_mode(
            self.ext.get("face_kd"), self.ext.get("texels"),
            self.ext.get("tex_filter", "nearest"),
            self.ext.get("tex_mode", "fused"))
        self._drop_graphs()

    @property
    def engine(self) -> bool:
        """Whether the backend is the engine (``cuda``), not a
        comparator."""
        return self.backend_name == "cuda"

    def _path(self) -> str:
        return cuda.resolve_path(self.options.get("path", "auto"),
                                 self.num_triangles,
                                 self.options.get("tri_chunk", 0))

    @property
    def rw(self) -> int:
        """Render-resolution width (output width x ssaa)."""
        return self.width * self.ssaa

    @property
    def rh(self) -> int:
        """Render-resolution height (output height x ssaa)."""
        return self.height * self.ssaa

    def resize(self, width: int, height: int) -> None:
        """Render at a new output size from the next frame on (the
        reference's CustomRenderer::resize, renderer.rs:159-170, rebuilds
        its buffers): calibration and the tile tuning re-arm unless the
        caller pinned them, and the cached graphs are dropped."""
        self.width = int(width)
        self.height = int(height)
        if not self._user_pair_cap:
            # A settled capacity was measured at the old size.
            self.options.pop("pair_cap", None)
            self._calibrate_pair_cap = True
        if self._tile_autotune and not self._user_tile:
            # The tuned shape was measured at the old size.
            self.options.pop("tile_h", None)
            self.options.pop("tile_w", None)
            self._tile_tuned = False
        self._drop_graphs()

    # -- per-frame step -------------------------------------------------------

    @staticmethod
    def pack_uniforms(uniforms: FrameUniforms) -> tuple[np.ndarray, int]:
        """Flatten the per-frame uniforms into ONE f32 buffer
        (``pack_into``), so a frame costs a single host->device
        transfer."""
        L = uniforms.light_world_pos.shape[0]
        packed = np.empty(packed_size(L), np.float32)
        pack_into(packed, uniforms)
        return packed, L

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array (the packed uniforms) on the device. On the card
        it crosses from pinned memory without holding the host: a copy
        from pageable memory waits for the stream to drain, which would
        make every dispatch wait for the frames before it (the viewers'
        pipelined present, ``app/window.py``). Stream order still puts
        the copy before the frame that reads it."""
        with tracing.span("renderer.upload"):
            t = torch.from_numpy(array)
            if self.device.type != "cuda":
                return t.to(self.device)
            return t.pin_memory().to(self.device, non_blocking=True)

    def _frame(self, packed, L: int, acc=None):
        """One frame from a packed device buffer, eagerly: (rgba, key,
        overflow); a comparator's key is its depth buffer and its overflow
        report zero. The engine's binning folds the frame into ``acc``
        ((7,) int64, or None)."""
        vpos, vp, eff, lwp, lc, li = unpack_uniforms(packed, L)
        if not self.engine:
            rgba, key = self.backend.render_frame(
                self.positions, self.normals, self.uvs, self.tri, vp, vpos,
                lwp, lc, li, eff, width=self.rw, height=self.rh,
                **self.ext, **self.options)
            overflow = torch.zeros((2,), dtype=torch.int32,
                                   device=self.device)
            if self.ssaa > 1:
                rgba = box_downsample(rgba, self.ssaa)
            return rgba, key, overflow
        rgba, key, overflow = cuda.render_frame(
            self.positions, self.normals, self.tri, vp, vpos, lwp, lc, li,
            eff, width=self.rw, height=self.rh, pos_soa=self.pos_soa,
            nrm_soa=self.nrm_soa, acc=acc, **self.ext, **self.options,
        )
        if self.ssaa > 1:
            rgba = box_downsample(rgba, self.ssaa)
        return rgba, key, overflow

    def graph_key(self, L: int) -> tuple:
        """The key of a frame's graph: what the JAX engine keys its step
        by (lights, frame size, tile shape) and what changes the port's
        shapes besides — the path, the mode and the capacities."""
        return (L, self.rw, self.rh, self._path(), self.mode,
                tuple(sorted(self.options.items())))

    def _frame_graph(self, packed, L: int) -> FrameGraph:
        """The cached graph of this key, captured from ``packed`` (a (P,)
        buffer, on the device or a staged host row) if there is none."""
        key = self.graph_key(L)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = self._capture(packed, L)
        return graph

    def _capture(self, packed, L: int) -> FrameGraph:
        """Capture one frame. One eager frame on a side stream comes
        first (PyTorch's rule for capture): it builds and loads the
        kernels and makes the state that outlives a launch (the micro
        raster's merge scratch), so that nothing is allocated or filled
        for the first time inside the graph, whose private pool would
        otherwise hold it and fill it only at replay."""
        tracing.tick("captures")
        with tracing.span("renderer.capture"):
            static_in = torch.empty(packed.shape, dtype=packed.dtype,
                                    device=self.device)
            static_in.copy_(packed)
            acc = torch.zeros((binning.ACC_WORDS,), dtype=torch.int64,
                              device=self.device)
            tracing.prepare(acc.device)
            stream = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                self._frame(static_in, L, acc)
            stream.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                rgba, key, overflow = self._frame(static_in, L, acc)
        return FrameGraph(graph, static_in, rgba, key, overflow, acc)

    def _drop_graphs(self, keep=lambda key: False) -> None:
        """Drop the cached graphs whose key ``keep`` refuses, and free
        their memory pools (the JAX engine clears its step cache)."""
        for key in [k for k in self._graphs if not keep(k)]:
            self._graphs.pop(key).graph.reset()
            tracing.tick("graph_drops")

    def close(self) -> None:
        """Drop the cached graphs and free their memory pools, and the
        staging buffers (a later frame captures and stages anew)."""
        self._drop_graphs()
        self._stage = Staging(pin=self.device.type == "cuda")

    def frame_graph(self, uniforms: FrameUniforms) -> FrameGraph:
        """The graph of ``uniforms``' key, captured now if there is none,
        with the uniforms in its input buffer: a replay renders them. On
        the card only; for tools that replay it themselves
        (``bench/profiling.py``)."""
        with tracing.span("renderer.pack"):
            packed, L = self.pack_uniforms(uniforms)
        packed = self._to_device(packed)
        graph = self._frame_graph(packed, L)
        graph.packed.copy_(packed)
        return graph

    def render_device(self, uniforms: FrameUniforms):
        """Render and return the device-resident (H, W, 4) u8 frame, the
        depth keys and the overflow report, without an overflow check
        (see ``_checked``). On the card it replays the frame's graph and
        returns copies of its outputs; a comparator renders eagerly."""
        if self.device.type != "cuda" or not self.engine:
            with tracing.span("renderer.pack"):
                packed, L = self.pack_uniforms(uniforms)
            return self._frame(torch.from_numpy(packed).to(self.device), L)
        graph = self.frame_graph(uniforms)
        graph.graph.replay()
        tracing.tick("replays")
        return graph.rgba.clone(), graph.key.clone(), graph.overflow.clone()

    def _checked(self, uniforms: FrameUniforms, max_retries: int = 3):
        """Render, read the overflow report (one device->host copy), and
        retry at the reported capacities until the frame fits."""
        self._maybe_tune_tile([uniforms])
        for _ in range(max_retries):
            # Inside the loop: a tile->micro fallback re-arms calibration.
            self._maybe_calibrate(uniforms)
            out = self.render_device(uniforms)
            flags = out[2].cpu().numpy()
            if not flags.any():
                return out
            self._grow_caps(pair_needed=int(flags[0]),
                            tile_needed=int(flags[1]))
        raise RuntimeError(
            f"binning capacity overflow after {max_retries} retries "
            f"(options={self.options})")

    def _maybe_calibrate(self, uniforms: FrameUniforms) -> None:
        """Settle the micro path's pair capacity to the frame's measured
        need (+12.5%, ``cuda.grow_pair_cap``) instead of the 3T/8
        heuristic: the front end at 8x8 cells, its cover counts (meta row
        3) summed on the device, one read. Overflow detection grows the
        capacity later if the camera moves into denser coverage. Once per
        scene and size; skipped when the caller pinned pair_cap."""
        if (not self._calibrate_pair_cap or not self.engine
                or self._path() != "micro"):
            return
        self._calibrate_pair_cap = False
        tracing.tick("calibrations")
        with tracing.span("renderer.calibrate"):
            packed, L = self.pack_uniforms(uniforms)
            vpos, vp, eff, *_ = unpack_uniforms(
                torch.from_numpy(packed).to(self.device), L)
            _, meta = front.front_end(self.pos_soa, self.nrm_soa, vp, eff,
                                      width=self.rw, height=self.rh,
                                      tile_h=8, tile_w=8)
            total = int(meta[3].sum(dtype=torch.int64))
            # Keep the cell-count floor of default_pair_cap_micro.
            num_cells = ((self.rw + 127) // 128) * ((self.rh + 7) // 8) * 16
            self.options["pair_cap"] = cuda.grow_pair_cap(
                0, max(total, num_cells, 1024))
            self._drop_graphs()

    def _tile_tunable(self) -> bool:
        """Whether the tile shape may be chosen by timing (the JAX
        engine's gating, engine/renderer.py:309-353): a nonempty scene on
        the tile path with a static effect class that keeps coverage
        inside each triangle. Plain, wave and edge-melt frames are then
        the same image at every tile shape; mirage and voxelize cover
        past the triangle, so the covered tiles are part of the image,
        and a dynamic effect (``effect_kind`` None) may become either."""
        return (self.engine and self.num_triangles > 0
                and self.effect_kind not in (None, EFFECT_MIRAGE,
                                             EFFECT_VOXELIZE)
                and self._path() == "tile")

    def _maybe_tune_tile(self, uniforms_seq) -> None:
        """Pick the tile shape by measurement, once per scene and size
        (JAX engine/renderer.py:309-392): on the card, for a scene that
        ``_tile_tunable`` admits, unless the caller pinned tile_h / tile_w
        or passed ``tile_autotune=False``."""
        if self._tile_tuned:
            return
        self._tile_tuned = True
        if (self.device.type == "cuda" and uniforms_seq
                and self._tile_tunable()):
            self._tune_tile(list(uniforms_seq))

    def _tune_tile(self, uniforms_seq) -> None:
        """Time each ``cuda.TILE_CANDIDATES`` shape on the caller's own
        granularity (its batch through the replayed graphs, or single
        frames) and keep the winner; the losers' graphs are dropped.
        ``tile_timings`` keeps each shape's best seconds. A checked
        warm-up first captures the candidate and settles its capacities,
        so no retry is timed; a tile->micro fallback during it ends the
        tuning (the shape is then moot)."""
        tracing.tick("tunes")
        with tracing.span("renderer.tune"):
            batched = len(uniforms_seq) > 1
            rounds = 3 if batched else 6
            results = {}
            for shape in cuda.TILE_CANDIDATES:
                self.options["tile_h"], self.options["tile_w"] = shape
                if batched:
                    self.render_batch_device(uniforms_seq)
                else:
                    self._checked(uniforms_seq[0])
                if self.options.get("path") == "micro":
                    return
                best = float("inf")
                for _ in range(rounds):
                    t0 = time.perf_counter()
                    if batched:
                        self.render_batch_device(uniforms_seq, check=False)
                    else:
                        self.render_device(uniforms_seq[0])
                    self.fence_pending()
                    best = min(best, time.perf_counter() - t0)
                results[shape] = best
            winner = min(results, key=results.get)
            self.options["tile_h"], self.options["tile_w"] = winner
            self.tile_timings = results
            self._drop_graphs(
                keep=lambda key: key == self.graph_key(key[0]))

    def _grow_caps(self, pair_needed: int = 0, tile_needed: int = 0) -> None:
        """Grow the binning capacities to the reported need (0 = leave);
        on the micro path only ``pair_cap`` exists. A retry: it ticks
        ``retries`` of ``tracing.counters()``."""
        tracing.tick("retries")
        with tracing.span("renderer.retry"):
            self._drop_graphs()
            path = self._path()
            if (path != "micro" and tile_needed > cuda.MAX_TILE_CAP
                    and self.options.get("path", "auto") == "auto"):
                # The tile kernel's list cap is exceeded at any legal
                # tile_cap (the triangle-count split cannot see screen
                # density).
                self._switch_to_micro()
                return
            caps = cuda.default_caps(path, max(self.num_triangles, 1),
                                     self.rw, self.rh,
                                     self.options.get("tile_h", 0),
                                     self.options.get("tile_w", 0))
            pc = self.options.get("pair_cap") or caps["pair_cap"]
            if pair_needed:
                pc = cuda.grow_pair_cap(pc, pair_needed)
            self.options["pair_cap"] = pc
            if path == "micro":
                return
            tc = self.options.get("tile_cap") or caps["tile_cap"]
            if tile_needed:
                tc = cuda.grow_tile_cap(tc, tile_needed, caps["tile_h"],
                                        caps["tile_w"])
            self.options["tile_cap"] = tc

    def _switch_to_micro(self) -> None:
        """Tile->micro fallback for over-dense scenes (see _grow_caps).
        Tile-path capacities are dropped (micro pairs count 8x8 cells, not
        tiles) and calibration re-arms, so the next checked render measures
        the micro pair need."""
        self.options["path"] = "micro"
        for k in ("tile_cap", "tile_h", "tile_w"):
            self.options.pop(k, None)
        if not self._user_pair_cap:
            self.options.pop("pair_cap", None)
            self._calibrate_pair_cap = True
        self._drop_graphs()

    def _frames(self, rows, L: int, staged: bool, pack=None):
        """The frames of K packed rows and their overflow maximum: where
        ``staged`` (the engine's graphs on the card), replays of one graph
        (three host calls a frame) from ``rows``, a (K, P) view of the
        staging buffer, each row first packed from ``pack``'s uniforms
        where given (a retry replays the rows as staged); else ``_frame``
        op by op from ``rows``, a (K, P) device stack. The
        frames' binning, micro raster and mip texture tail fold into one
        accumulator; while a profiler session records, its pairs, occupied
        tiles and samples go to ``tracing.frame_counts()``, with its
        textured pixels and span blocks on the tile path and its textured
        pixels on the micro path where the mode runs the mip tail; its
        longest bin list goes to ``tracing.frame_peaks()``."""
        with tracing.span("renderer.replay"):
            K = rows.shape[0]
            frames = torch.empty((K, self.height, self.width, 4),
                                 dtype=torch.uint8, device=self.device)
            if not staged:
                acc = torch.zeros((binning.ACC_WORDS,), dtype=torch.int64,
                                  device=self.device)
                for i in range(K):
                    frames[i] = self._frame(rows[i], L, acc)[0]
            else:
                host = rows.numpy()
                for i in range(K):
                    if pack is not None:
                        with tracing.span("renderer.pack"):
                            pack_into(host[i], pack[i])
                    if i == 0:  # a capture takes row 0 as its input
                        graph = self._frame_graph(rows[0], L)
                        acc = graph.acc
                        acc.zero_()
                    with tracing.span("renderer.upload"):
                        graph.packed.copy_(rows[i], non_blocking=True)
                    graph.graph.replay()
                    frames[i].copy_(graph.rgba)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
                self._stage.staged(event)
                tracing.tick("replays", K)
            if self.engine and tracing.recording():
                words = (5 if self._path() == "tile"
                         else 4 if self.mode == "texf_mip" else 3)
                tracing.add_frames(acc[2:2 + words], K, peaks=acc[7:])
            return frames, acc[:2].to(torch.int32)

    def render_batch_device(self, uniforms_seq, max_retries: int = 3,
                            check: bool = True, *, eager: bool = False):
        """Render a sequence of frames; returns the device-resident
        (K, H, W, 4) u8 stack.

        On the card every frame replays the key's graph, its uniforms
        packed into a row of a pinned staging buffer and copied up just
        before its replay, so the card starts after one frame's pack;
        ``eager=True`` runs the frames op by op instead, as the CPU does,
        from a (K, P) stack packed and uploaded first (the comparison that
        ``chip_smoke.py`` times). The frames' overflow maximum stays on
        the device. ``check=True`` reads it once (one device->host copy)
        and retries the batch at the reported capacities, from the rows
        as staged; ``check=False`` leaves it on the device for
        ``flush_overflow()`` — the steady-state benchmark loop."""
        uniforms_seq = list(uniforms_seq)
        if not uniforms_seq:
            return torch.empty((0, self.height, self.width, 4),
                               dtype=torch.uint8, device=self.device)
        self._maybe_tune_tile(uniforms_seq)
        K = len(uniforms_seq)
        L = uniforms_seq[0].light_world_pos.shape[0]
        P = packed_size(L)
        staged = not eager and self.device.type == "cuda" and self.engine
        if staged:
            rows, pack = self._stage.take(K, P), uniforms_seq
        else:
            with tracing.span("renderer.pack"):
                host = np.empty((K, P), np.float32)
                for row, u in zip(host, uniforms_seq):
                    pack_into(row, u)
            rows, pack = self._to_device(host), None
        for _ in range(max_retries):
            if check:
                self._maybe_calibrate(uniforms_seq[0])
            frames, overflow = self._frames(rows, L, staged, pack)
            pack = None
            if not check:
                self._pending_overflow = (
                    overflow if self._pending_overflow is None
                    else torch.maximum(self._pending_overflow, overflow))
                return frames
            flags = overflow.cpu().numpy()
            if not flags.any():
                return frames
            self._grow_caps(pair_needed=int(flags[0]),
                            tile_needed=int(flags[1]))
        raise RuntimeError(
            f"binning capacity overflow after {max_retries} retries "
            f"(options={self.options})")

    def fence_pending(self) -> None:
        """Block until every frame issued so far has finished on the
        device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def take_overflow(self):
        """The (2,) i32 device maximum of the overflow reports of the
        unchecked batch renders since the last take (zeros if none), and
        clear it: what a caller that checks batches itself reads (the
        frame-parallel renders, ``parallel/frames.py``)."""
        pending = self._pending_overflow
        self._pending_overflow = None
        if pending is None:
            return torch.zeros((2,), dtype=torch.int32, device=self.device)
        return pending

    def flush_overflow(self) -> bool:
        """Fetch and clear the flags of unchecked batch renders. True means
        a frame dropped triangles and the run is invalid."""
        with tracing.span("renderer.flush"):
            return bool(self.take_overflow().cpu().numpy().any())

    def render(self, uniforms: FrameUniforms) -> np.ndarray:
        """Render one frame to a host (H, W, 4) uint8 RGBA array."""
        return self._checked(uniforms)[0].cpu().numpy()

    def render_blocked(self, uniforms: FrameUniforms):
        """Render and wait for the device; returns the device frame."""
        out = self._checked(uniforms)  # reading the flags waits already
        return out[0]

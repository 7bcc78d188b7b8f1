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
frame's overflow report out. PyTorch
runs eagerly, so there is no compiled step to cache: the JAX package's
``jit``/``lax.scan`` batch becomes a frame loop whose overflow flags
accumulate in a device tensor.

On the micro path the pair capacity settles to the first checked frame's
measured need (``_maybe_calibrate``), and a tile path whose per-tile list
outgrows ``cuda.MAX_TILE_CAP`` falls back to the micro path
(``_switch_to_micro``), as in the JAX engine.

Not ported yet (ROADMAP): the comparator backends, and the TPU engine's
measured tile-shape auto-tune (this renderer keeps the fixed 16x256 of
``cuda.choose_tile``).
"""

from __future__ import annotations

import numpy as np
import torch

from compute_renderer_torch.backends import cuda, front
from compute_renderer_torch.engine.scene import FrameUniforms

_TILE_OPTIONS = ("tile_h", "tile_w", "pair_cap", "tile_cap", "tri_chunk",
                 "path")


def unpack_uniforms(packed, L: int):
    """Inverse of ``Renderer.pack_uniforms``: split the per-frame f32
    buffer into (view_position, view_proj, effect, light_pos, light_color,
    light_intensity). The one definition of the packed layout."""
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


class Renderer:
    """``Renderer(mesh, width, height)`` renders ``Mesh`` geometry on
    ``device``: ``"cuda"`` (the default) runs the hand-written kernels and
    raises where there is no card; ``device="cpu"`` runs their plain torch
    twins. The path (tile or micro) follows ``cuda.resolve_path``; a mesh's
    ``face_kd`` selects the material mode and its textures a texture mode
    (``cuda.frame_mode``): ``tex_filter`` "nearest", "bilinear",
    "trilinear" or "anisotropic", ``tex_mode`` "fused" (the default) or
    "deferred". ``backend`` is "cuda", the one engine ported so far."""

    def __init__(self, mesh, width: int, height: int, backend: str = "cuda",
                 *, device="cuda", **options):
        if backend != "cuda":
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet (ROADMAP queue 1, "
                "item 9: comparator backends); use 'cuda'")
        self.backend_name = backend
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
        unknown = set(options) - set(_TILE_OPTIONS)
        if unknown:
            raise NotImplementedError(
                f"renderer options {sorted(unknown)} are not ported (the "
                "JAX engine's tile auto-tune and effect specialisation; "
                "ROADMAP queue 1)")
        self.options = options
        # Settle-to-need pair capacity (micro path): once per scene and
        # size, unless the caller pinned pair_cap.
        self._user_pair_cap = "pair_cap" in options
        self._calibrate_pair_cap = not self._user_pair_cap
        self._pending_overflow = None
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
        # Corner-SoA geometry (3 corners, 3 comps, T), gathered ONCE: the
        # indices are static per mesh, so the per-frame front end streams
        # contiguous rows with no gather.
        self.pos_soa = cuda.corner_soa(self.positions, self.tri)
        self.nrm_soa = cuda.corner_soa(self.normals, self.tri)
        # Material / texture inputs, static per mesh like the corner SoA
        # (the mip pool is built here, once per mesh).
        self.ext = cuda.mesh_ext_tensors(mesh, self.tri, self.device,
                                         **self._tex_options)

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

    # -- per-frame step -------------------------------------------------------

    @staticmethod
    def pack_uniforms(uniforms: FrameUniforms) -> tuple[np.ndarray, int]:
        """Flatten the per-frame uniforms into ONE f32 buffer, so a frame
        costs a single host->device transfer."""
        L = uniforms.light_world_pos.shape[0]
        return np.concatenate(
            [
                np.asarray(uniforms.view_position, np.float32).ravel(),
                np.asarray(uniforms.view_proj, np.float32).ravel(),
                np.asarray(uniforms.effect, np.float32).ravel(),
                np.asarray(uniforms.light_world_pos, np.float32).ravel(),
                np.asarray(uniforms.light_color, np.float32).ravel(),
                np.asarray(uniforms.light_intensity, np.float32).ravel(),
            ]
        ).astype(np.float32), L

    def _frame(self, packed, L: int):
        """One frame from a packed device buffer: (rgba, key, overflow)."""
        vpos, vp, eff, lwp, lc, li = unpack_uniforms(packed, L)
        rgba, key, overflow = cuda.render_frame(
            self.positions, self.normals, self.tri, vp, vpos, lwp, lc, li,
            eff, width=self.rw, height=self.rh, pos_soa=self.pos_soa,
            nrm_soa=self.nrm_soa, **self.ext, **self.options,
        )
        if self.ssaa > 1:
            rgba = box_downsample(rgba, self.ssaa)
        return rgba, key, overflow

    def render_device(self, uniforms: FrameUniforms):
        """Render and return the device-resident (H, W, 4) u8 frame, the
        depth keys and the overflow report, without waiting for the device
        and without an overflow check (see ``_checked``)."""
        packed, L = self.pack_uniforms(uniforms)
        return self._frame(torch.from_numpy(packed).to(self.device), L)

    def _checked(self, uniforms: FrameUniforms, max_retries: int = 3):
        """Render, read the overflow report (one device->host copy), and
        retry at the reported capacities until the frame fits."""
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
        scene; skipped when the caller pinned pair_cap."""
        if not self._calibrate_pair_cap or self._path() != "micro":
            return
        self._calibrate_pair_cap = False
        packed, L = self.pack_uniforms(uniforms)
        vpos, vp, eff, *_ = unpack_uniforms(
            torch.from_numpy(packed).to(self.device), L)
        _, meta = front.front_end(self.pos_soa, self.nrm_soa, vp, eff,
                                  width=self.rw, height=self.rh, tile_h=8,
                                  tile_w=8)
        total = int(meta[3].sum(dtype=torch.int64))
        # Keep the cell-count floor of default_pair_cap_micro.
        num_cells = ((self.rw + 127) // 128) * ((self.rh + 7) // 8) * 16
        self.options["pair_cap"] = cuda.grow_pair_cap(
            0, max(total, num_cells, 1024))

    def _grow_caps(self, pair_needed: int = 0, tile_needed: int = 0) -> None:
        """Grow the binning capacities to the reported need (0 = leave);
        on the micro path only ``pair_cap`` exists."""
        path = self._path()
        if (path != "micro" and tile_needed > cuda.MAX_TILE_CAP
                and self.options.get("path", "auto") == "auto"):
            # The tile kernel's list cap is exceeded at any legal tile_cap
            # (the triangle-count split cannot see screen density).
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

    def render_batch_device(self, uniforms_seq, max_retries: int = 3,
                            check: bool = True):
        """Render a sequence of frames; returns the device-resident
        (K, H, W, 4) u8 stack.

        The uniforms cross to the device in one transfer, and the frames'
        overflow flags accumulate in a device tensor. ``check=True`` reads
        them once (one device->host copy) and retries the batch at the
        reported capacities; ``check=False`` leaves them on the device for
        ``flush_overflow()`` — the steady-state benchmark loop."""
        uniforms_seq = list(uniforms_seq)
        packs = [self.pack_uniforms(u) for u in uniforms_seq]
        if not packs:
            return torch.empty((0, self.height, self.width, 4),
                               dtype=torch.uint8, device=self.device)
        L = packs[0][1]
        stack = torch.from_numpy(np.stack([p for p, _ in packs])).to(
            self.device)
        for _ in range(max_retries):
            if check:
                self._maybe_calibrate(uniforms_seq[0])
            frames = torch.empty((len(packs), self.height, self.width, 4),
                                 dtype=torch.uint8, device=self.device)
            overflow = torch.zeros((2,), dtype=torch.int32,
                                   device=self.device)
            for i in range(len(packs)):
                rgba, _, ovf = self._frame(stack[i], L)
                frames[i] = rgba
                overflow = torch.maximum(overflow, ovf)
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

    def flush_overflow(self) -> bool:
        """Fetch and clear the flags of unchecked batch renders. True means
        a frame dropped triangles and the run is invalid."""
        if self._pending_overflow is None:
            return False
        flags = self._pending_overflow.cpu().numpy()
        self._pending_overflow = None
        return bool(flags.any())

    def render(self, uniforms: FrameUniforms) -> np.ndarray:
        """Render one frame to a host (H, W, 4) uint8 RGBA array."""
        return self._checked(uniforms)[0].cpu().numpy()

    def render_blocked(self, uniforms: FrameUniforms):
        """Render and wait for the device; returns the device frame."""
        out = self._checked(uniforms)  # reading the flags waits already
        return out[0]

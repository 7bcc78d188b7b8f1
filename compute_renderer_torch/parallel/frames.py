"""Frame parallelism over a ``torch.distributed`` group, and the 2-D
frames x stripes layout.

Counterpart of the JAX package's ``parallel/frames.py``. Every rank holds
the whole scene in its own ``Renderer`` and renders a contiguous block of
the frames: the single-device pipeline unchanged (on the card each frame
replays the rank's own captured CUDA graph), with no communication until
the frames are gathered. The frame list is padded to a multiple of the
group size by repeating its last frame, and the padding is dropped. The
overflow reports are all-reduced with MAX between attempts, so every rank
grows its capacities alike; no collective runs inside a frame, and none
is ever captured in a graph.

The 2-D form composes it with the framebuffer stripes of
``sharding.py``: a frames x stripes layout (``group.make_2d``) gives each
frame block to ``nt`` ranks, which render each of its frames as micro
stripes (``sharding.render_frame_sharded``, eagerly: a stripe's frame
ends in a collective).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from compute_renderer_torch.backends import cuda
from compute_renderer_torch.engine.renderer import unpack_uniforms
from compute_renderer_torch.parallel import group as grp
from compute_renderer_torch.parallel.sharding import render_frame_sharded


def _padded(uniforms_seq, n: int) -> list:
    """The frames padded to a multiple of ``n`` with the last frame."""
    seq = list(uniforms_seq)
    return seq + [seq[-1]] * ((-len(seq)) % n)


def _block(seq, index: int, n: int) -> list:
    if len(seq) % n:
        raise ValueError(f"frame count {len(seq)} is not a multiple of {n}")
    per = len(seq) // n
    return seq[index * per:(index + 1) * per]


def render_frames_sharded(renderer, uniforms_seq, group=None):
    """One attempt, called by every rank of ``group`` with its own
    renderer of one scene: the rank's contiguous block of the frames (whose
    count must be a multiple of the group size) through
    ``renderer.render_batch_device`` unchecked, and the overflow report's
    MAX over the ranks. Returns (this rank's frames (K / n, H, W, 4) u8 on
    its device, overflow (2,) i32)."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    block = renderer.render_batch_device(_block(list(uniforms_seq), rank, n),
                                         check=False)
    return block, grp.all_reduce_max(renderer.take_overflow().clone(), group)


def render_frames(renderer, uniforms_seq, group=None,
                  max_retries: int = 3) -> np.ndarray:
    """The frame-parallel host entry, called by every rank of ``group``:
    pads the frames, settles the micro path's pair capacity on the first
    frame (the same on every rank), renders with
    ``render_frames_sharded`` and grows the capacities at the reported
    MAX until no rank overflows (the tile->micro fallback included, as
    ``Renderer._grow_caps`` does it), then gathers the frames. Returns the
    (len(uniforms_seq), H, W, 4) u8 frames, numpy, on every rank."""
    seq = list(uniforms_seq)
    if not seq:
        return np.zeros((0, renderer.height, renderer.width, 4), np.uint8)
    K = len(seq)
    seq = _padded(seq, dist.get_world_size(group))
    for _ in range(max_retries):
        renderer._maybe_calibrate(seq[0])
        block, need = render_frames_sharded(renderer, seq, group)
        flags = need.cpu().numpy()
        if not flags.any():
            frames = torch.empty((len(seq),) + tuple(block.shape[1:]),
                                 dtype=torch.uint8, device=block.device)
            grp.all_gather(frames, block, group)
            return frames[:K].cpu().numpy()
        renderer._grow_caps(pair_needed=int(flags[0]),
                            tile_needed=int(flags[1]))
    raise RuntimeError(
        f"frame-parallel binning overflow after {max_retries} retries "
        f"(options={renderer.options})")


def render_frames_sharded_2d(renderer, uniforms_seq, layout,
                             pair_cap: int = 0):
    """One attempt on a frames x stripes ``layout`` (``group.make_2d``),
    called by every rank: the rank's frame block (the frame count a
    multiple of ``layout.nf``), each frame rendered by the ``layout.nt``
    ranks of ``layout.stripes`` as micro stripes from the renderer's
    uploaded scene (its modes and ``ssaa`` included), and the overflow
    report's MAX over all ranks. Returns (the block's frames (K / nf, H,
    W, 4) u8 on the rank's device, overflow (2,) i32)."""
    block = _block(list(uniforms_seq), layout.frame_index, layout.nf)
    device = renderer.device
    frames = torch.empty((len(block), renderer.height, renderer.width, 4),
                         dtype=torch.uint8, device=device)
    need = torch.zeros((2,), dtype=torch.int32, device=device)
    for i, uniforms in enumerate(block):
        packed, L = renderer.pack_uniforms(uniforms)
        vpos, vp, eff, lwp, lc, li = unpack_uniforms(
            torch.from_numpy(packed).to(device), L)
        rgba, _, overflow = render_frame_sharded(
            renderer.positions, renderer.normals, renderer.tri, vp, vpos,
            lwp, lc, li, eff, width=renderer.width, height=renderer.height,
            group=layout.stripes, path="micro", pair_cap=pair_cap,
            ssaa=renderer.ssaa, pos_soa=renderer.pos_soa,
            nrm_soa=renderer.nrm_soa, **renderer.ext)
        frames[i] = rgba
        need = torch.maximum(need, overflow)
    return frames, grp.all_reduce_max(need)


def render_frames_2d(renderer, uniforms_seq, layout,
                     max_retries: int = 3) -> np.ndarray:
    """The 2-D host entry, called by every rank: pads the frames to a
    multiple of ``layout.nf``, renders with ``render_frames_sharded_2d``,
    grows the pair capacity at the reported MAX until no rank overflows,
    and gathers the frame blocks over ``layout.frames``. Returns the
    (len(uniforms_seq), H, W, 4) u8 frames, numpy, on every rank."""
    seq = list(uniforms_seq)
    if not seq:
        return np.zeros((0, renderer.height, renderer.width, 4), np.uint8)
    K = len(seq)
    seq = _padded(seq, layout.nf)
    pair_cap = renderer.options.get("pair_cap") or cuda.default_caps(
        "micro", max(renderer.num_triangles, 1), renderer.rw,
        renderer.rh)["pair_cap"]
    for _ in range(max_retries):
        block, need = render_frames_sharded_2d(renderer, seq, layout,
                                               pair_cap)
        flags = need.cpu().numpy()
        if not flags.any():
            frames = torch.empty((len(seq),) + tuple(block.shape[1:]),
                                 dtype=torch.uint8, device=block.device)
            grp.all_gather(frames, block, layout.frames)
            return frames[:K].cpu().numpy()
        pair_cap = cuda.grow_pair_cap(pair_cap, int(flags[0]))
    raise RuntimeError(
        f"2-D frame-parallel binning overflow after {max_retries} retries "
        f"(pair_cap={pair_cap})")

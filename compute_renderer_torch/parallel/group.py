"""Process groups for the multi-device decompositions: one process a rank.

The JAX package runs its decompositions single-controller, ``shard_map``
over a device ``Mesh`` (``parallel/sharding.make_mesh``). Here each rank is
a process in a ``torch.distributed`` group, and this module is what
``make_mesh`` was:

- ``init`` / ``destroy``: join and leave a group. The backend is the
  caller's explicit choice: ``"nccl"`` where each rank has a GPU of its
  own (more ranks than GPUs raise: NCCL refuses two ranks on one device),
  ``"gloo"`` where ranks share a card or run on the CPU. Nothing switches
  backend by itself.
- ``launch``: run ``fn(rank, world_size, *args)`` on ``world_size``
  spawned ranks and return each rank's result. The group meets through a
  file store in a temporary directory and binds gloo to the loopback
  interface (``GLOO_SOCKET_IFNAME=lo``): on a host whose name resolves to
  an interface that leads nowhere, gloo's default binding hangs. The
  group's ``timeout`` bounds every collective, so a rank that dies
  cannot hold the others for ever, and a rank that raises makes
  ``launch`` raise in the parent (``torch.multiprocessing.spawn`` stops
  the other ranks).
- ``mesh_tensors`` / ``mesh_from_tensors``: a ``Mesh`` as CPU tensors,
  which ``launch`` hands to the ranks through shared memory, and back.
- ``make_2d``: the frames x stripes sub-groups of a 2-D layout
  (``dist.new_group``).
- ``all_gather``, ``all_to_all``, ``all_reduce_max``: the collectives the
  decompositions use, on the device tensors themselves: gloo takes CUDA
  tensors in all three on the card (PERF.md §6), so nothing
  is staged through host memory here.

``rank_device``: rank r of a ``"cuda"`` run uses ``cuda:{r %
device_count}``, so ranks share a card when there are more ranks than
cards; ``"cpu"`` runs the kernels' twins. No collective is ever captured
in a CUDA graph.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# Seconds a collective may wait for its peers before it raises.
DEFAULT_TIMEOUT_S = 300.0
# The kernels a rank on the card loads: the parent builds them before it
# spawns, so that the ranks do not each run nvcc.
KERNELS = ("front", "raster", "expand", "micro", "sort")


def rank_device(device, rank: int) -> torch.device:
    """The device of global rank ``rank``: ``cuda:{rank % count}`` for a
    CUDA device type (which raises where there is no card), else
    ``device`` itself."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a rank on device 'cuda' needs an NVIDIA GPU with "
                           "CUDA; pass device='cpu' for the twins")
    return torch.device("cuda", rank % torch.cuda.device_count())


def check_backend(backend: str, world_size: int, device) -> None:
    """Refuse a backend that cannot serve ``world_size`` ranks on
    ``device``: an unknown name, NCCL off the card, or NCCL with more
    ranks than cards."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (backends {BACKENDS})")
    if backend != "nccl":
        return
    if torch.device(device).type != "cuda":
        raise ValueError("backend 'nccl' needs device 'cuda'; use 'gloo' on "
                         "the CPU")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world_size > count:
        raise ValueError(
            f"backend 'nccl' runs one rank a GPU: {world_size} ranks, "
            f"{count} GPUs; ranks that share a card take backend='gloo'")


def init(backend: str, rank: int, world_size: int, init_method: str, *,
         device="cuda", timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default group as ``rank`` of ``world_size`` through
    ``init_method`` and return the rank's device (``rank_device``; made
    current on the card). ``device`` is "cuda" unless the caller asks for
    "cpu", as in ``launch``: without a card it raises."""
    check_backend(backend, world_size, device)
    dev = rank_device(device, rank)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout), **kwargs)
    return dev


def destroy() -> None:
    """Leave the default group (and its sub-groups)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, fn, world_size, backend, device, timeout, store_dir,
               args):
    """A spawned rank: join the group (one host: its sockets on the
    loopback interface), run ``fn``, save its result for the parent,
    leave the group."""
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    os.environ["NCCL_SOCKET_IFNAME"] = "lo"
    # Ranks share the host's cores.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    init(backend, rank, world_size, f"file://{store_dir}/store",
         device=device, timeout=timeout)
    try:
        result = fn(rank, world_size, *args)
        if result is not None:
            torch.save(result, os.path.join(store_dir, f"rank{rank}.pt"))
    finally:
        destroy()


def launch(fn, world_size: int, args=(), *, backend: str = "gloo",
           device="cuda", timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` ranks, each a
    process started by the ``spawn`` method (never ``fork``: the caller
    may hold JAX or CUDA state), in one group of ``backend`` whose
    collectives time out after ``timeout`` seconds. ``fn`` must be a
    module-level function; CPU tensors in ``args`` reach the ranks through
    shared memory. On the card the parent builds the kernels first.
    Returns each rank's return value (None where it returned None), CUDA
    tensors in it loaded onto the CPU. A rank that raises makes this
    raise (``torch.multiprocessing.ProcessRaisedException``)."""
    check_backend(backend, world_size, device)
    if torch.device(device).type == "cuda":
        rank_device(device, 0)
        from compute_renderer_torch import _build

        _build.build_all(KERNELS)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="crt_group_") as store_dir:
        mp.spawn(_rank_main,
                 args=(fn, world_size, backend, str(device), timeout,
                       store_dir, tuple(args)),
                 nprocs=world_size, join=True, start_method="spawn")
        results = []
        for rank in range(world_size):
            path = os.path.join(store_dir, f"rank{rank}.pt")
            results.append(torch.load(path, map_location="cpu",
                                      weights_only=False)
                           if os.path.exists(path) else None)
    return results


MESH_FIELDS = ("positions", "normals", "uvs", "indices", "face_kd",
               "face_tex", "texels", "tex_table")


def mesh_tensors(mesh) -> dict:
    """A ``Mesh``'s arrays as CPU tensors (indices as int32), for
    ``launch``'s arguments."""
    out = {}
    for name in MESH_FIELDS:
        a = getattr(mesh, name)
        if a is not None:
            if name == "indices":
                a = a.astype(np.int32)
            out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def mesh_from_tensors(tensors: dict):
    """The ``Mesh`` of ``mesh_tensors``' output (numpy views of the
    tensors, no copy but the indices)."""
    from compute_renderer_torch.core.types import Mesh

    arrays = {k: v.numpy() for k, v in tensors.items()}
    arrays["indices"] = arrays["indices"].astype(np.uint32)
    return Mesh(**arrays)


@dataclass
class Layout2D:
    """A rank's place in a frames x stripes layout: global rank ``f * nt +
    t`` renders stripe ``t`` of the frames of frame block ``f``.
    ``stripes`` is the group of the ``nt`` ranks of its frame block (they
    render one frame together), ``frames`` the group of the ``nf`` ranks
    that hold its stripe index (they hold the frame blocks)."""

    nf: int
    nt: int
    frame_index: int
    stripe_index: int
    stripes: object
    frames: object


def make_2d(nf: int, nt: int) -> Layout2D:
    """The frames x stripes layout of the default group, whose size must
    be ``nf * nt``. Every rank calls it (``dist.new_group`` is
    collective), and every rank makes every group, in one order."""
    world = dist.get_world_size()
    if nf * nt != world:
        raise ValueError(f"a {nf} x {nt} layout needs {nf * nt} ranks, the "
                         f"group has {world}")
    rank = dist.get_rank()
    stripes = frames = None
    for f in range(nf):
        g = dist.new_group([f * nt + t for t in range(nt)])
        if rank // nt == f:
            stripes = g
    for t in range(nt):
        g = dist.new_group([f * nt + t for f in range(nf)])
        if rank % nt == t:
            frames = g
    return Layout2D(nf, nt, rank // nt, rank % nt, stripes, frames)


def all_gather(out, inp, group=None) -> None:
    """``out`` = the ranks' ``inp`` stacked along dim 0, in group rank
    order (``dist.all_gather_into_tensor``)."""
    dist.all_gather_into_tensor(out, inp.contiguous(), group=group)


def all_to_all(out, inp, group=None) -> None:
    """Rank r's block d of ``inp`` (dim 0 split in equal blocks) lands as
    block r of rank d's ``out`` (``dist.all_to_all_single``)."""
    dist.all_to_all_single(out, inp.contiguous(), group=group)


def all_reduce_max(t, group=None):
    """``t`` replaced by its element-wise maximum over the ranks; returns
    it."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t

"""The rank side of ``tests/test_torch_parallel*.py``.

``compute_renderer_torch.parallel.launch`` spawns ranks that import a
function by its module, so the functions the tests launch live here, in a
module that imports numpy, torch and the port only (the test modules
import JAX, which a rank does not need). Scenes travel to the ranks as
CPU tensors (``mesh_tensors``), which reach them through shared memory.
"""

import time

import numpy as np
import torch

def to_mesh(tensors: dict):
    from compute_renderer_torch.parallel import mesh_from_tensors

    return mesh_from_tensors(tensors)


def frame_uniforms(u: dict):
    from compute_renderer_torch.engine.scene import FrameUniforms

    return FrameUniforms(**u)


def _sharded(rank, case, meshes, groups):
    """render_sharded (``case["raw"]``: one render_frame_sharded call at
    the case's capacities, its overflow report kept) on the case's
    group."""
    from compute_renderer_torch.backends import cuda
    from compute_renderer_torch.parallel import (
        render_frame_sharded, render_sharded,
    )

    u = case["uniforms"]
    lights = (u["light_world_pos"], u["light_color"], u["light_intensity"])
    mesh = to_mesh(meshes[case["mesh"]])
    cu = frame_uniforms(u)
    opts = dict(case.get("options", {}))
    device = case.get("device", "cpu")
    if not case.get("raw"):
        return render_sharded(mesh, cu, lights, u["effect"], case["width"],
                              case["height"], group=groups[case["ranks"]],
                              device=device, **opts)
    tex = {k: opts.pop(k) for k in ("tex_filter", "tex_mode") if k in opts}
    args, ext = cuda.frame_tensors(mesh, cu, lights, u["effect"], device,
                                   **tex)
    if opts.pop("pack_texels", False):
        from compute_renderer_torch.io.textures import pack_pool_u8

        ext["texels_packed"] = torch.from_numpy(pack_pool_u8(mesh.texels))
    rgba, keys, overflow = render_frame_sharded(
        *args, width=case["width"], height=case["height"],
        group=groups[case["ranks"]], **opts, **ext)
    return rgba.numpy(), keys.numpy(), overflow.numpy()


def _frames(rank, case, meshes, layout):
    from compute_renderer_torch.engine.renderer import Renderer
    from compute_renderer_torch.parallel import (
        render_frames, render_frames_2d,
    )

    r = Renderer(to_mesh(meshes[case["mesh"]]), case["width"],
                 case["height"], device="cpu", **case.get("options", {}))
    seq = [frame_uniforms(u) for u in case["frames"]]
    if case["kind"] == "frames2d":
        return render_frames_2d(r, seq, layout)
    return render_frames(r, seq)


def run_cases(rank, world_size, meshes, cases):
    """Every case on this rank; returns {case name: result} (every rank
    returns its own results, so that the tests can hold the ranks to each
    other). A case runs on the group of its first ``ranks`` ranks
    (``make_mesh``; the others skip it); "frames2d" cases run on the
    world's 2 x (world_size / 2) layout."""
    from compute_renderer_torch.parallel import make_2d, make_mesh

    sizes = sorted({c.get("ranks", world_size) for c in cases
                    if c["kind"] == "sharded"})
    groups = {s: make_mesh(s) for s in sizes}
    layout = (make_2d(2, world_size // 2)
              if any(c["kind"] == "frames2d" for c in cases) else None)
    out = {}
    for case in cases:
        if case["kind"] == "sharded":
            if rank < case.get("ranks", world_size):
                case = dict(case, ranks=case.get("ranks", world_size))
                out[case["name"]] = _sharded(rank, case, meshes, groups)
        else:
            out[case["name"]] = _frames(rank, case, meshes, layout)
    return out


def fail_on_rank_one(rank, world_size):
    """Rank 1 raises before the first collective; the others wait in it."""
    import torch.distributed as dist

    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()
    time.sleep(3600)  # never reached while rank 1 is gone


def layout_ranks(rank, world_size, nf, nt):
    """This rank's place in the nf x nt layout and its groups' ranks."""
    import torch.distributed as dist

    from compute_renderer_torch.parallel import make_2d

    layout = make_2d(nf, nt)
    return (layout.frame_index, layout.stripe_index,
            dist.get_process_group_ranks(layout.stripes),
            dist.get_process_group_ranks(layout.frames))

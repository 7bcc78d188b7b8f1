"""The multi-device decompositions, on ``torch.distributed``: one process
a rank (the JAX package's ``parallel/`` runs ``shard_map`` over a device
mesh).

- **framebuffer stripes** (``sharding.render_frame_sharded``, path
  "tile" or "micro"): each rank renders a stripe of tile rows at its
  global row offset; one gather of the stripes — shortens a frame;
- **sort-middle** (path "sortmiddle"): a triangle-parallel front end
  (front, expansion and sort on a 1/n slice of the triangles), an
  ``all_to_all`` pair exchange and one table ``all_gather``, then the
  stripes' rasters;
- **frame parallelism** (``frames.render_frames``): each rank renders a
  block of the frames through its own renderer, no communication until
  the frames are gathered; ``frames.render_frames_2d`` composes it with
  stripes on a frames x stripes layout.

The group helpers (``group.py``): ``launch`` runs a function on spawned
ranks, ``init`` / ``destroy`` join and leave a group (backend "gloo" or
"nccl", chosen by the caller), ``mesh_tensors`` / ``mesh_from_tensors``
carry a scene to the ranks, ``make_2d`` builds the 2-D layout's
sub-groups. Entry points run on the card (``device="cuda"``, rank r on
``cuda:{r % device_count}``) unless the caller passes ``device="cpu"``.
"""

from compute_renderer_torch.parallel.frames import (  # noqa: F401
    render_frames,
    render_frames_2d,
    render_frames_sharded,
    render_frames_sharded_2d,
)
from compute_renderer_torch.parallel.group import (  # noqa: F401
    Layout2D,
    destroy,
    init,
    launch,
    make_2d,
    mesh_from_tensors,
    mesh_tensors,
    rank_device,
)
from compute_renderer_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    render_frame_sharded,
    render_sharded,
)

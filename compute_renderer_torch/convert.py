"""State carried across from the JAX package.

Both functions take plain arrays — the numpy attributes of the JAX
package's ``Mesh`` and ``FrameUniforms``, or any array-likes — and return
this package's types, so tests can feed identical data to both packages
without this package importing the other.
"""

from __future__ import annotations

import numpy as np

from compute_renderer_torch.core.types import Mesh
from compute_renderer_torch.engine.scene import FrameUniforms


def mesh_from_arrays(positions, normals, uvs, indices, face_kd=None,
                     face_tex=None, texels=None, tex_table=None) -> Mesh:
    """A ``Mesh`` from (N, 3) positions, (N, 3) normals, (N, 2) uvs, flat
    (3T,) indices and the optional material / texture arrays — (T, 3)
    face_kd, (T,) face_tex, (P, 3) texels, (M, 3) tex_table (copied, as
    f32 / u32 / i32)."""
    copy = lambda a, dtype: None if a is None else np.array(a, dtype=dtype)
    return Mesh(
        positions=np.array(positions, dtype=np.float32),
        normals=np.array(normals, dtype=np.float32),
        uvs=np.array(uvs, dtype=np.float32),
        indices=np.array(indices, dtype=np.uint32).reshape(-1),
        face_kd=copy(face_kd, np.float32),
        face_tex=copy(face_tex, np.int32),
        texels=copy(texels, np.float32),
        tex_table=copy(tex_table, np.int32),
    )


def uniforms_from_arrays(view_position, view_proj, light_world_pos,
                         light_color, light_intensity,
                         effect) -> FrameUniforms:
    """A ``FrameUniforms`` from its six arrays (copied, as f32)."""
    f32 = lambda a: np.array(a, dtype=np.float32)
    return FrameUniforms(
        view_position=f32(view_position),
        view_proj=f32(view_proj),
        light_world_pos=f32(light_world_pos),
        light_color=f32(light_color),
        light_intensity=f32(light_intensity),
        effect=f32(effect),
    )

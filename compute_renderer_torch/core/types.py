"""Geometry and screen types.

The reference stores vertices as AoS structs padded for GPU storage buffers
(src/vertex.rs:41-65: 48-byte CustomVertex). Here the layout is SoA numpy
arrays — positions (N,3) f32, normals (N,3), uvs (N,2) — uploaded to the
device once by the renderer.

ScreenConfig mirrors the reference's screen uniform {width, height,
num_tiles_x, num_tiles_y} (src/custom_pipeline/util.rs:13-29) but the tile
shape is a backend choice: the reference uses 8x8 GPU workgroup tiles; the
cuda backend defaults to 16x256 framebuffer tiles.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from compute_renderer_torch.core.maths import F32

# The reference's binning tile size (raster_pass.rs:3). Used by the golden
# oracle for exact emulation; the cuda backend picks its own tile shape.
REF_TILE_SIZE = 8


@dataclass
class Mesh:
    """SoA triangle mesh. ``indices`` is flat (3*T,) uint32, CCW winding as
    loaded (the reference culls cross_z >= 0 in screen space).

    ``face_kd`` is the optional per-triangle diffuse color (T, 3) f32 from
    the material extension (``load_obj(materials=True)``); None (the
    default) means reference-faithful no-materials rendering.

    The texture extension (``load_obj(textures=True)``) adds the
    reference's flat-atlas layout (TextureInfo, custom_pipeline/
    util.rs:75-85): ``texels`` is the (P, 3) f32 pool of all images' rows
    back-to-back, ``tex_table`` the (M, 3) i32 per-texture
    {offset, width, height} rows, and ``face_tex`` the (T,) i32 texture
    slot per triangle (-1 = untextured)."""

    positions: np.ndarray  # (N, 3) f32
    normals: np.ndarray  # (N, 3) f32 (zero-filled if absent in source)
    uvs: np.ndarray  # (N, 2) f32 (zero-filled if absent in source)
    indices: np.ndarray  # (3*T,) u32
    face_kd: np.ndarray | None = None  # (T, 3) f32 per-triangle diffuse
    face_tex: np.ndarray | None = None  # (T,) i32 texture slot or -1
    texels: np.ndarray | None = None  # (P, 3) f32 flat texel pool
    tex_table: np.ndarray | None = None  # (M, 3) i32 {offset, width, height}

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions, dtype=F32)
        self.normals = np.ascontiguousarray(self.normals, dtype=F32)
        self.uvs = np.ascontiguousarray(self.uvs, dtype=F32)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.uint32)
        if self.face_kd is not None:
            self.face_kd = np.ascontiguousarray(self.face_kd, dtype=F32)
            assert self.face_kd.shape == (self.num_triangles, 3), (
                self.face_kd.shape, self.num_triangles)
        if self.face_tex is not None:
            self.face_tex = np.ascontiguousarray(self.face_tex, dtype=np.int32)
            assert self.face_tex.shape == (self.num_triangles,), (
                self.face_tex.shape, self.num_triangles)
            if (self.face_tex >= 0).any():
                assert self.texels is not None and self.tex_table is not None
        if self.texels is not None:
            self.texels = np.ascontiguousarray(self.texels, dtype=F32)
        if self.tex_table is not None:
            self.tex_table = np.ascontiguousarray(self.tex_table,
                                                  dtype=np.int32)

    @property
    def has_textures(self) -> bool:
        return self.face_tex is not None and bool((self.face_tex >= 0).any())

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0] // 3)

    @staticmethod
    def concatenate(meshes: list) -> "Mesh":
        """Multi-mesh concat with index offsetting (reference
        src/model.rs:109-121)."""
        if not meshes:
            return Mesh(
                positions=np.zeros((0, 3), dtype=F32),
                normals=np.zeros((0, 3), dtype=F32),
                uvs=np.zeros((0, 2), dtype=F32),
                indices=np.zeros((0,), dtype=np.uint32),
            )
        positions, normals, uvs, indices = [], [], [], []
        offset = 0
        for m in meshes:
            positions.append(m.positions)
            normals.append(m.normals)
            uvs.append(m.uvs)
            indices.append(m.indices.astype(np.uint32) + np.uint32(offset))
            offset += m.num_vertices
        # Per-triangle diffuse: None unless some input carries materials;
        # material-less inputs then contribute white (the identity color).
        face_kd = None
        if any(m.face_kd is not None for m in meshes):
            face_kd = np.concatenate(
                [
                    m.face_kd if m.face_kd is not None
                    else np.ones((m.num_triangles, 3), dtype=F32)
                    for m in meshes
                ],
                axis=0,
            )
        # Texture pools merge by re-offsetting: each input's table rows get
        # the running texel-pool offset added and its face_tex slots the
        # running slot offset; texture-less inputs contribute -1 slots.
        face_tex = texels = tex_table = None
        if any(m.face_tex is not None for m in meshes):
            ft_parts, texel_parts, table_parts = [], [], []
            texel_off = slot_off = 0
            for m in meshes:
                if m.face_tex is None:
                    ft_parts.append(
                        np.full((m.num_triangles,), -1, dtype=np.int32))
                    continue
                ft = m.face_tex.astype(np.int32)
                ft_parts.append(np.where(ft >= 0, ft + slot_off, -1))
                if m.tex_table is not None:
                    tbl = m.tex_table.astype(np.int32).copy()
                    tbl[:, 0] += texel_off
                    table_parts.append(tbl)
                    slot_off += tbl.shape[0]
                if m.texels is not None:
                    texel_parts.append(m.texels)
                    texel_off += m.texels.shape[0]
            face_tex = np.concatenate(ft_parts, axis=0)
            if table_parts:
                texels = (np.concatenate(texel_parts, axis=0)
                          if texel_parts else np.zeros((0, 3), dtype=F32))
                tex_table = np.concatenate(table_parts, axis=0)
        return Mesh(
            positions=np.concatenate(positions, axis=0),
            normals=np.concatenate(normals, axis=0),
            uvs=np.concatenate(uvs, axis=0),
            indices=np.concatenate(indices, axis=0),
            face_kd=face_kd,
            face_tex=face_tex,
            texels=texels,
            tex_table=tex_table,
        )


@dataclass
class ScreenConfig:
    width: int
    height: int
    tile_h: int = REF_TILE_SIZE
    tile_w: int = REF_TILE_SIZE

    @property
    def num_tiles_x(self) -> int:
        return (self.width + self.tile_w - 1) // self.tile_w

    @property
    def num_tiles_y(self) -> int:
        return (self.height + self.tile_h - 1) // self.tile_h

    @property
    def num_tiles(self) -> int:
        return self.num_tiles_x * self.num_tiles_y

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

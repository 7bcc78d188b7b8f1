"""Texture images and the flat texel atlas.

The reference defines atlas-style ``TextureInfo{offset, width, height}``
records pointing into a flat texel pool but never binds them to a pipeline
(custom_pipeline/util.rs:75-85, materials discarded at model.rs:24). This
module makes that exact layout live: every ``map_Kd`` image referenced by a
loaded MTL library is decoded to linear-indexed RGB rows and packed
back-to-back into one flat ``(P, 3) f32`` pool, so per-pixel texture
sampling is a single 1-D gather however many textures a scene uses.

Conventions (the reference has no sampling stage to match):
- texels are stored row-major with the image's TOP row first, values in
  [0, 1]; no color-space conversion is applied;
- the OBJ loader already flips V at load (``1 - v``, reference
  model.rs:64), so a flipped v of 0 addresses the image's top row.

A copy of the JAX package's ``io/textures.py`` (``load_image``,
``build_atlas``, ``build_mips``, ``trilinear_tex_arrays``,
``pack_pool_u8``, ``write_ppm``). PPM (P6/P3) is decoded in numpy; other
formats go through Pillow, imported when such a file is loaded.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from compute_renderer_torch.core.maths import F32


def _load_ppm(data: bytes) -> np.ndarray:
    """Decode a P6 (binary) or P3 (ascii) PPM into (H, W, 3) f32 [0, 1]."""
    # Header tokens: magic, width, height, maxval — whitespace/comment
    # separated. For P6 exactly one whitespace byte follows maxval, then
    # raster bytes.
    tokens = []
    i = 0
    n = len(data)
    while len(tokens) < 4 and i < n:
        c = data[i:i + 1]
        if c == b"#":
            while i < n and data[i:i + 1] not in (b"\n", b"\r"):
                i += 1
        elif c.isspace():
            i += 1
        else:
            j = i
            while j < n and not data[j:j + 1].isspace() and data[j:j + 1] != b"#":
                j += 1
            tokens.append(data[i:j])
            i = j
    if len(tokens) < 4 or tokens[0] not in (b"P6", b"P3"):
        raise ValueError("not a P6/P3 PPM")
    width, height, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval <= 0 or maxval > 65535:
        raise ValueError(f"bad PPM maxval {maxval}")
    if tokens[0] == b"P6":
        i += 1  # single whitespace after maxval
        dtype = np.dtype(">u2") if maxval > 255 else np.uint8
        count = width * height * 3
        raster = np.frombuffer(data, dtype=dtype, count=count, offset=i)
    else:
        raster = np.array(data[i:].split()[: width * height * 3], dtype=np.int64)
    img = raster.reshape(height, width, 3).astype(F32) / F32(maxval)
    return img


def load_image(path) -> np.ndarray:
    """Load a texture image file to (H, W, 3) f32 in [0, 1], top row first.

    PPM is decoded here; other formats need Pillow, and without it the
    ImportError names the file and its format."""
    path = Path(path)
    data = path.read_bytes()
    if data[:2] in (b"P6", b"P3"):
        return _load_ppm(data)
    try:
        from PIL import Image
    except ImportError as e:
        kind = path.suffix.lstrip(".").upper() or "non-PPM"
        raise ImportError(
            f"loading '{path.name}' ({kind} image) requires Pillow; only PPM "
            "is decoded without it"
        ) from e
    import io as _io

    with Image.open(_io.BytesIO(data)) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
    return arr.astype(F32) / F32(255.0)


def build_atlas(paths: list) -> tuple:
    """Pack texture image files into the reference's flat-atlas layout.

    ``paths``: ordered texture file paths (one per texture slot; duplicates
    allowed — each occurrence gets its own slot, callers dedup upstream).

    Returns ``(texels, table)``:
      texels: (P, 3) f32 — all images' rows back-to-back
      table:  (N, 3) i32 — per-slot {offset, width, height}, exactly the
              reference's TextureInfo fields (custom_pipeline/util.rs:75-85)
    An unreadable/undecodable file degrades to a 1x1 white texel (renders
    as the untextured material color), with a warning."""
    texels = []
    table = np.zeros((len(paths), 3), dtype=np.int32)
    offset = 0
    for slot, p in enumerate(paths):
        try:
            img = load_image(p)
        except (OSError, ValueError, ImportError) as e:
            import warnings

            warnings.warn(
                f"texture {p!r} unusable ({type(e).__name__}: {e}); "
                "degrading to 1x1 white texel",
                stacklevel=2,
            )
            img = np.ones((1, 1, 3), dtype=F32)
        h, w = img.shape[:2]
        table[slot] = (offset, w, h)
        texels.append(img.reshape(h * w, 3))
        offset += h * w
    pool = (
        np.concatenate(texels, axis=0)
        if texels else np.zeros((0, 3), dtype=F32)
    )
    return np.ascontiguousarray(pool, dtype=F32), table


def build_mips(texels: np.ndarray, tex_table: np.ndarray) -> tuple:
    """Extend a flat atlas with box-filtered mip chains, for the trilinear
    and anisotropic filters (an extension: the reference binds no sampler).

    Built once on the host. Level l+1 halves each dimension (floor, min
    1); each child texel is the f32 mean of a 2x2 parent block. Odd
    dimensions floor-halve, so the trailing row/column of an odd level
    does not contribute to the next one (a dimension already at 1
    duplicates instead).

    Returns ``(pool, mip_table)``:
      pool:      (P', 3) f32 — the original pool with every level >= 1
                 appended (level-0 rows keep their original offsets)
      mip_table: (M, L, 3) i32 — per-slot, per-level {offset, width,
                 height}; chains shorter than the longest repeat their
                 1x1 tail so L is uniform (sampling clamps lod to L-1)."""
    tex_table = np.asarray(tex_table, dtype=np.int32)
    M = tex_table.shape[0]
    chains = []
    for off, w, h in tex_table:
        img = np.asarray(texels[off:off + w * h], dtype=F32).reshape(h, w, 3)
        imgs = []
        while img.shape[0] > 1 or img.shape[1] > 1:
            h2 = max(img.shape[0] // 2, 1)
            w2 = max(img.shape[1] // 2, 1)
            # Clamp only engages for a dimension already at 1 (duplicate);
            # odd dims >= 3 floor-halve and drop the trailing row/column.
            ys = np.minimum(2 * np.arange(h2)[:, None] + np.arange(2),
                            img.shape[0] - 1)
            xs = np.minimum(2 * np.arange(w2)[:, None] + np.arange(2),
                            img.shape[1] - 1)
            block = img[ys[:, None, :, None], xs[None, :, None, :]]
            img = block.mean(axis=(2, 3), dtype=np.float64).astype(F32)
            imgs.append(img)
        chains.append(((int(off), int(w), int(h)), imgs))
    L = max(1 + len(c[1]) for c in chains) if chains else 1
    pool = [np.asarray(texels, dtype=F32).reshape(-1, 3)]
    offset = pool[0].shape[0]
    mip_table = np.zeros((M, L, 3), dtype=np.int32)
    for slot, (level0, imgs) in enumerate(chains):
        mip_table[slot, 0] = level0
        for li, img in enumerate(imgs, start=1):
            h, w = img.shape[:2]
            mip_table[slot, li] = (offset, w, h)
            pool.append(img.reshape(h * w, 3))
            offset += h * w
        # Uniform L: repeat the 1x1 tail for shorter chains.
        for li in range(1 + len(imgs), L):
            mip_table[slot, li] = mip_table[slot, li - 1]
    return np.ascontiguousarray(np.concatenate(pool, axis=0)), mip_table


def trilinear_tex_arrays(texels, tex_table) -> tuple:
    """(mip-extended pool, (M, L, 3) level table) for the mip filters: the
    one helper the host entries use, so the pool-replaces-texels
    convention cannot drift between them."""
    return build_mips(np.asarray(texels), np.asarray(tex_table))


def pack_pool_u8(texels: np.ndarray):
    """The flat (P, 3) f32 texel pool packed as (P,) i32 ``r | g << 8 |
    b << 16``, or None when some texel is not exactly a u8 value (v ==
    round(v * 255) / 255 in f32, bitwise: every u8-sourced image; not a
    16-bit PPM or a mip level's means). The fused tail's unpack divides by
    255 in f32 as the loader did (``common._pool_fetcher``), so sampling
    the packed pool gives the same floats as sampling ``texels``."""
    texels = np.asarray(texels, dtype=F32)
    if texels.size == 0:
        return None
    k = np.round(texels * 255.0).astype(np.int64)
    if k.min() < 0 or k.max() > 255:
        return None
    if not np.array_equal(k.astype(F32) / F32(255.0), texels):
        return None
    k = k.astype(np.int32)
    return np.ascontiguousarray(k[:, 0] | (k[:, 1] << 8) | (k[:, 2] << 16))


def write_ppm(path, img: np.ndarray) -> None:
    """Write (H, W, 3) u8 (or f32 in [0,1]) as binary P6 — the procedural
    texture asset writer (tests + objgen's generated scenes)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img[:, :, :3].tobytes())

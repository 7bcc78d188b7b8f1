"""The per-frame mip rows' share of their roofline: the least time
``mip_rows_kernel``'s compulsory work takes on the card (the larger of its
bytes over the HBM rate and its operations over the float32 rate,
``peaks.json``) over that kernel's time a frame in the traced window, in
percent.

Bytes, counted from the kernel's loads and stores (``csrc/texture.cu``):
each triangle's 3 vertex indices and its texture slot in (16 B) and its
5-float row out (20 B), 36 B; each vertex's position (12 B) and uv (8 B)
in once, 20 B, however many triangles share it (a corner read again
comes from the cache); the level table, the matrix and the effect are a
few hundred bytes. The structured scene holds 514,140 vertices for its
1,023,442 triangles (objgen v2: (600 + 1)^2 terrain, 531 x 285 statue,
8 a ruin, 4 banner), 0.5024 a triangle, so 36 + 20 x 0.5024 = 46.05 B a
triangle, frozen here as 46 (``chip_smoke.py``'s row-10 bound, N x 20 +
T x 36, gives the same). Operations: ~150 a triangle (three corner
transforms, the uv gradients, the level). None where the configuration
runs no mip filter."""

BYTES = 46
OPS = 150
KERNEL = "mip_rows_kernel"
MIP_FILTERS = ("trilinear", "anisotropic")


def read(ctx):
    if (ctx.config.get("shading") != "textures"
            or ctx.config.get("tex_filter") not in MIP_FILTERS):
        return None
    if ctx.trace is None or not ctx.traced["frames"]:
        return None
    seconds, count = ctx.trace.device_seconds([KERNEL])
    if not count or seconds <= 0.0:
        return None
    peaks = ctx.peaks()
    T = ctx.config["triangles"]
    bound = max(T * BYTES / peaks["hbm_bytes_per_s"],
                T * OPS / peaks["fp32_ops_per_s"])
    return 100.0 * bound / (seconds / ctx.traced["frames"])

"""The front's share of its roofline in the texf_mip mode (a textured
configuration under the trilinear or anisotropic filter): the least time
its compulsory work takes on the card (the larger of its bytes over the
HBM rate and its operations over the float32 rate, ``peaks.json``) over
its kernel time a frame in the traced window, in percent.

Bytes a triangle, whatever the frame culls: the 18 corner floats in (9
positions, 9 normals, 72 B), the mode's inputs (6 uv corner floats, 3 kd
and the triangle's 5 mip-row floats, 56 B), the coefficient row out (46
floats, 184 B) and 4 meta ints out (16 B): 72 + 56 + 46 * 4 + 16 = 328 B
(``front_roofline.py``'s ``texf_mip`` entry and ``chip_smoke.py``
``FRONT_BYTES``, frozen here). Operations: ~300 a triangle (three corner
transforms, the setup, 9 barycentric and 21 interpolant coefficients).
None where the configuration's front does not run that mode."""

BYTES = 72 + 56 + 46 * 4 + 16
OPS = 300
MIP_FILTERS = ("trilinear", "anisotropic")


def read(ctx):
    if (ctx.config.get("shading") != "textures"
            or ctx.config.get("tex_filter") not in MIP_FILTERS):
        return None
    if ctx.trace is None or not ctx.traced["frames"]:
        return None
    seconds, count = ctx.trace.device_seconds(ctx.layer("front"))
    if not count or seconds <= 0.0:
        return None
    peaks = ctx.peaks()
    T = ctx.config["triangles"]
    bound = max(T * BYTES / peaks["hbm_bytes_per_s"],
                T * OPS / peaks["fp32_ops_per_s"])
    return 100.0 * bound / (seconds / ctx.traced["frames"])

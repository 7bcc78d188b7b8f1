"""The front's share of its roofline: the least time its compulsory work
takes on the card (the larger of its bytes over the HBM rate and its
operations over the float32 rate, ``peaks.json``) over its kernel time a
frame in the traced window, in percent.

Bytes a triangle, whatever the frame culls: the 18 corner floats in (9
positions, 9 normals), the mode's inputs, the coefficient row and 4 meta
ints out; base: 72 + 32 * 4 + 16 = 216 (``chip_smoke.py`` ``FRONT_BYTES``
and the base count beside it, frozen here). Operations: ~300 a triangle
(three corner transforms, the setup, 9 barycentric and 21 interpolant
coefficients)."""

BYTES = {"base": 72 + 32 * 4 + 16, "mat": 72 + 12 + 35 * 4 + 16,
         "texf": 72 + 48 + 44 * 4 + 16, "texf_mip": 72 + 56 + 46 * 4 + 16}
OPS = 300


def read(ctx):
    if ctx.trace is None or not ctx.traced["frames"]:
        return None
    seconds, count = ctx.trace.device_seconds(ctx.layer("front"))
    if not count or seconds <= 0.0:
        return None
    peaks = ctx.peaks()
    T = ctx.config["triangles"]
    bound = max(T * BYTES[ctx.config["shading"]] / peaks["hbm_bytes_per_s"],
                T * OPS / peaks["fp32_ops_per_s"])
    return 100.0 * bound / (seconds / ctx.traced["frames"])

"""The mip texture tail's share of its roofline: the least time
``texture_tail_mip_kernel``'s compulsory work takes on the card (the
larger of its bytes over the HBM rate and its operations over the float32
rate, ``peaks.json``) over that kernel's time a frame in the traced
window, in percent.

Bytes a frame, the planes the tail must read and write at the frame's
size (``chip_smoke.py``'s row-8 bound): every pixel's depth key read and
its 4 B of RGBA written, 8 B; a covered pixel's G-buffer planes read, 10
and 2 a light, 4 B each (56 B with two lights). Covered pixels are not
counted by the program; the textured ones are (``tracing.frame_counts()
["textured"]``), and every textured pixel is covered, so the planes are
counted for those alone: a lower bound. The 8 texel gathers of a textured
pixel (two bilinear taps) are not counted as HBM bytes: neighbouring
pixels share their texels, which the cache serves, so counting them
would put the bound above the kernel's real least time. Operations:
~145 a textured pixel under trilinear (two taps ~60, the epilogue ~45,
~20 a light; ``chip_smoke.py``'s ``stage_ops``). None without the
program's textured count."""

from frame_bench import program

KEY_RGBA_BYTES = 4 + 4
PLANE_BYTES = 4
BASE_PLANES = 10
OPS = 60 + 45 + 20 * 2
KERNEL = "texture_tail_mip_kernel"


def read(ctx):
    counts = program.frame_counts(ctx)
    if not counts or counts.get("textured") is None:
        return None
    if not ctx.traced["frames"]:
        return None
    seconds, n = ctx.trace.device_seconds([KERNEL])
    if not n or seconds <= 0.0:
        return None
    textured = counts["textured"] / counts["frames"]
    planes = BASE_PLANES + 2 * len(ctx.config["lights"])
    nbytes = (ctx.config["width"] * ctx.config["height"] * KEY_RGBA_BYTES
              + textured * planes * PLANE_BYTES)
    peaks = ctx.peaks()
    bound = max(nbytes / peaks["hbm_bytes_per_s"],
                textured * OPS / peaks["fp32_ops_per_s"])
    return 100.0 * bound / (seconds / ctx.traced["frames"])

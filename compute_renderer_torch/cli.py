"""CLI mirroring the reference's flag/subcommand contract (src/main.rs:17-100,
README.md:74-131):

  --width --height --model-path --camera-mode {first-person,orbit}
  --backend-type {custom,wgpu,tpu,xla}
  benchmarks --offset N
  effect --effect {voxelize,edge_melt,mirage,wave,none} --param1..4

Additions: headless frame-loop options (--frames, --output, --duration)
since the renderer is normally driven without a window. The port's
version of the JAX package's CLI, with the same flags, subcommands,
defaults, aliases and error exits, plus ``--device {cuda,cpu}``: the
renderer runs on the card (the default; without one the CLI exits
non-zero with the renderer's error) or, when asked, on the CPU through
the torch twins; ``--web`` (the HTTP viewer) and ``--interactive`` (the
display window; headless when there is no display) render on the same
device.

    python3 -m compute_renderer_torch.cli [--device cpu] ...
"""

from __future__ import annotations

import argparse
import sys

from compute_renderer_torch.core.effects import Effect, WaveDirection
from compute_renderer_torch.engine.scene import CameraConfig, SceneConfig


def _positive_int(value: str) -> int:
    """argparse type: fail at parse time, not deep inside the renderer."""
    n = int(value)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="compute-renderer-tpu",
        description="Runs a 3D scene with configurable parameters "
        "(PyTorch + CUDA port of the TPU-native rebuild of "
        "compute-renderer).",
    )
    from compute_renderer_torch import __version__

    p.add_argument("--version", "-V", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("--width", type=int, default=1024,
                   help="Set the width of the framebuffer (in pixels)")
    p.add_argument("--height", type=int, default=768,
                   help="Set the height of the framebuffer (in pixels)")
    p.add_argument("--model-path", type=str, default="suzanne.obj",
                   help="Specify the path to a 3D model file in .obj format")
    p.add_argument("--camera-mode", type=str, default="first-person",
                   choices=["first-person", "orbit"],
                   help="Choose camera mode: 'first-person' or 'orbit'")
    p.add_argument("--backend-type", type=str, default="custom",
                   help="Select rendering backend: 'custom'/'tpu' (the "
                   "CUDA engine), 'wgpu'/'xla' (the brute-force baseline "
                   "with custom-pipeline semantics), or 'wgpu-faithful' "
                   "(software model of the reference's HARDWARE pipeline: "
                   "sRGB, float depth, no effects, CCW cull)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="Where to render: 'cuda' (the card; an error "
                   "without one) or 'cpu' (the torch twins of the kernels)")
    p.add_argument("--frames", type=int, default=1,
                   help="Number of frames to render headlessly")
    p.add_argument("--output", type=str, default="frame.png",
                   help="Output PNG path (frame index appended for "
                   "--frames>1); a .gif path with --frames>1 writes one "
                   "animated GIF instead (extension)")
    p.add_argument("--interactive", action="store_true",
                   help="Open an interactive viewer window (requires display)")
    p.add_argument("--web", nargs="?", const=8700, type=int, default=None,
                   metavar="PORT",
                   help="Serve the interactive viewer over HTTP on PORT "
                   "(default 8700; 0 picks a free port) — the headless-box "
                   "window: open the printed URL in a browser for live "
                   "frames + keyboard/mouse control (extension)")
    p.add_argument("--materials", action="store_true",
                   help="Resolve MTL diffuse colors into per-triangle "
                   "shading (extension; the reference discards materials)")
    p.add_argument("--textures", action="store_true",
                   help="Decode map_Kd images into a flat atlas and sample "
                   "them at the interpolated uv (extension; implies "
                   "--materials)")
    p.add_argument("--texture-filter", type=str, default="nearest",
                   choices=("nearest", "bilinear", "trilinear", "anisotropic"),
                   help="Atlas filtering for --textures (extension)")
    p.add_argument("--ssaa", type=_positive_int, default=1,
                   help="Supersampled anti-aliasing factor: render at "
                   "SSAA x the output resolution and box-resolve on "
                   "device (extension; 1 = off)")

    sub = p.add_subparsers(dest="command")

    b = sub.add_parser("benchmarks",
                       help="Run performance benchmarks across different scenes")
    b.add_argument("--offset", type=int, default=0,
                   help="Scene index to start benchmarks from (0-7)")
    b.add_argument("--duration", type=float, default=30.0,
                   help="Seconds per benchmark scene")
    b.add_argument("--json", type=str, default=None,
                   help="Write results to this JSON file")
    b.add_argument("--max-frames", type=int, default=None,
                   help="Cap frames per scene (smoke-test mode)")
    b.add_argument("--batch", type=int, default=1,
                   help="Frames per dispatch: 1 = fence every frame (true "
                   "latency), >1 = batched throughput mode (matches the "
                   "reference custom backend's async submits)")

    e = sub.add_parser("effect", help="Apply a visual effect to the scene")
    e.add_argument("--effect", type=str, default="voxelize",
                   help="Choose effect: 'voxelize', 'edge_melt', 'mirage', "
                   "'wave', or 'none'")
    e.add_argument("--param1", type=float, default=3.0,
                   help="Primary effect parameter (varies by effect type)")
    e.add_argument("--param2", type=float, default=0.2,
                   help="Secondary effect parameter (varies by effect type)")
    e.add_argument("--param3", type=float, default=1.0,
                   help="Third effect parameter (for wave & mirage effects)")
    e.add_argument("--param4", type=int, default=0,
                   help="Wave direction (0=Vertical, 1=Horizontal, 2=Radial)")
    return p


def effect_from_args(args) -> Effect | None:
    """Effect construction (reference main.rs:110-147)."""
    if getattr(args, "command", None) != "effect":
        return None
    name = args.effect
    if name == "voxelize":
        return Effect.voxelize(args.param1, args.param2)
    if name == "edge_melt":
        return Effect.edge_melt(args.param1, args.param2)
    if name == "mirage":
        return Effect.mirage(args.param1, args.param2, args.param3)
    if name == "wave":
        directions = {
            0: WaveDirection.VERTICAL,
            1: WaveDirection.HORIZONTAL,
            2: WaveDirection.RADIAL,
        }
        if args.param4 not in directions:
            print(
                f"Invalid wave direction {args.param4}. Use 0 for Vertical, "
                "1 for Horizontal, or 2 for Radial.",
                file=sys.stderr,
            )
            raise SystemExit(1)
        return Effect.wave(args.param1, args.param2, args.param3,
                           directions[args.param4])
    if name == "none":
        return None
    print(
        f"Invalid effect '{name}'. Use 'voxelize', 'edge_melt', 'mirage', "
        "'wave', or 'none'.",
        file=sys.stderr,
    )
    raise SystemExit(1)


def scene_config_from_args(args) -> SceneConfig:
    """Regular-mode scene construction (reference main.rs:233-268)."""
    if args.camera_mode == "first-person":
        camera_config = CameraConfig.first_person(
            # Reference spawns the free camera at the San Miguel pose.
            position=(13.566635, 2.6288567, 10.243919)
        )
    else:
        camera_config = CameraConfig(
            position=(13.566635, 2.6288567, 10.243919)
        )

    backend = args.backend_type
    if backend not in ("custom", "wgpu", "tpu", "xla", "wgpu-faithful"):
        print(
            f"Invalid backend type '{backend}'. "
            "Use 'custom', 'wgpu', 'tpu', 'xla', or 'wgpu-faithful'.",
            file=sys.stderr,
        )
        raise SystemExit(1)

    return SceneConfig(
        model_path=args.model_path,
        camera_config=camera_config,
        backend_type=backend,
        effect=effect_from_args(args),
        enable_materials=getattr(args, "materials", False),
        enable_textures=getattr(args, "textures", False),
        texture_filter=getattr(args, "texture_filter", "nearest"),
        ssaa=getattr(args, "ssaa", 1),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.command == "benchmarks":
        from compute_renderer_torch.bench.suite import run_suite

        try:
            run_suite(
                width=args.width, height=args.height, offset=args.offset,
                duration_secs=args.duration, json_path=args.json,
                max_frames=args.max_frames, batch=args.batch,
                device=args.device,
            )
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        return 0

    config = scene_config_from_args(args)
    if args.web is not None:
        from compute_renderer_torch.app.webview import run_web

        run_web(config, args.width, args.height, port=args.web,
                device=args.device)
        return 0
    if args.interactive:
        from compute_renderer_torch.app.window import run_interactive

        try:
            run_interactive(config, args.width, args.height,
                            device=args.device)
            return 0
        except RuntimeError as e:
            # Docstring contract: fall back to headless when no display.
            print(f"{e} Falling back to headless.", file=sys.stderr)

    from compute_renderer_torch.app.headless import run_headless

    run_headless(config, args.width, args.height, frames=args.frames,
                 output=args.output, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""``python3 -m compute_renderer_torch``: the CLI (``cli.main``)."""

from compute_renderer_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())

"""Asset path resolution (reference src/util.rs:3-30).

The reference searches exe-adjacent ``assets/``, macOS ``../Resources/assets``
and ``CARGO_MANIFEST_DIR/assets`` and panics if missing. We search, in order:

1. the path itself (absolute or cwd-relative),
2. ``$COMPUTE_RENDERER_TPU_ASSETS/<name>``,
3. ``<cwd>/assets/<name>``,
4. ``<repo_root>/assets/<name>`` (package-adjacent),

and raise ``FileNotFoundError`` if none exist.
"""

from __future__ import annotations

import os
from pathlib import Path


def asset_search_dirs() -> list:
    dirs = []
    env = os.environ.get("COMPUTE_RENDERER_TPU_ASSETS")
    if env:
        dirs.append(Path(env))
    dirs.append(Path.cwd() / "assets")
    dirs.append(Path(__file__).resolve().parent.parent.parent / "assets")
    return dirs


def get_asset_path(name: str) -> Path:
    p = Path(name)
    if p.exists():
        return p
    for d in asset_search_dirs():
        candidate = d / name
        if candidate.exists():
            return candidate
    raise FileNotFoundError(
        f"Asset '{name}' not found. Searched: {[str(d) for d in asset_search_dirs()]}"
    )

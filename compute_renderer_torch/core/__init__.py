"""Pure math & state types: cameras, lights, effects, screen transforms.

Mirrors the reference's scene/domain layer (reference src/camera.rs,
src/scene.rs, src/effect.rs, src/vertex.rs) as plain dataclasses + numpy
math. Everything here is host-side-cheap and feeds the per-frame render step
as a packed uniform buffer.
"""

from compute_renderer_torch.core.camera import (  # noqa: F401
    Camera,
    CameraMode,
    CameraUniform,
)
from compute_renderer_torch.core.effects import (  # noqa: F401
    Effect,
    EffectUniform,
    WaveDirection,
    EFFECT_NONE,
    EFFECT_WAVE,
    EFFECT_EDGE_MELT,
    EFFECT_VOXELIZE,
    EFFECT_MIRAGE,
)
from compute_renderer_torch.core.lights import Light  # noqa: F401
from compute_renderer_torch.core.types import ScreenConfig, Mesh  # noqa: F401

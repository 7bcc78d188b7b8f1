"""Engine: scene/domain model + per-frame update + the render step."""

from compute_renderer_torch.engine.scene import (  # noqa: F401
    CameraConfig,
    FrameUniforms,
    Scene,
    SceneConfig,
)
from compute_renderer_torch.engine.renderer import Renderer  # noqa: F401

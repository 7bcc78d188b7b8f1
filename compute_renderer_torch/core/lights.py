"""Lights (reference src/scene.rs:10-32).

A light is a point light with world position, view-space position (recomputed
each frame from the camera view matrix — reference src/scene.rs:149-154),
color, and intensity. Note: the reference's fragment shader uses
``world_position`` for shading (fragment.wgsl:76) — ``view_position`` is
computed and uploaded but dead in the lighting formula. We keep the field for
API parity and fill it identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from compute_renderer_torch.core.maths import F32


@dataclass
class Light:
    world_position: np.ndarray = field(
        default_factory=lambda: np.array([5.0, 5.0, 5.0], dtype=F32)
    )
    view_position: np.ndarray = field(
        default_factory=lambda: np.zeros(3, dtype=F32)
    )
    color: np.ndarray = field(
        default_factory=lambda: np.array([1.0, 1.0, 1.0], dtype=F32)
    )
    intensity: float = 1.0

    @staticmethod
    def make(position, color, intensity: float) -> "Light":
        return Light(
            world_position=np.asarray(position, dtype=F32),
            view_position=np.zeros(3, dtype=F32),
            color=np.asarray(color, dtype=F32),
            intensity=float(intensity),
        )


def pack_lights(lights: list) -> tuple:
    """SoA pack for the device: (world_pos (L,3), color (L,3), intensity (L,)).

    The packed arrays are f32; at least one light slot is always present so the
    jitted kernels see a static non-zero light axis (intensity 0 for padding).
    """
    if len(lights) == 0:
        return (
            np.zeros((1, 3), dtype=F32),
            np.zeros((1, 3), dtype=F32),
            np.zeros((1,), dtype=F32),
        )
    wp = np.stack([l.world_position for l in lights]).astype(F32)
    col = np.stack([l.color for l in lights]).astype(F32)
    inten = np.array([l.intensity for l in lights], dtype=F32)
    return wp, col, inten

"""Animated vertex/pixel effects: wave, edge-melt, voxelize, mirage.

Behavioral contract from the reference (src/effect.rs):

- Four effects with per-effect parameter structs (effect.rs:3-48).
- ``update(dt)`` advances phase/time (effect.rs:99-124). Voxelize animates
  ``voxel_size = (sin(time - pi/2) + 1) / 2`` with ``time += dt * speed``
  (effect.rs:111-117).
- Edge-melt amplitude is clamped to [0, 0.33] at construction (effect.rs:75).
- The packed uniform is ``{effect_type: u32, param1..4: f32, time: f32}``
  with type codes 0=none, 1=wave, 2=edge_melt, 3=voxelize, 4=mirage
  (effect.rs:126-185).

Where each effect acts in the pipeline (device side):
- wave: vertex stage world-position displacement (binning.wgsl:144-161);
- edge_melt: raster-stage pixel discard on min barycentric (rasteriser.wgsl:136-145);
- voxelize: disables backface culling (binning.wgsl:119) and inflates
  triangles via a negative barycentric threshold (rasteriser.wgsl:127-134);
- mirage: raster-stage sample-position warp (rasteriser.wgsl:112-118).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from compute_renderer_torch.core.maths import F32

EFFECT_NONE = 0
EFFECT_WAVE = 1
EFFECT_EDGE_MELT = 2
EFFECT_VOXELIZE = 3
EFFECT_MIRAGE = 4


class WaveDirection(enum.Enum):
    VERTICAL = 0
    HORIZONTAL = 1
    RADIAL = 2


@dataclass
class EffectUniform:
    """Packed per-frame effect uniform (reference src/effect.rs:126-150)."""

    effect_type: int = EFFECT_NONE
    param1: float = 0.0
    param2: float = 0.0
    param3: float = 0.0
    param4: float = 0.0
    time: float = 0.0

    def as_array(self) -> np.ndarray:
        """(6,) f32 array: [effect_type, param1..4, time] — the device-side
        uniform layout (effect_type stored as float; it is only compared
        against small integer codes)."""
        return np.array(
            [
                float(self.effect_type),
                self.param1,
                self.param2,
                self.param3,
                self.param4,
                self.time,
            ],
            dtype=F32,
        )


@dataclass
class Effect:
    """Host-side animated effect state. Factory constructors and update
    semantics mirror reference src/effect.rs:63-124."""

    kind: int  # EFFECT_* code
    amplitude: float = 0.0
    frequency: float = 0.0
    phase: float = 0.0
    speed: float = 0.0
    direction: WaveDirection = WaveDirection.VERTICAL
    voxel_size: float = 0.0
    time: float = 0.0

    # -- factories (reference effect.rs:63-96) -------------------------------

    @staticmethod
    def wave(amplitude: float, frequency: float, speed: float,
             direction: WaveDirection) -> "Effect":
        return Effect(kind=EFFECT_WAVE, amplitude=amplitude, frequency=frequency,
                      phase=0.0, speed=speed, direction=direction)

    @staticmethod
    def edge_melt(amplitude: float, speed: float) -> "Effect":
        # amplitude clamped to [0, 0.33] (reference effect.rs:75)
        return Effect(kind=EFFECT_EDGE_MELT,
                      amplitude=float(np.clip(amplitude, 0.0, 0.33)),
                      phase=0.0, speed=speed)

    @staticmethod
    def voxelize(voxel_size: float, speed: float) -> "Effect":
        return Effect(kind=EFFECT_VOXELIZE, voxel_size=voxel_size, speed=speed,
                      time=0.0)

    @staticmethod
    def mirage(amplitude: float, frequency: float, speed: float) -> "Effect":
        return Effect(kind=EFFECT_MIRAGE, amplitude=amplitude,
                      frequency=frequency, phase=0.0, speed=speed)

    # -- per-frame update (reference effect.rs:99-124) ------------------------

    def update(self, dt: float) -> None:
        if self.kind in (EFFECT_WAVE, EFFECT_EDGE_MELT, EFFECT_MIRAGE):
            self.phase += dt * self.speed
        elif self.kind == EFFECT_VOXELIZE:
            self.time += dt * self.speed
            t = (np.sin(F32(self.time) - F32(np.pi / 2)) + 1.0) * 0.5
            self.voxel_size = float(t * 1.0)

    # -- uniform packing (reference effect.rs:152-184) ------------------------

    def uniform(self, scene_time: float) -> EffectUniform:
        u = EffectUniform(time=scene_time)
        if self.kind == EFFECT_WAVE:
            u.effect_type = EFFECT_WAVE
            u.param1 = self.amplitude
            u.param2 = self.frequency
            u.param3 = self.phase
            u.param4 = float(self.direction.value)
        elif self.kind == EFFECT_EDGE_MELT:
            u.effect_type = EFFECT_EDGE_MELT
            u.param1 = self.amplitude
            u.param2 = self.phase
        elif self.kind == EFFECT_VOXELIZE:
            u.effect_type = EFFECT_VOXELIZE
            u.param1 = self.voxel_size
        elif self.kind == EFFECT_MIRAGE:
            u.effect_type = EFFECT_MIRAGE
            u.param1 = self.amplitude
            u.param2 = self.frequency
            u.param3 = self.phase
            u.param4 = self.speed
        return u

"""Scene / SceneConfig: the reference's domain model as pure dataclasses.

Reference: src/scene.rs. One deliberate architectural fix: the reference's
``Scene::update_buffers`` writes directly into the custom renderer's GPU
buffers (scene.rs:132-188, a cross-layer coupling flagged in SURVEY.md §1);
here ``Scene.update(dt)`` is pure — it advances host-side state and returns a
``FrameUniforms`` record that the renderer's per-frame step consumes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from compute_renderer_torch import tracing
from compute_renderer_torch.core import maths
from compute_renderer_torch.core.camera import Camera, CameraMode, CameraUniform
from compute_renderer_torch.core.effects import (
    EFFECT_NONE,
    Effect,
    EffectUniform,
)
from compute_renderer_torch.core.lights import Light, pack_lights
from compute_renderer_torch.core.maths import F32
from compute_renderer_torch.io.model import Model


@dataclass
class CameraConfig:
    """Reference src/scene.rs:243-276."""

    distance: float = 4.0
    theta: float = 0.0
    phi: float = 0.0
    target: tuple = (0.0, 0.0, 0.0)
    mode: CameraMode = CameraMode.ORBIT
    position: tuple = (0.0, 2.0, 5.0)

    @staticmethod
    def first_person(position=(0.0, 0.0, 0.0)) -> "CameraConfig":
        return CameraConfig(distance=0.0, mode=CameraMode.FIRST_PERSON,
                            position=tuple(position))


def _default_lights():
    """Reference default: warm key light at origin + cool fill
    (src/scene.rs:229-236)."""
    return [
        ((0.0, 0.0, 0.0), (1.0, 0.9, 0.8), 1.0),
        ((-5.0, 3.0, 0.0), (0.3, 0.4, 0.5), 0.5),
    ]


@dataclass
class SceneConfig:
    """Reference src/scene.rs:204-241. ``backend_type`` accepts the port's
    names ('cuda', 'xla', 'wgpu-faithful'), the JAX package's ('tpu' ->
    cuda) and the reference's ('custom' -> cuda, 'wgpu' -> xla)."""

    model_path: str = "suzanne.obj"
    lights: list = field(default_factory=_default_lights)
    effect: Optional[Effect] = None
    camera_config: CameraConfig = field(default_factory=CameraConfig)
    benchmark_duration_secs: Optional[float] = None  # None = endless (u64::MAX)
    backend_type: str = "cuda"
    # Material extension (beyond the reference, which discards MTL data,
    # model.rs:24): resolve MTL diffuse colors into per-triangle shading.
    enable_materials: bool = False
    # Texture extension (implies materials): decode map_Kd images into the
    # flat atlas and sample them at the interpolated uv.
    enable_textures: bool = False
    # Atlas filtering for the texture extension:
    # "nearest" | "bilinear" | "trilinear" (mipmapped).
    texture_filter: str = "nearest"
    # SSAA extension: render at ssaa x the output resolution, box-resolve
    # on device (1 = off; the reference has no anti-aliasing).
    ssaa: int = 1

    def scene_name(self) -> str:
        mat = (" +textures" if self.enable_textures
               else " +materials" if self.enable_materials else "")
        if self.enable_textures and self.texture_filter != "nearest":
            mat += f" +{self.texture_filter}"
        if self.ssaa != 1:
            mat += f" +ssaa{self.ssaa}"
        return (f"Scene {self.model_path} - "
                f"{self.normalized_backend()} Pipeline{mat}")

    def normalized_backend(self) -> str:
        from compute_renderer_torch.backends import normalize_backend

        return normalize_backend(self.backend_type)


@dataclass
class FrameUniforms:
    """The per-frame uniforms crossing into the render step — the
    equivalent of the reference's camera/light/effect UBO writes
    (scene.rs:156-186)."""

    view_position: np.ndarray  # (4,) f32
    view_proj: np.ndarray  # (4,4) f32
    light_world_pos: np.ndarray  # (L,3) f32
    light_color: np.ndarray  # (L,3) f32
    light_intensity: np.ndarray  # (L,) f32
    effect: np.ndarray  # (6,) f32


class Scene:
    """Host-side scene state (reference src/scene.rs:34-201)."""

    def __init__(self):
        self.models: list = []
        self.cameras: list = []
        self.active_camera: Optional[int] = None
        self.lights: list = []
        self.effect: Optional[Effect] = None
        self.time: float = 0.0
        self.total_tris: int = 0
        self.texture_filter: str = "nearest"
        self.ssaa: int = 1

    @staticmethod
    def from_config(config: SceneConfig, width: int, height: int) -> "Scene":
        """Reference Scene::from_config (scene.rs:62-95)."""
        scene = Scene()
        scene.add_model(Model.load(config.model_path,
                                   materials=config.enable_materials,
                                   textures=config.enable_textures))
        for (position, color, intensity) in config.lights:
            scene.add_light(position, color, intensity)
        scene.effect = config.effect
        scene.texture_filter = config.texture_filter
        scene.ssaa = config.ssaa
        aspect = width / height
        cc = config.camera_config
        if cc.mode is CameraMode.FIRST_PERSON:
            camera = Camera.first_person(cc.position, aspect)
        else:
            camera = Camera.orbit(cc.distance, cc.theta, cc.phi, cc.target, aspect)
        scene.add_camera(camera)
        scene.set_active_camera(0)
        return scene

    # -- mutation API mirroring the reference --------------------------------

    def add_model(self, model: Model) -> int:
        self.models.append(model)
        self.total_tris = sum(m.num_triangles for m in self.models)
        return len(self.models) - 1

    def add_light(self, position, color, intensity: float) -> int:
        self.lights.append(Light.make(position, color, intensity))
        return len(self.lights) - 1

    def add_camera(self, camera: Camera) -> None:
        self.cameras.append(camera)

    def set_active_camera(self, index: int) -> None:
        self.active_camera = index

    def get_active_camera(self) -> Optional[Camera]:
        if self.active_camera is None:
            return None
        return self.cameras[self.active_camera]

    @property
    def mesh(self):
        """Concatenated geometry of all models."""
        from compute_renderer_torch.core.types import Mesh

        if len(self.models) == 1:
            return self.models[0].mesh
        return Mesh.concatenate([m.mesh for m in self.models])

    def renderer_options(self) -> dict:
        """Static Renderer options derived from the scene: the effect KIND
        is fixed per SceneConfig (only its parameters animate), which lets
        the renderer tune the tile shape of scenes whose effect keeps
        coverage inside each triangle."""
        kind = self.effect.kind if self.effect is not None else EFFECT_NONE
        opts = {"effect_kind": int(kind)}
        if self.texture_filter != "nearest":
            opts["tex_filter"] = self.texture_filter
        if self.ssaa != 1:
            opts["ssaa"] = self.ssaa
        return opts

    # -- per-frame update (pure w.r.t. device state) -------------------------

    def update(self, dt: float) -> FrameUniforms:
        """Advance time/effect/light state and produce the frame uniforms
        (reference Scene::update_buffers semantics, scene.rs:132-188, minus
        the direct buffer writes), in the span ``scene.update``."""
        with tracing.span("scene.update"):
            self.time += dt
            if self.effect is not None:
                self.effect.update(dt)

            camera = self.get_active_camera()
            if camera is not None:
                cam_uniform = camera.uniform()
                # Lights world -> view by the view matrix (scene.rs:149-154).
                # (Dead in the reference's shading formula; kept for parity.)
                view = camera.build_view_matrix()
                for light in self.lights:
                    light.view_position = maths.transform_point3(
                        view, light.world_position
                    )
            else:
                cam_uniform = CameraUniform.identity()

            lwp, lc, li = pack_lights(self.lights)
            eff = (
                self.effect.uniform(self.time)
                if self.effect is not None
                else EffectUniform()
            )
            return FrameUniforms(
                view_position=cam_uniform.view_position,
                view_proj=cam_uniform.view_proj,
                light_world_pos=lwp,
                light_color=lc,
                light_intensity=li,
                effect=eff.as_array(),
            )

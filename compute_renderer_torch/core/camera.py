"""Camera: orbit + first-person modes, view/projection construction.

Behavioral contract from the reference (src/camera.rs):

- Projection: RH look_at + perspective, FOVY = pi/2, znear 0.1, zfar 10000
  (camera.rs:51-53, 91-95).
- Orbit mode: yaw (degrees) advances ``dt * orbit_speed * 57.2958`` per
  second; eye on a sphere of ``orbit_distance`` around ``target``
  (camera.rs:179-201).
- First-person mode: WASD/Space/C movement with Shift 10x sprint, ``[``/``]``
  speed trim; mouse yaw/pitch with pitch clamped to +/-89 degrees
  (camera.rs:97-173).
- ``CameraUniform { view_position: vec4, view_proj: mat4 }`` (camera.rs:6-27).

Camera state lives host-side (it's driven by wall-clock input); only the
resulting uniform (eye position + view-proj matrix) crosses into the jitted
render step each frame.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from compute_renderer_torch.core import maths
from compute_renderer_torch.core.maths import F32

ZFAR = 10000.0
ZNEAR = 0.1
FOVY = float(np.pi) / 2.0
UP = np.array([0.0, 1.0, 0.0], dtype=F32)


class CameraMode(enum.Enum):
    ORBIT = "orbit"
    FIRST_PERSON = "first-person"


@dataclass
class CameraUniform:
    """Per-frame camera uniform handed to the render step.

    Mirrors the reference's ``CameraUniform`` (src/camera.rs:8-11):
    ``view_position`` is the eye with w=1, ``view_proj = proj * view``.
    """

    view_position: np.ndarray  # (4,) f32
    view_proj: np.ndarray  # (4, 4) f32, applied as M @ v

    @staticmethod
    def identity() -> "CameraUniform":
        return CameraUniform(
            view_position=np.zeros(4, dtype=F32),
            view_proj=np.eye(4, dtype=F32),
        )


@dataclass
class Camera:
    mode: CameraMode = CameraMode.ORBIT
    eye: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=F32))
    target: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=F32))
    up: np.ndarray = field(default_factory=lambda: UP.copy())
    aspect: float = 4.0 / 3.0
    yaw: float = 0.0  # degrees
    pitch: float = 0.0  # degrees
    movement_speed: float = 5.0
    mouse_sensitivity: float = 0.1
    orbit_speed: float = 0.5
    orbit_distance: float = 0.0

    # -- constructors matching reference factories ---------------------------

    @staticmethod
    def orbit(distance: float, theta: float, phi: float, target, aspect: float) -> "Camera":
        """Orbit camera (reference Camera::new, src/camera.rs:56-73)."""
        cam = Camera(
            mode=CameraMode.ORBIT,
            target=np.asarray(target, dtype=F32),
            aspect=aspect,
            yaw=theta,
            pitch=phi,
            orbit_distance=distance,
        )
        cam._update_orbit_position()
        return cam

    @staticmethod
    def first_person(position, aspect: float) -> "Camera":
        """First-person camera (reference Camera::new_first_person,
        src/camera.rs:75-89). Initial facing is -Z (yaw = -90 deg)."""
        position = np.asarray(position, dtype=F32)
        return Camera(
            mode=CameraMode.FIRST_PERSON,
            eye=position.copy(),
            target=(position - np.array([0, 0, 1], dtype=F32)),
            aspect=aspect,
            yaw=-90.0,
            pitch=0.0,
        )

    # -- matrices -------------------------------------------------------------

    def build_view_matrix(self) -> np.ndarray:
        return maths.look_at_rh(self.eye, self.target, self.up)

    def build_view_projection_matrix(self) -> np.ndarray:
        view = maths.look_at_rh(self.eye, self.target, self.up)
        proj = maths.perspective_rh(FOVY, self.aspect, ZNEAR, ZFAR)
        return (proj.astype(F32) @ view.astype(F32)).astype(F32)

    def uniform(self) -> CameraUniform:
        return CameraUniform(
            view_position=np.array(
                [self.eye[0], self.eye[1], self.eye[2], 1.0], dtype=F32
            ),
            view_proj=self.build_view_projection_matrix(),
        )

    # -- per-frame updates ----------------------------------------------------

    def update_over_time(self, dt: float) -> None:
        """Orbit advance (reference src/camera.rs:179-189): yaw +=
        dt * orbit_speed * 57.2958 (deg), wrapped at 360."""
        if self.mode is CameraMode.ORBIT:
            self.yaw += dt * self.orbit_speed * 57.2958
            if self.yaw >= 360.0:
                self.yaw -= 360.0
            self._update_orbit_position()

    def process_keyboard(self, keys_down: set, dt: float) -> None:
        """First-person movement (reference src/camera.rs:97-150).

        ``keys_down`` is a set of key names: 'w','a','s','d','space','c',
        'shift', '[', ']', 'p'.
        """
        if self.mode is not CameraMode.FIRST_PERSON:
            return
        speed_increment = 5.0 * dt
        if "]" in keys_down:
            self.movement_speed += speed_increment
        if "[" in keys_down:
            self.movement_speed = max(self.movement_speed - speed_increment, 0.0)

        velocity = self.movement_speed * dt * (10.0 if "shift" in keys_down else 1.0)
        front = maths.normalize(self.target - self.eye)
        right_vec = maths.normalize(maths.cross(front, self.up))

        movement = np.zeros(3, dtype=F32)
        if "w" in keys_down:
            movement += front
        if "s" in keys_down:
            movement -= front
        if "d" in keys_down:
            movement += right_vec
        if "a" in keys_down:
            movement -= right_vec
        if "space" in keys_down:
            movement += np.array([0, 1, 0], dtype=F32)
        if "c" in keys_down:
            movement -= np.array([0, 1, 0], dtype=F32)
        if "p" in keys_down:
            print(f"Camera position: {self.eye}")
            print(f"Camera target: {self.target}")

        if np.any(movement != 0):
            movement = maths.normalize(movement) * F32(velocity)
            self.eye = (self.eye + movement).astype(F32)
            self.target = (self.target + movement).astype(F32)

    def process_mouse(self, x_offset: float, y_offset: float) -> None:
        """First-person mouse look (reference src/camera.rs:152-173)."""
        if self.mode is not CameraMode.FIRST_PERSON:
            return
        self.yaw += x_offset * self.mouse_sensitivity
        self.pitch += y_offset * self.mouse_sensitivity
        self.pitch = float(np.clip(self.pitch, -89.0, 89.0))

        pitch_rad = maths.to_radians(self.pitch)
        yaw_rad = maths.to_radians(self.yaw)
        front = maths.normalize(
            np.array(
                [
                    np.cos(yaw_rad) * np.cos(pitch_rad),
                    np.sin(pitch_rad),
                    np.sin(yaw_rad) * np.cos(pitch_rad),
                ],
                dtype=F32,
            )
        )
        self.target = (self.eye + front).astype(F32)

    def set_aspect_ratio(self, aspect: float) -> None:
        self.aspect = aspect

    def _update_orbit_position(self) -> None:
        pitch_cos = F32(np.cos(maths.to_radians(self.pitch)))
        x = F32(self.orbit_distance) * F32(np.cos(maths.to_radians(self.yaw))) * pitch_cos
        y = F32(self.orbit_distance) * F32(np.sin(maths.to_radians(self.pitch)))
        z = F32(self.orbit_distance) * F32(np.sin(maths.to_radians(self.yaw))) * pitch_cos
        self.eye = (np.array([x, y, z], dtype=F32) + self.target).astype(F32)

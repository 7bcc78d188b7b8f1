"""The camera paths of the traffic mixes, and the camera arithmetic that
turns a pose into the frame's matrices.

The arithmetic is a frozen copy of the reference renderer's camera
(src/camera.rs: glam's ``look_at_rh`` and ``perspective_rh``, FOVY pi/2,
znear 0.1, zfar 10000; first-person WASD movement and mouse look; the
orbit advance) in float32 NumPy, the same operations in the same order as
the port's ``core/camera.py`` and ``core/maths.py``, so a pose gives the
same matrix on both sides. The harness drives the program's camera with
the same inputs (mouse offsets, keys, ticks); the reference works the
pose out here, from the inputs alone.

Paths, each a function of the mix's parameters and the seed:

- ``LookAround``: from the spawn, the view swings ``yaw_deg`` and
  ``pitch_deg`` on an ellipse with a period of ``period_s`` of scene time;
  the seed sets the phase and the direction, so every seed sees the same
  poses in another order;
- ``Walk``: from the spawn, segments of keys held and mouse turns, looped
  (the camera returns to the spawn at the start of each period); the seed
  sets the phase;
- ``Orbit``: the orbit camera around the configuration's target at its
  distance; the seed sets the starting yaw.
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32
ZFAR = 10000.0
ZNEAR = 0.1
FOVY = float(np.pi) / 2.0
UP = np.array([0.0, 1.0, 0.0], dtype=F32)
MOUSE_SENSITIVITY = 0.1
MOVEMENT_SPEED = 5.0
# Degrees a second of orbit per unit of orbit speed (camera.rs:179-189).
ORBIT_DEG = 57.2958


def normalize(v):
    v = v.astype(F32)
    n = F32(np.sqrt(F32(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])))
    return (v / n).astype(F32)


def cross(a, b):
    a = a.astype(F32)
    b = b.astype(F32)
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], dtype=F32)


def dot(a, b):
    a = a.astype(F32)
    b = b.astype(F32)
    return F32(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def to_radians(deg):
    return F32(np.deg2rad(np.asarray(deg, dtype=F32)))


def look_at_rh(eye, center, up):
    eye = np.asarray(eye, dtype=F32)
    center = np.asarray(center, dtype=F32)
    up = np.asarray(up, dtype=F32)
    f = normalize(center - eye)
    s = normalize(cross(f, up))
    u = cross(s, f)
    m = np.zeros((4, 4), dtype=F32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -dot(s, eye)
    m[1, 3] = -dot(u, eye)
    m[2, 3] = dot(f, eye)
    m[3, 3] = F32(1.0)
    return m


def perspective_rh(fovy, aspect, znear, zfar):
    fovy, aspect, znear, zfar = F32(fovy), F32(aspect), F32(znear), F32(zfar)
    sin_fov = F32(np.sin(F32(0.5) * fovy))
    cos_fov = F32(np.cos(F32(0.5) * fovy))
    h = F32(cos_fov / sin_fov)
    w = F32(h / aspect)
    r = F32(zfar / (znear - zfar))
    m = np.zeros((4, 4), dtype=F32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = F32(r * znear)
    m[3, 2] = F32(-1.0)
    return m


class Pose:
    """A camera: ``eye`` and ``target`` (float32), ``yaw`` and ``pitch`` in
    degrees (Python floats), and the orbit's distance where it orbits."""

    def __init__(self, eye, target, yaw, pitch, distance=0.0):
        self.eye = np.asarray(eye, dtype=F32)
        self.target = np.asarray(target, dtype=F32)
        self.yaw = yaw
        self.pitch = pitch
        self.distance = distance

    @staticmethod
    def first_person(position):
        position = np.asarray(position, dtype=F32)
        return Pose(position.copy(), position - np.array([0, 0, 1], dtype=F32),
                    -90.0, 0.0)

    @staticmethod
    def orbit(distance, yaw, pitch, target):
        pose = Pose(np.zeros(3, dtype=F32), target, yaw, pitch, distance)
        pose._orbit_eye()
        return pose

    def mouse(self, dx, dy):
        self.yaw += dx * MOUSE_SENSITIVITY
        self.pitch += dy * MOUSE_SENSITIVITY
        self.pitch = float(np.clip(self.pitch, -89.0, 89.0))
        pr = to_radians(self.pitch)
        yr = to_radians(self.yaw)
        front = normalize(np.array([np.cos(yr) * np.cos(pr), np.sin(pr),
                                    np.sin(yr) * np.cos(pr)], dtype=F32))
        self.target = (self.eye + front).astype(F32)

    def keys(self, held, dt):
        """First-person movement at the default speed, no sprint or trim."""
        velocity = MOVEMENT_SPEED * dt * 1.0
        front = normalize(self.target - self.eye)
        right = normalize(cross(front, UP))
        movement = np.zeros(3, dtype=F32)
        if "w" in held:
            movement += front
        if "s" in held:
            movement -= front
        if "d" in held:
            movement += right
        if "a" in held:
            movement -= right
        if np.any(movement != 0):
            movement = normalize(movement) * F32(velocity)
            self.eye = (self.eye + movement).astype(F32)
            self.target = (self.target + movement).astype(F32)

    def advance_orbit(self, dt, speed):
        self.yaw += dt * speed * ORBIT_DEG
        if self.yaw >= 360.0:
            self.yaw -= 360.0
        self._orbit_eye()

    def _orbit_eye(self):
        pc = F32(np.cos(to_radians(self.pitch)))
        d = F32(self.distance)
        x = d * F32(np.cos(to_radians(self.yaw))) * pc
        y = d * F32(np.sin(to_radians(self.pitch)))
        z = d * F32(np.sin(to_radians(self.yaw))) * pc
        self.eye = (np.array([x, y, z], dtype=F32) + self.target).astype(F32)

    def matrices(self, aspect):
        """(view_position (4,), view_proj (4, 4)), float32."""
        view = look_at_rh(self.eye, self.target, UP)
        proj = perspective_rh(FOVY, aspect, ZNEAR, ZFAR)
        vp = (proj.astype(F32) @ view.astype(F32)).astype(F32)
        vpos = np.array([self.eye[0], self.eye[1], self.eye[2], 1.0],
                        dtype=F32)
        return vpos, vp


def _rng(seed):
    return np.random.default_rng(int(seed))


class LookAround:
    """Frame ``j`` shows pose ``(phase + direction * j) mod period``; pose
    ``i`` is the spawn turned by the mouse offsets ``offsets[i]``."""

    def __init__(self, params, camera, dt, seed):
        self.period = int(round(params["period_s"] / dt))
        rng = _rng(seed)
        self.phase = int(rng.integers(self.period))
        self.direction = 1 if rng.integers(2) else -1
        self.spawn = camera["spawn"]
        a = 2.0 * math.pi * np.arange(self.period) / self.period
        self.offsets = [
            (float(params["yaw_deg"] * math.sin(x) / MOUSE_SENSITIVITY),
             float(params["pitch_deg"] * math.cos(x) / MOUSE_SENSITIVITY))
            for x in a]

    def pose_index(self, j):
        return (self.phase + self.direction * j) % self.period

    def pose(self, i):
        pose = Pose.first_person(self.spawn)
        pose.mouse(*self.offsets[i])
        return pose


class Walk:
    """Tick ``g`` of the run: the camera is reset to the spawn at every
    ``g`` that is a multiple of the period, then each tick applies that
    tick's mouse offset (if any) and keys. ``phase`` is the seeded count of
    ticks by which set-up advances the camera, unrendered, before the
    timed loop."""

    def __init__(self, params, camera, dt, seed):
        self.dt = dt
        self.spawn = camera["spawn"]
        self.inputs = []  # (mouse dx or None, keys) a tick
        for seg in params["segments"]:
            n = int(seg["ticks"])
            dx = (float(seg["turn_deg"]) / n / MOUSE_SENSITIVITY
                  if seg.get("turn_deg") else None)
            self.inputs += [(dx, frozenset(seg.get("keys", ())))] * n
        self.period = len(self.inputs)
        self.phase = int(_rng(seed).integers(self.period))

    def tick(self, g):
        """(reset, mouse dx or None, keys) of tick ``g``: ``reset`` puts the
        camera back at the spawn before the tick's inputs."""
        dx, keys = self.inputs[g % self.period]
        return g % self.period == 0, dx, keys

    def step(self, pose, g):
        """The pose after tick ``g``, from the pose after tick ``g - 1``."""
        reset, dx, keys = self.tick(g)
        if reset:
            pose = Pose.first_person(self.spawn)
        if dx is not None:
            pose.mouse(dx, 0.0)
        pose.keys(keys, self.dt)
        return pose

    def poses(self, ticks):
        """{g: pose after tick g} for the ticks asked."""
        out = {}
        for g in set(ticks):
            pose = None
            for k in range(g - g % self.period, g + 1):
                pose = self.step(pose, k)
            out[g] = pose
        return out


class Orbit:
    """Tick ``g`` of the run: the orbit camera advanced ``g + 1`` times from
    the seeded starting yaw."""

    def __init__(self, params, camera, dt, seed):
        self.dt = dt
        self.speed = float(params["speed"])
        self.distance = float(camera["orbit_distance"])
        self.target = camera.get("orbit_target", (0.0, 0.0, 0.0))
        self.yaw0 = float(_rng(seed).uniform(0.0, 360.0))
        self.phase = 0
        # Ticks of one revolution.
        self.period = int(math.ceil(360.0 / (dt * self.speed * ORBIT_DEG)))

    def start(self):
        return Pose.orbit(self.distance, self.yaw0, 0.0, self.target)

    def tick(self, g):
        """(reset, mouse dx, keys) of tick ``g``: the orbit only advances."""
        return False, None, frozenset()

    def step(self, pose, g):
        pose = self.start() if pose is None else pose
        pose.advance_orbit(self.dt, self.speed)
        return pose

    def poses(self, ticks):
        """{g: pose} for the ticks asked, walking the orbit once."""
        want = set(ticks)
        out = {}
        pose = None
        for g in range(max(want) + 1 if want else 0):
            pose = self.step(pose, g)
            if g in want:
                out[g] = Pose(pose.eye.copy(), pose.target.copy(), pose.yaw,
                              pose.pitch, pose.distance)
        return out


def interactive_path(params, camera, dt, seed):
    """The viewer mix's path: the configuration names its interactive
    camera (``"walk"`` from the spawn or ``"orbit"``)."""
    kind = camera["interactive"]
    cls = {"walk": Walk, "orbit": Orbit}[kind]
    return cls(params[kind], camera, dt, seed)

"""3D cameras.

Host-side pure-python matrix builders matching the reference's camera suite
(reference: src/camera/mod.rs `D3Camera` trait; src/camera/d3orbit.rs;
src/camera/d3firstp.rs; src/camera/d3iso.rs). Matrix conventions follow
ops/matrices.py (row-major, column vectors).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .batch import _cross3

from ..ops.matrices import look_at_rh, perspective_fov_rh_zo


@dataclass
class Ray:
    origin: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    dir: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))

    def at(self, t: float) -> np.ndarray:
        return self.origin + self.dir * t


class D3Camera:
    """Base camera interface (reference src/camera/mod.rs:9-72)."""

    def id(self) -> str:
        return ""

    def position(self) -> np.ndarray:
        return np.zeros(3, np.float32)

    def fov(self) -> float:
        return 1.0

    def view_matrix(self) -> np.ndarray:
        return np.eye(4, dtype=np.float32)

    def projection_matrix(self, width: float, height: float) -> np.ndarray:
        raise NotImplementedError

    def basis_vectors(self):
        raise NotImplementedError

    # Parameter get/set by string key mirrors the reference's dynamic API.
    def set_parameter_f32(self, key: str, value: float) -> None:
        pass

    def set_parameter_vec2(self, key: str, value) -> None:
        pass

    def set_parameter_vec3(self, key: str, value) -> None:
        pass

    def rotate(self, delta) -> None:
        pass

    def zoom(self, delta: float) -> None:
        pass

    def create_ray(self, uv, screen, offset) -> Ray:
        return Ray()


def _perspective_ray(position, forward, up_hint, fov_deg, uv, screen, offset) -> Ray:
    """Shared pinhole ray builder (reference src/camera/d3orbit.rs:117-160)."""
    aspect = screen[0] / screen[1]
    pixel_size = (1.0 / screen[0], 1.0 / screen[1])
    u, v = uv[0], 1.0 - uv[1]

    forward = np.asarray(forward, np.float32)
    right = _cross3(forward, up_hint)
    if float(np.dot(right, right)) < 1e-12:
        right = np.array([1.0, 0.0, 0.0], np.float32)
    right = right / np.linalg.norm(right)
    up = _cross3(right, forward)
    up = up / np.linalg.norm(up)

    half_height = math.tan(math.radians(fov_deg) * 0.5)
    half_width = half_height * aspect

    ndc_x = (pixel_size[0] * offset[0] + u) * 2.0 - 1.0
    ndc_y = (pixel_size[1] * offset[1] + v) * 2.0 - 1.0

    d = forward + right * (ndc_x * half_width) - up * (ndc_y * half_height)
    d = d / np.linalg.norm(d)
    return Ray(np.asarray(position, np.float32), d.astype(np.float32))


@dataclass
class D3OrbitCamera(D3Camera):
    """Orbiting camera on a spherical mount (reference src/camera/d3orbit.rs)."""

    center: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    distance: float = 20.0
    azimuth: float = math.pi / 2.0
    elevation: float = 0.698
    up: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    fov: float = 75.0
    near: float = 0.01
    far: float = 100.0

    def id(self) -> str:
        return "orbit"

    def eye_position(self) -> np.ndarray:
        x = self.distance * math.cos(self.azimuth) * math.cos(self.elevation)
        y = self.distance * math.sin(self.elevation)
        z = self.distance * math.sin(self.azimuth) * math.cos(self.elevation)
        return np.array([x, y, z], np.float32) + self.center

    def position(self) -> np.ndarray:
        return self.eye_position()

    def view_matrix(self) -> np.ndarray:
        return look_at_rh(self.eye_position(), self.center, self.up)

    def projection_matrix(self, width: float, height: float) -> np.ndarray:
        return perspective_fov_rh_zo(
            math.radians(self.fov), width, height, self.near, self.far
        )

    def basis_vectors(self):
        position = self.eye_position()
        forward = self.center - position
        forward = forward / np.linalg.norm(forward)
        right = _cross3(forward, self.up)
        if float(np.dot(right, right)) < 1e-12:
            right = np.array([1.0, 0.0, 0.0], np.float32)
        right = right / np.linalg.norm(right)
        up = _cross3(right, forward)
        return forward, right, up / np.linalg.norm(up)

    def set_parameter_f32(self, key: str, value: float) -> None:
        if key == "distance":
            self.distance = value

    def set_parameter_vec2(self, key: str, value) -> None:
        if key == "from_normalized":
            self.azimuth = math.pi * value[0]
            self.elevation = math.pi * (value[1] - 0.5)

    def set_parameter_vec3(self, key: str, value) -> None:
        if key == "center":
            self.center = np.asarray(value, np.float32)

    def rotate(self, delta) -> None:
        sensitivity = 0.005
        self.azimuth -= delta[0] * sensitivity
        self.elevation += delta[1] * sensitivity
        max_elevation = math.pi / 2 - 0.01
        self.elevation = max(-max_elevation, min(max_elevation, self.elevation))

    def zoom(self, delta: float) -> None:
        zoom_factor = min(2.0, max(0.5, 1.0 - delta * 0.05))
        self.distance = min(100.0, max(0.1, self.distance * zoom_factor))

    def create_ray(self, uv, screen, offset) -> Ray:
        position = self.eye_position()
        forward = self.center - position
        forward = forward / np.linalg.norm(forward)
        return _perspective_ray(
            position, forward, self.up, self.fov, uv, screen, offset
        )


@dataclass
class D3FirstPCamera(D3Camera):
    """First-person camera (reference src/camera/d3firstp.rs)."""

    position_v: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    center: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    fov: float = 75.0
    near: float = 0.01
    far: float = 100.0

    def id(self) -> str:
        return "firstp"

    def position(self) -> np.ndarray:
        return self.position_v

    def view_matrix(self) -> np.ndarray:
        return look_at_rh(
            self.position_v, self.center, np.array([0, 1, 0], np.float32)
        )

    def projection_matrix(self, width: float, height: float) -> np.ndarray:
        return perspective_fov_rh_zo(
            math.radians(self.fov), width, height, self.near, self.far
        )

    def basis_vectors(self):
        forward = self.center - self.position_v
        n = np.linalg.norm(forward)
        forward = forward / n if n > 0 else np.array([0, 0, -1], np.float32)
        up_hint = np.array([0, 1, 0], np.float32)
        right = _cross3(forward, up_hint)
        if float(np.dot(right, right)) < 1e-12:
            right = np.array([1.0, 0.0, 0.0], np.float32)
        right = right / np.linalg.norm(right)
        up = _cross3(right, forward)
        return forward, right, up / np.linalg.norm(up)

    def set_parameter_f32(self, key: str, value: float) -> None:
        if key == "fov":
            self.fov = value
        elif key == "near":
            self.near = value
        elif key == "far":
            self.far = value

    def set_parameter_vec3(self, key: str, value) -> None:
        if key == "position":
            self.position_v = np.asarray(value, np.float32)
        elif key == "center":
            self.center = np.asarray(value, np.float32)

    def zoom(self, delta: float) -> None:
        self.fov = min(120.0, max(20.0, self.fov - delta * 0.5))

    def create_ray(self, uv, screen, offset) -> Ray:
        forward = self.center - self.position_v
        forward = forward / np.linalg.norm(forward)
        return _perspective_ray(
            self.position_v,
            forward,
            np.array([0, 1, 0], np.float32),
            self.fov,
            uv,
            screen,
            offset,
        )


@dataclass
class D3IsoCamera(D3Camera):
    """Fixed-angle isometric-style camera (reference src/camera/d3iso.rs).

    The reference implements iso as a perspective look_at from an azimuth/
    elevation offset around the center at a given distance.
    """

    center: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    distance: float = 10.0
    azimuth: float = math.radians(45.0)
    elevation: float = math.radians(35.264)
    fov: float = 45.0
    near: float = 0.01
    far: float = 100.0

    def id(self) -> str:
        return "iso"

    def eye_position(self) -> np.ndarray:
        x = self.distance * math.cos(self.azimuth) * math.cos(self.elevation)
        y = self.distance * math.sin(self.elevation)
        z = self.distance * math.sin(self.azimuth) * math.cos(self.elevation)
        return np.array([x, y, z], np.float32) + self.center

    def position(self) -> np.ndarray:
        return self.eye_position()

    def view_matrix(self) -> np.ndarray:
        return look_at_rh(
            self.eye_position(), self.center, np.array([0, 1, 0], np.float32)
        )

    def projection_matrix(self, width: float, height: float) -> np.ndarray:
        return perspective_fov_rh_zo(
            math.radians(self.fov), width, height, self.near, self.far
        )

    def basis_vectors(self):
        position = self.eye_position()
        forward = self.center - position
        forward = forward / np.linalg.norm(forward)
        right = _cross3(forward, np.array([0, 1, 0], np.float32))
        right = right / np.linalg.norm(right)
        up = _cross3(right, forward)
        return forward, right, up / np.linalg.norm(up)

    def set_parameter_f32(self, key: str, value: float) -> None:
        if key == "distance":
            self.distance = value
        elif key == "azimuth":
            self.azimuth = value
        elif key == "elevation":
            self.elevation = value

    def set_parameter_vec3(self, key: str, value) -> None:
        if key == "center":
            self.center = np.asarray(value, np.float32)

    def create_ray(self, uv, screen, offset) -> Ray:
        position = self.eye_position()
        forward = self.center - position
        forward = forward / np.linalg.norm(forward)
        return _perspective_ray(
            position,
            forward,
            np.array([0, 1, 0], np.float32),
            self.fov,
            uv,
            screen,
            offset,
        )

"""Lights.

reference: src/map/light.rs — editable `Light` (property bag) compiles to a
flat `CompiledLight` (:457-477); per-pixel math is `color_at` (:491-502),
`radiance_at` (:504-533) and the per-type falloffs (:535-653).

The host classes here carry exact scalar ports of those falloffs (used by the
oracle tests and the host 2D path); `pack_lights` lowers a light list into a
SoA dict of (L, ...) arrays that the jitted shading pass broadcasts over all
pixels at once.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class LightType(enum.IntEnum):
    """reference src/map/light.rs:7-14"""

    Point = 0
    Ambient = 1
    AmbientDaylight = 2
    Spot = 3
    Area = 4
    Daylight = 5


def _smoothstep(edge0: float, edge1: float, x: float) -> float:
    t = (x - edge0) / (edge1 - edge0)
    t = min(1.0, max(0.0, t))
    return t * t * (3.0 - 2.0 * t)


@dataclass
class CompiledLight:
    """Flat render-ready light (reference src/map/light.rs:457-477)."""

    light_type: LightType = LightType.Point
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    intensity: float = 1.0
    emitting: bool = True
    start_distance: float = 1.0
    end_distance: float = 5.0
    flicker: float = 0.0
    direction: np.ndarray = field(default_factory=lambda: np.array([0, -1, 0], np.float32))
    cone_angle: float = 0.5
    normal: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    width: float = 1.0
    height: float = 1.0
    from_linedef: bool = False

    def position_2d(self) -> np.ndarray:
        return np.array([self.position[0], self.position[2]], np.float32)

    # -- scalar falloff ports (oracle / host paths) --

    def apply_flicker(self, color, intensity: float, flicker: float, hash_: int):
        """reference light.rs:656-672. Note the Rust `f32 as u32` saturating cast."""
        if flicker > 0.0:
            def as_u32(x: float) -> int:
                if math.isnan(x) or x <= 0.0:
                    return 0
                return min(int(x), 0xFFFFFFFF)

            combined = (
                hash_
                + (as_u32(float(self.position[0]))
                   + as_u32(float(self.position[1]))
                   + as_u32(float(self.position[2])))
                * 100
            ) & 0xFFFFFFFF
            flicker_value = min(1.0, max(0.0, combined / 0xFFFFFFFF))
            factor = 1.0 - flicker_value * flicker
        else:
            factor = 1.0
        return [c * intensity * factor for c in color]

    def color_at(self, point, hash_: int, d2: bool) -> Optional[list]:
        """reference light.rs:491-502"""
        if not self.emitting:
            return None
        p = np.asarray(point, np.float32)
        t = self.light_type
        if t == LightType.Point:
            return self._point(p, hash_)
        if t in (LightType.Ambient, LightType.AmbientDaylight):
            return self.apply_flicker(self.color, self.intensity, self.flicker, hash_)
        if t == LightType.Spot:
            return self._spot(p, hash_)
        if t == LightType.Area:
            return self._area(p, d2)
        return self._daylight(p)

    def radiance_at(self, point, surface_normal, hash_: int) -> Optional[np.ndarray]:
        """color_at + Lambert (reference light.rs:504-533)."""
        c = self.color_at(point, hash_, False)
        if c is None:
            return None
        incoming = np.asarray(c, np.float32)
        if self.light_type in (
            LightType.Ambient,
            LightType.AmbientDaylight,
            LightType.Daylight,
        ):
            return incoming
        if surface_normal is None:
            return incoming
        d = self.position - np.asarray(point, np.float32)
        n = np.linalg.norm(d)
        if n > 0:
            d = d / n
        lambert = max(0.0, float(np.dot(surface_normal, d)))
        return incoming * lambert

    def _point(self, p, hash_):
        dist = float(np.linalg.norm(p - self.position))
        if dist >= self.end_distance:
            return None
        if dist <= self.start_distance:
            return self.apply_flicker(self.color, self.intensity, self.flicker, hash_)
        att = _smoothstep(self.end_distance, self.start_distance, dist)
        return self.apply_flicker(self.color, self.intensity * att, self.flicker, hash_)

    def _spot(self, p, hash_):
        dist = float(np.linalg.norm(p - self.position))
        if dist >= self.end_distance:
            return None
        if dist <= self.start_distance:
            att = 1.0
        else:
            att = 1.0 - (dist - self.start_distance) / (
                self.end_distance - self.start_distance
            )
        to_p = p - self.position
        n = np.linalg.norm(to_p)
        if n > 0:
            to_p = to_p / n
        angle = math.acos(min(1.0, max(-1.0, float(np.dot(self.direction, to_p)))))
        if angle > self.cone_angle:
            return None
        return self.apply_flicker(self.color, self.intensity * att, self.flicker, hash_)

    def _area(self, p, d2: bool):
        to_point = p - self.position
        dist = float(np.linalg.norm(to_point))
        if dist >= self.end_distance:
            return None
        if dist < 0.1:
            return list(self.color)
        if dist <= self.start_distance:
            datt = 1.0
        else:
            datt = _smoothstep(self.end_distance, self.start_distance, dist)
        area = self.width * self.height
        direction = to_point / dist
        if self.from_linedef:
            att = datt * area * self.intensity
        elif d2:
            ax = max(0.0, 1.0 - abs(to_point[0] / (self.width * 0.5)))
            ay = max(0.0, 1.0 - abs(to_point[1] / (self.height * 0.5)))
            att = ax * ay * datt * self.intensity
        else:
            aatt = max(0.0, float(np.dot(self.normal, direction)))
            att = aatt * datt * area * self.intensity
        return [c * att for c in self.color]

    def _daylight(self, p):
        to_point = p - self.position
        dist = float(np.linalg.norm(to_point))
        if dist >= self.end_distance:
            return None
        direction = to_point / dist if dist > 0 else to_point
        aatt = max(0.0, float(np.dot(self.normal, direction)))
        datt = (
            1.0
            if dist <= self.start_distance
            else _smoothstep(self.end_distance, self.start_distance, dist)
        )
        att = aatt * datt * self.intensity
        return [c * att for c in self.color]


@dataclass
class Light:
    """Editable light — property-bag style like the reference's ValueContainer
    version (src/map/light.rs:31-193), compiled to CompiledLight."""

    light_type: LightType = LightType.Point
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    intensity: float = 1.0
    emitting: bool = True
    start_distance: float = 1.0
    end_distance: float = 5.0
    flicker: float = 0.0
    direction: np.ndarray = field(default_factory=lambda: np.array([0, -1, 0], np.float32))
    cone_angle: float = 0.5
    normal: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    width: float = 1.0
    height: float = 1.0
    from_linedef: bool = False

    # builder-style setters matching reference naming
    def with_intensity(self, v: float) -> "Light":
        self.intensity = v
        return self

    def with_color(self, c) -> "Light":
        self.color = np.asarray(c, np.float32)
        return self

    def with_position(self, p) -> "Light":
        self.position = np.asarray(p, np.float32)
        return self

    def with_range(self, start: float, end: float) -> "Light":
        self.start_distance = start
        self.end_distance = end
        return self

    def with_flicker(self, f: float) -> "Light":
        self.flicker = f
        return self

    # plain getters/setters (light.rs:60-126)

    def get_intensity(self) -> float:
        return self.intensity

    def set_intensity(self, v: float) -> None:
        self.intensity = float(v)

    def get_color(self):
        return self.color

    def set_color(self, c) -> None:
        self.color = np.asarray(c, np.float32)

    def get_start_distance(self) -> float:
        return self.start_distance

    def set_start_distance(self, v: float) -> None:
        self.start_distance = float(v)

    def get_end_distance(self) -> float:
        return self.end_distance

    def set_end_distance(self, v: float) -> None:
        self.end_distance = float(v)

    def with_start_distance(self, v: float) -> "Light":
        self.start_distance = float(v)
        return self

    def with_end_distance(self, v: float) -> "Light":
        self.end_distance = float(v)
        return self

    def get_flicker(self) -> float:
        return self.flicker

    def set_flicker(self, v: float) -> None:
        self.flicker = float(v)

    def set_position(self, p) -> None:
        self.position = np.asarray(p, np.float32)

    def place_on_linedef(self, p1, p2, height: float) -> "Light":
        """Light::from_linedef (light.rs:232-343): wall-mounted placement at
        the segment midpoint, pushed 0.1 along the wall normal; Spot lights
        aim along the normal, Area lights span the segment width. (Named
        place_on_linedef here because the `from_linedef` FIELD — the
        area-light 2D-variant flag — occupies the reference method name.)"""
        import copy as _copy

        p1 = np.asarray(p1, np.float32)
        p2 = np.asarray(p2, np.float32)
        d = p2 - p1
        length = float(np.linalg.norm(d))
        d = d / max(length, 1e-20)
        normal = np.array([d[1], -d[0]], np.float32)
        mid = (p1 + p2) * 0.5 + normal * 0.1
        if self.light_type in (LightType.Ambient, LightType.AmbientDaylight):
            return _copy.deepcopy(self)
        out = _copy.deepcopy(self)
        out.position = np.array([mid[0], height, mid[1]], np.float32)
        if self.light_type == LightType.Spot:
            out.direction = np.array([normal[0], 0.0, normal[1]], np.float32)
        elif self.light_type == LightType.Area:
            out.from_linedef = True
            out.normal = np.array([normal[0], 0.0, normal[1]], np.float32)
            out.width = length
            out.height = 1.0
        elif self.light_type == LightType.Daylight:
            out.light_type = LightType.Area
        return out

    def place_on_sector(self, center, size=None) -> "Light":
        """Light::from_sector (light.rs:346-452): ceiling/floor placement at
        the sector center pushed 0.1 up; Spot aims up, Area spans `size`."""
        import copy as _copy

        if self.light_type in (LightType.Ambient, LightType.AmbientDaylight):
            return _copy.deepcopy(self)
        out = _copy.deepcopy(self)
        center = np.asarray(center, np.float32)
        out.position = center + np.array([0.0, 0.1, 0.0], np.float32)
        if self.light_type == LightType.Spot:
            out.direction = np.array([0.0, 1.0, 0.0], np.float32)
        elif self.light_type == LightType.Area:
            out.normal = np.array([0.0, 1.0, 0.0], np.float32)
            if size is not None:
                out.width = float(size[0])
                out.height = float(size[1])
        elif self.light_type == LightType.Daylight:
            out.light_type = LightType.Area
        return out

    def compile(self) -> CompiledLight:
        return CompiledLight(
            light_type=self.light_type,
            position=np.asarray(self.position, np.float32).copy(),
            color=np.asarray(self.color, np.float32).copy(),
            intensity=self.intensity,
            emitting=self.emitting,
            start_distance=self.start_distance,
            end_distance=self.end_distance,
            flicker=self.flicker,
            direction=np.asarray(self.direction, np.float32).copy(),
            cone_angle=self.cone_angle,
            normal=np.asarray(self.normal, np.float32).copy(),
            width=self.width,
            height=self.height,
            from_linedef=self.from_linedef,
        )


def pack_lights(lights, capacity: Optional[int] = None) -> dict:
    """Lower CompiledLight list to SoA arrays, padded to `capacity`.

    Invalid (padding) entries have valid=0; the shading pass masks them.
    """
    n = len(lights)
    cap = capacity if capacity is not None else max(n, 1)
    out = {
        "valid": np.zeros(cap, np.float32),
        "type": np.zeros(cap, np.int32),
        "position": np.zeros((cap, 3), np.float32),
        "color": np.zeros((cap, 3), np.float32),
        "intensity": np.zeros(cap, np.float32),
        "start": np.zeros(cap, np.float32),
        "end": np.ones(cap, np.float32),
        "flicker": np.zeros(cap, np.float32),
        "direction": np.zeros((cap, 3), np.float32),
        "cone_angle": np.zeros(cap, np.float32),
        "normal": np.zeros((cap, 3), np.float32),
        "width": np.zeros(cap, np.float32),
        "height": np.zeros(cap, np.float32),
        "from_linedef": np.zeros(cap, np.float32),
    }
    for i, l in enumerate(lights[:cap]):
        out["valid"][i] = 1.0 if l.emitting else 0.0
        out["type"][i] = int(l.light_type)
        out["position"][i] = l.position
        out["color"][i] = l.color
        out["intensity"][i] = l.intensity
        out["start"][i] = l.start_distance
        out["end"][i] = l.end_distance
        out["flicker"][i] = l.flicker
        out["direction"][i] = l.direction
        out["cone_angle"][i] = l.cone_angle
        out["normal"][i] = l.normal
        out["width"][i] = l.width
        out["height"][i] = l.height
        out["from_linedef"][i] = 1.0 if l.from_linedef else 0.0
    return out

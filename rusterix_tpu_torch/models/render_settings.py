"""PBR render settings + daylight simulation (reference
src/render_settings.rs:10-120, 282 `apply_hour`; TOML format per
render_settings_example.toml)."""

from __future__ import annotations

import math
import tomllib
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


def _lerp3(a, b, t):
    return [a[i] + (b[i] - a[i]) * t for i in range(3)]


@dataclass
class DaylightSimulation:
    """reference render_settings.rs:72-124."""

    enabled: bool = False
    night_sky_color: Tuple[float, float, float] = (0.02, 0.02, 0.05)
    morning_sky_color: Tuple[float, float, float] = (1.0, 0.6, 0.4)
    midday_sky_color: Tuple[float, float, float] = (0.529, 0.808, 0.922)
    evening_sky_color: Tuple[float, float, float] = (1.0, 0.5, 0.3)
    night_sun_color: Tuple[float, float, float] = (0.1, 0.1, 0.15)
    morning_sun_color: Tuple[float, float, float] = (1.0, 0.8, 0.6)
    midday_sun_color: Tuple[float, float, float] = (1.0, 1.0, 0.95)
    evening_sun_color: Tuple[float, float, float] = (1.0, 0.7, 0.5)
    sunrise_time: float = 6.0
    sunset_time: float = 18.0


@dataclass
class RenderSettings:
    """reference render_settings.rs:10-70."""

    sky_color: Tuple[float, float, float] = (0.5, 0.7, 0.9)
    sun_color: Tuple[float, float, float] = (1.0, 1.0, 0.95)
    sun_intensity: float = 1.0
    sun_direction: Tuple[float, float, float] = (0.3, -1.0, 0.2)
    sun_enabled: bool = True
    ambient_color: Tuple[float, float, float] = (0.2, 0.2, 0.25)
    ambient_strength: float = 1.0
    fog_color: Tuple[float, float, float] = (0.5, 0.5, 0.55)
    fog_density: float = 0.0
    ao_samples: float = 4.0
    ao_radius: float = 0.5
    bump_strength: float = 0.5
    max_transparency_bounces: float = 4.0
    max_shadow_distance: float = 50.0
    max_sky_distance: float = 1000.0
    max_shadow_steps: float = 16.0
    reflection_samples: float = 0.0
    frame_time_ms: float = 33.3
    simulation: DaylightSimulation = field(default_factory=DaylightSimulation)
    #: in-flight timed setting changes: key -> (start, target, duration,
    #: elapsed) (reference render_settings.rs:65,149-198 `Transition`)
    transitions: dict = field(default_factory=dict)

    #: color-valued keys interpolate componentwise (Vec3 transitions)
    _COLOR_KEYS = frozenset(
        ("sky_color", "sun_color", "sun_direction", "ambient_color", "fog_color")
    )

    def set(self, name: str, value, time: float = 0.0) -> None:
        """Schedule a timed setting change: interpolate `name` from its
        current value to `value` over `time` seconds, advanced by
        update_transitions() at frame_time_ms per frame (reference
        render_settings.rs:222-277 `set`). time=0 applies immediately.
        Raises KeyError for unknown setting names."""
        if name == "frame_time_ms":
            self.frame_time_ms = max(float(value), 0.0)
            return
        if name == "sun_enabled":
            self.sun_enabled = bool(value)
            self.transitions.pop(name, None)
            return
        if not hasattr(self, name) or name in ("simulation", "transitions"):
            raise KeyError(f"Unknown render setting '{name}'")
        if name in self._COLOR_KEYS:
            target = tuple(float(c) for c in value)
        else:
            target = float(value)
        duration = max(float(time), 0.0)
        if duration == 0.0:
            setattr(self, name, target)
            self.transitions.pop(name, None)
            return
        self.transitions[name] = (getattr(self, name), target, duration, 0.0)

    def update_transitions(self) -> None:
        """Advance every in-flight transition by one frame
        (dt = frame_time_ms/1000 — reference render_settings.rs:433-505;
        this is what frame_time_ms exists for)."""
        if not self.transitions:
            return
        dt = max(self.frame_time_ms / 1000.0, 0.0001)
        done = []
        for key, (start, target, duration, elapsed) in self.transitions.items():
            elapsed = elapsed + dt
            t = min(elapsed / duration, 1.0)
            if isinstance(target, tuple):
                setattr(self, key, tuple(_lerp3(start, target, t)))
            else:
                setattr(self, key, start + (target - start) * t)
            if t >= 1.0:
                done.append(key)
            else:
                self.transitions[key] = (start, target, duration, elapsed)
        for key in done:
            del self.transitions[key]

    @staticmethod
    def from_toml(text: str) -> "RenderSettings":
        """Parse the [render] / [daylight] tables
        (reference render_settings.rs TOML loader + example file)."""
        rs = RenderSettings()
        try:
            data = tomllib.loads(text)
        except Exception:
            return rs
        def color(v):
            """[r,g,b] floats or '#RRGGBB' hex (the example file uses hex)."""
            if isinstance(v, str):
                h = v.lstrip("#")
                return tuple(int(h[i : i + 2], 16) / 255.0 for i in (0, 2, 4))
            return tuple(float(x) for x in v)

        r = data.get("render", data)
        for key in (
            "sky_color", "sun_color", "sun_direction", "ambient_color", "fog_color",
        ):
            if key in r:
                setattr(rs, key, color(r[key]))
        for key in (
            "sun_intensity", "ambient_strength", "fog_density", "ao_samples",
            "ao_radius", "bump_strength", "max_transparency_bounces",
            "max_shadow_distance", "max_sky_distance", "max_shadow_steps",
            "reflection_samples", "frame_time_ms",
        ):
            if key in r:
                setattr(rs, key, float(r[key]))
        if "sun_enabled" in r:
            rs.sun_enabled = bool(r["sun_enabled"])
        # the example file names the table [simulation]; accept both
        d = data.get("simulation", data.get("daylight", {}))
        sim = rs.simulation
        if d:
            sim.enabled = bool(d.get("enabled", True))
            for key in (
                "night_sky_color", "morning_sky_color", "midday_sky_color",
                "evening_sky_color", "night_sun_color", "morning_sun_color",
                "midday_sun_color", "evening_sun_color",
            ):
                if key in d:
                    setattr(sim, key, color(d[key]))
            sim.sunrise_time = float(d.get("sunrise_time", sim.sunrise_time))
            sim.sunset_time = float(d.get("sunset_time", sim.sunset_time))
        return rs

    def apply_hour(self, hour: float) -> None:
        """Drive sky/sun colors + sun position from the hour
        (reference render_settings.rs:282+)."""
        sim = self.simulation
        if not sim.enabled:
            return
        sunrise, sunset = sim.sunrise_time, sim.sunset_time
        midday = (sunrise + sunset) / 2.0

        if hour < sunrise - 1.0 or hour > sunset + 1.0:
            self.sky_color = tuple(sim.night_sky_color)
            self.sun_color = tuple(sim.night_sun_color)
            self.sun_intensity = 0.15
        elif hour < sunrise + 1.0:
            t = (hour - (sunrise - 1.0)) / 2.0
            self.sky_color = tuple(_lerp3(sim.night_sky_color, sim.morning_sky_color, t))
            self.sun_color = tuple(_lerp3(sim.night_sun_color, sim.morning_sun_color, t))
            self.sun_intensity = 0.15 + 0.85 * t
        elif hour < midday:
            t = (hour - (sunrise + 1.0)) / max(midday - sunrise - 1.0, 1e-6)
            self.sky_color = tuple(_lerp3(sim.morning_sky_color, sim.midday_sky_color, t))
            self.sun_color = tuple(_lerp3(sim.morning_sun_color, sim.midday_sun_color, t))
            self.sun_intensity = 1.0
        elif hour < sunset - 1.0:
            t = (hour - midday) / max(sunset - 1.0 - midday, 1e-6)
            self.sky_color = tuple(_lerp3(sim.midday_sky_color, sim.evening_sky_color, t))
            self.sun_color = tuple(_lerp3(sim.midday_sun_color, sim.evening_sun_color, t))
            self.sun_intensity = 1.0
        else:
            t = (hour - (sunset - 1.0)) / 2.0
            self.sky_color = tuple(_lerp3(sim.evening_sky_color, sim.night_sky_color, t))
            self.sun_color = tuple(_lerp3(sim.evening_sun_color, sim.night_sun_color, t))
            self.sun_intensity = max(0.15, 1.0 - 0.85 * t)

        # sun arc east->west
        t_day = min(max((hour - sunrise) / max(sunset - sunrise, 1e-6), 0.0), 1.0)
        theta = t_day * math.pi
        self.sun_direction = (
            -math.cos(theta),
            -max(math.sin(theta), 0.05),
            0.2,
        )

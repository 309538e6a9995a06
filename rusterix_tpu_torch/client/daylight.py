"""Daylight cycle (reference src/client/daylight.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _lerp(a, b, t):
    return a + (b - a) * t


@dataclass
class Daylight:
    sunrise: int = 300  # 5:00 AM (minutes)
    sunset: int = 1200  # 8:00 PM
    transition_duration: int = 60
    daylight_color: np.ndarray = field(
        default_factory=lambda: np.array([0.9, 0.9, 1.0], np.float32)
    )
    sunrise_color: np.ndarray = field(
        default_factory=lambda: np.array([1.0, 0.8, 0.8], np.float32)
    )
    sunset_color: np.ndarray = field(
        default_factory=lambda: np.array([1.0, 0.8, 0.8], np.float32)
    )
    night_color: np.ndarray = field(
        default_factory=lambda: np.array([0.3, 0.3, 0.3], np.float32)
    )

    def daylight(self, time: int, min_bright: float, max_bright: float) -> np.ndarray:
        """daylight.rs:30-60"""
        minutes = time
        td = self.transition_duration
        daylight_start = self.sunrise + td
        sunset_end = self.sunset + td
        if minutes < self.sunrise or minutes > sunset_end:
            color = self.night_color
        elif minutes < daylight_start:
            color = _lerp(
                self.night_color, self.sunrise_color, (minutes - self.sunrise) / td
            )
        elif minutes < self.sunset:
            color = self.daylight_color
        else:
            color = _lerp(
                self.sunset_color, self.night_color, (minutes - self.sunset) / td
            )
        return np.clip(color, min_bright, max_bright).astype(np.float32)

    def daylight_intensity(self, time: int) -> float:
        """daylight.rs:63-79"""
        minutes = time
        td = self.transition_duration
        daylight_start = self.sunrise + td
        sunset_end = self.sunset + td
        if minutes < self.sunrise or minutes > sunset_end:
            return 0.0
        if minutes < daylight_start:
            return (minutes - self.sunrise) / td
        if minutes < self.sunset:
            return 1.0
        return 1.0 - (minutes - self.sunset) / td

    def calculate_light_direction(self, time: int) -> np.ndarray:
        """daylight.rs:82-103"""
        minutes = time
        total = self.sunset - self.sunrise
        if minutes < self.sunrise:
            t = 0.0
        elif minutes > self.sunset:
            t = float(total)
        else:
            t = float(minutes - self.sunrise)
        normalized = t / total
        sun = np.array(
            [
                np.sin(normalized * np.pi * 2.0),
                np.sin(normalized * np.pi),
                0.0,
            ],
            np.float32,
        )
        n = np.linalg.norm(sun)
        return sun / n if n > 0 else np.array([0, 1, 0], np.float32)

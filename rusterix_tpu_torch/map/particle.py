"""Particle emitter (reference src/map/particle.rs:6-169).

Host-side state; per-frame the active particles export as camera-facing
billboard quads (the renderer draws them like entity billboards)."""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass
class Particle:
    pos: np.ndarray
    vel: np.ndarray
    lifetime: float
    radius: float
    color: Tuple[int, int, int, int]


@dataclass
class ParticleEmitter:
    origin: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    direction: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    spread: float = math.pi / 4
    rate: float = 30.0
    time_accum: float = 0.0
    color: Tuple[int, int, int, int] = (255, 160, 0, 255)
    color_variation: int = 30
    lifetime_range: Tuple[float, float] = (0.5, 1.5)
    radius_range: Tuple[float, float] = (0.05, 0.15)
    speed_range: Tuple[float, float] = (0.5, 1.5)
    particles: List[Particle] = field(default_factory=list)

    def __post_init__(self):
        n = np.linalg.norm(self.direction)
        if n > 0:
            self.direction = np.asarray(self.direction, np.float32) / n

    def _random_direction(self) -> np.ndarray:
        """Uniform direction within the spread cone around `direction`."""
        cos_max = math.cos(self.spread)
        u = random.uniform(cos_max, 1.0)
        phi = random.uniform(0.0, math.tau)
        s = math.sqrt(max(1.0 - u * u, 0.0))
        local = np.array([s * math.cos(phi), s * math.sin(phi), u], np.float32)
        # basis around direction (z-aligned)
        d = self.direction
        helper = (
            np.array([1, 0, 0], np.float32)
            if abs(d[0]) < 0.9
            else np.array([0, 1, 0], np.float32)
        )
        t = np.cross(d, helper)
        t = t / max(np.linalg.norm(t), 1e-12)
        b = np.cross(d, t)
        return (t * local[0] + b * local[1] + d * local[2]).astype(np.float32)

    def update(self, dt: float) -> None:
        """Emit + integrate + expire (particle.rs:54-120)."""
        self.time_accum += dt
        emit_count = int(self.rate * self.time_accum)
        if emit_count > 0:
            self.time_accum -= emit_count / self.rate
            for _ in range(emit_count):
                speed = random.uniform(*self.speed_range)
                cv = self.color_variation
                col = tuple(
                    int(np.clip(c + random.randint(-cv, cv), 0, 255))
                    for c in self.color[:3]
                ) + (self.color[3],)
                self.particles.append(
                    Particle(
                        pos=self.origin.copy(),
                        vel=self._random_direction() * speed,
                        lifetime=random.uniform(*self.lifetime_range),
                        radius=random.uniform(*self.radius_range),
                        color=col,
                    )
                )
        alive = []
        for particle in self.particles:
            particle.lifetime -= dt
            if particle.lifetime > 0:
                particle.pos = particle.pos + particle.vel * dt
                alive.append(particle)
        self.particles = alive

    def build_billboards(self, view_right, view_up):
        """Active particles -> one Batch3D of camera-facing quads."""
        from ..models.batch import Batch3D, PixelSource

        batch = Batch3D()
        for particle in self.particles:
            batch.add_vertex_billboard(
                particle.pos, view_right, view_up, particle.radius * 2.0
            )
        if self.particles:
            batch.set_source(PixelSource.pixel(self.particles[0].color))
        return batch

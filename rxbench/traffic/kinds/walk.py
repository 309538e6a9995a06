"""The camera of a first-person walk over a grid of rooms.

The configuration names the grid (`rooms_x`, `rooms_y`, `room_size`). The
seed picks a route of `legs` legs from a room's centre to a neighbouring
room's centre through the doorway between them, never straight back
where another way is open. The camera moves `step` units a frame at
`eye_height`, looks along the route with a seeded sway of the yaw of up to
`sway_deg` over a period drawn from `sway_period_frames`, and tilts by
`pitch_deg`."""

from __future__ import annotations

import math

import numpy as np


class Camera:
    def __init__(self, params: dict, cfg: dict, rng):
        self.p = params
        nx, ny, size = cfg["rooms_x"], cfg["rooms_y"], cfg["room_size"]
        room = (int(rng.integers(nx)), int(rng.integers(ny)))
        prev = None
        points = []
        for _ in range(params["legs"] + 1):
            points.append(((room[0] + 0.5) * size, (room[1] + 0.5) * size))
            steps = [(room[0] + dx, room[1] + dy) for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1))]
            steps = [r for r in steps if 0 <= r[0] < nx and 0 <= r[1] < ny]
            if prev in steps and len(steps) > 1:
                steps.remove(prev)
            prev, room = room, steps[int(rng.integers(len(steps)))]
        self.points = np.asarray(points, np.float64)
        lo, hi = params["sway_period_frames"]
        self.period = float(rng.uniform(lo, hi))
        self.phase = float(rng.uniform(0.0, 2.0 * math.pi))
        self.size = size

    def along(self, i: int, ahead: float = 0.0):
        """The route `ahead` units beyond frame i's eye -> ((x, z), unit
        direction of its leg)."""
        s = i * self.p["step"] + ahead
        leg = min(int(s // self.size), len(self.points) - 2)
        a, b = self.points[leg], self.points[leg + 1]
        f = min(s / self.size - leg, 1.0)
        return a + (b - a) * f, (b - a) / np.linalg.norm(b - a)

    def pose(self, i: int):
        """Frame i -> (eye (3,), target (3,))."""
        xz, fwd = self.along(i)
        sway = math.radians(self.p["sway_deg"]) * math.sin(2.0 * math.pi * i / self.period
                                                           + self.phase)
        yaw = math.atan2(fwd[1], fwd[0]) + sway
        pitch = math.radians(self.p["pitch_deg"])
        eye = np.array([xz[0], self.p["eye_height"], xz[1]])
        look = np.array([math.cos(yaw) * math.cos(pitch), math.sin(pitch),
                         math.sin(yaw) * math.cos(pitch)])
        return eye, eye + look

"""Axis-aligned rectangles and boxes (reference: src/rect.rs, bvh AABB usage)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Rect:
    x: float = 0.0
    y: float = 0.0
    width: float = 0.0
    height: float = 0.0

    @property
    def max_x(self) -> float:
        return self.x + self.width

    @property
    def max_y(self) -> float:
        return self.y + self.height

    def contains(self, px: float, py: float) -> bool:
        return self.x <= px < self.max_x and self.y <= py < self.max_y

    def intersects(self, other: "Rect") -> bool:
        return (
            self.x < other.max_x
            and self.max_x > other.x
            and self.y < other.max_y
            and self.max_y > other.y
        )

    def union(self, other: "Rect") -> "Rect":
        x0 = min(self.x, other.x)
        y0 = min(self.y, other.y)
        x1 = max(self.max_x, other.max_x)
        y1 = max(self.max_y, other.max_y)
        return Rect(x0, y0, x1 - x0, y1 - y0)


@dataclass
class BBox3:
    """3D axis-aligned bounding box."""

    min_x: float = 0.0
    min_y: float = 0.0
    min_z: float = 0.0
    max_x: float = 0.0
    max_y: float = 0.0
    max_z: float = 0.0

    @classmethod
    def from_points(cls, pts) -> "BBox3":
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        zs = [p[2] for p in pts]
        return cls(min(xs), min(ys), min(zs), max(xs), max(ys), max(zs))

    def grown(self, d: float) -> "BBox3":
        return BBox3(
            self.min_x - d,
            self.min_y - d,
            self.min_z - d,
            self.max_x + d,
            self.max_y + d,
            self.max_z + d,
        )

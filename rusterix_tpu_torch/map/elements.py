"""Map elements: Vertex, Linedef, Sector (reference src/map/vertex.rs,
linedef.rs, sector.rs)."""

from __future__ import annotations

import math
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..utils.rect import Rect
from .value import ValueContainer


@dataclass
class Vertex:
    """reference src/map/vertex.rs:5 — id, x, y (+z world height)."""

    id: int
    x: float
    y: float
    z: float = 0.0
    properties: ValueContainer = field(default_factory=ValueContainer)

    def as_vec2(self):
        return np.array([self.x, self.y], np.float32)

    def as_vec3_world(self):
        """2D map coords (x, y) map to world (x, z); vertex z is world height."""
        return np.array([self.x, self.z, self.y], np.float32)


@dataclass
class Linedef:
    """reference src/map/linedef.rs:5-114."""

    id: int
    start_vertex: int
    end_vertex: int
    name: str = ""
    sector_ids: List[int] = field(default_factory=list)
    properties: ValueContainer = field(default_factory=ValueContainer)
    creator_id: str = field(default_factory=lambda: str(uuid_mod.uuid4()))

    def signed_distance(self, map_, point) -> Optional[float]:
        """Negative on the front (normal-facing) side (linedef.rs:38-57)."""
        v0 = map_.get_vertex(self.start_vertex)
        v1 = map_.get_vertex(self.end_vertex)
        if v0 is None or v1 is None:
            return None
        p = np.asarray(point, np.float32)
        a = v0.as_vec2()
        b = v1.as_vec2()
        edge = b - a
        t = float(np.dot(p - a, edge) / max(np.dot(edge, edge), 1e-20))
        t = min(1.0, max(0.0, t))
        closest = a + edge * t
        dist = float(np.linalg.norm(p - closest))
        normal = np.array([-edge[1], edge[0]], np.float32)
        n = np.linalg.norm(normal)
        if n > 0:
            normal = normal / n
        side = float(np.dot(p - closest, normal))
        return -dist if side < 0.0 else dist

    def length(self, map_) -> Optional[float]:
        v0 = map_.get_vertex(self.start_vertex)
        v1 = map_.get_vertex(self.end_vertex)
        if v0 is None or v1 is None:
            return None
        return float(np.linalg.norm(v1.as_vec2() - v0.as_vec2()))

    def bounding_box(self, map_) -> Rect:
        v0 = map_.get_vertex(self.start_vertex)
        v1 = map_.get_vertex(self.end_vertex)
        a = v0.as_vec2() if v0 is not None else np.zeros(2)
        b = v1.as_vec2() if v1 is not None else np.zeros(2)
        x0, y0 = min(a[0], b[0]), min(a[1], b[1])
        x1, y1 = max(a[0], b[0]), max(a[1], b[1])
        return Rect(x0, y0, x1 - x0, y1 - y0)

    def same_edge(self, other: "Linedef") -> bool:
        return (
            self.start_vertex == other.start_vertex
            and self.end_vertex == other.end_vertex
        ) or (
            self.start_vertex == other.end_vertex
            and self.end_vertex == other.start_vertex
        )

    def y_span_world(self, map_) -> Optional[Tuple[float, float]]:
        """World-y extent of the endpoints (linedef.rs:83-89)."""
        a = map_.get_vertex_3d(self.start_vertex)
        b = map_.get_vertex_3d(self.end_vertex)
        if a is None or b is None:
            return None
        return min(a[1], b[1]), max(a[1], b[1])

    def intersects_vertical_slice(self, map_, slice_y: float, thickness: float) -> bool:
        """linedef.rs:92-104."""
        if thickness <= 0.0:
            return False
        span = self.y_span_world(map_)
        if span is None:
            return False
        half = thickness * 0.5
        return span[1] >= slice_y - half and span[0] <= slice_y + half


@dataclass
class CompiledLinedef:
    """Flat wall segment for lighting/collision (linedef.rs:117-133)."""

    start: np.ndarray
    end: np.ndarray
    wall_width: float = 0.0
    wall_height: float = 0.0


@dataclass
class Sector:
    """reference src/map/sector.rs:6-24 — ordered linedef loop + properties."""

    id: int
    linedefs: List[int] = field(default_factory=list)
    name: str = ""
    layer: Optional[int] = None
    properties: ValueContainer = field(default_factory=ValueContainer)
    creator_id: str = field(default_factory=lambda: str(uuid_mod.uuid4()))

    def __post_init__(self):
        if not self.properties.contains("source"):
            from ..models.batch import PixelSource

            self.properties.set("source", PixelSource.off())

    def polygon(self, map_) -> List[np.ndarray]:
        """Unique boundary vertices in loop order (sector.rs:196-211)."""
        out = []
        seen = []
        for lid in self.linedefs:
            ld = map_.find_linedef(lid)
            if ld is None:
                return []
            v = map_.get_vertex(ld.start_vertex)
            if v is None:
                return []
            p = (float(v.x), float(v.y))
            if p not in seen:
                seen.append(p)
                out.append(v.as_vec2())
        return out

    def generate_geometry(self, map_) -> Optional[Tuple[list, list]]:
        """Earcut triangulation of the floor polygon (sector.rs:194-232).

        Returns ([ [x, y], ... ], [(i0, i1, i2), ...]) with reversed winding
        like the reference (chunk[2], chunk[1], chunk[0])."""
        from .geometry import triangulate_polygon

        poly = self.polygon(map_)
        if len(poly) < 3:
            return None
        pts = [(float(p[0]), float(p[1])) for p in poly]
        _, tris = triangulate_polygon(pts)
        tris = [(c, b, a) for (a, b, c) in tris]
        return [list(p) for p in pts], tris

    def bounding_box(self, map_) -> Rect:
        xs, ys = [], []
        for lid in self.linedefs:
            ld = map_.find_linedef(lid)
            if ld is None:
                continue
            for vid in (ld.start_vertex, ld.end_vertex):
                v = map_.get_vertex(vid)
                if v is not None:
                    xs.append(v.x)
                    ys.append(v.y)
        if not xs:
            return Rect()
        return Rect(min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys))

    def center(self, map_) -> Optional[np.ndarray]:
        poly = self.polygon(map_)
        if not poly:
            return None
        return np.mean(np.stack(poly), axis=0)

    def _wall_rings(self, map_, thickness_at) -> Optional[tuple]:
        """Miter-offset outer/inner rings around the sector loop
        (shared by the 2D wall geometry generators, sector.rs:337-435).
        `thickness_at(i)` gives the corner thickness for loop index i."""
        polygon = []
        for lid in self.linedefs:
            ld = map_.find_linedef(lid)
            if ld is None:
                continue
            v = map_.get_vertex(ld.start_vertex)
            if v is not None:
                polygon.append(np.array([v.x, v.y], np.float32))
        n = len(polygon)
        if n < 3:
            return None
        outer, inner = [], []
        for i in range(n):
            prev_p = polygon[(i + n - 1) % n]
            curr = polygon[i]
            next_p = polygon[(i + 1) % n]
            d1 = curr - prev_p
            d2 = next_p - curr
            d1 = d1 / max(float(np.linalg.norm(d1)), 1e-20)
            d2 = d2 / max(float(np.linalg.norm(d2)), 1e-20)
            n1 = np.array([-d1[1], d1[0]], np.float32)
            n2 = np.array([-d2[1], d2[0]], np.float32)
            bis = n1 + n2
            bis = bis / max(float(np.linalg.norm(bis)), 1e-20)
            # angle_between(d1, d2) / 2 as in vek (unsigned)
            cosang = float(np.clip(d1 @ d2, -1.0, 1.0))
            half = float(np.arccos(cosang)) / 2.0
            off = thickness_at(i) / max(2.0 * float(np.cos(half)), 0.1)
            outer.append(curr + bis * off)
            inner.append(curr - bis * off)
        return polygon, outer, inner

    def generate_wall_geometry(self, map_, thickness: float) -> Optional[tuple]:
        """Uniform-thickness 2D wall ring around the loop
        (sector.rs:337-435): miter-offset outer/inner rings triangulated as
        quads -> ([ [x, y], ... ], [(i0, i1, i2), ...])."""
        rings = self._wall_rings(map_, lambda i: thickness)
        if rings is None:
            return None
        _, outer, inner = rings
        n = len(outer)
        vertices = [[float(p[0]), float(p[1])] for p in outer] + [
            [float(p[0]), float(p[1])] for p in inner
        ]
        indices = []
        for i in range(n):
            nxt = (i + 1) % n
            indices.append((i, nxt, n + i))
            indices.append((nxt, n + nxt, n + i))
        return vertices, indices

    def generate_wall_geometry_by_linedef(self, map_) -> Optional[dict]:
        """Per-linedef wall quads with per-wall 'wall_width' thickness
        (corner thickness = average of adjacent walls, sector.rs:437-580).
        -> {linedef_id: ([4 verts], [(0,1,3), (1,2,3)])} or None when no
        wall has width."""

        def width(lid):
            ld = map_.find_linedef(lid)
            if ld is None:
                return 0.0
            return ld.properties.get_float_default("wall_width", 0.0)

        if not any(width(lid) > 0.0 for lid in self.linedefs):
            return None
        n = len(self.linedefs)

        def corner_thickness(i):
            return (width(self.linedefs[(i + n - 1) % n]) + width(self.linedefs[i])) * 0.5

        rings = self._wall_rings(map_, corner_thickness)
        if rings is None:
            return None
        _, outer, inner = rings
        out = {}
        for i in range(len(outer)):
            nxt = (i + 1) % len(outer)
            o1, o2 = outer[i], outer[nxt]
            i1, i2 = inner[i], inner[nxt]
            verts = [
                [float(o1[0]), float(o1[1])],
                [float(o2[0]), float(o2[1])],
                [float(i2[0]), float(i2[1])],
                [float(i1[0]), float(i1[1])],
            ]
            out[self.linedefs[i]] = (verts, [(0, 1, 3), (1, 2, 3)])
        return out

    def vertices_world(self, map_) -> Optional[list]:
        """Loop start-vertices as (x, z, y) world points, deduped
        (sector.rs:44-56)."""
        verts = []
        for lid in self.linedefs:
            ld = map_.find_linedef(lid)
            if ld is None:
                return None
            v = map_.get_vertex(ld.start_vertex)
            if v is None:
                return None
            p = np.array([v.x, getattr(v, "z", 0.0), v.y], np.float32)
            if not verts or not np.array_equal(verts[-1], p):
                verts.append(p)
        if len(verts) < 3:
            return None
        return verts

    def y_span(self, map_) -> Optional[Tuple[float, float]]:
        """World-y extent of the loop (sector.rs:59-72)."""
        verts = self.vertices_world(map_)
        if verts is None:
            return None
        ys = [float(p[1]) for p in verts]
        return min(ys), max(ys)

    def intersects_vertical_slice(self, map_, slice_y: float, thickness: float) -> bool:
        """sector.rs:75-87."""
        if thickness <= 0.0:
            return False
        span = self.y_span(map_)
        if span is None:
            return False
        half = thickness * 0.5
        return span[1] >= slice_y - half and span[0] <= slice_y + half

    def center_3d(self, map_) -> Optional[np.ndarray]:
        """Average of loop endpoint world positions (sector.rs:146-169)."""
        pts = []
        for lid in self.linedefs:
            ld = map_.find_linedef(lid)
            if ld is None:
                continue
            for vid in (ld.start_vertex, ld.end_vertex):
                v = map_.get_vertex(vid)
                if v is not None:
                    pts.append([v.x, getattr(v, "z", 0.0), v.y])
        if not pts:
            return None
        return np.mean(np.asarray(pts, np.float32), axis=0)

    def get_random_position(self, map_, rng=None) -> Optional[np.ndarray]:
        """Uniform random point inside the sector: random triangle +
        sqrt-barycentric sample (sector.rs:237-269 — commented out there
        mid-refactor; this is the documented intent, used by the
        random_walk_in_sector entity action)."""
        import random as _random

        rng = rng if rng is not None else _random
        geo = self.generate_geometry(map_)
        if not geo:
            return None
        vertices, indices = geo
        if not indices:
            return None
        i1, i2, i3 = indices[rng.randrange(len(indices))] if hasattr(
            rng, "randrange"
        ) else indices[int(rng.random() * len(indices))]
        v1, v2, v3 = (np.asarray(vertices[i], np.float32) for i in (i1, i2, i3))
        r1, r2 = rng.random(), rng.random()
        sqrt_r1 = float(np.sqrt(r1))
        u = 1.0 - sqrt_r1
        v = r2 * sqrt_r1
        return u * v1 + v * v2 + (1.0 - u - v) * v3

    def area(self, map_) -> float:
        from .geometry import polygon_area

        poly = self.polygon(map_)
        if len(poly) < 3:
            return 0.0
        return abs(polygon_area([(p[0], p[1]) for p in poly]))

    def is_inside(self, map_, point) -> bool:
        """Ray casting point-in-polygon (sector.rs:272-300)."""
        poly = self.polygon(map_)
        if len(poly) < 3:
            return False
        x, y = float(point[0]), float(point[1])
        inside = False
        j = len(poly) - 1
        for i in range(len(poly)):
            xi, yi = poly[i]
            xj, yj = poly[j]
            if (yi > y) != (yj > y) and x < (xj - xi) * (y - yi) / (yj - yi) + xi:
                inside = not inside
            j = i
        return inside

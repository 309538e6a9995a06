"""Planar 3D surfaces attached to sectors (reference src/map/surface.rs).

A Surface carries a plane + orthonormal frame fitted to its sector's world
vertices (Newell plane), UV mapping helpers, an extrusion spec, profile loops
with non-destructive ops (hole/relief/recess/billboard), and billboard
animation state for doors/gates. The builders consume surfaces to emit caps,
side walls and features.
"""

from __future__ import annotations

import enum
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


class BillboardAnimation(enum.IntEnum):
    """surface.rs:10-18."""

    Nothing = 0
    OpenUp = 1
    OpenRight = 2
    OpenDown = 3
    OpenLeft = 4
    Fade = 5


class LoopOpKind(enum.IntEnum):
    Nothing = 0  # hole
    Relief = 1
    Recess = 2
    Billboard = 3


@dataclass
class LoopOp:
    """surface.rs:22-36."""

    kind: LoopOpKind = LoopOpKind.Nothing
    height: float = 0.0  # Relief
    depth: float = 0.0  # Recess / Billboard inset
    tile_id: Optional[str] = None  # Billboard
    animation: BillboardAnimation = BillboardAnimation.Nothing
    target_side: int = 0  # 0 = front cap, 1 = back cap ("profile_target")


@dataclass
class ProfileLoop:
    """surface.rs:82-88: closed loop in the surface's UV space."""

    path: List[Tuple[float, float]] = field(default_factory=list)
    op: LoopOp = field(default_factory=LoopOp)
    origin_profile_sector: Optional[int] = None


@dataclass
class Plane:
    origin: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    normal: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))


@dataclass
class Basis3:
    right: np.ndarray = field(default_factory=lambda: np.array([1, 0, 0], np.float32))
    up: np.ndarray = field(default_factory=lambda: np.array([0, 0, 1], np.float32))
    normal: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))


class ExtrudeUVMode(enum.IntEnum):
    Stretch = 0
    PlanarFront = 1


@dataclass
class ExtrusionSpec:
    """surface.rs:143-170."""

    enabled: bool = False
    depth: float = 0.0
    cap_front: bool = True
    cap_back: bool = False
    flip_normal: bool = False
    uv_mode: ExtrudeUVMode = ExtrudeUVMode.Stretch
    uv_scale: Tuple[float, float] = (1.0, 1.0)


def _normalize_or_zero(v):
    n = float(np.linalg.norm(v))
    return v / n if n > 1e-12 else np.zeros(3, np.float32)


def _newell_plane(points):
    """Newell's method plane fit: (centroid, normal)."""
    n = np.zeros(3, np.float64)
    c = np.zeros(3, np.float64)
    m = len(points)
    for i in range(m):
        p0 = points[i]
        p1 = points[(i + 1) % m]
        n[0] += (p0[1] - p1[1]) * (p0[2] + p1[2])
        n[1] += (p0[2] - p1[2]) * (p0[0] + p1[0])
        n[2] += (p0[0] - p1[0]) * (p0[1] + p1[1])
        c += np.asarray(p0, np.float64)
    ln = np.linalg.norm(n)
    if ln > 1e-12:
        n = n / ln
    return (c / m).astype(np.float32), n.astype(np.float32)


def _stable_right(points, normal):
    """Longest-edge direction projected off the normal."""
    best = None
    best_len = -1.0
    m = len(points)
    for i in range(m):
        e = np.asarray(points[(i + 1) % m], np.float32) - np.asarray(points[i], np.float32)
        l = float(np.linalg.norm(e))
        if l > best_len:
            best_len = l
            best = e
    if best is None:
        return np.array([1, 0, 0], np.float32)
    r = best - normal * float(np.dot(best, normal))
    return _normalize_or_zero(r)


@dataclass
class Surface:
    """surface.rs Surface struct."""

    sector_id: int = 0
    id: str = field(default_factory=lambda: str(uuid_mod.uuid4()))
    plane: Plane = field(default_factory=Plane)
    frame: Basis3 = field(default_factory=Basis3)
    edit_scale: float = 1.0
    extrusion: ExtrusionSpec = field(default_factory=ExtrusionSpec)
    profile: Optional[str] = None  # key into map.profiles (editor profile map)
    profile_loops: List[ProfileLoop] = field(default_factory=list)
    billboard_progress: float = 0.0  # door/gate open state 0..1

    def is_valid(self) -> bool:
        return bool(
            np.isfinite(self.plane.origin).all()
            and np.isfinite(self.frame.right).all()
            and np.isfinite(self.frame.up).all()
            and np.isfinite(self.frame.normal).all()
        )

    def calculate_geometry(self, map_) -> None:
        """Fit plane + orthonormal basis to the sector polygon
        (surface.rs:222-275)."""
        sector = map_.find_sector(self.sector_id)
        if sector is None:
            return
        pts2 = sector.polygon(map_)
        if len(pts2) < 3:
            return
        # map 2D map coords (x, y) -> world (x, z); vertex z = world height
        points = []
        for lid in sector.linedefs:
            ld = map_.find_linedef(lid)
            v = map_.get_vertex(ld.start_vertex) if ld else None
            if v is not None:
                points.append(v.as_vec3_world())
        if len(points) < 3:
            return

        centroid, normal = _newell_plane(points)
        if float(np.linalg.norm(normal)) < 1e-6:
            normal = np.array([0, 1, 0], np.float32)
        right = _stable_right(points, normal)
        up = _normalize_or_zero(np.cross(normal, right))
        if float(np.linalg.norm(up)) < 1e-6:
            right = _normalize_or_zero(np.cross(normal, np.array([0, 1, 0], np.float32)))
            up = _normalize_or_zero(np.cross(normal, right))
        if float(np.linalg.norm(up)) < 1e-6:
            right = np.array([1, 0, 0], np.float32)
            up = _normalize_or_zero(np.cross(normal, right))

        self.plane = Plane(origin=centroid, normal=normal)
        self.frame = Basis3(right=right, up=up, normal=normal)
        self.edit_scale = 1.0

    # -- UV mapping (surface.rs:277-330) --

    def uv_to_world(self, uv) -> np.ndarray:
        return (
            self.plane.origin
            + self.frame.right * (uv[0] * self.edit_scale)
            + self.frame.up * (uv[1] * self.edit_scale)
        )

    def uvw_to_world(self, uv, w: float) -> np.ndarray:
        return self.uv_to_world(uv) + self.frame.normal * w

    def world_to_uv(self, p) -> np.ndarray:
        rel = np.asarray(p, np.float32) - self.plane.origin
        return (
            np.array(
                [float(np.dot(rel, self.frame.right)), float(np.dot(rel, self.frame.up))],
                np.float32,
            )
            / self.edit_scale
        )

    def world_to_tile(self, p) -> Tuple[int, int]:
        uv = self.world_to_uv(p)
        return int(np.floor(uv[0])), int(np.floor(uv[1]))

    def tile_outline_world(self, tile: Tuple[int, int]):
        tx, ty = tile
        return [
            self.uv_to_world((tx, ty)),
            self.uv_to_world((tx + 1, ty)),
            self.uv_to_world((tx + 1, ty + 1)),
            self.uv_to_world((tx, ty + 1)),
        ]

    def sector_loop_uv(self, map_) -> Optional[List[Tuple[float, float]]]:
        """Sector polygon projected to UV space, CCW (surface.rs:318-330)."""
        sector = map_.find_sector(self.sector_id)
        if sector is None:
            return None
        points = []
        for lid in sector.linedefs:
            ld = map_.find_linedef(lid)
            v = map_.get_vertex(ld.start_vertex) if ld else None
            if v is not None:
                points.append(v.as_vec3_world())
        if len(points) < 3:
            return None
        uv = [tuple(self.world_to_uv(p)) for p in points]
        from .geometry import polygon_area

        if polygon_area(uv) < 0:
            uv.reverse()
        return uv

    def triangulate_cap_with_holes(self, outer, holes):
        """UV loops -> (world_positions, triangles, uvs) (surface.rs:330+)."""
        from .geometry import triangulate_polygon

        pts, tris = triangulate_polygon(outer, holes)
        world = [self.uv_to_world(p) for p in pts]
        return np.asarray(world, np.float32), np.asarray(tris, np.int32), np.asarray(
            pts, np.float32
        )

    def build_extruded_batches(self, map_, sector=None, source=None):
        """Extrusion caps + jamb side bands as Batch3D — thin wrapper over
        the full surface builder (builders/surfacebuilder.py)."""
        from ..builders.surfacebuilder import build_surface_batches

        if sector is None:
            sector = map_.find_sector(self.sector_id)
        if sector is None:
            return []
        if source is not None:
            sector.properties.set("source", source)
        batches, _bb = build_surface_batches(map_, sector, self)
        return batches

    def build_cap_batch(self, map_, source=None):
        """Flat cap (with hole loops applied) as a Batch3D."""
        from ..models.batch import Batch3D, PixelSource

        outer = self.sector_loop_uv(map_)
        if outer is None:
            return None
        holes = [
            l.path for l in self.profile_loops if l.op.kind == LoopOpKind.Nothing and l.path
        ]
        world, tris, uvs = self.triangulate_cap_with_holes(outer, holes)
        verts = np.concatenate(
            [world, np.ones((len(world), 1), np.float32)], axis=1
        )
        normals = np.tile(self.frame.normal, (len(world), 1))
        batch = Batch3D(
            vertices=verts,
            indices=tris,
            uvs=uvs,
            normals=normals.astype(np.float32),
            source=source if source is not None else PixelSource.off(),
        )
        return batch

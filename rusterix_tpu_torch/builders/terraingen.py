"""Procedural terrain generation from map control points
(reference src/chunkbuilder/terrain_generator.rs + TERRAIN.md).

Height pipeline per grid point (TERRAIN.md "Height Calculation Order"):
  1. control vertices (terrain_control=true, vertex.z = height) create round
     hills via circle-SDF smoothstep falloff scaled by `smoothness`; MAX of
     all contributions (terrain_generator.rs:650-712)
  2. ridge sectors (terrain_mode=2) ADD plateau+falloff height from distance
     to the sector boundary (:513-548)
  3. terrain_smooth linedefs BLEND toward the corridor target height
     interpolated between their endpoint z values (:555-620)
  4. map-edge falloff to 0 within 10 world units of the map bbox (:718-745)

All per-point math is vectorized NumPy over the whole grid — this runs at
build time, producing mesh arrays that feed the packed device scene.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

DEFAULT_TERRAIN_TILE = "27826750-a9e7-4346-994b-fb318b238452"  # TERRAIN.md


@dataclass
class TerrainConfig:
    """terrain_generator.rs:22-43."""

    subdivisions: int = 1
    idw_power: float = 2.0
    max_influence_distance: float = 50.0
    smoothness: float = 1.0


def _smoothstep(t):
    return t * t * (3.0 - 2.0 * t)


def _collect_control_points(map_, config: TerrainConfig):
    out = []
    for v in map_.vertices:
        if not v.properties.get_bool_default("terrain_control", False):
            continue
        sm = v.properties.get_float_default("smoothness", config.smoothness)
        out.append((float(v.x), float(v.y), float(v.z), float(sm)))
    return out


def _collect_ridge_sectors(map_):
    out = []
    for s in map_.sectors:
        if s.properties.get_int_default("terrain_mode", 0) != 2:
            continue
        out.append(
            (
                s,
                s.properties.get_float_default("ridge_height", 1.0),
                s.properties.get_float_default("ridge_plateau_width", 0.0),
                s.properties.get_float_default("ridge_falloff_distance", 5.0),
                s.properties.get_float_default("ridge_falloff_steepness", 2.0),
            )
        )
    return out


def _collect_terrain_linedefs(map_):
    out = []
    for ld in map_.linedefs:
        if not ld.properties.get_bool_default("terrain_smooth", False):
            continue
        v0 = map_.get_vertex(ld.start_vertex)
        v1 = map_.get_vertex(ld.end_vertex)
        if v0 is None or v1 is None:
            continue
        out.append(
            (
                (float(v0.x), float(v0.y)),
                (float(v1.x), float(v1.y)),
                float(v0.z),
                float(v1.z),
                ld.properties.get_float_default("terrain_width", 2.0),
                ld.properties.get_float_default("terrain_falloff_distance", 3.0),
                ld.properties.get_float_default("terrain_falloff_steepness", 2.0),
            )
        )
    return out


def _sector_edges(sector, map_) -> np.ndarray:
    segs = []
    for lid in sector.linedefs:
        ld = map_.find_linedef(lid)
        if ld is None:
            continue
        v0 = map_.get_vertex(ld.start_vertex)
        v1 = map_.get_vertex(ld.end_vertex)
        if v0 is None or v1 is None:
            continue
        segs.append(((v0.x, v0.y), (v1.x, v1.y)))
    return np.asarray(segs, np.float32).reshape(-1, 2, 2)


def _segment_distance(px, py, edges: np.ndarray) -> np.ndarray:
    """Min point-segment distance over all edges, vectorized over points."""
    if len(edges) == 0:
        return np.full(px.shape, np.inf, np.float32)
    a, b = edges[:, 0], edges[:, 1]
    e = b - a
    ee = np.maximum((e * e).sum(axis=1), 1e-8)
    t = np.clip(
        ((px[..., None] - a[:, 0]) * e[:, 0] + (py[..., None] - a[:, 1]) * e[:, 1])
        / ee,
        0.0,
        1.0,
    )
    cx = a[:, 0] + t * e[:, 0]
    cy = a[:, 1] + t * e[:, 1]
    return np.sqrt(((px[..., None] - cx) ** 2 + (py[..., None] - cy) ** 2).min(axis=-1))


def _point_in_polygon(px, py, poly: np.ndarray):
    inside = np.zeros(px.shape, bool)
    n = len(poly)
    for i in range(n):
        x0, y0 = poly[i]
        x1, y1 = poly[(i + 1) % n]
        cond = (y0 > py) != (y1 > py)
        with np.errstate(divide="ignore", invalid="ignore"):
            xin = (x1 - x0) * (py - y0) / (y1 - y0 + 1e-30) + x0
        inside ^= cond & (px < xin)
    return inside


def _map_bbox(map_) -> Tuple[float, float, float, float]:
    if not map_.vertices:
        return (-100.0, -100.0, 100.0, 100.0)
    xs = [v.x for v in map_.vertices]
    ys = [v.y for v in map_.vertices]
    return (min(xs), min(ys), max(xs), max(ys))


class TerrainGenerator:
    """terrain_generator.rs:45-1056, vectorized."""

    def __init__(self, config: Optional[TerrainConfig] = None):
        self.config = config or TerrainConfig()

    # ---- height model ----

    def interpolate_height_at(self, px, py, control_points, bbox) -> np.ndarray:
        """Circle-SDF smoothstep hills, MAX-combined, with map-edge falloff
        (terrain_generator.rs:650-712)."""
        px = np.asarray(px, np.float32)
        py = np.asarray(py, np.float32)
        best = np.zeros(px.shape, np.float32)
        for cx, cy, h, sm in control_points:
            dist = np.hypot(px - cx, py - cy)
            radius = sm * 2.0
            smoothing = radius
            sdf = dist - radius
            t = np.clip((smoothing - sdf) / (2.0 * smoothing), 0.0, 1.0)
            falloff = np.where(
                sdf < -smoothing, 1.0, np.where(sdf > smoothing, 0.0, _smoothstep(t))
            )
            contrib = h * falloff
            # exact-hit fast path folds into falloff==1 at distance<radius
            best = np.where(contrib > best, contrib, best)
        return best * self.map_edge_falloff(px, py, bbox)

    def map_edge_falloff(self, px, py, bbox) -> np.ndarray:
        """0 at the map boundary, 1 beyond 10 units inside (:718-745)."""
        x0, y0, x1, y1 = bbox
        d = np.minimum(
            np.minimum(px - x0, x1 - px), np.minimum(py - y0, y1 - py)
        )
        t = np.clip(d / 10.0, 0.0, 1.0)
        return np.where(d <= 0.0, 0.0, _smoothstep(t)).astype(np.float32)

    def calculate_ridge_height_at(self, px, py, ridge_sectors, map_) -> np.ndarray:
        """Additive plateau+falloff per ridge sector (:513-548)."""
        px = np.asarray(px, np.float32)
        py = np.asarray(py, np.float32)
        total = np.zeros(px.shape, np.float32)
        for sector, height, plateau_w, fall_d, fall_s in ridge_sectors:
            edges = _sector_edges(sector, map_)
            dist = _segment_distance(px, py, edges)
            falloff_dist = dist - plateau_w
            t = 1.0 - np.clip(falloff_dist / max(fall_d, 1e-8), 0.0, 1.0)
            contrib = np.where(
                dist <= plateau_w,
                height,
                np.where(falloff_dist >= fall_d, 0.0, height * t ** fall_s),
            )
            total += contrib
        return total

    def apply_linedef_smoothing(self, px, py, heights, terrain_linedefs) -> np.ndarray:
        """Corridor blending toward interpolated endpoint heights (:555-620)."""
        final = np.asarray(heights, np.float32).copy()
        current = final.copy()
        total_influence = np.zeros_like(final)
        for (a, b, h0, h1, width, fall_d, fall_s) in terrain_linedefs:
            ax, ay = a
            bx, by = b
            sx, sy = bx - ax, by - ay
            len_sq = sx * sx + sy * sy
            if len_sq < 1e-8:
                dist = np.hypot(px - ax, py - ay)
                tpar = np.zeros_like(dist)
            else:
                tpar = np.clip(((px - ax) * sx + (py - ay) * sy) / len_sq, 0.0, 1.0)
                dist = np.hypot(px - (ax + sx * tpar), py - (ay + sy * tpar))
            target = h0 + (h1 - h0) * tpar
            falloff_dist = dist - width
            t = 1.0 - np.clip(falloff_dist / max(fall_d, 1e-8), 0.0, 1.0)
            infl = np.where(
                dist <= width,
                1.0,
                np.where(falloff_dist >= fall_d, 0.0, t ** fall_s),
            )
            total_influence += infl
            final = final * (1.0 - infl) + target * infl
        # over-smoothing clamp when corridors overlap (:613-618)
        excess = np.maximum(total_influence - 1.0, 0.0)
        final = final * (1.0 - excess * 0.5) + current * (excess * 0.5)
        return final

    def height_field(self, map_, px, py) -> np.ndarray:
        cps = _collect_control_points(map_, self.config)
        ridges = _collect_ridge_sectors(map_)
        lds = _collect_terrain_linedefs(map_)
        bbox = _map_bbox(map_)
        px = np.asarray(px, np.float32)
        py = np.asarray(py, np.float32)
        base = self.interpolate_height_at(px, py, cps, bbox)
        base = base + self.calculate_ridge_height_at(px, py, ridges, map_)
        return self.apply_linedef_smoothing(px, py, base, lds)

    # ---- mesh generation (:247-460, :747-950) ----

    def generate(
        self,
        map_,
        bbox: Tuple[float, float, float, float],
        assets=None,
        default_source=None,
        tile_overrides: Optional[Dict[Tuple[int, int], object]] = None,
    ):
        """-> list of (PixelSource, verts (N,3), indices (M,3), uvs (N,2))."""
        cell = 1.0 / self.config.subdivisions
        min_x, min_y = np.floor(bbox[0]), np.floor(bbox[1])
        max_x, max_y = np.ceil(bbox[2]), np.ceil(bbox[3])
        cols = int(np.ceil((max_x - min_x) / cell)) + 1
        rows = int(np.ceil((max_y - min_y) / cell)) + 1
        gx, gy = np.meshgrid(
            min_x + np.arange(cols, dtype=np.float32) * cell,
            min_y + np.arange(rows, dtype=np.float32) * cell,
        )
        px = gx.reshape(-1)
        py = gy.reshape(-1)

        heights = self.height_field(map_, px, py)

        # grid triangulation (two CCW triangles per cell, :829-880)
        idx = np.arange(rows * cols).reshape(rows, cols)
        i0 = idx[:-1, :-1].reshape(-1)
        i1 = i0 + 1
        i2 = i0 + cols
        i3 = i2 + 1
        tris = np.concatenate(
            [
                np.stack([i0, i2, i1], axis=1),
                np.stack([i1, i2, i3], axis=1),
            ],
            axis=1,
        ).reshape(-1, 3)

        # exclusion: drop triangles fully inside terrain_mode=1 sectors (:747)
        excluded = [
            s
            for s in map_.sectors
            if s.properties.get_int_default("terrain_mode", 0) == 1
        ]
        if excluded:
            keep = np.ones(len(tris), bool)
            for sector in excluded:
                poly = _sector_edges(sector, map_)[:, 0]
                if len(poly) < 3:
                    continue
                inside = _point_in_polygon(px, py, poly)
                keep &= ~(inside[tris[:, 0]] & inside[tris[:, 1]] & inside[tris[:, 2]])
            tris = tris[keep]
        if len(tris) == 0:
            return []

        verts = np.stack([px, heights, py], axis=1).astype(np.float32)
        uvs = np.stack([px, py], axis=1).astype(np.float32)  # world xz -> uv

        # partition by 1x1 tile of the triangle centroid (:954-1035)
        from ..models.batch import PixelSource

        default_src = default_source
        if default_src is None:
            dv = map_.properties.get("default_terrain_tile") if hasattr(map_, "properties") else None
            default_src = dv.data if dv is not None and dv.data is not None else PixelSource.terrain()

        if not tile_overrides:
            return [(default_src, verts, tris.astype(np.int32), uvs)]

        cen_u = uvs[tris, 0].mean(axis=1)
        cen_v = uvs[tris, 1].mean(axis=1)
        cells = np.stack(
            [np.floor(cen_u).astype(int), np.floor(cen_v).astype(int)], axis=1
        )
        groups: Dict[int, Tuple[object, List[int]]] = {}
        for ti, cellxy in enumerate(map(tuple, cells)):
            src = tile_overrides.get(cellxy, default_src)
            key = id(src)
            groups.setdefault(key, (src, []))[1].append(ti)
        out = []
        for src, tlist in groups.values():
            sub = tris[tlist]
            used, remap = np.unique(sub, return_inverse=True)
            out.append(
                (
                    src,
                    verts[used],
                    remap.reshape(-1, 3).astype(np.int32),
                    uvs[used],
                )
            )
        return out

    # ---- sampling API (terrain_generator.rs:57-192) ----

    def sample_height_at(self, map_, point) -> float:
        p = np.asarray(point, np.float32)
        return float(self.height_field(map_, p[..., 0], p[..., 1]))

    def sample_normal_at(self, map_, point, eps: float = 0.5) -> np.ndarray:
        x, y = float(point[0]), float(point[1])
        px = np.array([x - eps, x + eps, x, x], np.float32)
        py = np.array([y, y, y - eps, y + eps], np.float32)
        h = self.height_field(map_, px, py)
        n = np.array([h[0] - h[1], 2.0 * eps, h[2] - h[3]], np.float32)
        ln = np.linalg.norm(n)
        return n / ln if ln > 0 else np.array([0, 1, 0], np.float32)

    def tile_normal(self, map_, tile: Tuple[int, int]) -> np.ndarray:
        return self.sample_normal_at(map_, (tile[0] + 0.5, tile[1] + 0.5))


def sample_height_at(map_, point, config: Optional[TerrainConfig] = None) -> float:
    return TerrainGenerator(config).sample_height_at(map_, point)

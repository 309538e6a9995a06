"""Chunked 2D collision world (reference src/collision_world.rs).

Swept-circle movement with wall sliding (friction 0.5), corner handling and
a final push-out pass (`move_distance`, collision_world.rs:144-246); doors/
windows as dynamic openings; walkable floor heights.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

EPSILON = 0.001


class OpeningType(enum.IntEnum):
    """reference collision_world.rs:52-57"""

    Door = 0
    Window = 1
    Passage = 2


@dataclass
class BlockingVolume:
    geo_id: object
    min: np.ndarray  # (3,)
    max: np.ndarray  # (3,)


@dataclass
class DynamicOpening:
    geo_id: object
    boundary_2d: List[np.ndarray]
    floor_height: float = 0.0
    ceiling_height: float = 3.0
    opening_type: OpeningType = OpeningType.Door
    item_blocking: Optional[bool] = None


@dataclass
class WalkableFloor:
    geo_id: object
    height: float
    polygon_2d: List[np.ndarray]


@dataclass
class ChunkCollision:
    static_volumes: List[BlockingVolume] = field(default_factory=list)
    dynamic_openings: List[DynamicOpening] = field(default_factory=list)
    walkable_floors: List[WalkableFloor] = field(default_factory=list)


@dataclass
class DynamicState:
    is_passable: bool = False
    animation_progress: float = 0.0


def _v2(x):
    return np.asarray(x, np.float32)


class CollisionWorld:
    def __init__(self, chunk_size: int = 10):
        self.chunks: Dict[Tuple[int, int], ChunkCollision] = {}
        self.dynamic_states: Dict[object, DynamicState] = {}
        self.chunk_size = chunk_size

    def update_chunk(self, chunk_origin, collision: ChunkCollision) -> None:
        self.chunks[tuple(chunk_origin)] = collision

    def remove_chunk(self, chunk_origin) -> None:
        self.chunks.pop(tuple(chunk_origin), None)

    def world_to_chunk(self, p) -> Tuple[int, int]:
        return (
            int(math.floor(p[0] / self.chunk_size)),
            int(math.floor(p[1] / self.chunk_size)),
        )

    def _neighbor_chunks(self, p2):
        cx, cy = self.world_to_chunk(p2)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                c = self.chunks.get((cx + dx, cy + dy))
                if c is not None:
                    yield c

    # ---- state ----

    def set_opening_state(self, geo_id, is_passable: bool) -> None:
        st = self.dynamic_states.setdefault(geo_id, DynamicState())
        st.is_passable = is_passable
        for chunk in self.chunks.values():
            for opening in chunk.dynamic_openings:
                if opening.geo_id == geo_id:
                    opening.item_blocking = not is_passable

    def get_opening_state(self, geo_id) -> Optional[DynamicState]:
        return self.dynamic_states.get(geo_id)

    def _opening_is_passable(self, opening: DynamicOpening) -> bool:
        if opening.opening_type == OpeningType.Passage:
            return True
        if opening.opening_type == OpeningType.Window:
            return False
        st = self.dynamic_states.get(opening.geo_id)
        return st.is_passable if st is not None else True  # doors default open

    def _opening_is_blocking(self, opening: DynamicOpening) -> bool:
        if opening.opening_type == OpeningType.Passage:
            return False
        if opening.opening_type == OpeningType.Window:
            return True
        st = self.dynamic_states.get(opening.geo_id)
        return (not st.is_passable) if st is not None else False

    # ---- queries ----

    def collides_with_aabb(self, position, radius, mn, mx) -> bool:
        p = np.asarray(position, np.float32)
        closest = np.clip(p, mn, mx)
        d = p - closest
        return float(np.dot(d, d)) <= radius * radius

    def point_in_polygon_2d(self, point, polygon, padding: float = 0.0) -> bool:
        if len(polygon) < 3:
            return False
        x, y = float(point[0]), float(point[1])
        inside = False
        j = len(polygon) - 1
        for i in range(len(polygon)):
            xi, yi = polygon[i]
            xj, yj = polygon[j]
            if (yi > y) != (yj > y) and x < (xj - xi) * (y - yi) / (yj - yi) + xi:
                inside = not inside
            j = i
        if inside:
            return True
        if padding > 0.0:
            for i in range(len(polygon)):
                a = _v2(polygon[i])
                b = _v2(polygon[(i + 1) % len(polygon)])
                if _point_segment_dist(_v2(point), a, b) <= padding:
                    return True
        return False

    def is_blocked(self, position, radius: float) -> bool:
        """reference collision_world.rs:124-142 + check_chunk_collision."""
        p2 = (position[0], position[2])
        for chunk in self._neighbor_chunks(p2):
            if self._check_chunk_collision(position, radius, chunk):
                return True
        return False

    def _check_chunk_collision(self, position, radius, chunk) -> bool:
        p2 = np.array([position[0], position[2]], np.float32)
        y = float(position[1])
        for opening in chunk.dynamic_openings:
            if self._opening_is_passable(opening):
                if (
                    y + radius >= opening.floor_height
                    and y - radius <= opening.ceiling_height
                    and self.point_in_polygon_2d(p2, opening.boundary_2d, radius)
                ):
                    return False
        for volume in chunk.static_volumes:
            if self.collides_with_aabb(position, radius, volume.min, volume.max):
                return True
        for opening in chunk.dynamic_openings:
            if self._opening_is_blocking(opening):
                if (
                    y + radius >= opening.floor_height
                    and y - radius <= opening.ceiling_height
                    and self.point_in_polygon_2d(p2, opening.boundary_2d, radius)
                ):
                    return True
        return False

    def get_floor_height(self, position) -> Optional[float]:
        chunk = self.chunks.get(self.world_to_chunk(position))
        if chunk is not None:
            for floor in chunk.walkable_floors:
                if self.point_in_polygon_2d(position, floor.polygon_2d, 0.0):
                    return floor.height
        return None

    def _is_in_passable_opening(self, position, radius) -> bool:
        p2 = (position[0], position[2])
        y = float(position[1])
        for chunk in self._neighbor_chunks(p2):
            for opening in chunk.dynamic_openings:
                if (
                    self._opening_is_passable(opening)
                    and y + radius >= opening.floor_height
                    and y - radius <= opening.ceiling_height
                    and self.point_in_polygon_2d(
                        np.array([position[0], position[2]]), opening.boundary_2d, radius
                    )
                ):
                    return True
        return False

    def _collect_blocking_segments(self, position, radius):
        p2 = (position[0], position[2])
        y = float(position[1])
        segments = []
        for chunk in self._neighbor_chunks(p2):
            for volume in chunk.static_volumes:
                mn, mx = volume.min, volume.max
                corners = [
                    _v2((mn[0], mn[2])),
                    _v2((mx[0], mn[2])),
                    _v2((mx[0], mx[2])),
                    _v2((mn[0], mx[2])),
                ]
                for i in range(4):
                    segments.append((corners[i], corners[(i + 1) % 4]))
            for opening in chunk.dynamic_openings:
                if (
                    self._opening_is_blocking(opening)
                    and y + radius >= opening.floor_height
                    and y - radius <= opening.ceiling_height
                ):
                    poly = opening.boundary_2d
                    for i in range(len(poly)):
                        segments.append(
                            (_v2(poly[i]), _v2(poly[(i + 1) % len(poly)]))
                        )
        return segments

    # ---- movement (collision_world.rs:144-246) ----

    def move_distance(self, start_pos, move_vector, radius: float):
        start_pos = np.asarray(start_pos, np.float32)
        move_vector = np.asarray(move_vector, np.float32)
        target = start_pos + move_vector
        if self._is_in_passable_opening(target, radius):
            return target, False

        current = start_pos.copy()
        current[1] = target[1]

        current_2d = np.array([start_pos[0], start_pos[2]], np.float32)
        remaining = np.array([move_vector[0], move_vector[2]], np.float32)
        blocked = False

        segments = self._collect_blocking_segments(start_pos, radius)

        # native fast path (native/rusterix_native.cpp rx_move_distance)
        if segments:
            from ..native import move_distance_native

            flat = np.array(
                [[a[0], a[1], b[0], b[1]] for a, b in segments], np.float32
            )
            out = move_distance_native(flat, start_pos, move_vector, radius)
            if out is not None:
                return out

        iterations = 0
        while float(np.dot(remaining, remaining)) > EPSILON * EPSILON and iterations < 3:
            iterations += 1
            closest = None
            for a, b in segments:
                hit = _check_intersection(current_2d, current_2d + remaining, a, b, radius)
                if hit is not None and (closest is None or hit[0] < closest[0]):
                    closest = hit
            if closest is None:
                current_2d = current_2d + remaining
                remaining = np.zeros(2, np.float32)
            else:
                distance, normal = closest
                blocked = True
                mv_len = float(np.linalg.norm(remaining))
                move_dir = remaining / max(mv_len, 1e-12)
                current_2d = current_2d + move_dir * (distance - EPSILON)
                leftover = mv_len - distance
                if leftover > EPSILON:
                    normal_component = float(np.dot(normal, remaining)) * normal
                    slide = remaining - normal_component
                    slide_len = float(np.linalg.norm(slide))
                    if slide_len > EPSILON:
                        remaining = slide / slide_len * leftover * 0.5  # friction
                    else:
                        remaining = np.zeros(2, np.float32)
                else:
                    remaining = np.zeros(2, np.float32)
                current_2d = current_2d + normal * EPSILON

        for a, b in segments:
            hit = _check_point_against_segment(current_2d, a, b, radius)
            if hit is not None:
                dist, normal = hit
                penetration = radius - dist
                if penetration > 0.0:
                    blocked = True
                    current_2d = current_2d + normal * (penetration + EPSILON)

        current[0] = current_2d[0]
        current[2] = current_2d[1]
        return current, blocked


def _check_intersection(start, end, line_start, line_end, radius):
    """Swept circle vs segment (collision_world.rs check_intersection)."""
    line_vec = line_end - line_start
    line_len = float(np.linalg.norm(line_vec))
    if line_len < 1e-7:
        return None
    line_dir = line_vec / line_len
    normal = np.array([-line_dir[1], line_dir[0]], np.float32)

    start_dist = float(np.dot(start - line_start, normal))
    end_dist = float(np.dot(end - line_start, normal))

    if start_dist > radius and end_dist > radius:
        return None
    if start_dist < -radius and end_dist < -radius:
        return None

    diff = end_dist - start_dist
    if abs(diff) < 1e-7:
        if abs(start_dist) <= radius:
            t = 0.0
        else:
            return None
    else:
        desired = -radius if start_dist < 0.0 else radius
        t = (desired - start_dist) / diff
    if not (0.0 <= t <= 1.0):
        return None

    intersection = start + (end - start) * t
    line_proj = float(np.dot(intersection - line_start, line_dir))
    if line_proj < 0.0 or line_proj > line_len:
        corner = line_start if line_proj < 0.0 else line_end
        return _check_point_collision(intersection, corner, radius, start)

    collision_dist = float(np.linalg.norm(intersection - start))
    final_normal = -normal if start_dist < 0.0 else normal
    return collision_dist, final_normal


def _check_point_collision(collision_point, corner, radius, start):
    to_corner = collision_point - corner
    dist_sq = float(np.dot(to_corner, to_corner))
    if dist_sq > radius * radius:
        return None
    d = math.sqrt(dist_sq)
    if d > 1e-7:
        normal = to_corner / d
    else:
        sc = start - corner
        n = float(np.linalg.norm(sc))
        normal = sc / n if n > 1e-7 else np.array([1.0, 0.0], np.float32)
    return float(np.linalg.norm(collision_point - start)), normal


def _check_point_against_segment(point, seg_start, seg_end, radius):
    seg_vec = seg_end - seg_start
    seg_len = float(np.linalg.norm(seg_vec))
    if seg_len < 1e-7:
        d_sq = float(np.dot(point - seg_start, point - seg_start))
        if d_sq > radius * radius:
            return None
        d = math.sqrt(d_sq)
        normal = (point - seg_start) / d if d > 1e-7 else np.array([1.0, 0.0], np.float32)
        return d, normal
    seg_dir = seg_vec / seg_len
    t = float(np.clip(np.dot(point - seg_start, seg_dir), 0.0, seg_len))
    closest = seg_start + seg_dir * t
    delta = point - closest
    dist_sq = float(np.dot(delta, delta))
    if dist_sq > radius * radius:
        return None
    dist = math.sqrt(dist_sq)
    normal = delta / dist if dist > 1e-7 else np.array([1.0, 0.0], np.float32)
    return dist, normal


def _point_segment_dist(p, a, b) -> float:
    e = b - a
    ln = float(np.dot(e, e))
    if ln < 1e-12:
        return float(np.linalg.norm(p - a))
    t = float(np.clip(np.dot(p - a, e) / ln, 0.0, 1.0))
    return float(np.linalg.norm(p - (a + e * t)))

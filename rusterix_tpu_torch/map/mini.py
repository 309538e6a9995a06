"""MapMini — slimmed map for per-pixel lighting occlusion and server
navigation (reference src/map/mini.rs).

Holds compiled wall segments + occluded-sector boxes. The renderer consumes
`pack_device` SoA arrays: the 2D light-visibility test
(`is_visible`, mini.rs:88+) vectorizes to a pixel x segment crossing test in
the shading pass; the host methods serve the server (collision/AI).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

import numpy as np

from .elements import CompiledLinedef


@dataclass
class MapMini:
    linedefs: List[CompiledLinedef] = field(default_factory=list)
    dynamic_linedefs: List[CompiledLinedef] = field(default_factory=list)
    occluded_sectors: List[Tuple[object, float]] = field(default_factory=list)  # (Rect, occlusion)
    blocked_tiles: Set[Tuple[int, int]] = field(default_factory=set)

    def all_linedefs(self):
        return list(self.linedefs) + list(self.dynamic_linedefs)

    def get_occlusion(self, point) -> float:
        """Occlusion factor from occluded-sector boxes (mini.rs:57+)."""
        x, y = float(point[0]), float(point[1])
        occ = 1.0
        for rect, o in self.occluded_sectors:
            if rect.x <= x <= rect.max_x and rect.y <= y <= rect.max_y:
                occ = min(occ, o)
        return occ

    def is_visible(self, frm, to) -> bool:
        """Segment-vs-walls visibility (mini.rs:88+): blocked when the
        from->to segment crosses any wall segment with height > 0."""
        fx, fy = float(frm[0]), float(frm[1])
        tx, ty = float(to[0]), float(to[1])
        for ld in self.all_linedefs():
            if ld.wall_height <= 0.0:
                continue
            if _segments_intersect(
                fx, fy, tx, ty, ld.start[0], ld.start[1], ld.end[0], ld.end[1]
            ):
                return False
        return True

    def is_blocked(self, point, radius: float = 0.0) -> bool:
        x, y = float(point[0]), float(point[1])
        if (int(np.floor(x)), int(np.floor(y))) in self.blocked_tiles:
            return True
        for ld in self.all_linedefs():
            if ld.wall_height <= 0.0:
                continue
            if _point_segment_distance(x, y, ld) <= radius:
                return True
        return False

    def pathfind(self, start, goal, step: float = 0.5, max_nodes: int = 20000):
        """Grid A* over the walkable plane (reference uses the `pathfinding`
        crate, mini.rs). Returns list of (x, y) or None."""
        sx, sy = round(start[0] / step), round(start[1] / step)
        gx, gy = round(goal[0] / step), round(goal[1] / step)

        def blocked(cx, cy):
            return self.is_blocked((cx * step, cy * step), radius=step * 0.4)

        if blocked(gx, gy):
            return None
        open_q = [(0.0, (sx, sy))]
        came = {(sx, sy): None}
        cost = {(sx, sy): 0.0}
        visited = 0
        while open_q and visited < max_nodes:
            _, cur = heapq.heappop(open_q)
            visited += 1
            if cur == (gx, gy):
                path = []
                while cur is not None:
                    path.append((cur[0] * step, cur[1] * step))
                    cur = came[cur]
                return list(reversed(path))
            cx, cy = cur
            for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)):
                nxt = (cx + dx, cy + dy)
                if nxt in cost:
                    continue
                if blocked(*nxt):
                    continue
                c = cost[cur] + (1.414 if dx and dy else 1.0)
                cost[nxt] = c
                came[nxt] = cur
                h = abs(nxt[0] - gx) + abs(nxt[1] - gy)
                heapq.heappush(open_q, (c + h, nxt))
        return None

    @staticmethod
    def empty() -> "MapMini":
        """mini.rs:30-39."""
        return MapMini()

    def is_visible_and_lit(self, frm, to) -> bool:
        """Light visibility with wall-side awareness (mini.rs:98-117):
        a wall hit from its inside face still counts as lit."""
        f = np.asarray(frm, np.float32)
        t = np.asarray(to, np.float32)
        for ld in self.linedefs:
            if _segments_intersect(
                f[0], f[1], t[0], t[1],
                ld.start[0], ld.start[1], ld.end[0], ld.end[1],
            ):
                d = np.asarray(ld.end, np.float32) - np.asarray(ld.start, np.float32)
                nrm = np.linalg.norm(d)
                if nrm < 1e-20:
                    return False
                d /= nrm
                normal = np.array([-d[1], d[0]], np.float32)
                light_dir = f - t
                ln = np.linalg.norm(light_dir)
                if ln > 1e-20:
                    light_dir /= ln
                return bool(float(normal @ light_dir) < 0.0)
        return True

    def move_distance(self, start_pos, move_vector, radius: float):
        """Iterative (<=3) swept-circle move vs wall linedefs with sliding
        (friction 0.5), corner handling and a final push-out pass
        (mini.rs:120-216). -> (new_pos (2,) f32, blocked)."""
        eps = 0.001
        pos = np.asarray(start_pos, np.float32).copy()
        remaining = np.asarray(move_vector, np.float32).copy()
        blocked = False
        for _ in range(3):
            if float(remaining @ remaining) <= eps * eps:
                break
            closest = None
            for ld in self.all_linedefs():
                coll_r = radius + ld.wall_width / 2.0
                hit = _swept_circle_vs_segment(
                    pos, pos + remaining, ld.start, ld.end, coll_r
                )
                if hit is not None and (closest is None or hit[0] < closest[0]):
                    closest = hit
            if closest is None:
                pos += remaining
                break
            blocked = True
            dist, normal = closest
            mag = float(np.linalg.norm(remaining))
            move_dir = remaining / max(mag, 1e-20)
            pos += move_dir * (dist - eps)
            leftover = mag - dist
            if leftover > eps:
                slide = remaining - float(normal @ remaining) * normal
                slide_len = float(np.linalg.norm(slide))
                if slide_len > eps:
                    remaining = slide / slide_len * leftover * 0.5  # friction
                else:
                    remaining = np.zeros(2, np.float32)
            else:
                remaining = np.zeros(2, np.float32)
            pos += normal * eps
        for ld in self.all_linedefs():
            coll_r = radius + ld.wall_width / 2.0
            hit = _point_vs_segment(pos, ld.start, ld.end, coll_r)
            if hit is not None:
                dist, normal = hit
                pen = coll_r - dist
                if pen > 0.0:
                    pos += normal * (pen + eps)
        return pos, blocked

    def _tile_astar(self, start_cell, successors_ok, heuristic, is_goal,
                    max_nodes: int = 20000):
        """4-directional uniform-cost A* over blocked_tiles (the reference
        uses the `pathfinding` crate's astar, mini.rs:388-430)."""
        open_q = [(heuristic(start_cell), 0, start_cell)]
        came = {start_cell: None}
        cost = {start_cell: 0}
        visited = 0
        while open_q and visited < max_nodes:
            _, g, cur = heapq.heappop(open_q)
            visited += 1
            if is_goal(cur):
                path = []
                while cur is not None:
                    path.append(cur)
                    cur = came[cur]
                return list(reversed(path))
            for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                nxt = (cur[0] + dx, cur[1] + dy)
                if nxt in cost or not successors_ok(nxt):
                    continue
                cost[nxt] = g + 1
                came[nxt] = cur
                heapq.heappush(open_q, (g + 1 + heuristic(nxt), g + 1, nxt))
        return None

    def move_towards(self, frm, to, speed: float, radius: float,
                     tile_size: float):
        """A*-guided step toward `to` (mini.rs:388-455):
        path over the blocked-tile grid, step at `speed` toward the next
        tile center through move_distance. -> (new_pos, arrived)."""
        f = np.asarray(frm, np.float32)
        t = np.asarray(to, np.float32)
        from_tile = (int(np.floor(f[0] / tile_size)), int(np.floor(f[1] / tile_size)))
        to_tile = (int(np.floor(t[0] / tile_size)), int(np.floor(t[1] / tile_size)))
        path = self._tile_astar(
            from_tile,
            lambda p: p not in self.blocked_tiles,
            lambda p: abs(to_tile[0] - p[0]) + abs(to_tile[1] - p[1]),
            lambda p: p == to_tile,
        )
        if path is None:
            return f, False
        next_tile = path[1] if len(path) >= 2 else to_tile
        target = (np.asarray(next_tile, np.float32) + 0.5) * tile_size
        to_vec = target - f
        if float(np.linalg.norm(to_vec)) <= speed:
            return target, True
        mv = to_vec / np.linalg.norm(to_vec) * speed
        new_pos, _ = self.move_distance(f, mv, radius)
        return new_pos, False

    def close_in(self, frm, target, dest_radius: float, speed: float,
                 agent_radius: float, tile_size: float):
        """Move toward `target` until within `dest_radius` world units
        (mini.rs:458-540). -> (new_pos, arrived)."""
        f = np.asarray(frm, np.float32)
        t = np.asarray(target, np.float32)
        if float(np.linalg.norm(t - f)) <= dest_radius:
            return f, True
        start_cell = (int(np.floor(f[0] / tile_size)), int(np.floor(f[1] / tile_size)))

        def center(cell):
            return (np.asarray(cell, np.float32) + 0.5) * tile_size

        path = self._tile_astar(
            start_cell,
            lambda p: p not in self.blocked_tiles,
            lambda p: max(
                int(float(np.linalg.norm(t - center(p))) - dest_radius), 0
            ),
            lambda p: float(np.linalg.norm(center(p) - t)) <= dest_radius,
        )
        if path is None:
            return f, False
        next_cell = path[1] if len(path) >= 2 else path[0]
        tgt = center(next_cell)
        to_vec = tgt - f
        dist = float(np.linalg.norm(to_vec))
        if dist <= speed:
            new_pos = tgt
        else:
            new_pos, _ = self.move_distance(
                f, to_vec / dist * speed, agent_radius
            )
        arrived = float(np.linalg.norm(t - new_pos)) <= dest_radius
        return new_pos, arrived

    def pack_device(self, capacity: Optional[int] = None) -> dict:
        """SoA wall segments for the in-kernel visibility test."""
        lds = [ld for ld in self.all_linedefs() if ld.wall_height > 0.0]
        n = len(lds)
        cap = capacity if capacity is not None else max(1, 1 << int(np.ceil(np.log2(max(n, 1)))))
        out = {
            "seg_a": np.zeros((cap, 2), np.float32),
            "seg_b": np.zeros((cap, 2), np.float32),
            "seg_valid": np.zeros(cap, np.float32),
        }
        for i, ld in enumerate(lds[:cap]):
            out["seg_a"][i] = ld.start
            out["seg_b"][i] = ld.end
            out["seg_valid"][i] = 1.0
        return out


def _segments_intersect(ax, ay, bx, by, cx, cy, dx, dy) -> bool:
    def ccw(px, py, qx, qy, rx, ry):
        return (ry - py) * (qx - px) > (qy - py) * (rx - px)

    return ccw(ax, ay, cx, cy, dx, dy) != ccw(bx, by, cx, cy, dx, dy) and ccw(
        ax, ay, bx, by, cx, cy
    ) != ccw(ax, ay, bx, by, dx, dy)


def _point_segment_distance(x, y, ld: CompiledLinedef) -> float:
    a = np.asarray(ld.start, np.float32)
    b = np.asarray(ld.end, np.float32)
    p = np.array([x, y], np.float32)
    e = b - a
    t = float(np.dot(p - a, e) / max(float(np.dot(e, e)), 1e-20))
    t = min(1.0, max(0.0, t))
    return float(np.linalg.norm(p - (a + e * t)))


def _swept_circle_vs_segment(start, end, seg_a, seg_b, radius):
    """Earliest crossing of the radius corridor around seg_a->seg_b along
    start->end, with corner handling (mini.rs:219-302 check_intersection).
    -> (distance_from_start, outward_normal (2,) f32) or None."""
    start = np.asarray(start, np.float32)
    end = np.asarray(end, np.float32)
    a = np.asarray(seg_a, np.float32)
    b = np.asarray(seg_b, np.float32)
    line_vec = b - a
    line_len = float(np.linalg.norm(line_vec))
    if line_len < 1e-12:
        return None
    line_dir = line_vec / line_len
    normal = np.array([-line_dir[1], line_dir[0]], np.float32)
    start_dist = float((start - a) @ normal)
    end_dist = float((end - a) @ normal)
    if start_dist > radius and end_dist > radius:
        return None
    if start_dist < -radius and end_dist < -radius:
        return None
    dist_diff = end_dist - start_dist
    if abs(dist_diff) < 1e-12:
        if abs(start_dist) <= radius:
            t = 0.0
        else:
            return None
    else:
        desired = -radius if start_dist < 0.0 else radius
        t = (desired - start_dist) / dist_diff
    if not (0.0 <= t <= 1.0):
        return None
    intersection = start + (end - start) * t
    line_proj = float((intersection - a) @ line_dir)
    if line_proj < 0.0 or line_proj > line_len:
        corner = a if line_proj < 0.0 else b
        to_corner = intersection - corner
        d_sq = float(to_corner @ to_corner)
        if d_sq > radius * radius:
            return None
        d = np.sqrt(d_sq)
        nrm = to_corner / d if d > 1e-12 else np.array([1.0, 0.0], np.float32)
        return float(np.linalg.norm(intersection - start)), nrm.astype(np.float32)
    final_normal = -normal if start_dist < 0.0 else normal
    return float(np.linalg.norm(intersection - start)), final_normal


def _point_vs_segment(point, seg_a, seg_b, radius):
    """Penetration test of a circle at `point` vs a segment
    (mini.rs:339-386 check_point_against_segment).
    -> (distance, outward_normal) or None when not penetrating."""
    p = np.asarray(point, np.float32)
    a = np.asarray(seg_a, np.float32)
    b = np.asarray(seg_b, np.float32)
    seg_vec = b - a
    seg_len = float(np.linalg.norm(seg_vec))
    if seg_len < 1e-12:
        delta = p - a
    else:
        seg_dir = seg_vec / seg_len
        t = float(np.clip((p - a) @ seg_dir, 0.0, seg_len))
        delta = p - (a + seg_dir * t)
    d_sq = float(delta @ delta)
    if d_sq > radius * radius:
        return None
    d = np.sqrt(d_sq)
    nrm = delta / d if d > 1e-12 else np.array([1.0, 0.0], np.float32)
    return float(d), nrm.astype(np.float32)

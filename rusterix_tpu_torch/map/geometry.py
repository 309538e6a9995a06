"""Polygon triangulation (ear clipping with holes).

Replaces the reference's `earcutr` dependency (used by Sector geometry,
src/map/sector.rs:194 and the chunk builder's earcut-with-holes,
src/chunkbuilder/d3chunkbuilder.rs:2019). Fresh O(n^2) ear-clipping
implementation — map sectors are small polygons, so asymptotics don't
matter; correctness on concave polygons and holes does.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def _area2(ax, ay, bx, by, cx, cy) -> float:
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def _point_in_triangle(px, py, ax, ay, bx, by, cx, cy) -> bool:
    d1 = _area2(px, py, ax, ay, bx, by)
    d2 = _area2(px, py, bx, by, cx, cy)
    d3 = _area2(px, py, cx, cy, ax, ay)
    has_neg = (d1 < 0) or (d2 < 0) or (d3 < 0)
    has_pos = (d1 > 0) or (d2 > 0) or (d3 > 0)
    return not (has_neg and has_pos)


def polygon_area(points: Sequence[Tuple[float, float]]) -> float:
    """Signed area (positive = CCW in math orientation)."""
    s = 0.0
    n = len(points)
    for i in range(n):
        x0, y0 = points[i]
        x1, y1 = points[(i + 1) % n]
        s += x0 * y1 - x1 * y0
    return s * 0.5


def _eliminate_holes(outer: List[Tuple[float, float]], holes: List[List[Tuple[float, float]]]):
    """Merge holes into the outer ring via bridge edges (rightmost-vertex
    strategy, as in the earcut algorithm family)."""
    poly = list(outer)
    # process holes by descending rightmost x
    hole_list = sorted(holes, key=lambda h: -max(p[0] for p in h))
    for hole in hole_list:
        # hole must be CW if outer is CCW; normalize: make hole opposite
        h = list(hole)
        if polygon_area(h) > 0:
            h.reverse()
        # rightmost hole vertex
        hi = max(range(len(h)), key=lambda i: h[i][0])
        hx, hy = h[hi]
        # find visible outer vertex: closest intersection of ray +x
        best_j = None
        best_dist = float("inf")
        for j in range(len(poly)):
            x0, y0 = poly[j]
            x1, y1 = poly[(j + 1) % len(poly)]
            if (y0 > hy) == (y1 > hy):
                continue
            t = (hy - y0) / (y1 - y0) if y1 != y0 else 0.0
            xi = x0 + t * (x1 - x0)
            if xi >= hx and xi - hx < best_dist:
                best_dist = xi - hx
                best_j = j if x0 > x1 else (j + 1) % len(poly)
        if best_j is None:
            best_j = max(range(len(poly)), key=lambda i: poly[i][0])
        # splice: outer[0..=best_j], hole[hi..], hole[..=hi], outer[best_j..]
        bridge_o = poly[best_j]
        rotated = h[hi:] + h[:hi]
        poly = poly[: best_j + 1] + rotated + [rotated[0], bridge_o] + poly[best_j + 1 :]
    return poly


def earcut(
    vertices: Sequence[float], hole_indices: Sequence[int] = (), dim: int = 2
) -> List[int]:
    """mapbox-earcut-compatible interface: flat coords + hole start indices.

    Returns flat triangle indices into the ORIGINAL vertex list.
    """
    pts = [
        (float(vertices[i]), float(vertices[i + 1]))
        for i in range(0, len(vertices), dim)
    ]
    if not hole_indices:
        from ..native import earcut_native

        native = earcut_native(pts)
        if native is not None:
            return native
    if hole_indices:
        ring_bounds = list(hole_indices) + [len(pts)]
        outer_pts = pts[: ring_bounds[0]]
        holes = [
            pts[ring_bounds[k] : ring_bounds[k + 1]]
            for k in range(len(hole_indices))
        ]
        # triangulate the merged polygon, track original indices
        merged = _eliminate_holes_indexed(pts, ring_bounds[0], hole_indices)
        idx = _earcut_simple([pts[i] for i in merged])
        return [merged[i] for i in idx]
    idx = _earcut_simple(pts)
    return idx


def _eliminate_holes_indexed(pts, outer_len, hole_indices):
    bounds = list(hole_indices) + [len(pts)]
    outer = list(range(outer_len))
    # normalize outer to CCW
    if polygon_area([pts[i] for i in outer]) < 0:
        outer.reverse()
    holes = []
    for k in range(len(hole_indices)):
        ring = list(range(bounds[k], bounds[k + 1]))
        if polygon_area([pts[i] for i in ring]) > 0:
            ring.reverse()
        holes.append(ring)
    holes.sort(key=lambda h: -max(pts[i][0] for i in h))

    poly = outer
    for h in holes:
        hi_pos = max(range(len(h)), key=lambda i: pts[h[i]][0])
        hx, hy = pts[h[hi_pos]]
        best_j = None
        best_dist = float("inf")
        for j in range(len(poly)):
            x0, y0 = pts[poly[j]]
            x1, y1 = pts[poly[(j + 1) % len(poly)]]
            if (y0 > hy) == (y1 > hy):
                continue
            t = (hy - y0) / (y1 - y0) if y1 != y0 else 0.0
            xi = x0 + t * (x1 - x0)
            if xi >= hx and xi - hx < best_dist:
                best_dist = xi - hx
                best_j = j if x0 > x1 else (j + 1) % len(poly)
        if best_j is None:
            best_j = max(range(len(poly)), key=lambda i: pts[poly[i]][0])
        rotated = h[hi_pos:] + h[:hi_pos]
        poly = (
            poly[: best_j + 1] + rotated + [rotated[0], poly[best_j]] + poly[best_j + 1 :]
        )
    return poly


def _earcut_simple(pts: List[Tuple[float, float]]) -> List[int]:
    n = len(pts)
    if n < 3:
        return []
    indices = list(range(n))
    # normalize to CCW
    if polygon_area(pts) < 0:
        indices.reverse()

    out: List[int] = []
    guard = 0
    while len(indices) > 3 and guard < 10 * n * n:
        guard += 1
        found = False
        m = len(indices)
        for k in range(m):
            i0 = indices[(k - 1) % m]
            i1 = indices[k]
            i2 = indices[(k + 1) % m]
            ax, ay = pts[i0]
            bx, by = pts[i1]
            cx, cy = pts[i2]
            if _area2(ax, ay, bx, by, cx, cy) <= 1e-12:
                continue  # reflex or degenerate
            # no other vertex strictly inside (bridge duplicates sit exactly
            # on corners and must not block ears)
            ok = True
            for j in indices:
                if j in (i0, i1, i2):
                    continue
                px, py = pts[j]
                if (px, py) in ((ax, ay), (bx, by), (cx, cy)):
                    continue
                if _point_in_triangle(px, py, ax, ay, bx, by, cx, cy):
                    ok = False
                    break
            if ok:
                out.extend([i0, i1, i2])
                indices.pop(k)
                found = True
                break
        if not found:
            # fallback: clip the least-degenerate ear to guarantee progress
            best_k, best_a = 0, -1e30
            for k in range(m):
                i0 = indices[(k - 1) % m]
                i1 = indices[k]
                i2 = indices[(k + 1) % m]
                a = _area2(*pts[i0], *pts[i1], *pts[i2])
                if a > best_a:
                    best_a = a
                    best_k = k
            k = best_k
            out.extend(
                [indices[(k - 1) % m], indices[k], indices[(k + 1) % m]]
            )
            indices.pop(k)
    if len(indices) == 3:
        out.extend(indices)
    return out


def triangulate_polygon(points, holes=None):
    """Convenience: list of (x, y) + optional hole rings -> (verts, tris).

    Returns (all points in input order incl. holes, [(i0, i1, i2), ...])."""
    flat = [c for p in points for c in p]
    hole_indices = []
    all_pts = list(points)
    if holes:
        for h in holes:
            hole_indices.append(len(all_pts))
            all_pts.extend(h)
            flat.extend(c for p in h for c in p)
    idx = earcut(flat, hole_indices, 2)
    tris = [(idx[i], idx[i + 1], idx[i + 2]) for i in range(0, len(idx), 3)]
    return all_pts, tris

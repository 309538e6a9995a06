"""2D map -> styled texture renderer (reference src/shapestack/mod.rs:13-296).

Sectors (and standalone linedefs) carrying a ShapeFXGraph source are
rendered as signed-distance shapes styled by their material graph. The
reference walks every pixel under rayon; here each sector evaluates as
whole-grid NumPy ops (asset-bake path — character tiles are 64x64, built
once per entity/sequence, never per frame).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.batch import PixelSourceKind
from ..shapefx.graph import ShapeFXGraph, ShapeFXRole
from .context import ShapeContext
from .nodes import evaluate_pixel

_GRID_OFFSETS = [
    (-1, -1), (0, -1), (1, -1),
    (-1, 0), (0, 0), (1, 0),
    (-1, 1), (0, 1), (1, 1),
]


def _segment_distance(px, py, edges: np.ndarray):
    """Min distance from every grid point to any segment; edges (E,2,2)."""
    a = edges[:, 0]  # (E,2)
    b = edges[:, 1]
    e = b - a  # (E,2)
    ee = np.maximum((e * e).sum(axis=1), 1e-20)  # (E,)
    # (H,W,E)
    tx = (px[..., None] - a[:, 0]) * e[:, 0] + (py[..., None] - a[:, 1]) * e[:, 1]
    t = np.clip(tx / ee, 0.0, 1.0)
    cx = a[:, 0] + t * e[:, 0]
    cy = a[:, 1] + t * e[:, 1]
    d2 = (px[..., None] - cx) ** 2 + (py[..., None] - cy) ** 2
    return np.sqrt(d2.min(axis=-1))


def _point_in_polygon(px, py, poly: np.ndarray):
    """Even-odd crossing test vectorized over the grid; poly (N,2)."""
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


def _graph_for(container, key: str, graphs: Dict[str, object]):
    v = container.get(key)
    if v is None or v.data is None:
        return None
    src = v.data
    if getattr(src, "kind", None) == PixelSourceKind.ShapeFXGraphId:
        return graphs.get(src.uuid)
    return None


def _evaluate_material(graph: ShapeFXGraph, ctx: ShapeContext, incoming, palette):
    """Vectorized ShapeFXGraph::evaluate_material
    (shapefxgraph.rs:221-261): walk from node 0 (material geometry root),
    terminal 0 for inside pixels and 1 for outside, chaining node colors.
    Returns (rgba, mask) or (None, None)."""
    if not graph.nodes or graph.nodes[0].role != ShapeFXRole.MaterialGroup:
        return None, None

    H, W = ctx.distance.shape
    out = np.zeros((H, W, 4), np.float32)
    out_mask = np.zeros((H, W), bool)
    inside_mask = ctx.distance <= 0.0

    for terminal, region in ((0, inside_mask), (1, ~inside_mask)):
        if not region.any():
            continue
        color = incoming.copy()
        curr, curr_t = 0, terminal
        steps = 0
        while steps < 16:
            nxt = graph.find_connected_input_node(curr, curr_t)
            if nxt is None:
                break
            ni, nt = nxt
            col, mask = evaluate_pixel(
                graph.nodes[ni], ctx, color, palette, graph, ni
            )
            if col is not None:
                m = mask & region
                out = np.where(m[..., None], col, out)
                out_mask |= m
                color = np.where(mask[..., None], col, color)
            curr, curr_t = ni, nt
            steps += 1

    if not out_mask.any():
        return None, None
    return out, out_mask


class ShapeStack:
    """reference src/shapestack/mod.rs ShapeStack."""

    def __init__(self, area_min, area_max):
        self.area_min = np.asarray(area_min, np.float32)
        self.area_max = np.asarray(area_max, np.float32)

    def render_geometry(
        self,
        buffer: np.ndarray,
        map_,
        assets,
        material_mode: bool = False,
        sector_overrides: Optional[Dict[int, np.ndarray]] = None,
    ) -> None:
        """Render into `buffer` (H,W,4) u8, in place (mod.rs:24-296)."""
        sector_overrides = sector_overrides or {}
        height, width = buffer.shape[:2]
        area_size = self.area_max - self.area_min
        px_size = float(area_size[0]) / width

        sector_graph_key = "source" if material_mode else "shape_graph"
        linedef_graph_key = "row1_source" if material_mode else "shape_graph"
        offsets = _GRID_OFFSETS if material_mode else [(0, 0)]

        palette = getattr(assets, "palette", None)

        # apply the editing soft-rig pose (tilebuilder animation frames)
        vert_pos = {v.id: (float(v.x), float(v.y)) for v in map_.vertices}
        rig = (
            map_.softrigs.get(map_.editing_rig)
            if getattr(map_, "editing_rig", None) is not None
            else None
        )
        if rig is not None and rig.keyforms:
            for vid, pos in rig.keyforms[0].vertex_positions:
                vert_pos[vid] = (float(pos[0]), float(pos[1]))

        # pixel grid -> world (v flipped, mod.rs:135-136)
        xs = (np.arange(width, dtype=np.float32)) / width
        ys = 1.0 - (np.arange(height, dtype=np.float32)) / height
        wx = self.area_min[0] + xs[None, :] * area_size[0]
        wy = self.area_min[1] + ys[:, None] * area_size[1]
        wx = np.broadcast_to(wx, (height, width)).astype(np.float32)
        wy = np.broadcast_to(wy, (height, width)).astype(np.float32)

        color = buffer.astype(np.float32) / 255.0

        graphs = dict(getattr(map_, "shapefx_graphs", {}))
        for g in graphs.values():
            for node in g.nodes:
                node.render_setup(0.0)

        # --- sectors, largest-area first so smaller shapes draw on top ---
        sectors = sorted(
            map_.sectors,
            key=lambda s: -abs(_polygon_area_of(s, map_, vert_pos)),
        )
        for sector in sectors:
            graph = _graph_for(sector.properties, sector_graph_key, graphs)
            if graph is None:
                continue
            poly, edges = _sector_geometry(sector, map_, vert_pos)
            if poly is None:
                continue
            rounding = graph.nodes[0].values.get_float_default("rounding", 0.0)
            aa = sector.properties.get_float_default("material_a_a", 1.0)
            bb_min = poly.min(axis=0)
            bb_max = poly.max(axis=0)
            bb_size = np.maximum(bb_max - bb_min, 1e-20)

            best_sdf = None
            best_uv = None
            for ox, oy in offsets:
                sx = wx - ox * area_size[0]
                sy = wy - oy * area_size[1]
                dist = _segment_distance(sx, sy, edges)
                inside = _point_in_polygon(sx, sy, poly)
                signed = np.where(inside, -dist, dist)
                sdf = signed / px_size - rounding
                if best_sdf is None:
                    best_sdf = sdf
                    best_uv = np.stack(
                        [(sx - bb_min[0]) / bb_size[0], (sy - bb_min[1]) / bb_size[1]],
                        axis=-1,
                    )
                else:
                    better = sdf < best_sdf
                    uv = np.stack(
                        [(sx - bb_min[0]) / bb_size[0], (sy - bb_min[1]) / bb_size[1]],
                        axis=-1,
                    )
                    best_sdf = np.where(better, sdf, best_sdf)
                    best_uv = np.where(better[..., None], uv, best_uv)

            override = sector_overrides.get(sector.id)
            ctx = ShapeContext(
                uv=best_uv.astype(np.float32),
                distance=best_sdf.astype(np.float32),
                px=px_size,
                anti_aliasing=aa,
                override_color=None
                if override is None
                else np.asarray(override, np.float32),
                shape_id=sector.id,
            )
            col, mask = _evaluate_material(graph, ctx, color, palette)
            if col is not None:
                a = np.where(mask, col[..., 3], 0.0)[..., None]
                color = color + (col - color) * a

        # --- standalone linedefs (no sector) with a graph ---
        for linedef in map_.linedefs:
            if linedef.sector_ids:
                continue
            graph = _graph_for(linedef.properties, linedef_graph_key, graphs)
            if graph is None:
                continue
            v0 = vert_pos.get(linedef.start_vertex)
            v1 = vert_pos.get(linedef.end_vertex)
            if v0 is None or v1 is None:
                continue
            line_width = graph.nodes[0].values.get_float_default("line_width", 1.0)
            tile = (10.0, 10.0)  # mod.rs:228
            lpx = tile[0] / width
            a = np.asarray(v0, np.float32)
            b = np.asarray(v1, np.float32)
            ab = b - a
            ab_len = max(float(np.hypot(*ab)), 1e-20)
            ab_dir = ab / ab_len

            best_sdf = None
            best_t = None
            for ox, oy in offsets:
                sx = wx - ox * tile[0]
                sy = wy - oy * tile[1]
                apx = sx - a[0]
                apy = sy - a[1]
                t = (apx * ab_dir[0] + apy * ab_dir[1]) / ab_len
                tc = np.clip(t, 0.0, 1.0)
                cx = a[0] + ab_dir[0] * tc * ab_len
                cy = a[1] + ab_dir[1] * tc * ab_len
                sdf = np.hypot(sx - cx, sy - cy) / lpx - line_width * 0.5
                if best_sdf is None:
                    best_sdf, best_t = sdf, t
                else:
                    better = sdf < best_sdf
                    best_t = np.where(better, t, best_t)
                    best_sdf = np.where(better, sdf, best_sdf)

            ctx = ShapeContext(
                uv=np.stack(
                    [best_t - np.trunc(best_t), 0.5 + best_sdf], axis=-1
                ).astype(np.float32),
                distance=best_sdf.astype(np.float32),
                px=lpx,
                anti_aliasing=linedef.properties.get_float_default("material_a_a", 1.0),
                t=best_t.astype(np.float32),
                line_dir=(float(ab_dir[0]), float(ab_dir[1])),
            )
            col, mask = _evaluate_material(graph, ctx, color, palette)
            if col is not None:
                a_ = np.where(mask, col[..., 3], 0.0)[..., None]
                color = color + (col - color) * a_

        buffer[:] = (np.clip(color, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _sector_geometry(sector, map_, vert_pos) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    pts: List[Tuple[float, float]] = []
    edges: List[Tuple[Tuple[float, float], Tuple[float, float]]] = []
    for lid in sector.linedefs:
        ld = map_.find_linedef(lid)
        if ld is None:
            continue
        v0 = vert_pos.get(ld.start_vertex)
        v1 = vert_pos.get(ld.end_vertex)
        if v0 is None or v1 is None:
            continue
        pts.append(v0)
        edges.append((v0, v1))
    if len(pts) < 3:
        return None, None
    return np.asarray(pts, np.float32), np.asarray(edges, np.float32)


def _polygon_area_of(sector, map_, vert_pos) -> float:
    poly, _ = _sector_geometry(sector, map_, vert_pos)
    if poly is None:
        return 0.0
    x = poly[:, 0]
    y = poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


# ---------------------------------------------------------------------------
# shape graphs + screen widgets (shapefxgraph.rs:144-218, 385-499)
# ---------------------------------------------------------------------------


def evaluate_shape_distance(graph, px, py, vertices):
    """Chain-walk from a Shape root taking per-pixel min distance; returns
    (distance (H,W), node_index (H,W) i32) (shapefxgraph.rs:144-181)."""
    from .nodes import evaluate_distance

    px = np.asarray(px, np.float32)
    py = np.asarray(py, np.float32)
    best = np.full(px.shape, np.finfo(np.float32).max, np.float32)
    best_node = np.zeros(px.shape, np.int32)
    if not graph.nodes or graph.nodes[0].role != ShapeFXRole.Shape:
        return best, best_node

    curr, curr_t = 0, 0
    steps = 0
    while steps < 16:
        nxt = graph.find_connected_input_node(curr, curr_t)
        if nxt is None:
            break
        ni, nt = nxt
        d = evaluate_distance(graph.nodes[ni], px, py, vertices)
        if d is not None:
            better = d < best
            best = np.where(better, d, best)
            best_node = np.where(better, ni, best_node)
        curr, curr_t = ni, nt
        steps += 1
    return best, best_node


def evaluate_shape_color(graph, ctx: ShapeContext, node_index: int, palette):
    """Color chain hanging off a shape node's terminal 1
    (shapefxgraph.rs:184-218). Returns (rgba, mask) or (None, None)."""
    H, W = ctx.distance.shape
    color = None
    mask_all = np.zeros((H, W), bool)
    curr, curr_t = node_index, 1
    steps = 0
    while steps < 16:
        nxt = graph.find_connected_input_node(curr, curr_t)
        if nxt is None:
            break
        ni, nt = nxt
        col, mask = evaluate_pixel(graph.nodes[ni], ctx, color, None if palette is None else palette, graph, ni)
        if col is not None:
            if color is None:
                color = np.zeros((H, W, 4), np.float32)
            color = np.where(mask[..., None], col, color)
            mask_all |= mask
        curr, curr_t = ni, nt
        steps += 1
    if color is None:
        return None, None
    return color, mask_all


def evaluate_screen_widget(graph, ctx: ShapeContext, incoming, terminal: int, palette):
    """Widget-root chain for normal/selected states
    (shapefxgraph.rs:385-426). Returns (rgba, mask) or (None, None)."""
    if not graph.nodes or graph.nodes[0].role != ShapeFXRole.UIWidget:
        return None, None
    H, W = ctx.distance.shape
    color = np.broadcast_to(np.asarray(incoming, np.float32), (H, W, 4)).copy()
    out = None
    out_mask = np.zeros((H, W), bool)
    curr, curr_t = 0, terminal
    steps = 0
    while steps < 16:
        nxt = graph.find_connected_input_node(curr, curr_t)
        if nxt is None:
            break
        ni, nt = nxt
        col, mask = evaluate_pixel(graph.nodes[ni], ctx, color, palette, graph, ni)
        if col is not None:
            if out is None:
                out = np.zeros((H, W, 4), np.float32)
            out = np.where(mask[..., None], col, out)
            out_mask |= mask
            color = np.where(mask[..., None], col, color)
        curr, curr_t = ni, nt
        steps += 1
    if out is None:
        return None, None
    return out, out_mask


def create_screen_widgets(graph, width: int, height: int, palette=None):
    """Bake normal/selected widget textures (shapefxgraph.rs:428-499):
    the context distance is the negated distance to the nearest buffer
    edge scaled by min(w,h)."""
    xs = np.arange(width, dtype=np.float32)[None, :] / width
    ys = 1.0 - np.arange(height, dtype=np.float32)[:, None] / height
    u = np.broadcast_to(xs, (height, width))
    v = np.broadcast_to(ys, (height, width))
    edge = np.minimum(np.minimum(u, 1.0 - u), np.minimum(v, 1.0 - v))
    distance = (-edge * min(width, height)).astype(np.float32)
    ctx = ShapeContext(
        uv=np.stack([u, v], axis=-1).astype(np.float32),
        distance=distance,
        px=1.0,
        anti_aliasing=1.0,
    )
    textures = []
    for terminal in (0, 1):
        base = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
        col, mask = evaluate_screen_widget(graph, ctx, base, terminal, palette)
        if col is None:
            out = np.zeros((height, width, 4), np.float32)
            out[..., 3] = 1.0
        else:
            out = np.where(mask[..., None], col, base)
        textures.append(
            (np.clip(out, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        )
    return textures

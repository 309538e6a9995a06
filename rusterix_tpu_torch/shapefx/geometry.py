"""ShapeFX geometry-group nodes: SectorGeometry / LinedefGeometry roots with
Flatten / Colorize modifiers, evaluated during terrain-chunk building.

Port of the reference's two-pass terrain modifier pipeline:
  * driver: TerrainChunk::process_batch_modifiers
    (reference src/terrain/chunk.rs:144-247) — sectors sorted by area,
    `region_graph` property -> graph, Height pass then Colorize pass;
  * sector nodes: ShapeFX::sector_modify_heightmap
    (src/shapestack/shapefx.rs:411-680) — Flatten blends control heights
    toward the sector's floor_height by a smoothstep over `bevel` of the
    sector SDF; Colorize paints the baked chunk texture through the node's
    color-terminal material chain with border/height/steepness fades;
  * linedef nodes: ShapeFX::linedef_modify_heightmap
    (src/shapestack/shapefx.rs:682-930) — path flattening along segments
    (vertex `height` properties lerped by segment t) and path painting
    with `path_width` + `fade_distance`.

Everything here is host-side numpy over one 16x16 chunk grid (and its
pixels_per_tile^2 bake texture) — build-time work, vectorized per chunk.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..map.value import Value
from ..shapestack.context import ShapeContext
from ..shapestack.nodes import evaluate_pixel, noise2d, smoothstep
from .graph import ShapeFXRole

PASS_HEIGHT = 0
PASS_COLORIZE = 1


def _node_supports_pass(node, pass_) -> bool:
    """shapefx.rs:150-156: Flatten runs in both passes, Colorize only in
    the Colorize pass."""
    if node.role == ShapeFXRole.Flatten:
        return True
    if node.role == ShapeFXRole.Colorize:
        return pass_ == PASS_COLORIZE
    return False


def polygon_signed_distance(poly: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Signed distance of pts (N,2) to a closed polygon (V,2): negative
    inside (the convention sector.signed_distance uses in the reference)."""
    a = poly
    b = np.roll(poly, -1, axis=0)
    ab = b - a  # (V,2)
    ap = pts[:, None, :] - a[None, :, :]  # (N,V,2)
    denom = np.maximum((ab * ab).sum(axis=1), 1e-20)  # (V,)
    t = np.clip((ap * ab[None, :, :]).sum(axis=2) / denom[None, :], 0.0, 1.0)
    closest = a[None, :, :] + ab[None, :, :] * t[..., None]
    dist = np.sqrt(((pts[:, None, :] - closest) ** 2).sum(axis=2)).min(axis=1)

    # ray-cast inside test, vectorized over points
    xi, yi = a[:, 0], a[:, 1]
    xj, yj = b[:, 0], b[:, 1]
    px = pts[:, 0:1]
    py = pts[:, 1:2]
    cond = (yi[None, :] > py) != (yj[None, :] > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xcross = (xj - xi)[None, :] * (py - yi[None, :]) / np.where(
            (yj - yi)[None, :] == 0.0, 1e-20, (yj - yi)[None, :]
        ) + xi[None, :]
    crossings = (cond & (px < xcross)).sum(axis=1)
    inside = crossings % 2 == 1
    return np.where(inside, -dist, dist).astype(np.float32)


def sector_signed_distance(map_, sector, pts: np.ndarray) -> Optional[np.ndarray]:
    poly = sector.polygon(map_)
    if len(poly) < 3:
        return None
    return polygon_signed_distance(np.asarray(poly, np.float32), pts)


def _segments_closest(pts: np.ndarray, segs: List[dict]):
    """-> (dist (N,), t (N,), idx (N,)) of the closest segment per point."""
    best_d = np.full(len(pts), np.inf, np.float32)
    best_t = np.zeros(len(pts), np.float32)
    best_i = np.zeros(len(pts), np.int32)
    for i, s in enumerate(segs):
        a, b = s["start"], s["end"]
        ab = b - a
        denom = max(float(ab @ ab), 1e-20)
        t = np.clip((pts - a) @ ab / denom, 0.0, 1.0)
        closest = a + ab * t[:, None]
        d = np.sqrt(((pts - closest) ** 2).sum(axis=1))
        better = d < best_d
        best_d = np.where(better, d, best_d)
        best_t = np.where(better, t, best_t)
        best_i = np.where(better, i, best_i)
    return best_d, best_t, best_i


def _graph_for(map_, element) -> Optional[tuple]:
    """element's `region_graph` property -> (graph, root_index 0)."""
    v = element.properties.get("region_graph")
    if v is None or v.data is None:
        return None
    gid = getattr(v.data, "uuid", None) or (
        v.data if isinstance(v.data, str) else None
    )
    if gid is None:
        return None
    graph = map_.shapefx_graphs.get(gid)
    if graph is None or not graph.nodes:
        return None
    return graph


def _modifier_chain(graph, root_role) -> List[int]:
    """Walk terminal-0 links from the root node (shapefxgraph.rs:61-90)."""
    if graph.nodes[0].role != root_role:
        return []
    out = []
    curr, term = 0, 0
    for _ in range(16):
        nxt = graph.find_connected_input_node(curr, term)
        if nxt is None:
            break
        node, _t = nxt
        out.append(node)
        curr, term = node, 0
    return out


def _fade_outside_range(value, lo, hi, fade):
    t_lo = np.clip((lo - value) / max(fade, 1e-20), 0.0, 1.0)
    t_hi = np.clip((value - hi) / max(fade, 1e-20), 0.0, 1.0)
    t = np.where(value < lo, t_lo, np.where(value > hi, t_hi, 0.0))
    return 1.0 - t * t * (3.0 - 2.0 * t)


def _border_fade(sd, fade_distance):
    """shapefx.rs:623-647: fade OUTSIDE (fd>0) or INSIDE (fd<0) the border."""
    if fade_distance == 0.0:
        return (sd <= 0.0).astype(np.float32)
    fd = abs(fade_distance)
    if fade_distance > 0.0:
        t = np.clip(sd / fd, 0.0, 1.0)
        f = 1.0 - t * t * (3.0 - 2.0 * t)
        return np.where(sd <= 0.0, 1.0, np.where(sd <= fd, f, 0.0))
    t = np.clip((sd + fd) / fd, 0.0, 1.0)
    f = 1.0 - t * t * (3.0 - 2.0 * t)
    return np.where(sd <= -fd, 1.0, np.where(sd <= 0.0, f, 0.0))


def _colorize_extra_fade(node, terrain, wpts, fade_distance):
    """Colorize-only height/steepness window fades (shapefx.rs:570-619)."""
    total = np.ones(len(wpts), np.float32)
    min_h = node.values.get_float_default("min_height", 0.0)
    max_h = node.values.get_float_default("max_height", 10.0)
    min_s = node.values.get_float_default("min_steepness", 0.0)
    max_s = node.values.get_float_default("max_steepness", 1.0)
    fd = max(fade_distance, 1e-6)
    if min_s > 0.0 or max_s < 1.0:
        steep = terrain.compute_steepness_many(wpts[:, 0], wpts[:, 1])
        total *= _fade_outside_range(steep, min_s, max_s, fd)
    if min_h != 0.0 or max_h != 10.0:
        h = terrain.sample_height_many(wpts[:, 0], wpts[:, 1])
        total *= _fade_outside_range(h, min_h, max_h, fd)
    return total


def _paint(texture, graph, node, node_idx, px_mask, sd_px, wpts, fade, palette):
    """Evaluate the node's color-terminal chain and blend into `texture`
    ((H,W,4) u8) at the masked pixels with the given fade."""
    h, w = texture.shape[:2]
    ys, xs = np.nonzero(px_mask.reshape(h, w))
    if len(ys) == 0:
        return
    uv_scale = max(node.values.get_float_default("uv_scale", 1.0), 1e-6)
    n = len(ys)
    ctx = ShapeContext(
        uv=np.stack([wpts[:, 0] / uv_scale, wpts[:, 1] / uv_scale], axis=-1).reshape(
            n, 1, 2
        ),
        distance=sd_px.reshape(n, 1),
        px=1.0,
        shape_id=0,
    )
    color = None
    for ni in graph.collect_nodes_from(node_idx, 1):
        out, mask = evaluate_pixel(graph.nodes[ni], ctx, color, palette, graph, ni)
        if out is not None:
            color = out if color is None else np.where(mask[..., None], out, color)
    if color is None:
        return
    color = color.reshape(n, 4) * fade[:, None]
    existing = texture[ys, xs].astype(np.float32) / 255.0
    blended = existing * (1.0 - fade[:, None]) + color
    out = np.clip(blended * 255.0 + 0.5, 0, 255).astype(np.uint8)
    out[:, 3] = 255
    texture[ys, xs] = out


def _chunk_pixel_grid(chunk, ppt: int, scale: float):
    """World positions of every bake-texture pixel center of a chunk."""
    from ..map.terrain import CHUNK_SIZE

    n = CHUNK_SIZE * ppt
    ox, oy = chunk.origin
    xs = (np.arange(n, dtype=np.float32) + 0.5) / ppt + ox
    ys = (np.arange(n, dtype=np.float32) + 0.5) / ppt + oy
    gx, gy = np.meshgrid(xs * scale, ys * scale)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


def _sector_modify(node, sector, map_, terrain, chunk, heights, graph,
                   node_idx, texture, pass_, palette):
    bevel = node.values.get_float_default("bevel", 0.5)
    fade_distance = node.values.get_float_default("fade_distance", 0.5)
    noise_strength = node.values.get_float_default("fade_noise", 0.0)
    floor_h = sector.properties.get_float_default("floor_height", 0.0)
    is_colorize = node.role == ShapeFXRole.Colorize

    from ..map.terrain import CHUNK_SIZE

    ox, oy = chunk.origin

    if not is_colorize and pass_ == PASS_HEIGHT:
        # control-vertex flattening: vertex (tx, ty) sits at world
        # (tx*scale, ty*scale); the sector polygon lives in world/map units
        lx, ly = np.meshgrid(
            np.arange(CHUNK_SIZE + 1), np.arange(CHUNK_SIZE + 1)
        )
        idx = np.stack(
            [(lx.reshape(-1) + ox), (ly.reshape(-1) + oy)], axis=-1
        )
        pts = idx.astype(np.float32) * terrain.scale
        sd = sector_signed_distance(map_, sector, pts)
        if sd is None:
            return
        s = smoothstep(0.0, max(bevel, 1e-6), bevel - sd)
        affect = sd < bevel * 4.0
        for i in np.nonzero(affect & (s > 0.0))[0]:
            tx, ty = int(idx[i, 0]), int(idx[i, 1])
            orig = heights.get((tx, ty), terrain.get_height(tx, ty))
            heights[(tx, ty)] = orig * (1.0 - s[i]) + floor_h * s[i]
        return

    if pass_ != PASS_COLORIZE or texture is None:
        return

    ppt = texture.shape[0] // CHUNK_SIZE
    wpts = _chunk_pixel_grid(chunk, ppt, terrain.scale)
    sd = sector_signed_distance(map_, sector, wpts)
    if sd is None:
        return
    if noise_strength > 0.0:
        sd = sd + noise2d(wpts[:, 0], wpts[:, 1]) * noise_strength
    fade = _border_fade(sd, fade_distance)
    if is_colorize:
        sel = fade > 0.01
        if sel.any():
            fade = fade * np.where(
                sel, _colorize_extra_fade(node, terrain, wpts, fade_distance), 1.0
            )
    mask = fade > 0.01
    if not mask.any():
        return
    _paint(texture, graph, node, node_idx, mask,
           sd[mask], wpts[mask], fade[mask], palette)


def _linedef_modify(node, linedefs, map_, terrain, chunk, heights, graph,
                    node_idx, texture, pass_, palette):
    bevel = node.values.get_float_default("bevel", 0.5)
    path_width = node.values.get_float_default("path_width", 2.0)
    fade_distance = node.values.get_float_default("fade_distance", 0.5)
    noise_strength = node.values.get_float_default("fade_noise", 0.0)
    is_flatten = node.role == ShapeFXRole.Flatten

    segs = []
    for ld in linedefs:
        v0 = map_.get_vertex(ld.start_vertex)
        v1 = map_.get_vertex(ld.end_vertex)
        if v0 is None or v1 is None:
            continue
        segs.append(
            {
                "start": v0.as_vec2(),
                "end": v1.as_vec2(),
                "h0": v0.properties.get_float_default("height", 0.0),
                "h1": v1.properties.get_float_default("height", 0.0),
            }
        )
    if not segs:
        return

    from ..map.terrain import CHUNK_SIZE

    ox, oy = chunk.origin

    if is_flatten and pass_ == PASS_HEIGHT:
        lx, ly = np.meshgrid(np.arange(CHUNK_SIZE + 1), np.arange(CHUNK_SIZE + 1))
        grid = np.stack(
            [(lx.reshape(-1) + ox), (ly.reshape(-1) + oy)], axis=-1
        )
        pts = grid.astype(np.float32) * terrain.scale
        dist, t, idx = _segments_closest(pts, segs)
        blend = smoothstep(0.0, max(bevel, 1e-6), bevel - dist)
        h0 = np.array([segs[i]["h0"] for i in idx], np.float32)
        h1 = np.array([segs[i]["h1"] for i in idx], np.float32)
        target = h0 * (1.0 - t) + h1 * t
        for i in np.nonzero((dist <= bevel) & (blend > 0.0))[0]:
            tx, ty = int(grid[i, 0]), int(grid[i, 1])
            orig = heights.get((tx, ty), terrain.get_height(tx, ty))
            heights[(tx, ty)] = orig * (1.0 - blend[i]) + target[i] * blend[i]
        return

    if pass_ != PASS_COLORIZE or texture is None:
        return

    ppt = texture.shape[0] // CHUNK_SIZE
    wpts = _chunk_pixel_grid(chunk, ppt, terrain.scale)
    dist, t, idx = _segments_closest(wpts, segs)
    if noise_strength > 0.0:
        dist = dist + noise2d(wpts[:, 0], wpts[:, 1], scale=(10.0, 10.0)) * noise_strength
    half = path_width * 0.5
    fd = max(fade_distance, 1e-6)
    tt = np.clip((dist - half) / fd, 0.0, 1.0)
    fade = np.where(
        dist <= half, 1.0, 1.0 - tt * tt * (3.0 - 2.0 * tt)
    ).astype(np.float32)
    fade = np.where(dist <= half + fade_distance, fade, 0.0)
    mask = fade > 0.01
    if not mask.any():
        return
    _paint(texture, graph, node, node_idx, mask,
           (dist - half)[mask], wpts[mask], fade[mask], palette)


def process_chunk_modifiers(map_, terrain, chunk, texture=None, palette=None):
    """Both modifier passes for one TerrainChunk -> processed height overlay
    {(tx, ty): height}; Colorize paints into `texture` ((H,W,4) u8) in place.
    Driver port of terrain/chunk.rs:144-247."""
    heights: Dict[Tuple[int, int], float] = {}
    graphs = getattr(map_, "shapefx_graphs", None)
    if not graphs:
        return heights

    sectors = sorted(
        map_.sectors, key=lambda s: -(s.area(map_) if hasattr(s, "area") else 0.0)
    )
    linedef_groups: Dict[str, list] = {}
    for ld in map_.linedefs:
        g = _graph_for(map_, ld)
        if g is not None:
            linedef_groups.setdefault(id(g), []).append((g, ld))

    for pass_ in (PASS_HEIGHT, PASS_COLORIZE):
        for sector in sectors:
            graph = _graph_for(map_, sector)
            if graph is None:
                continue
            for ni in _modifier_chain(graph, ShapeFXRole.SectorGeometry):
                node = graph.nodes[ni]
                if _node_supports_pass(node, pass_):
                    _sector_modify(
                        node, sector, map_, terrain, chunk, heights,
                        graph, ni, texture, pass_, palette,
                    )
        for group in linedef_groups.values():
            graph = group[0][0]
            lds = [ld for _g, ld in group]
            for ni in _modifier_chain(graph, ShapeFXRole.LinedefGeometry):
                node = graph.nodes[ni]
                if _node_supports_pass(node, pass_):
                    _linedef_modify(
                        node, lds, map_, terrain, chunk, heights,
                        graph, ni, texture, pass_, palette,
                    )
    return heights

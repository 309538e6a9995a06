"""Vectorized ShapeFX material-node evaluators.

Behavioral port of `ShapeFX::evaluate_pixel` + the noise/box-divide helpers
(reference src/shapestack/shapefx.rs:1385-1738, 2258-2409). The reference
evaluates one pixel at a time under rayon; here each node evaluates the whole
grid as NumPy array ops — this is the asset-bake path (character/item tile
textures), not the per-frame device path, so host vectorization is the right
tool.

Every evaluator returns (rgba (H,W,4), mask (H,W)): `mask` marks pixels where
the reference would return Some(color).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..shapefx.graph import ShapeFXRole

BAYER_4X4 = (
    np.array(
        [
            [0.0, 8.0, 2.0, 10.0],
            [12.0, 4.0, 14.0, 6.0],
            [3.0, 11.0, 1.0, 9.0],
            [15.0, 7.0, 13.0, 5.0],
        ],
        np.float32,
    )
    / 16.0
)


def _fract(x):
    """Rust f32::fract (trunc-based, keeps sign)."""
    return x - np.trunc(x)


def smoothstep(edge0, edge1, x):
    t = np.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _hash2(px, py):
    """shapefx.rs:2264-2268."""
    p3x = _fract(px * 0.13)
    p3y = _fract(py * 0.13)
    p3z = _fract(px * 0.13)
    d = p3x * (p3y + 3.333) + p3y * (p3z + 3.333) + p3z * (p3x + 3.333)
    p3x, p3y, p3z = p3x + d, p3y + d, p3z + d
    return _fract((p3x + p3y) * p3z)


def _value_noise(x, y, hashfn):
    ix, iy = np.floor(x), np.floor(y)
    fx, fy = _fract(x), _fract(y)
    a = hashfn(ix, iy)
    b = hashfn(ix + 1.0, iy)
    c = hashfn(ix, iy + 1.0)
    d = hashfn(ix + 1.0, iy + 1.0)
    ux = fx * fx * (3.0 - 2.0 * fx)
    uy = fy * fy * (3.0 - 2.0 * fy)
    return a + (b - a) * ux + (c - a) * uy * (1.0 - ux) + (d - b) * ux * uy


def noise2d(u, v, scale=(1.0, 1.0), octaves: int = 3):
    """shapefx.rs:2263-2299 (fbm value noise with rotation per octave)."""
    x = u * 8.0 * scale[0]
    y = v * 8.0 * scale[1]
    if octaves == 0:
        return _value_noise(x, y, _hash2)
    val = np.zeros_like(x)
    amp = 0.5
    c, s = np.cos(0.5), np.sin(0.5)
    for _ in range(octaves):
        val = val + amp * _value_noise(x, y, _hash2)
        x, y = (c * x + s * y) * 2.0 + 100.0, (-s * x + c * y) * 2.0 + 100.0
        amp *= 0.5
    return val


def noise2d_tileable(u, v, scale, octaves: int, tile_size):
    """shapefx.rs:2301-2346 (hash wrapped into the tile so edges match)."""
    x = u * 8.0 * scale[0]
    y = v * 8.0 * scale[1]
    tx = tile_size[0] * 8.0 * scale[0]
    ty = tile_size[1] * 8.0 * scale[1]

    def make_hash(tsx, tsy):
        def h(px, py):
            wx = np.mod(np.mod(px, tsx) + tsx, tsx)
            wy = np.mod(np.mod(py, tsy) + tsy, tsy)
            return _hash2(wx, wy)

        return h

    if octaves == 0:
        return _value_noise(x, y, make_hash(tx, ty))
    val = np.zeros_like(x)
    amp = 0.5
    for _ in range(octaves):
        val = val + amp * _value_noise(x, y, make_hash(tx, ty))
        x, y = x * 2.0, y * 2.0
        tx, ty = tx * 2.0, ty * 2.0
        amp *= 0.5
    return val


def _hash21(px, py):
    """shapefx.rs:2355-2364."""
    p3x = _fract(px * 0.1031)
    p3y = _fract(py * 0.1031)
    p3z = _fract(px * 0.1031)
    d = p3x * (p3y + 33.333) + p3y * (p3z + 33.333) + p3z * (p3x + 33.333)
    p3x, p3y, p3z = p3x + d, p3y + d, p3z + d
    return _fract((p3x + p3y) * p3z)


def box_divide(px, py, gap: float, rotation: float, rounding: float):
    """Shane's box-divide cell SDF, vectorized (shapefx.rs:2367-2409).
    Returns (sdf, cell_id)."""
    ipx, ipy = np.floor(px), np.floor(py)
    px = px - ipx
    py = py - ipy

    lx = np.ones_like(px)
    ly = np.ones_like(py)
    r = _hash21(ipx, ipy)
    for _ in range(6):
        r = _fract((lx + r) * 123.71 + (ly + r) * 439.43) * 0.4 + 0.3

        swap = lx > ly
        px, py = np.where(swap, py, px), np.where(swap, px, py)
        lx, ly = np.where(swap, ly, lx), np.where(swap, lx, ly)

        lo = px < r
        lx = np.where(lo, lx / r, lx / (1.0 - r))
        px = np.where(lo, px / r, (px - r) / (1.0 - r))

        swap = lx > ly
        px, py = np.where(swap, py, px), np.where(swap, px, py)
        lx, ly = np.where(swap, ly, lx), np.where(swap, lx, ly)

    px -= 0.5
    py -= 0.5
    cid = _hash21(ipx + lx, ipy + ly)
    ang = (cid - 0.5) * rotation
    c, s = np.cos(ang), np.sin(ang)
    rx = c * px + s * py
    ry = -s * px + c * py

    thx = lx * 0.02 * gap
    thy = ly * 0.02 * gap
    bx = 0.5 - thx - rounding
    by = 0.5 - thy - rounding
    dx = np.abs(rx) - bx
    dy = np.abs(ry) - by
    inside = np.minimum(np.maximum(dx, dy), 0.0)
    outside = np.sqrt(np.maximum(dx, 0.0) ** 2 + np.maximum(dy, 0.0) ** 2)
    return inside + outside - rounding, cid


def _palette_color(palette, index: int, fallback=(0.0, 0.0, 0.0)) -> np.ndarray:
    if palette is not None and 0 <= index < len(palette):
        c = np.asarray(palette[index], np.float32)
        if c.shape[-1] >= 4:
            return c[:4].astype(np.float32)
        return np.array([c[0], c[1], c[2], 1.0], np.float32)
    return np.array([*fallback, 1.0], np.float32)


def _subchain(graph, node_index: int, terminal: int, ctx, start, palette):
    """Evaluate the nodes hanging off (node, terminal) as a sub-chain
    (Wood light/dark, Stone stone/mortar, NoiseOverlay color)."""
    color = np.broadcast_to(
        np.asarray(start, np.float32), (*ctx.distance.shape, 4)
    ).copy()
    for ni in graph.collect_nodes_from(node_index, terminal):
        out, mask = evaluate_pixel(graph.nodes[ni], ctx, color, palette, graph, ni)
        if out is not None:
            color = np.where(mask[..., None], out, color)
    return color


def evaluate_pixel(
    node, ctx, incoming: Optional[np.ndarray], palette, graph=None, node_index: int = 0
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """-> (rgba (H,W,4), mask (H,W)) or (None, None) for non-material roles."""
    role = node.role
    d = ctx.distance
    H, W = d.shape
    uvx = ctx.uv[..., 0]
    uvy = ctx.uv[..., 1]

    if role == ShapeFXRole.Gradient:
        # shapefx.rs:1449-1527 (Bayer-dithered stepped SDF gradient)
        pixel_size = 0.05
        pre0 = node.precomputed[0] if node.precomputed else (4.0, 0.0, 0.0, 1.0)
        pre1 = (
            node.precomputed[1]
            if len(node.precomputed) > 1
            else (1.0, 0.0, 0.0, 0.0)
        )
        steps = max(int(pre0[0]), 1)
        blend_mode = int(pre0[1])
        from_c = _palette_color(palette, int(pre0[2]), (0, 0, 0))
        to_c = (
            np.asarray(ctx.override_color, np.float32)
            if ctx.override_color is not None
            else _palette_color(palette, int(pre0[3]), (1, 1, 1))
        )
        from_grid = np.broadcast_to(from_c, (H, W, 4))
        if blend_mode == 1 and incoming is not None:
            from_grid = incoming

        thickness = pre1[0] / ctx.px
        offset = pre1[1] / ctx.px
        depth = np.clip(-(d + offset), 0.0, thickness)
        snapped = np.floor(depth / pixel_size) * pixel_size
        t = np.clip(snapped / max(thickness, 1e-20), 0.0, 1.0)

        if ctx.t is not None and int(pre1[2]) == 1:
            line_factor = np.clip(ctx.t, 0.0, 1.0)
            radial = np.clip(depth / max(thickness, 1e-20), 0.0, 1.0)
            t = radial * (1.0 - line_factor)

        pxi = np.floor(uvx / pixel_size).astype(np.int64)
        pyi = np.floor(uvy / pixel_size).astype(np.int64)
        threshold = BAYER_4X4[pyi & 3, pxi & 3]

        ft = t * steps
        base_step = np.floor(ft)
        dithered = np.where(ft - base_step > threshold, base_step + 1.0, base_step)
        dithered = np.minimum(dithered, steps - 1)
        qt = (dithered / max(steps - 1, 1))[..., None]

        out = from_grid * (1.0 - qt) + to_c * qt
        out = np.concatenate([out[..., :3], np.ones((H, W, 1), np.float32)], axis=-1)
        return out.astype(np.float32), np.ones((H, W), bool)

    if role == ShapeFXRole.Color:
        # shapefx.rs:1528-1545 (AA fill; reference keeps alpha=1 outside too)
        alpha = np.where(
            d > 0.0, 1.0, 1.0 - smoothstep(-ctx.anti_aliasing, 0.0, d)
        ).astype(np.float32)
        col = _palette_color(palette, node.values.get_int_default("color", 0))
        out = np.broadcast_to(col, (H, W, 4)).copy()
        out[..., 3] = alpha
        return out, alpha > 0.0

    if role == ShapeFXRole.Outline:
        # shapefx.rs:1546-1558
        col = _palette_color(palette, node.values.get_int_default("color", 0))
        thickness = node.values.get_float_default("thickness", 1.5)
        mask = (d < 0.0) & (d >= -thickness)
        return np.broadcast_to(col, (H, W, 4)).copy(), mask

    if role == ShapeFXRole.NoiseOverlay:
        # shapefx.rs:1559-1597
        if incoming is None:
            return None, None
        pixel_size = node.values.get_float_default("pixel_size", 0.05)
        randomness = node.values.get_float_default("randomness", 0.2)
        octaves = node.values.get_int_default("octaves", 3)
        scale = (1.0 / max(pixel_size, 1e-9),) * 2
        nval = noise2d_tileable(uvx, uvy, scale, octaves, (-5.0, 5.0))

        other = None
        if graph is not None:
            subnodes = graph.collect_nodes_from(node_index, 1)
            if subnodes:
                other = _subchain(graph, node_index, 1, ctx, (0, 0, 0, 0), palette)

        out = incoming.copy()
        if other is not None:
            blend = np.clip(nval * randomness, 0.0, 1.0)[..., None]
            out = incoming + (other - incoming) * blend
        else:
            n = ((nval * 2.0 - 1.0) * randomness)[..., None]
            out = out.copy()
            out[..., :3] = np.clip(out[..., :3] + n, 0.0, 1.0)
        return out.astype(np.float32), np.ones((H, W), bool)

    if role == ShapeFXRole.Glow:
        # shapefx.rs:1598-1618
        thickness = node.values.get_float_default("radius", 10.0)
        col = _palette_color(palette, node.values.get_int_default("color", 0), (1, 1, 1))
        mask = (d > 0.0) & (d <= thickness)
        t = np.clip(d / max(thickness, 1e-20), 0.0, 1.0)
        alpha = 1.0 - smoothstep(0.0, 1.0, t)
        out = np.broadcast_to(col, (H, W, 4)).copy()
        out[..., 3] = alpha
        return out, mask

    if role == ShapeFXRole.Wood:
        # shapefx.rs:1619-1684
        alpha = np.where(d >= 0.0, 1.0 - np.clip(d / ctx.px, 0.0, 1.0), 1.0)
        mask = alpha > 0.0
        light = np.ones(4, np.float32)
        dark = np.zeros(4, np.float32)
        if graph is not None:
            light = _subchain(graph, node_index, 1, ctx, light, palette)
            dark = _subchain(graph, node_index, 2, ctx, dark, palette)
        else:
            light = np.broadcast_to(light, (H, W, 4))
            dark = np.broadcast_to(dark, (H, W, 4))

        direction = np.deg2rad(node.values.get_float_default("direction", 0.0))
        scale = node.values.get_float_default("grain_scale", 4.0)
        streak_noise = node.values.get_float_default("streak_noise", 1.5)
        fine_noise = node.values.get_float_default("fine_noise", 0.10)
        octaves = node.values.get_int_default("octaves", 3)

        perp = (-np.sin(direction), np.cos(direction))
        across = (uvx * perp[0] + uvy * perp[1]) * scale
        wobble = noise2d(uvx, uvy, (0.5, 0.5), octaves) * streak_noise
        s = _fract(across + wobble)
        s = np.where(s < 0.0, s + 1.0, s)
        stripe = (1.0 - np.abs(2.0 * s - 1.0)) ** 0.4
        grain = noise2d(uvx * 120.0, uvy * 120.0, (1.0, 1.0), 1) * fine_noise
        t = np.clip(stripe + grain, 0.0, 1.0)[..., None]
        out = np.clip(light * (1.0 - t) + dark * t, 0.0, 1.0)
        out[..., 3] = alpha
        return out.astype(np.float32), mask

    if role == ShapeFXRole.Stone:
        # shapefx.rs:1685-1735
        gap = node.values.get_float_default("gap", 0.2)
        rounding = node.values.get_float_default("rounding", 0.2)
        rotation = node.values.get_float_default("rotation", 3.0)
        stone = np.ones(4, np.float32)
        mortar = np.zeros(4, np.float32)
        if graph is not None:
            stone = _subchain(graph, node_index, 1, ctx, stone, palette)
            mortar = _subchain(graph, node_index, 2, ctx, mortar, palette)
        else:
            stone = np.broadcast_to(stone, (H, W, 4)).copy()
            mortar = np.broadcast_to(mortar, (H, W, 4)).copy()

        ux, uy = uvx, uvy
        if ctx.line_dir is not None:
            ax, ay = ctx.line_dir
            ln = max(np.hypot(ax, ay), 1e-20)
            ax, ay = ax / ln, ay / ln
            ux, uy = uvx * ax + uvy * ay, uvx * -ay + uvy * ax

        sdf, cid = box_divide(ux / 10.0, uy / 10.0, gap, rotation / 10.0, rounding)
        edge = smoothstep(-0.08, 0.0, sdf)[..., None]
        shade = (0.85 + 0.3 * (cid * 2.0 - 1.0))[..., None]
        out = mortar * edge + stone * shade * (1.0 - edge)
        out[..., 3] = 1.0
        return out.astype(np.float32), np.ones((H, W), bool)

    return None, None


# ---------------------------------------------------------------------------
# shape SDF nodes (shapefx.rs:1277-1385 evaluate_distance)
# ---------------------------------------------------------------------------


def evaluate_distance(node, px, py, vertices) -> Optional[np.ndarray]:
    """Vectorized shape SDF for Circle/Line/Box nodes; `vertices` are the
    shape's control points in world space."""
    if len(vertices) == 0:
        return None
    role = node.role
    v0 = np.asarray(vertices[0], np.float32)

    if role == ShapeFXRole.Circle:
        radius = node.values.get_float_default("radius", 0.5)
        return np.hypot(px - v0[0], py - v0[1]) - radius

    if role == ShapeFXRole.Line:
        if len(vertices) < 2:
            return None
        v1 = np.asarray(vertices[1], np.float32)
        radius = node.values.get_float_default("radius", 0.5)
        radius2 = node.values.get_float_default("radius2", 0.0)
        ba = v1 - v0
        ba_dot = float(ba @ ba)
        if ba_dot == 0.0:
            return np.hypot(px - v0[0], py - v0[1]) - max(radius, radius2)
        h = np.clip(((px - v0[0]) * ba[0] + (py - v0[1]) * ba[1]) / ba_dot, 0.0, 1.0)
        dist = np.hypot(px - (v0[0] + ba[0] * h), py - (v0[1] + ba[1] * h))
        if radius2 == 0.0:
            return dist - radius
        return dist - (radius * (1.0 - h) + radius2 * h)

    if role == ShapeFXRole.Box:
        if len(vertices) < 2:
            return None
        v1 = np.asarray(vertices[1], np.float32)
        th = node.values.get_float_default("thickness", 0.5)
        rounding = node.values.get_float_default("rounding", 0.0)
        ba = v1 - v0
        length = float(np.hypot(*ba))
        if length == 0.0:
            return np.full(px.shape, np.finfo(np.float32).max, np.float32)
        d = ba / length
        cx, cy = (v0 + v1) * 0.5
        qx = px - cx
        qy = py - cy
        rx = np.abs(d[0] * qx + d[1] * qy)
        ry = np.abs(-d[1] * qx + d[0] * qy)
        mx = rx - length * 0.5 + rounding
        my = ry - th * 0.5 + rounding
        outside = np.hypot(np.maximum(mx, 0.0), np.maximum(my, 0.0))
        inside = np.minimum(np.maximum(mx, my), 0.0)
        return outside + inside - rounding

    return None

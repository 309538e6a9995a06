"""Surface/profile chunk building: base caps with profile holes, extrusion
(back cap + jamb bands), feature meshes (relief / recess / billboard), and
per-tile source / vertex-blend override partitioning.

TPU-native equivalent of the reference's surface flow:
  * src/chunkbuilder/d3chunkbuilder.rs:380-1200 — base cap triangulation with
    hole subtraction, tile/blend override partitioning, extrusion back cap,
    jamb side bands
  * src/chunkbuilder/action/{relief,recess,hole,billboard}.rs — feature
    descriptors (cap FilledRegion + sides QuadStrip control points)
  * src/chunkbuilder/surface_mesh_builder.rs — unified topology meshing and
    winding fixes

All mesh generation here is host-side NumPy (it runs at map-build time, like
the reference's CPU chunk builders); the emitted Batch3D flow through the
packed SoA scene path and are rasterized on device like everything else.
Vertex-blended batches carry `source2` + per-vertex `blend_weights`, which
the device setup pass folds into one extra perspective-correct attribute
plane (see ops/setup_pass.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..map.geometry import polygon_area, triangulate_polygon
from ..map.surface import (
    BillboardAnimation,
    LoopOpKind,
    ProfileLoop,
    Surface,
)
from ..models.batch import Batch3D, PixelSource, RepeatMode
from ..models.blend import VertexBlendPreset

_EPS = 1e-5


# ---------------------------------------------------------------------------
# small mesh utilities (surface_mesh_builder.rs:201-284)
# ---------------------------------------------------------------------------


def fix_winding(vertices: np.ndarray, indices: np.ndarray, desired_normal) -> np.ndarray:
    """Flip all triangles when the sampled average normal opposes
    `desired_normal` (surface_mesh_builder.rs:201-239)."""
    if len(indices) == 0 or len(vertices) < 3:
        return indices
    v = np.asarray(vertices, np.float32)[:, :3]
    avg = np.zeros(3, np.float64)
    for a, b, c in indices[: min(8, len(indices))]:
        avg += np.cross(v[b] - v[a], v[c] - v[a])
    mag = np.linalg.norm(avg)
    if mag < 1e-8:
        return indices
    if float(np.dot(avg / mag, np.asarray(desired_normal, np.float64))) < 0.0:
        return np.asarray(indices, np.int32)[:, ::-1].copy()
    return np.asarray(indices, np.int32)


def build_surface_uvs(verts_uv: np.ndarray, sector) -> np.ndarray:
    """Texture UVs for cap vertices: fit (tile_mode 0) or world-repeat with
    texture_scale_x/y (d3chunkbuilder.rs:49-81)."""
    verts_uv = np.asarray(verts_uv, np.float32)
    if len(verts_uv) == 0:
        return verts_uv.reshape(0, 2)
    tile_mode = sector.properties.get_int_default("tile_mode", 1)
    mn = verts_uv.min(axis=0)
    if tile_mode == 0:
        size = np.maximum(verts_uv.max(axis=0) - mn, 1e-6)
        return (verts_uv - mn) / size
    sx = max(sector.properties.get_float_default("texture_scale_x", 1.0), 1e-6)
    sy = max(sector.properties.get_float_default("texture_scale_y", 1.0), 1e-6)
    return (verts_uv - mn) / np.array([sx, sy], np.float32)


def _world4(surface: Surface, verts_uv) -> np.ndarray:
    out = np.empty((len(verts_uv), 4), np.float32)
    for i, uv in enumerate(verts_uv):
        p = surface.uv_to_world(uv)
        out[i] = (p[0], p[1], p[2], 1.0)
    return out


def _clip_axis(poly: List[np.ndarray], axis: int, keep_min: bool, bound: float):
    """Sutherland-Hodgman clip against one axis-aligned bound
    (d3chunkbuilder.rs:236-302)."""
    if not poly:
        return poly
    res: List[np.ndarray] = []
    prev = poly[-1]

    def inside(p):
        return p[axis] >= bound - _EPS if keep_min else p[axis] <= bound + _EPS

    prev_in = inside(prev)
    for curr in poly:
        curr_in = inside(curr)
        d = curr - prev
        if abs(d[axis]) < _EPS:
            t = 0.0
        else:
            t = (bound - prev[axis]) / d[axis]
        inter = prev + d * min(max(t, 0.0), 1.0)
        if curr_in:
            if not prev_in:
                res.append(inter)
            res.append(curr)
        elif prev_in:
            res.append(inter)
        prev, prev_in = curr, curr_in
    return res


def subdivide_triangles_into_tiles(indices, verts_uv, surface: Surface):
    """Split triangles along integer UV tile boundaries; returns
    (new_uvs, new_world, [(cell, tri)], vertex_cells)
    (d3chunkbuilder.rs:226-363)."""
    verts_uv = np.asarray(verts_uv, np.float32)
    new_uvs = [list(uv) for uv in verts_uv]
    new_world = [list(w) for w in _world4(surface, verts_uv)]
    vertex_cells = [
        (int(math.floor(uv[0])), int(math.floor(uv[1]))) for uv in verts_uv
    ]
    tiled: List[Tuple[Tuple[int, int], Tuple[int, int, int]]] = []

    for a, b, c in indices:
        tri = [verts_uv[a].copy(), verts_uv[b].copy(), verts_uv[c].copy()]
        orig_sign = 1.0 if polygon_area([tuple(p) for p in tri]) >= 0 else -1.0
        xs = [p[0] for p in tri]
        ys = [p[1] for p in tri]
        for tx in range(int(math.floor(min(xs))), int(math.ceil(max(xs)))):
            for ty in range(int(math.floor(min(ys))), int(math.ceil(max(ys)))):
                poly = list(tri)
                poly = _clip_axis(poly, 0, True, float(tx))
                poly = _clip_axis(poly, 0, False, float(tx + 1))
                poly = _clip_axis(poly, 1, True, float(ty))
                poly = _clip_axis(poly, 1, False, float(ty + 1))
                if len(poly) < 3:
                    continue
                area = polygon_area([tuple(p) for p in poly])
                if abs(area) < 1e-6:
                    continue
                if (1.0 if area >= 0 else -1.0) * orig_sign < 0:
                    poly.reverse()
                base = len(new_uvs)
                for p in poly:
                    new_uvs.append([float(p[0]), float(p[1])])
                    w = surface.uv_to_world(p)
                    new_world.append([float(w[0]), float(w[1]), float(w[2]), 1.0])
                    vertex_cells.append((tx, ty))
                for i in range(1, len(poly) - 1):
                    tiled.append(((tx, ty), (base, base + i, base + i + 1)))

    return (
        np.asarray(new_uvs, np.float32).reshape(-1, 2),
        np.asarray(new_world, np.float32).reshape(-1, 4),
        tiled,
        vertex_cells,
    )


def _src_key(ps: PixelSource) -> tuple:
    return (int(ps.kind), getattr(ps, "uuid", None), getattr(ps, "index", None))


def partition_tile_and_blend_overrides(
    indices,
    verts_uv,
    tile_overrides: Optional[Dict[Tuple[int, int], PixelSource]],
    blend_overrides: Optional[
        Dict[Tuple[int, int], Tuple[VertexBlendPreset, PixelSource]]
    ],
    surface: Surface,
    default_source: Optional[PixelSource],
):
    """Route per-tile triangles to tile/blend override batches
    (d3chunkbuilder.rs:101-224).

    Returns (tiled_uvs, world_vertices, default_indices,
             [(PixelSource, tris)], [(base_src, blend_src, weights, tris)],
             local_uvs)."""
    indices = [tuple(int(i) for i in tri) for tri in indices]
    if not tile_overrides and not blend_overrides:
        world = _world4(surface, np.asarray(verts_uv, np.float32))
        uvs = np.asarray(verts_uv, np.float32).reshape(-1, 2)
        return uvs, world, indices, [], [], uvs.copy()

    tiled_uvs, tiled_world, tiled_tris, vertex_cells = subdivide_triangles_into_tiles(
        indices, verts_uv, surface
    )
    # tile-local UVs for the bilinear corner-weight evaluation
    local_uvs = tiled_uvs.copy()
    for i, (tx, ty) in enumerate(vertex_cells):
        local_uvs[i, 0] -= tx
        local_uvs[i, 1] -= ty

    defaults: List[Tuple[int, int, int]] = []
    per_tile: Dict[tuple, Tuple[PixelSource, List]] = {}
    per_blend: Dict[tuple, Tuple[PixelSource, PixelSource, VertexBlendPreset, List]] = {}

    for cell, tri in tiled_tris:
        if blend_overrides and cell in blend_overrides:
            preset, blend_src = blend_overrides[cell]
            base_src = (
                tile_overrides.get(cell, default_source)
                if tile_overrides
                else default_source
            )
            if base_src is None:
                base_src = PixelSource.off()
            oriented = preset.orient_to_world(surface.plane.normal)
            key = (_src_key(base_src), _src_key(blend_src), int(oriented))
            per_blend.setdefault(key, (base_src, blend_src, oriented, []))[3].append(tri)
            continue
        if tile_overrides and cell in tile_overrides:
            ps = tile_overrides[cell]
            per_tile.setdefault(_src_key(ps), (ps, []))[1].append(tri)
            continue
        defaults.append(tri)

    blend_batches = []
    for base_src, blend_src, preset, tris in per_blend.values():
        w = preset.weights()  # (TL, TR, BR, BL)
        weights = np.zeros(len(tiled_uvs), np.float32)
        for a, b, c in tris:
            for idx in (a, b, c):
                u, v = float(local_uvs[idx, 0]), float(local_uvs[idx, 1])
                weights[idx] = (
                    w[0] * (1 - u) * (1 - v)
                    + w[1] * u * (1 - v)
                    + w[2] * u * v
                    + w[3] * (1 - u) * v
                )
        blend_batches.append((base_src, blend_src, weights, tris))

    return (
        tiled_uvs,
        tiled_world,
        defaults,
        [v for v in per_tile.values()],
        blend_batches,
        local_uvs,
    )


# ---------------------------------------------------------------------------
# profile loops
# ---------------------------------------------------------------------------


def read_profile_loops(
    surface: Surface, sector, map_
) -> Optional[Tuple[ProfileLoop, List[ProfileLoop]]]:
    """Outer loop from the host sector + hole loops from the surface
    (direct `profile_loops`) and/or an attached profile map
    (d3chunkbuilder.rs:1863-2010)."""
    from ..map.surface import LoopOp

    outer_path = surface.sector_loop_uv(map_)
    if outer_path is None or len(outer_path) < 3:
        return None

    op_code = sector.properties.get_int_default("profile_outer_op", 0)
    outer_op = LoopOp()
    if op_code == 1:
        outer_op = LoopOp(
            LoopOpKind.Relief,
            height=sector.properties.get_float_default("profile_outer_height", 0.0),
        )
    elif op_code == 2:
        outer_op = LoopOp(
            LoopOpKind.Recess,
            depth=sector.properties.get_float_default("profile_outer_depth", 0.0),
        )
    outer = ProfileLoop(path=list(outer_path), op=outer_op)

    holes: List[ProfileLoop] = [pl for pl in surface.profile_loops if pl.path]

    # attached editor profile map: each profile sector is one loop; editor
    # convention is -Y up so flip Y (d3chunkbuilder.rs:1918)
    if surface.profile is not None and surface.profile in getattr(map_, "profiles", {}):
        pm = map_.profiles[surface.profile]
        for ps in pm.sectors:
            path: List[Tuple[float, float]] = []
            for lid in ps.linedefs:
                ld = pm.find_linedef(lid)
                v = pm.get_vertex(ld.start_vertex) if ld else None
                if v is None:
                    continue
                pt = (float(v.x), float(-v.y))
                if not path or path[-1] != pt:
                    path.append(pt)
            if len(path) >= 3 and math.dist(path[0], path[-1]) < 1e-4:
                path.pop()
            if len(path) < 3:
                continue
            pcode = ps.properties.get_int_default("profile_op", 0)
            amount = ps.properties.get_float_default("profile_amount", float("nan"))
            op = LoopOp()
            if pcode == 1:
                h = (
                    ps.properties.get_float_default("profile_height", 0.0)
                    if math.isnan(amount)
                    else amount
                )
                op = LoopOp(LoopOpKind.Relief, height=h)
            elif pcode == 2:
                d = (
                    ps.properties.get_float_default("profile_depth", 0.0)
                    if math.isnan(amount)
                    else amount
                )
                op = LoopOp(LoopOpKind.Recess, depth=d)
            elif pcode == 3:
                inset = (
                    ps.properties.get_float_default("profile_inset", 0.0)
                    if math.isnan(amount)
                    else amount
                )
                tile = ps.properties.get_str_default("billboard_tile_id", "") or None
                anim = BillboardAnimation(
                    ps.properties.get_int_default("billboard_animation", 0)
                )
                op = LoopOp(
                    LoopOpKind.Billboard, depth=inset, tile_id=tile, animation=anim
                )
            op.target_side = ps.properties.get_int_default("profile_target", 0)
            holes.append(
                ProfileLoop(path=path, op=op, origin_profile_sector=ps.id)
            )
    return outer, holes


def split_loops_for_base(
    holes: List[ProfileLoop], extrude_abs: float
) -> Tuple[List[ProfileLoop], List[ProfileLoop]]:
    """Classify hole loops into base-cap subtractions vs feature meshes
    (d3chunkbuilder.rs:1822-1860)."""
    base_holes: List[ProfileLoop] = []
    features: List[ProfileLoop] = []
    for h in holes:
        k = h.op.kind
        if k == LoopOpKind.Nothing:
            base_holes.append(h)
        elif k == LoopOpKind.Recess:
            if extrude_abs <= _EPS:
                base_holes.append(h)
                features.append(h)
            else:
                features.append(h)
        elif k == LoopOpKind.Relief:
            features.append(h)
        elif k == LoopOpKind.Billboard:
            base_holes.append(h)
            features.append(h)
    return base_holes, features


# ---------------------------------------------------------------------------
# feature meshes (action/*.rs + surface_mesh_builder.rs)
# ---------------------------------------------------------------------------


def _filled_region(surface: Surface, loop_uv, extrusion: float):
    """Cap mesh at a constant extrusion (surface_mesh_builder.rs:68-122)."""
    pts, tris = triangulate_polygon([tuple(p) for p in loop_uv], [])
    if len(tris) == 0:
        return None
    world = np.empty((len(pts), 4), np.float32)
    for i, p in enumerate(pts):
        w = surface.uvw_to_world(p, extrusion)
        world[i] = (w[0], w[1], w[2], 1.0)
    uvs = np.asarray(pts, np.float32).reshape(-1, 2)
    # the reference reverses earcut winding here; fix_winding re-orients later
    tris = np.asarray(tris, np.int32)[:, ::-1].copy()
    return world, tris, uvs


def _quad_strip(surface: Surface, loop_uv, w_a: float, w_b: float):
    """Side walls connecting the loop at extrusion w_a to w_b
    (surface_mesh_builder.rs:124-189)."""
    n = len(loop_uv)
    if n < 2:
        return None
    world_a = [surface.uvw_to_world(p, w_a) for p in loop_uv]
    dists = [0.0]
    for i in range(n):
        dists.append(
            dists[-1]
            + float(np.linalg.norm(world_a[(i + 1) % n] - world_a[i]))
        )
    total = max(dists[-1], 1e-6)

    verts = np.empty((2 * n, 4), np.float32)
    uvs = np.empty((2 * n, 2), np.float32)
    for i in range(n):
        pa = world_a[i]
        pb = surface.uvw_to_world(loop_uv[i], w_b)
        verts[2 * i] = (pa[0], pa[1], pa[2], 1.0)
        verts[2 * i + 1] = (pb[0], pb[1], pb[2], 1.0)
        u = dists[i] / total
        uvs[2 * i] = (u, 0.0)
        uvs[2 * i + 1] = (u, 1.0)
    indices = []
    for i in range(n):
        ca, cb = 2 * i, 2 * i + 1
        na, nb = 2 * ((i + 1) % n), 2 * ((i + 1) % n) + 1
        indices.append((ca, na, nb))
        indices.append((ca, nb, cb))
    return verts, np.asarray(indices, np.int32), uvs


def feature_meshes(surface: Surface, loop: ProfileLoop, thickness: float):
    """(cap/sides) meshes for one feature loop with reference action
    semantics; returns [(verts, indices, uvs, is_cap)]
    (action/relief.rs, recess.rs, billboard.rs + d3chunkbuilder.rs:2474-2494)."""
    op = loop.op
    target = op.target_side
    base_ext = thickness if target == 1 else 0.0
    out = []

    n = surface.plane.normal.astype(np.float64)
    ln = np.linalg.norm(n)
    n = n / ln if ln > 1e-6 else np.array([0.0, 1.0, 0.0])

    if op.kind == LoopOpKind.Relief and op.height > 0.0:
        direction = 1.0 if target == 1 else -1.0
        ext = base_ext + direction * op.height
        cap = _filled_region(surface, loop.path, ext)
        sides = _quad_strip(surface, loop.path, base_ext, ext)
    elif op.kind == LoopOpKind.Recess and op.depth > 0.0:
        direction = -1.0 if target == 1 else 1.0
        ext = base_ext + direction * op.depth
        cap = _filled_region(surface, loop.path, ext)
        sides = _quad_strip(surface, loop.path, base_ext, ext)
    elif op.kind == LoopOpKind.Billboard:
        cap = _filled_region(surface, loop.path, op.depth)
        sides = None
    else:
        return out

    if cap is not None:
        verts, tris, uvs = cap
        desired = -n if target == 0 else n
        tris = fix_winding(verts, tris, desired)
        out.append((verts, tris, uvs, True))
    if sides is not None:
        verts, tris, uvs = sides
        tris = fix_winding(verts, tris, n)
        out.append((verts, tris, uvs, False))
    return out


# ---------------------------------------------------------------------------
# jamb bands (d3chunkbuilder.rs:667-772)
# ---------------------------------------------------------------------------


def build_jamb(surface: Surface, loop_uv, depth: float, sector):
    """Per-edge side quads from the surface plane to +normal*depth, with
    perimeter-distance U; horizontal floor-level edges are skipped (door
    bottoms, d3chunkbuilder.rs:731-739)."""
    m = len(loop_uv)
    if m < 2:
        return None
    n = surface.plane.normal.astype(np.float64)
    ln = np.linalg.norm(n)
    n = n / ln if ln > 1e-6 else np.array([0.0, 1.0, 0.0])

    front = [surface.uv_to_world(p).astype(np.float64) for p in loop_uv]
    dists = [0.0]
    for i in range(m):
        dists.append(dists[-1] + float(np.linalg.norm(front[(i + 1) % m] - front[i])))
    perim = max(dists[-1], 1e-6)

    tm = sector.properties.get_int_default(
        "side_tile_mode", sector.properties.get_int_default("tile_mode", 1)
    )
    su = max(
        sector.properties.get_float_default(
            "side_texture_scale_x",
            sector.properties.get_float_default("texture_scale_x", 1.0),
        ),
        1e-6,
    )
    sv = max(
        sector.properties.get_float_default(
            "side_texture_scale_y",
            sector.properties.get_float_default("texture_scale_y", 1.0),
        ),
        1e-6,
    )
    depth_abs = max(abs(depth), 1e-6)

    verts, uvs, inds = [], [], []
    for i in range(m):
        a, b = front[i], front[(i + 1) % m]
        # skip horizontal edges at floor level (door bottoms)
        if abs(a[1] - b[1]) < 0.01 and min(a[1], b[1]) < 0.2:
            continue
        a2, b2 = a + n * depth, b + n * depth
        base = len(verts)
        for p in (a, b, b2, a2):
            verts.append([p[0], p[1], p[2], 1.0])
        if tm == 0:
            ua, ub, v0, v1 = dists[i] / perim, dists[i + 1] / perim, 0.0, 1.0
        else:
            ua, ub, v0, v1 = dists[i] / su, dists[i + 1] / su, 0.0, depth_abs / sv
        uvs.extend([[ua, v0], [ub, v0], [ub, v1], [ua, v1]])
        inds.append((base, base + 1, base + 2))
        inds.append((base, base + 2, base + 3))
    if not inds:
        return None
    return (
        np.asarray(verts, np.float32),
        np.asarray(inds, np.int32),
        np.asarray(uvs, np.float32),
    )


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------


@dataclass
class SurfaceBillboard:
    """Door/gate billboard emitted by a profile loop; the client animates it
    each frame from item visibility (scene_handler.rs:580-731)."""

    geo_id: Tuple[int, Optional[int]]  # (host sector, profile sector)
    tile_id: Optional[str]
    animation: BillboardAnimation
    center: np.ndarray
    right: np.ndarray
    up: np.ndarray
    size: float
    loop_uv: List[Tuple[float, float]] = field(default_factory=list)
    inset: float = 0.0


def build_surface_batches(map_, sector, surface: Surface, assets=None):
    """All Batch3D for one sector surface: base cap (holes cut), tile/blend
    overrides, extrusion back cap + jambs, feature meshes. Billboards are
    returned separately for client-side open/close animation.

    Returns (batches, billboards)."""
    from .d3builder import resolve_source

    loops = read_profile_loops(surface, sector, map_)
    if loops is None:
        return [], []
    outer, holes = loops
    extrude_abs = abs(surface.extrusion.depth)
    base_holes, features = split_loops_for_base(holes, extrude_abs)

    def get_source(key: str) -> Optional[PixelSource]:
        src = sector.properties.get_source(key) or sector.properties.get_source(
            "source"
        )
        resolved = resolve_source(src, assets) if assets is not None else src
        return resolved if resolved is not None else src

    cap_source = get_source("cap_source")
    jamb_source = get_source("jamb_source")

    tile_overrides = None
    tv = sector.properties.get("tiles")
    if tv is not None and isinstance(tv.data, dict):
        tile_overrides = {
            cell: (resolve_source(ps, assets) or ps) if assets else ps
            for cell, ps in tv.data.items()
        }
    blend_overrides = None
    bv = sector.properties.get("blend_tiles")
    if bv is not None and isinstance(bv.data, dict):
        blend_overrides = {
            cell: (preset, (resolve_source(ps, assets) or ps) if assets else ps)
            for cell, (preset, ps) in bv.data.items()
        }

    batches: List[Batch3D] = []
    billboards: List[SurfaceBillboard] = []

    n = surface.plane.normal.astype(np.float64)
    ln = np.linalg.norm(n)
    n = n / ln if ln > 1e-6 else np.array([0.0, 1.0, 0.0])

    def emit(verts, tris, uvs, src, normal):
        if len(tris) == 0:
            return
        b = Batch3D(
            vertices=np.asarray(verts, np.float32).reshape(-1, 4),
            indices=np.asarray(tris, np.int32).reshape(-1, 3),
            uvs=np.asarray(uvs, np.float32).reshape(-1, 2),
            normals=np.tile(
                np.asarray(normal, np.float32), (len(verts), 1)
            ),
            source=src if src is not None else PixelSource.off(),
            repeat_mode=RepeatMode.RepeatXY,
        )
        b.profile_id = sector.id
        batches.append(b)

    def build_cap(offset: float, hole_paths, desired_normal):
        """Triangulate outer-with-holes at `offset` along the normal and emit
        default + override + blend batches."""
        pts, tris = triangulate_polygon(
            [tuple(p) for p in outer.path], [list(h) for h in hole_paths]
        )
        if len(tris) == 0:
            return
        world0 = _world4(surface, pts)
        tris = fix_winding(world0, np.asarray(tris, np.int32), desired_normal)

        (
            tiled_uvs,
            world,
            default_tris,
            override_batches,
            blend_batches,
            _local_uvs,
        ) = partition_tile_and_blend_overrides(
            tris, np.asarray(pts, np.float32), tile_overrides, blend_overrides,
            surface, cap_source,
        )
        if offset != 0.0:
            world = world + np.array([*(n * offset), 0.0], np.float32)

        tex_uvs = build_surface_uvs(tiled_uvs, sector)
        nrm = desired_normal
        if default_tris:
            emit(world, default_tris, tex_uvs, cap_source, nrm)
        for ps, tris_o in override_batches:
            emit(world, tris_o, tex_uvs, ps, nrm)
        for base_src, blend_src, weights, tris_b in blend_batches:
            if not tris_b:
                continue
            b = Batch3D(
                vertices=world,
                indices=np.asarray(tris_b, np.int32).reshape(-1, 3),
                uvs=tex_uvs,
                normals=np.tile(np.asarray(nrm, np.float32), (len(world), 1)),
                source=base_src if base_src is not None else PixelSource.off(),
                repeat_mode=RepeatMode.RepeatXY,
                source2=blend_src,
                blend_weights=weights,
            )
            b.profile_id = sector.id
            batches.append(b)

    # ---- 1) front cap: base holes + front-targeted recess/relief cuts ----
    front_holes = [h.path for h in base_holes]
    if extrude_abs > _EPS:
        for h in holes:
            if h.op.kind == LoopOpKind.Recess and (
                h.op.target_side == 0 or h.op.depth > extrude_abs
            ):
                front_holes.append(h.path)
            elif h.op.kind == LoopOpKind.Relief and h.op.target_side == 0:
                front_holes.append(h.path)
    build_cap(0.0, front_holes, n)  # front cap faces +normal (dcb.rs:524)

    # ---- 2) extrusion: back cap + jamb bands ----
    if surface.extrusion.enabled and extrude_abs > 1e-6:
        depth = surface.extrusion.depth
        back_holes = []
        for h in holes:
            k = h.op.kind
            if k == LoopOpKind.Nothing or k == LoopOpKind.Billboard:
                back_holes.append(h.path)
            elif k in (LoopOpKind.Recess, LoopOpKind.Relief) and h.op.target_side == 1:
                back_holes.append(h.path)
        build_cap(depth, back_holes, -n)  # back cap faces -normal (dcb.rs:897)

        jamb = build_jamb(surface, outer.path, depth, sector)
        if jamb is not None:
            emit(jamb[0], jamb[1], jamb[2], jamb_source, n)
        # jamb tubes around through-holes
        for h in base_holes:
            tube = build_jamb(surface, h.path, depth, sector)
            if tube is not None:
                emit(tube[0], tube[1], tube[2], jamb_source, n)

    # ---- 3) features ----
    for f in features:
        if f.op.kind == LoopOpKind.Billboard:
            uv = np.asarray(f.path, np.float32)
            center_uv = uv.mean(axis=0)
            size = float(max(uv.max(axis=0) - uv.min(axis=0)))
            center = surface.uvw_to_world(center_uv, f.op.depth)
            billboards.append(
                SurfaceBillboard(
                    geo_id=(sector.id, f.origin_profile_sector),
                    tile_id=f.op.tile_id,
                    animation=f.op.animation,
                    center=np.asarray(center, np.float32),
                    right=surface.frame.right.copy(),
                    up=surface.frame.up.copy(),
                    size=size,
                    loop_uv=list(f.path),
                    inset=f.op.depth,
                )
            )
            # no static geometry: the client re-emits the billboard every
            # frame as dynamic geometry so doors can animate open/close
            # (scene_handler.rs:580-731)
            continue
        for verts, tris, uvs, is_cap in feature_meshes(surface, f, extrude_abs):
            src = cap_source if is_cap else jamb_source
            nrm = (-n if f.op.target_side == 0 else n) if is_cap else n
            emit(verts, tris, uvs, src, nrm)

    return batches, billboards

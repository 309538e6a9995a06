"""Map -> 3D renderable geometry (the chunk-builder pipeline).

Behavioral port of the reference's classic Doom-style build rules (legacy
D3Builder property model, src/scenebuilder/d3builder.rs, and the live
D3ChunkBuilder surface flow, src/chunkbuilder/d3chunkbuilder.rs:380+):

  * sector floors: earcut polygon at `floor_height` with `floor_source`
  * sector ceilings: at `ceiling_height` with `ceiling_source` (only when
    ceiling_height > 0)
  * linedef walls: quads from floor to `wall_height` with `row1..row4_source`
    bands (1 unit tall each) or the linedef `source`
  * transparent wall sources (doors/windows with `is_door`/`is_window` or
    non-opaque tiles) go to the opacity batch list
  * per-sector/linedef lights compile into chunk lights
  * collision volumes from walls (wall_height > 0)
  * terrain mesh when the map's terrain is non-empty

Output geometry is grouped into 16x16 world chunks for incremental builds
(reference scenemanager.rs:272-285).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from ..models.batch import Batch2D, Batch3D, PixelSource, PixelSourceKind, RepeatMode
from ..utils.rect import Rect
from .chunk import CHUNK_SIZE, Chunk, ChunkCollision


def resolve_source(src, assets) -> Optional[PixelSource]:
    """TileId/MaterialId -> StaticTileIndex via assets
    (reference pixelsource.rs tile_from_tile_list)."""
    if src is None:
        return None
    if src.kind in (PixelSourceKind.TileId, PixelSourceKind.MaterialId):
        idx = assets.tile_index(src.uuid) if assets is not None else None
        if idx is None:
            return None
        return PixelSource.static_tile_index(idx)
    if src.kind == PixelSourceKind.Off:
        return None
    return src


def source_is_opaque(src: PixelSource, assets) -> bool:
    if src is None:
        return True
    if src.kind == PixelSourceKind.StaticTileIndex:
        if assets is None or src.index >= len(assets.tile_list):
            return True
        return all(t.is_fully_opaque() for t in assets.tile_list[src.index].textures)
    if src.kind in (PixelSourceKind.Pixel, PixelSourceKind.Color):
        return src.pixel[3] >= 255
    return True


def chunk_key_for(x: float, y: float) -> Tuple[int, int]:
    return (int(math.floor(x / CHUNK_SIZE)), int(math.floor(y / CHUNK_SIZE)))


class D3Builder:
    """Builds the whole map into scene chunks. The SceneManager drives the
    incremental (per-chunk) variant; `build` does everything at once."""

    def build(self, map_, assets, scene) -> None:
        chunks: Dict[Tuple[int, int], Chunk] = {}

        def chunk_at(x: float, y: float) -> Chunk:
            key = chunk_key_for(x, y)
            c = chunks.get(key)
            if c is None:
                c = Chunk(
                    origin=(key[0] * CHUNK_SIZE, key[1] * CHUNK_SIZE),
                    bbox=Rect(
                        key[0] * CHUNK_SIZE, key[1] * CHUNK_SIZE, CHUNK_SIZE, CHUNK_SIZE
                    ),
                )
                chunks[key] = c
            return c

        # --- sector floors / ceilings ---
        for sector in map_.sectors:
            geo = sector.generate_geometry(map_)
            if geo is None:
                continue
            verts2, tris = geo
            center = sector.center(map_)
            if center is None:
                continue
            chunk = chunk_at(center[0], center[1])

            occlusion = sector.properties.get_float_default("occlusion", 1.0)
            if occlusion < 1.0:
                bb = sector.bounding_box(map_)
                chunk.occluded_sectors.append(
                    (Rect(bb.x - 0.1, bb.y - 0.1, bb.width + 0.2, bb.height + 0.2), occlusion)
                )

            floor_h = sector.properties.get_float_default("floor_height", 0.0)
            ceil_h = sector.properties.get_float_default("ceiling_height", 0.0)

            floor_src = resolve_source(
                sector.properties.get_source("floor_source")
                or sector.properties.get_source("source"),
                assets,
            )
            if floor_src is not None:
                batch = self._horizontal_batch(verts2, tris, floor_h, floor_src, up=True)
                self._stash(chunk, batch, floor_src, assets)

            ceil_src = resolve_source(
                sector.properties.get_source("ceiling_source"), assets
            )
            if ceil_src is not None and ceil_h > 0.0:
                batch = self._horizontal_batch(verts2, tris, ceil_h, ceil_src, up=False)
                self._stash(chunk, batch, ceil_src, assets)

            # sector lights (floor_light / ceiling_light properties)
            for key, yoff in (("floor_light", floor_h + 0.1), ("ceiling_light", max(ceil_h - 0.1, 0.1))):
                lv = sector.properties.get(key)
                if lv is not None and lv.data is not None:
                    light = lv.data
                    compiled = light.compile() if hasattr(light, "compile") else light
                    compiled.position = np.array(
                        [center[0], yoff, center[1]], np.float32
                    )
                    chunk.lights.append(compiled)

        # --- linedef walls ---
        for linedef in map_.linedefs:
            wall_h = linedef.properties.get_float_default("wall_height", 0.0)
            if wall_h <= 0.0:
                continue
            v0 = map_.get_vertex(linedef.start_vertex)
            v1 = map_.get_vertex(linedef.end_vertex)
            if v0 is None or v1 is None:
                continue
            mid = ((v0.x + v1.x) / 2.0, (v0.y + v1.y) / 2.0)
            chunk = chunk_at(*mid)

            # wall floor base: lowest adjoining sector floor
            base = 0.0
            for sid in linedef.sector_ids:
                s = map_.find_sector(sid)
                if s is not None:
                    base = min(base, s.properties.get_float_default("floor_height", 0.0))

            # texture bands: row1..row4_source each 1 unit tall; unset rows
            # fall back to row1 then the linedef `source`
            default_src = resolve_source(
                linedef.properties.get_source("row1_source"), assets
            ) or resolve_source(linedef.properties.get_source("source"), assets)
            y = base
            row = 1
            while y < base + wall_h - 1e-6:
                h = min(1.0, base + wall_h - y)
                src = resolve_source(
                    linedef.properties.get_source(f"row{row}_source"), assets
                ) or default_src
                if src is not None:
                    batch = self._wall_batch(v0, v1, y, y + h, src)
                    is_door = linedef.properties.get_bool_default("is_door", False)
                    is_window = linedef.properties.get_bool_default("is_window", False)
                    if is_door or is_window or not source_is_opaque(src, assets):
                        batch.profile_id = linedef.id
                        chunk.batches3d_opacity.append(batch)
                    else:
                        chunk.batches3d.append(batch)
                y += h
                row += 1

            # collision volume
            chunk.collision.blocking_volumes.append(
                (
                    np.array([v0.x, v0.y], np.float32),
                    np.array([v1.x, v1.y], np.float32),
                    base,
                    base + wall_h,
                )
            )

            # linedef-attached light
            lv = linedef.properties.get("light")
            if lv is not None and lv.data is not None:
                light = lv.data
                compiled = light.compile() if hasattr(light, "compile") else light
                compiled.position = np.array(
                    [mid[0], base + wall_h / 2.0, mid[1]], np.float32
                )
                chunk.lights.append(compiled)

        # --- sector surfaces (profile loops, extrusion, tile/blend overrides,
        # relief/recess/billboard features — d3chunkbuilder.rs:380-1200) ---
        from .surfacebuilder import build_surface_batches

        for surface in map_.surfaces.values():
            sector = map_.find_sector(surface.sector_id)
            if sector is None or not surface.is_valid():
                continue
            if sector.properties.get_int_default("terrain_mode", 0) == 2:
                continue  # ridge-mode sectors only shape terrain
            if not sector.properties.get_bool_default("visible", True):
                continue
            center = sector.center(map_)
            if center is None:
                continue
            chunk = chunk_at(center[0], center[1])
            batches, billboards = build_surface_batches(map_, sector, surface, assets)
            for b in batches:
                self._stash(chunk, b, b.source, assets)
            for bb in billboards:
                chunk.billboards.append(bb)

        # --- map lights ---
        for light in map_.lights:
            compiled = light.compile() if hasattr(light, "compile") else light
            p = compiled.position
            chunk_at(float(p[0]), float(p[2])).lights.append(compiled)

        # --- generated terrain (control vertices / ridges / corridors,
        # terrain_generator.rs + TERRAIN.md) ---
        if map_.properties.get_bool_default("terrain_enabled", False):
            from .terraingen import TerrainGenerator

            gen = TerrainGenerator()
            xs = [v.x for v in map_.vertices] or [0.0]
            ys = [v.y for v in map_.vertices] or [0.0]
            bbox = (min(xs), min(ys), max(xs), max(ys))
            tv = map_.properties.get("terrain_tiles")
            overrides = tv.data if tv is not None and isinstance(tv.data, dict) else None
            dv = map_.properties.get("default_terrain_tile")
            default_src = resolve_source(dv.data, assets) if dv is not None and dv.data is not None else None
            for src, verts3, tris, uvs in gen.generate(
                map_, bbox, assets, default_src,
                {c: (resolve_source(s, assets) or s) for c, s in overrides.items()}
                if overrides
                else None,
            ):
                # per-vertex normals from the analytic height field
                eps = 0.5
                hx0 = gen.height_field(map_, verts3[:, 0] - eps, verts3[:, 2])
                hx1 = gen.height_field(map_, verts3[:, 0] + eps, verts3[:, 2])
                hy0 = gen.height_field(map_, verts3[:, 0], verts3[:, 2] - eps)
                hy1 = gen.height_field(map_, verts3[:, 0], verts3[:, 2] + eps)
                n = np.stack(
                    [hx0 - hx1, np.full(len(verts3), 2.0 * eps, np.float32), hy0 - hy1],
                    axis=1,
                )
                n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
                batch = Batch3D(
                    vertices=np.concatenate(
                        [verts3, np.ones((len(verts3), 1), np.float32)], axis=1
                    ),
                    indices=tris,
                    uvs=uvs,
                    normals=n.astype(np.float32),
                    source=src if src is not None else PixelSource.terrain(),
                    repeat_mode=RepeatMode.RepeatXY,
                )
                cen = verts3[:, [0, 2]].mean(axis=0)
                chunk_at(float(cen[0]), float(cen[1])).batches3d.append(batch)

        # --- terrain: bake chunk texture (tile sources + ShapeFX Colorize),
        # run the geometry-node Height pass (Flatten), mesh with overrides
        # (reference terrain/mod.rs:318 bake_chunk +
        # terrain/chunk.rs:144-247 process_batch_modifiers) ---
        if map_.terrain is not None and not map_.terrain.is_empty():
            from ..models.texture import Texture, Tile

            palette = assets.palette if assets is not None else None
            for key in list(map_.terrain.chunks.keys()):
                baked = map_.terrain.bake_chunk(map_, key, assets, palette=palette)
                tex_np, height_ov = baked if baked is not None else (None, {})
                mesh = map_.terrain.build_mesh(
                    key, height_overrides=height_ov, chunk_uvs=tex_np is not None
                )
                if mesh is None:
                    continue
                verts, indices, uvs, normals = mesh
                if tex_np is not None:
                    src = PixelSource.dynamic_tile_index(len(scene.dynamic_textures))
                    scene.dynamic_textures.append(
                        Tile.from_texture(Texture(tex_np))
                    )
                else:
                    src = PixelSource.terrain()
                batch = Batch3D(
                    vertices=verts,
                    indices=indices,
                    uvs=uvs,
                    normals=normals,
                    source=src,
                )
                ck = chunk_at(verts[0][0], verts[0][2])
                ck.terrain_batch3d = batch
                if tex_np is not None:
                    ck.terrain_texture = Texture(tex_np)

        # --- sky plane (map.sky_texture) ---
        # The live reference lost `add_sky` to the SceneVM refactor (dangling
        # call at src/scenebuilder/d3builder.rs:342-350 inside the commented
        # legacy build); the visual contract survives in screenshot_map.png:
        # a fullbright textured ceiling plane spanning the world.
        if map_.sky_texture is not None:
            src = resolve_source(PixelSource.tile_id(map_.sky_texture), assets)
            if src is not None:
                xs = [v.x for v in map_.vertices] or [0.0]
                ys = [v.y for v in map_.vertices] or [0.0]
                cx = (min(xs) + max(xs)) / 2.0
                cz = (min(ys) + max(ys)) / 2.0
                ext = max(max(xs) - min(xs), max(ys) - min(ys), 10.0) * 4.0
                sky_h = 2.0
                for l in map_.linedefs:
                    sky_h = max(
                        sky_h, l.properties.get_float_default("wall_height", 0.0)
                    )
                uv_max = ext / 8.0  # one texture repeat per 8 world units
                quad = Batch3D(
                    vertices=np.array(
                        [
                            [cx - ext, sky_h, cz - ext, 1.0],
                            [cx + ext, sky_h, cz - ext, 1.0],
                            [cx + ext, sky_h, cz + ext, 1.0],
                            [cx - ext, sky_h, cz + ext, 1.0],
                        ],
                        np.float32,
                    ),
                    indices=[(0, 2, 1), (0, 3, 2)],
                    uvs=np.array(
                        [[0, 0], [uv_max, 0], [uv_max, uv_max], [0, uv_max]],
                        np.float32,
                    ),
                    source=src,
                    repeat_mode=RepeatMode.RepeatXY,
                    receives_light=False,
                )
                chunk_at(cx, cz).batches3d.append(quad)

        scene.chunks = chunks
        scene.mapmini = map_.as_mini()

    # -- geometry emitters --

    def _horizontal_batch(self, verts2, tris, height, src, up: bool) -> Batch3D:
        """Floor/ceiling slab; map-space (x, y) -> world (x, z); uv = world
        coords so RepeatXY tiles per unit (reference builder behavior)."""
        verts = np.array(
            [[p[0], height, p[1], 1.0] for p in verts2], np.float32
        )
        uvs = np.array([[p[0], p[1]] for p in verts2], np.float32)
        idx = np.asarray(tris, np.int32)
        if not up:
            idx = idx[:, ::-1]
        ny = 1.0 if up else -1.0
        normals = np.tile(np.array([0.0, ny, 0.0], np.float32), (len(verts), 1))
        return Batch3D(
            vertices=verts,
            indices=idx.copy(),
            uvs=uvs,
            normals=normals,
            source=src,
            repeat_mode=RepeatMode.RepeatXY,
        )

    def _wall_batch(self, v0, v1, y0, y1, src) -> Batch3D:
        length = math.hypot(v1.x - v0.x, v1.y - v0.y)
        verts = np.array(
            [
                [v0.x, y0, v0.y, 1.0],
                [v1.x, y0, v1.y, 1.0],
                [v1.x, y1, v1.y, 1.0],
                [v0.x, y1, v0.y, 1.0],
            ],
            np.float32,
        )
        uvs = np.array(
            [[0, y1 - y0], [length, y1 - y0], [length, 0], [0, 0]], np.float32
        )
        indices = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        d = np.array([v1.x - v0.x, v1.y - v0.y], np.float32)
        n = np.array([-d[1], 0.0, d[0]], np.float32)
        ln = np.linalg.norm(n)
        if ln > 0:
            n = n / ln
        normals = np.tile(n, (4, 1))
        return Batch3D(
            vertices=verts,
            indices=indices,
            uvs=uvs,
            normals=normals,
            source=src,
            repeat_mode=RepeatMode.RepeatXY,
        )

    def _stash(self, chunk: Chunk, batch: Batch3D, src, assets) -> None:
        if source_is_opaque(src, assets):
            chunk.batches3d.append(batch)
        else:
            chunk.batches3d_opacity.append(batch)

"""Map -> top-down 2D geometry (reference src/chunkbuilder/d2chunkbuilder.rs
and the editor preview builder src/scenebuilder/d2preview.rs).

Emits sector floor polygons as textured 2D batches (grid-space coordinates)
plus linedef wall strips, grouped into the same 16x16 chunks as the 3D
builder.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from ..models.batch import Batch2D, RepeatMode
from .chunk import CHUNK_SIZE, Chunk
from .d3builder import chunk_key_for, resolve_source


class D2Builder:
    def build(self, map_, assets, scene) -> None:
        chunks = scene.chunks if scene.chunks else {}

        def chunk_at(x: float, y: float) -> Chunk:
            key = chunk_key_for(x, y)
            c = chunks.get(key)
            if c is None:
                from ..utils.rect import Rect

                c = Chunk(
                    origin=(key[0] * CHUNK_SIZE, key[1] * CHUNK_SIZE),
                    bbox=Rect(
                        key[0] * CHUNK_SIZE, key[1] * CHUNK_SIZE, CHUNK_SIZE, CHUNK_SIZE
                    ),
                )
                chunks[key] = c
            return c

        for sector in map_.sectors:
            geo = sector.generate_geometry(map_)
            if geo is None:
                continue
            verts2, tris = geo
            center = sector.center(map_)
            if center is None:
                continue
            src = resolve_source(
                sector.properties.get_source("floor_source")
                or sector.properties.get_source("source"),
                assets,
            )
            if src is None:
                continue
            batch = Batch2D(
                vertices=np.asarray(verts2, np.float32),
                indices=np.asarray(tris, np.int32)[:, ::-1].copy(),
                uvs=np.asarray(verts2, np.float32),
                source=src,
                repeat_mode=RepeatMode.RepeatXY,
            )
            chunk_at(center[0], center[1]).batches2d.append(batch)

        # walls as thick line quads
        for linedef in map_.linedefs:
            wall_w = max(
                linedef.properties.get_float_default("wall_width", 0.0),
                0.1 if linedef.properties.get_float_default("wall_height", 0.0) > 0 else 0.0,
            )
            if wall_w <= 0.0:
                continue
            v0 = map_.get_vertex(linedef.start_vertex)
            v1 = map_.get_vertex(linedef.end_vertex)
            if v0 is None or v1 is None:
                continue
            src = resolve_source(
                linedef.properties.get_source("row1_source")
                or linedef.properties.get_source("source"),
                assets,
            )
            if src is None:
                continue
            batch = Batch2D(source=src, repeat_mode=RepeatMode.RepeatXY)
            batch.add_line(v0.as_vec2(), v1.as_vec2(), wall_w)
            mid = ((v0.x + v1.x) / 2.0, (v0.y + v1.y) / 2.0)
            chunk_at(*mid).batches2d.append(batch)

        scene.chunks = chunks


class D2MaterialBuilder:
    """Material-mode preview bake of a (profile) map's shape graphs into a
    texture over the fixed [-5, 5]^2 editor domain
    (reference src/scenebuilder/d2material.rs:20-24)."""

    def build_texture(self, map_, assets, texture) -> None:
        from ..shapestack.stack import ShapeStack

        stack = ShapeStack((-5.0, -5.0), (5.0, 5.0))
        stack.render_geometry(texture, map_, assets, material_mode=True)

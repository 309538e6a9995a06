"""2D editor preview builder (reference src/scenebuilder/d2preview.rs,
1,079 LoC — grid background, sector fills, linedef lines, vertex handles,
selection highlights).

Produces a Scene whose 2D batches render the map top-down for editing; the
grid comes from the GridShader background.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.batch import Batch2D, PixelSource, PrimitiveMode
from ..models.scene import Scene
from ..models.shader import GridShader

SELECTION_COLOR = (255, 200, 60, 255)
VERTEX_COLOR = (160, 160, 170, 255)
LINEDEF_COLOR = (200, 200, 210, 255)
SECTOR_FILL = (70, 70, 85, 160)
SECTOR_FILL_SELECTED = (120, 100, 50, 180)


class D2PreviewBuilder:
    """Map -> editor preview scene."""

    def __init__(self):
        self.vertex_size = 0.12  # world units
        self.draw_grid = True

    def build(self, map_, assets=None, screen_size=None) -> Scene:
        scene = Scene.empty()
        if self.draw_grid:
            grid = GridShader()
            grid.set_parameter_f32("grid_size", map_.grid_size)
            grid.set_parameter_f32("subdivisions", map_.subdivisions)
            scene.background = grid

        # sector fills
        for sector in map_.sectors:
            geo = sector.generate_geometry(map_)
            if geo is None:
                continue
            verts2, tris = geo
            color = (
                SECTOR_FILL_SELECTED
                if sector.id in map_.selected_sectors
                else SECTOR_FILL
            )
            scene.d2_static.append(
                Batch2D(
                    vertices=np.asarray(verts2, np.float32),
                    indices=np.asarray(tris, np.int32)[:, ::-1].copy(),
                    uvs=np.asarray(verts2, np.float32),
                    source=PixelSource.pixel(color),
                )
            )

        # linedef lines (selected ones highlighted)
        lines = Batch2D(mode=PrimitiveMode.Lines, source=PixelSource.pixel(LINEDEF_COLOR))
        sel_lines = Batch2D(
            mode=PrimitiveMode.Lines, source=PixelSource.pixel(SELECTION_COLOR)
        )
        for ld in map_.linedefs:
            v0 = map_.get_vertex(ld.start_vertex)
            v1 = map_.get_vertex(ld.end_vertex)
            if v0 is None or v1 is None:
                continue
            target = sel_lines if ld.id in map_.selected_linedefs else lines
            base = len(target.vertices)
            target.vertices = np.concatenate(
                [target.vertices, np.array([[v0.x, v0.y], [v1.x, v1.y]], np.float32)]
            )
            target.uvs = np.concatenate(
                [target.uvs, np.zeros((2, 2), np.float32)]
            )
            target.indices = np.concatenate(
                [target.indices, np.array([[base, base + 1, base]], np.int32)]
            )
        if len(lines.indices):
            scene.d2_static.append(lines)
        if len(sel_lines.indices):
            scene.d2_static.append(sel_lines)

        # vertex handles as small quads
        handles = Batch2D(source=PixelSource.pixel(VERTEX_COLOR))
        sel_handles = Batch2D(source=PixelSource.pixel(SELECTION_COLOR))
        s = self.vertex_size
        for v in map_.vertices:
            target = sel_handles if v.id in map_.selected_vertices else handles
            target.add_rectangle(v.x - s / 2, v.y - s / 2, s, s)
        if len(handles.indices):
            scene.d2_static.append(handles)
        if len(sel_handles.indices):
            scene.d2_static.append(sel_handles)

        for b in scene.d2_static:
            b.receives_light = False
        scene.touch()
        return scene

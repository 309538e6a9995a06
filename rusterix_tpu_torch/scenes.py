"""Scenes the port's checks render.

`build_map_scene` is the JAX package's bench north-star scene (bench.py
`build_map_scene`, the procedural map of benches/rasterize_map.rs): a 5x5
grid of 10-unit rooms with corridors, point lights in every third room, a
spot and an ambient light, seen from a first-person camera. It is built
here through the port's host layer because bench.py imports jax.

`build_map_refl_scene` is the bench's `map_1920x1080_ggx_refl1`
configuration (bench.py `build_map_refl_scene`): the map with a sun, the
GGX BRDF and one reflection ray per pixel.
"""

from __future__ import annotations

import numpy as np

from .builders import D3Builder, MapScript
from .models import Assets, D3FirstPCamera, Light, LightType, Scene, Texture

MAP_SOURCE_HEADER = """
set_default("wall_tex", "brick")
set_default("floor_tex", "floor")
set_default("ceiling_tex", "floor")
set_default("wall_height", 3.0)
"""


def build_map_scene(width: int, height: int, device=None):
    """-> (Rasterizer on `device`, scene, assets) for the map at W x H."""
    from .ops.raster import Rasterizer

    assets = Assets.default()
    assets.textures["brick"] = Texture.checkerboard(32, 8)
    assets.textures["floor"] = Texture.checkerboard(32, 4)

    lines = [MAP_SOURCE_HEADER]
    for ry in range(5):
        for rx in range(5):
            ox, oy = rx * 10, ry * 10
            lines.append(f"move_to({ox}, {oy})")
            for _ in range(4):
                lines.append("wall(4)")
                lines.append("move_forward(2)")
                lines.append("wall(4)")
                lines.append("turn_right()")
            if (rx + ry) % 3 == 0:
                lines.append(f"move_to({ox + 5}, {oy + 5})")
                lines.append('add_point_light("#ffcc88", 2.0, 2.0, 8.0)')
    m = MapScript(assets).compile("\n".join(lines))

    scene = Scene.empty()
    D3Builder().build(m, assets, scene)
    spot = Light(LightType.Spot).with_position([25.0, 2.5, 25.0]).with_intensity(1.5)
    spot.end_distance = 12.0
    amb = Light(LightType.Ambient).with_position([25.0, 2.0, 25.0]).with_intensity(0.2)
    amb.end_distance = 100.0
    scene.lights = [spot.compile(), amb.compile()]

    camera = D3FirstPCamera()
    camera.set_parameter_vec3("position", [5.0, 1.6, 5.0])
    camera.set_parameter_vec3("center", [15.0, 1.4, 15.0])
    rast = Rasterizer.setup(
        None, camera.view_matrix(), camera.projection_matrix(width, height), device=device
    ).ambient([0.25, 0.25, 0.3, 1.0])
    return rast, scene, assets


def build_map_refl_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): the map plus a sun, GGX shading and
    one GGX reflection ray per pixel."""
    rast, scene, assets = build_map_scene(width, height, device=device)
    rast.sun_dir = np.array([0.4, -1.0, 0.25], np.float32)
    rast.sun_color = np.array([1.0, 1.0, 0.95], np.float32)
    rast.day_factor = 1.0
    rast.set_brdf("ggx").set_reflections(1)
    return rast, scene, assets

"""Scenes the port's checks render.

`build_map_scene` is the JAX package's bench north-star scene (bench.py
`build_map_scene`, the procedural map of benches/rasterize_map.rs): a 5x5
grid of 10-unit rooms with corridors, point lights in every third room, a
spot and an ambient light, seen from a first-person camera. It is built
here through the port's host layer because bench.py imports jax.

`build_map_refl_scene` is the bench's `map_1920x1080_ggx_refl1`
configuration (bench.py `build_map_refl_scene`): the map with a sun, the
GGX BRDF and one reflection ray per pixel. `build_map_ao_scene`,
`build_map_refl_half_scene` and `build_map_ssaa2_scene` are the bench's
`map_1920x1080_ao`, `map_1920x1080_ggx_refl1_half` and
`map_1920x1080_ssaa2` configurations. `build_sky_light_scene` is the
repo's own sky-light scene (a floor the sky can light; the map's walls all
face sideways).

`build_map_shadow_scene` is the bench's `map_1920x1080_shadow_fps`
configuration (bench.py `build_map_shadow_scene`): the map plus a point
light at (15, 2.5, 15), a sun and `set_shadows(True)` with its defaults
(cube maps of 128², a sun map of 256², at most 4 casting lights, bias
0.05). Its docstring says the map's spot light casts a cube map; with
those defaults it does not: the four casting lights are the brightest
point/spot rows, the map's point lights of intensity 2.0 (the first four
of eight), ahead of the spot (1.5) and the added point light (1.8).
`build_map_shadow_refl_scene` is the GGX-reflection map
(`build_map_refl_scene`) with `set_shadows(True)`: the reflection hits
look up the same maps.

`build_map_glass_scene` glazes the shadowed map's doorways: each 2-unit
doorway becomes a wall of a translucent "glass" texture, which D3Builder
routes into opacity batches (three 1-unit bands a doorway: 300 batches of
600 triangles, beside 625 opaque batches), under the render graph's sky
and fog at hour 14, with two depth-peeled transparency layers, the
SceneVM tonemap and shadow maps whose transmittance layers the glass
fills (max_shadow_steps 16 -> 4 peeled layers per map). It is the
reference's game look on a map with windows (the JAX package's
`examples/map.py` sets the same sky graph). `build_map_glass_refl_scene`
adds the GGX BRDF and one reflection ray per pixel, on the opaque frame
and on both transparency layers.
"""

from __future__ import annotations

import numpy as np

from .builders import D3Builder, MapScript
from .models import (
    Assets,
    Batch3D,
    D3FirstPCamera,
    D3OrbitCamera,
    Light,
    LightType,
    PixelSource,
    Scene,
    Texture,
)

MAP_SOURCE_HEADER = """
set_default("wall_tex", "brick")
set_default("floor_tex", "floor")
set_default("ceiling_tex", "floor")
set_default("wall_height", 3.0)
"""


def build_map_scene(width: int, height: int, device=None, glazed: bool = False):
    """-> (Rasterizer on `device`, scene, assets) for the map at W x H.
    `glazed` closes each doorway with a wall of the translucent "glass"
    texture (RGBA 120, 180, 220, 110) instead of leaving it open."""
    from .ops.raster import Rasterizer

    assets = Assets.default()
    assets.textures["brick"] = Texture.checkerboard(32, 8)
    assets.textures["floor"] = Texture.checkerboard(32, 4)
    if glazed:
        assets.textures["glass"] = Texture.from_color((120, 180, 220, 110))
    doorway = ['wall(2)', 'set("wall_tex", "glass")'] if glazed else ["move_forward(2)"]

    lines = [MAP_SOURCE_HEADER]
    for ry in range(5):
        for rx in range(5):
            ox, oy = rx * 10, ry * 10
            lines.append(f"move_to({ox}, {oy})")
            for _ in range(4):
                lines.append("wall(4)")
                lines.extend(doorway)
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


def build_map_ao_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): the map with screen-space ambient
    occlusion, 8 samples within 0.6 world units (bench.py:659-664)."""
    rast, scene, assets = build_map_scene(width, height, device=device)
    rast.set_ambient_occlusion(True, samples=8, radius=0.6)
    return rast, scene, assets


def build_map_refl_half_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): the GGX-reflection map with its
    reflections traced at half resolution in each axis and upsampled
    (bench.py:676-678, `set_reflections(1, scale=2)`)."""
    rast, scene, assets = build_map_refl_scene(width, height, device=device)
    rast.set_reflections(1, scale=2)
    return rast, scene, assets


def build_map_ssaa2_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): the map with 2x2 supersampling, the
    frame rendered at (2H, 2W) and box-filtered down (bench.py:686-688)."""
    rast, scene, assets = build_map_scene(width, height, device=device)
    rast.set_supersample(2)
    return rast, scene, assets


def build_sky_light_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): a grey floor slab, a brown wall and a
    point light under a blue sky, seen by an orbit camera at elevation 0.35
    and distance 8 (tests/test_reflect.py:252-276), with the sky light on
    and the bench's AO (8 samples within 0.6 world units). Mirror rays of
    the floor near the camera reach the sky; those next to the wall hit
    it."""
    from .ops.raster import Rasterizer

    floor = (
        Batch3D.from_box(-6, -1.2, -4, 12, 0.2, 8)
        .set_source(PixelSource.pixel((120, 120, 120, 255)))
        .with_computed_normals()
    )
    wall = (
        Batch3D.from_box(-6, -1.0, -4, 0.3, 5.0, 8)
        .set_source(PixelSource.pixel((90, 60, 40, 255)))
        .with_computed_normals()
    )
    scene = Scene.from_static([], [floor, wall]).set_lights(
        [Light(LightType.Point).with_position([2, 3, 2]).with_intensity(1.0).compile()]
    )
    cam = D3OrbitCamera()
    cam.azimuth = 0.0
    cam.elevation = 0.35
    cam.set_parameter_f32("distance", 8.0)
    rast = Rasterizer.setup(
        None, cam.view_matrix(), cam.projection_matrix(width, height), device=device
    ).ambient((0.2, 0.2, 0.2, 1.0))
    rast.background((60, 110, 220, 255))
    rast.set_sky_light(True).set_ambient_occlusion(True, samples=8, radius=0.6)
    return rast, scene, Assets.default()


def build_map_shadow_scene(width: int, height: int, device=None, glazed: bool = False):
    """-> (Rasterizer, scene, assets): the map plus a point light at (15,
    2.5, 15) of intensity 1.8 reaching 14 units, a sun and shadow maps with
    set_shadows' defaults (bench.py:443-460). `glazed` as for
    build_map_scene."""
    rast, scene, assets = build_map_scene(width, height, device=device, glazed=glazed)
    point = Light(LightType.Point).with_position([15.0, 2.5, 15.0]).with_intensity(1.8)
    point.end_distance = 14.0
    scene.lights.append(point.compile())
    rast.sun_dir = np.array([0.4, -1.0, 0.25], np.float32)
    rast.sun_color = np.array([1.0, 1.0, 0.95], np.float32)
    rast.day_factor = 1.0
    rast.set_shadows(True)
    return rast, scene, assets


def build_map_shadow_refl_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): the GGX-reflection map (sun, GGX,
    one reflection ray per pixel) with shadow maps at set_shadows'
    defaults; B1 and the reflection hits read the same maps."""
    rast, scene, assets = build_map_refl_scene(width, height, device=device)
    rast.set_shadows(True)
    return rast, scene, assets


def build_map_glass_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): the shadowed map (bench.py:443-460)
    with glazed doorways, the render graph's sky and fog at hour 14, two
    transparency layers, the SceneVM tonemap and shadow maps at
    set_shadows' defaults with transmittance (the default
    max_shadow_steps, 16, keeps 4 layers per map)."""
    from .shapefx import ShapeFXGraph

    rast, scene, assets = build_map_shadow_scene(width, height, device=device, glazed=True)
    rast.render_graph = ShapeFXGraph.default_render_graph(with_sky=True, with_fog=True)
    rast.hour = 14.0
    rast.transparency_layers = 2
    rast.set_tonemap("scenevm")
    return rast, scene, assets


def build_map_glass_refl_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): build_map_glass_scene with the GGX
    BRDF and one GGX reflection ray per pixel, on the opaque frame and on
    both transparency layers."""
    rast, scene, assets = build_map_glass_scene(width, height, device=device)
    rast.set_brdf("ggx").set_reflections(1)
    return rast, scene, assets

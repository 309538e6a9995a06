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

`build_map_blend_scene` paints the map's floors as an Eldiron map does:
each 2-unit doorway is closed by a linedef of wall height 0 (no wall is
built for it, and no 2D light is blocked by it), so each room is a sector;
its floor is a sector surface whose `blend_tiles` paint every 1-unit cell
with one of the 18 non-Solid VertexBlendPresets in turn, toward a second,
green checkerboard. The sector's texture moves to `cap_source`, which only
the surface builder reads, so no plain floor lies under the blended one.
`build_map_blend_refl_scene` adds a sun, the GGX BRDF and one reflection
ray per pixel. `build_cube_scene` is the bench's `cube_800x600` (bench.py
`build_cube_scene`, the reference's benches/rasterize_cube.rs): a box with
a checkerboard tile under an orbit camera over the gray gradient
background, and a 200x200 2D rectangle. `build_map_2d_scene` is the
editor's 2D map view (the reference's Client::draw_d2) of the blended
map: D2Builder's sector floors and 0.1-unit wall strips, a 2D projection
that fits the 50x50-unit map to the frame, the map's 8 point lights and an
ambient light lighting it in 2D, the map's walls (MapMini) blocking the
lights, and the 3D pass off. The 2D pass covers a pixel only where all
three edge functions are >= 0, one winding; earcut's floor triangles
(reversed by D2Builder) have the other under this y-down projection, so
the floors take their steps but draw no pixel, in the JAX package as in
the port: the frame shows the lit wall strips.

`build_feature_scene` is the JAX package's multichip feature scene (its
tests/test_multichip.py): every feature of its sharded feature frame on a
floor, a wall, a blocker and a glass pane.

`build_minigame` is the engine loop's world (the JAX package's
tests/test_minigame.py `build_engine`, the reference's
examples/minigame.rs): a 15-unit walled room with a point light, a player
and a wandering monster (a billboard), scripted in rusteria, through the
`Rusterix` facade on the device the caller names. `build_tracer_scene` is
the bench's path-tracer scene (bench.py `measure_tracer`): a floor slab,
a red box and an emissive pillar under a point light, with its orbit
camera.
"""

from __future__ import annotations

import numpy as np

from .builders import D2Builder, D3Builder, MapScript
from .map import Surface
from .models import (
    Assets,
    Batch2D,
    Batch3D,
    CullMode,
    D3FirstPCamera,
    D3OrbitCamera,
    Light,
    LightType,
    PixelSource,
    RenderMode,
    Scene,
    Texture,
    Tile,
    VertexBlendPreset,
    VGrayGradientShader,
)
from .ops.matrices import mat3_translation_scale

MAP_SOURCE_HEADER = """
set_default("wall_tex", "brick")
set_default("floor_tex", "floor")
set_default("ceiling_tex", "floor")
set_default("wall_height", 3.0)
"""


def _map_source(doorway, rooms_x: int = 5, rooms_y: int = 5) -> str:
    """The map's MapScript: a grid of 10-unit rooms (5 x 5 in the bench)
    whose sides are wall(4), the `doorway` commands and wall(4), with a
    point light in every third room."""
    lines = [MAP_SOURCE_HEADER]
    for ry in range(rooms_y):
        for rx in range(rooms_x):
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
    return "\n".join(lines)


def _map_assets(glazed: bool = False, blended: bool = False) -> Assets:
    assets = Assets.default()
    assets.textures["brick"] = Texture.checkerboard(32, 8)
    assets.textures["floor"] = Texture.checkerboard(32, 4)
    if glazed:
        assets.textures["glass"] = Texture.from_color((120, 180, 220, 110))
    if blended:
        moss = Texture.checkerboard(32, 4)
        white = moss.data[..., 0] > 0
        moss.data[..., :3] = np.where(white[..., None], np.array([70, 140, 60], np.uint8),
                                      np.array([30, 70, 40], np.uint8))
        assets.textures["moss"] = moss
    return assets


def _map_lights_and_camera(scene, width: int, height: int, device):
    """The map's spot and ambient lights, and the first-person camera."""
    from .ops.raster import Rasterizer

    spot = Light(LightType.Spot).with_position([25.0, 2.5, 25.0]).with_intensity(1.5)
    spot.end_distance = 12.0
    amb = Light(LightType.Ambient).with_position([25.0, 2.0, 25.0]).with_intensity(0.2)
    amb.end_distance = 100.0
    scene.lights = [spot.compile(), amb.compile()]

    camera = D3FirstPCamera()
    camera.set_parameter_vec3("position", [5.0, 1.6, 5.0])
    camera.set_parameter_vec3("center", [15.0, 1.4, 15.0])
    return Rasterizer.setup(
        None, camera.view_matrix(), camera.projection_matrix(width, height), device=device
    ).ambient([0.25, 0.25, 0.3, 1.0])


def build_map_scene(width: int, height: int, device=None, glazed: bool = False):
    """-> (Rasterizer on `device`, scene, assets) for the map at W x H.
    `glazed` closes each doorway with a wall of the translucent "glass"
    texture (RGBA 120, 180, 220, 110) instead of leaving it open."""
    assets = _map_assets(glazed=glazed)
    doorway = ['wall(2)', 'set("wall_tex", "glass")'] if glazed else ["move_forward(2)"]
    m = MapScript(assets).compile(_map_source(doorway))
    scene = Scene.empty()
    D3Builder().build(m, assets, scene)
    return _map_lights_and_camera(scene, width, height, device), scene, assets


def blend_map(assets, rooms_x: int = 5, rooms_y: int = 5, surfaces: bool = True):
    """The map with closed doorways (linedefs of wall height 0) -> Map; with
    `surfaces`, each room's floor becomes a sector surface whose 1-unit
    cells blend, each with the next non-Solid VertexBlendPreset in turn,
    toward the "moss" texture, and its texture moves to `cap_source`.
    rooms_x x rooms_y rooms (the bench's 5 x 5; fewer for small checks)."""
    script = MapScript(assets)
    m = script.compile(_map_source(['wall(2)', 'set("wall_height", 0.0)'], rooms_x, rooms_y))
    # each room closes a loop of its own 12 linedefs, in creation order; the
    # rooms share wall vertices, and MapScript's loop search closes every
    # room after the first of a row around the union with its neighbour, so
    # each sector gets its own room's linedefs back (no floor overlaps
    # another)
    rooms = rooms_x * rooms_y
    if len(m.sectors) != rooms or len(m.linedefs) != 12 * rooms:
        raise ValueError(f"expected {rooms} sectors of 12 linedefs, got {len(m.sectors)} "
                         f"sectors and {len(m.linedefs)} linedefs")
    for r, sector in enumerate(m.sectors):
        sector.linedefs = [ld.id for ld in m.linedefs[12 * r:12 * r + 12]]
    if not surfaces:
        return m
    moss = PixelSource.tile_id(script._get_texture("moss"))
    presets = [p for p in VertexBlendPreset if p != VertexBlendPreset.Solid]
    n = 0
    for sector in m.sectors:
        sector.properties.set("cap_source", sector.properties.get_source("source"))
        sector.properties.remove("source")
        surface = Surface(sector_id=sector.id)
        surface.calculate_geometry(m)
        m.surfaces[surface.id] = surface
        bb = sector.bounding_box(m)
        corners = np.array([surface.world_to_uv([x, 0.0, y])
                            for x in (bb.x, bb.x + bb.width) for y in (bb.y, bb.y + bb.height)])
        lo = np.floor(corners.min(axis=0) + 1e-4).astype(int)
        hi = np.ceil(corners.max(axis=0) - 1e-4).astype(int)
        cells = {}
        for cy in range(lo[1], hi[1]):
            for cx in range(lo[0], hi[0]):
                cells[(cx, cy)] = (presets[n % len(presets)], moss)
                n += 1
        sector.properties.set("blend_tiles", cells)
    return m


def build_map_blend_scene(width: int, height: int, device=None, rooms_x: int = 5,
                          rooms_y: int = 5):
    """-> (Rasterizer, scene, assets): the map with closed doorways and
    vertex-blended floors (module docstring), its lights and camera; rooms
    as for blend_map."""
    assets = _map_assets(blended=True)
    scene = Scene.empty()
    D3Builder().build(blend_map(assets, rooms_x, rooms_y), assets, scene)
    return _map_lights_and_camera(scene, width, height, device), scene, assets


def build_map_blend_refl_scene(width: int, height: int, device=None, rooms_x: int = 5,
                               rooms_y: int = 5):
    """-> (Rasterizer, scene, assets): the blended map with a sun, GGX
    shading and one GGX reflection ray per pixel (B's settings)."""
    rast, scene, assets = build_map_blend_scene(width, height, device, rooms_x, rooms_y)
    rast.sun_dir = np.array([0.4, -1.0, 0.25], np.float32)
    rast.sun_color = np.array([1.0, 1.0, 0.95], np.float32)
    rast.day_factor = 1.0
    rast.set_brdf("ggx").set_reflections(1)
    return rast, scene, assets


def build_cube_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): the bench's cube (bench.py:23-51): a
    unit box with a 128x128 checkerboard tile (squares of 16), culling off,
    under the default orbit camera, over the gray gradient background, and
    a 200x200 2D rectangle with the default source."""
    from .ops.raster import Rasterizer

    scene = Scene.from_static(
        [Batch2D.from_rectangle(0.0, 0.0, 200.0, 200.0)],
        [
            Batch3D.from_box(-0.5, -0.5, -0.5, 1.0, 1.0, 1.0)
            .set_cull_mode(CullMode.Off)
            .set_source(PixelSource.static_tile_index(0))
        ],
    ).set_background(VGrayGradientShader())
    assets = Assets.default().with_textures([Tile.from_texture(Texture.checkerboard(128, 16))])
    camera = D3OrbitCamera()
    rast = Rasterizer.setup(None, camera.view_matrix(), camera.projection_matrix(width, height),
                            device=device)
    return rast, scene, assets


def build_map_2d_scene(width: int, height: int, device=None, rooms_x: int = 5,
                       rooms_y: int = 5):
    """-> (Rasterizer, scene, assets): the 2D map view of the blended map's
    geometry (module docstring); rooms as for blend_map."""
    from .ops.raster import Rasterizer

    assets = _map_assets(blended=True)
    m = blend_map(assets, rooms_x, rooms_y, surfaces=False)
    scene = Scene.empty()
    D2Builder().build(m, assets, scene)
    amb = Light(LightType.Ambient).with_position([25.0, 2.0, 25.0]).with_intensity(0.2)
    amb.end_distance = 100.0
    scene.lights = [light.compile() for light in m.lights] + [amb.compile()]
    scene.mapmini = m.as_mini()
    ex, ey = 10.0 * rooms_x, 10.0 * rooms_y
    scale = min(width / ex, height / ey)
    proj2d = mat3_translation_scale((width - ex * scale) / 2.0, (height - ey * scale) / 2.0,
                                    scale)
    eye = np.eye(4, dtype=np.float32)
    rast = Rasterizer.setup(proj2d, eye, eye, device=device).ambient([0.25, 0.25, 0.3, 1.0])
    rast.set_render_mode(RenderMode.render_2d())
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


def build_feature_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): the JAX package's multichip feature
    scene (tests/test_multichip.py: a floor, a wall and a blocker under a
    point light and the sun; shadow maps with transmittance through a pane,
    AO, GGX, one reflection ray a pixel with shadowed hits, sky light,
    exp^2 fog and depth-peeled layers), with the pane as a static opacity
    batch of a chunk."""
    from .builders.chunk import Chunk
    from .models.render_settings import RenderSettings
    from .ops.raster import Rasterizer

    floor = (Batch3D.from_box(-3, -1.3, -3, 6, 0.2, 6)
             .set_source(PixelSource.pixel((60, 60, 70, 255))).with_computed_normals())
    wall = (Batch3D.from_box(-2.5, -1.1, -2.7, 5.0, 2.8, 0.2)
            .set_source(PixelSource.pixel((220, 220, 220, 255))).with_computed_normals())
    blocker = (Batch3D.from_box(-0.6, -0.8, -1.3, 1.2, 1.4, 0.2)
               .set_source(PixelSource.pixel((90, 60, 60, 255))).with_computed_normals())
    scene = Scene.from_static([], [floor, wall, blocker])
    pane_v = np.array([[0.8, -1.0, -0.5, 1], [1.6, -1.0, -0.5, 1],
                       [1.6, 0.6, -0.5, 1], [0.8, 0.6, -0.5, 1]], np.float32)
    pane_t = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    pane_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    chunk = Chunk()
    chunk.batches3d_opacity = [Batch3D.new(pane_v, pane_t, pane_uv).set_cull_mode(CullMode.Off)
                               .set_source(PixelSource.pixel((120, 180, 220, 140)))]
    scene.chunks[(0, 0)] = chunk
    scene.set_lights([Light(LightType.Point).with_position([0.0, 0.6, 1.8])
                      .with_intensity(1.8).with_range(0.5, 30.0).compile()])
    cam = D3OrbitCamera()
    cam.azimuth = 0.4
    cam.set_parameter_f32("distance", 5.0)
    rast = Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(width, height),
                            device=device)
    rast.ambient((0.2, 0.2, 0.25, 1.0)).background((70, 90, 120, 255))
    rast.sun_dir = np.array([0.3, -1.0, 0.2], np.float32)
    rast.day_factor = 0.7
    rast.set_brdf("ggx")
    rast.set_shadows(True, res=64, sun_res=64)
    rast.set_sky_light(True)
    rast.set_ambient_occlusion(True)
    rs = RenderSettings()
    rs.fog_density = 0.05
    rs.ao_samples = 4.0
    rs.ao_radius = 0.6
    rs.reflection_samples = 1.0
    rast.apply_render_settings(rs)
    rast.set_reflections(1)
    return rast, scene, Assets.default()


#: the bench's wood shader (bench.py WOOD_SHADER, the reference's
#: examples/cube_shaded.rs): it reads `time` only as time * 0.0, so it bakes
#: to one frame, with the constant roughness 0.6 as the batch's material
WOOD_SHADER = """
fn shade() {
    let t = time * 0.0;
    let uv2 = uv / 3.0 - vec2(1.5);
    let n1 = sample(uv2 + vec2(t, 0.0), "fbm_perlin");
    let n2 = sample(uv2 * 2.0 + vec2(0.0, t*0.7), "fbm_perlin");
    let turb = 0.65 * n1 + 0.35 * n2;
    let rings = length(uv2) + 0.22 * (turb - 0.5) * 2.0;
    let rings_mask = pow(1.0 - abs(sin(rings * 10.0)), 3.0);
    color = mix(vec3(0.72, 0.52, 0.32), vec3(0.45, 0.30, 0.16), rings_mask);
    roughness = 0.6;
}
"""

#: the bench's time-dependent shader (bench.py build_cube_timeshader_scene):
#: 16 animation frames, a quarter of a second of shader time apart
TIME_SHADER = """
fn shade() {
    let t = fract(time / 4.0);
    let uv2 = uv / 3.0 - vec2(1.5);
    let waves = sin((length(uv2) + t) * 10.0);
    let mask = pow(1.0 - abs(waves), 3.0);
    color = mix(vec3(0.72, 0.52, 0.32), vec3(0.45, 0.30, 0.16), mask);
    roughness = 0.6;
}
"""

#: per-pixel material shaders (tests/test_matmap.py): emissive stripes with
#: roughness and metallic varying over uv, and a written normal
EMISSIVE_VARYING = """
fn shade() {
    color = vec3(0.3, 0.3, 0.35);
    emissive = vec3(step(0.5, fract(uv.x * 2.0)) * 0.8, 0.0, 0.1);
    roughness = fract(uv.y * 3.0);
    metallic = step(0.5, fract(uv.y));
}
"""

NORMAL_WRITER = """
fn shade() {
    color = vec3(0.6, 0.5, 0.4);
    normal = vec3(sin(uv.x * 6.28318), 0.6, cos(uv.x * 6.28318));
}
"""


def build_cube_shaded_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): the bench's cube_shaded (bench.py
    build_cube_shaded_scene, the reference's examples/cube_shaded.rs): a
    unit box under the wood shader (WOOD_SHADER), a point light at (2, 0.8,
    1), the gray gradient background, the orbit camera at distance 1.5 and
    ambient 0.1. The shader bakes to an atlas tile at pack time, on the
    rasterizer's device."""
    from .ops.raster import Rasterizer

    scene = Scene.from_static(
        [],
        [
            Batch3D.from_box(-0.5, -0.5, -0.5, 1.0, 1.0, 1.0)
            .set_cull_mode(CullMode.Off)
            .with_computed_normals()
            .set_shader(0)
        ],
    ).set_background(VGrayGradientShader()).set_lights(
        [Light(LightType.Point).with_position([2.0, 0.8, 1.0]).with_intensity(1.0).compile()]
    )
    scene.add_shader(WOOD_SHADER)
    camera = D3OrbitCamera()
    camera.set_parameter_f32("distance", 1.5)
    rast = Rasterizer.setup(None, camera.view_matrix(), camera.projection_matrix(width, height),
                            device=device).ambient([0.1, 0.1, 0.1, 1.0])
    return rast, scene, Assets.default()


def build_cube_timeshader_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): build_cube_shaded_scene under the
    time-dependent TIME_SHADER (bench.py build_cube_timeshader_scene), which
    bakes to SHADER_ANIM_FRAMES animation frames; scene.animation_frame
    picks the frame."""
    rast, scene, assets = build_cube_shaded_scene(width, height, device=device)
    scene.shaders.clear()
    scene.shaders_with_opacity.clear()
    scene.add_shader(TIME_SHADER)
    scene.touch()
    return rast, scene, assets


def build_map_material_scene(width: int, height: int, device=None, rooms_x: int = 5,
                             rooms_y: int = 5):
    """-> (Rasterizer, scene, assets): the map (bench.py:389-440; rooms_x x
    rooms_y rooms, 5 x 5 in the bench) under per-pixel materials, with the
    sun, the GGX BRDF and one reflection ray per pixel of
    build_map_refl_scene. Every wall batch takes EMISSIVE_VARYING. The map
    has no floor batches (its open doorways leave MapScript no closed
    sector), so each room gets a 10 x 10 floor quad at height 0, its uv the
    world position in units, under NORMAL_WRITER. Both shaders bake to
    material sidecar tiles (B1's has_matmap); the bump strength keeps its
    default (1: the written normal replaces the geometric one)."""
    from .ops.raster import Rasterizer

    assets = _map_assets()
    m = MapScript(assets).compile(_map_source(["move_forward(2)"], rooms_x, rooms_y))
    scene = Scene.empty()
    D3Builder().build(m, assets, scene)
    for b in scene.all_d3_batches(include_dynamic=False):
        b.set_shader(0)
    for ry in range(rooms_y):
        for rx in range(rooms_x):
            x0, z0 = 10.0 * rx, 10.0 * ry
            corners = [(x0, z0), (x0 + 10.0, z0), (x0 + 10.0, z0 + 10.0), (x0, z0 + 10.0)]
            floor = Batch3D.new(
                [(x, 0.0, z, 1.0) for x, z in corners], [(0, 1, 2), (0, 2, 3)],
                [(x, z) for x, z in corners],
            ).set_cull_mode(CullMode.Off).with_computed_normals().set_shader(1)
            scene.d3_static.append(floor)
    scene.add_shader(EMISSIVE_VARYING)
    scene.add_shader(NORMAL_WRITER)
    scene.touch()
    rast = _map_lights_and_camera(scene, width, height, device)
    rast.sun_dir = np.array([0.4, -1.0, 0.25], np.float32)
    rast.sun_color = np.array([1.0, 1.0, 0.95], np.float32)
    rast.day_factor = 1.0
    rast.set_brdf("ggx").set_reflections(1)
    return rast, scene, assets


#: a runtime floor shader: a checker of 2-unit world cells over the hit
#: point, times the texel's colour. It reads `color` and `hitpoint`, so it
#: cannot bake; only exact operations (fract, step, products), so the card
#: and the CPU evaluate it alike
FLOOR_CHECKER = """
fn shade() {
    let cx = step(0.5, fract(hitpoint.x * 0.25));
    let cz = step(0.5, fract(hitpoint.z * 0.25));
    let c = abs(cx - cz);
    color = color * vec3(0.55 + 0.45 * c, 0.6 + 0.3 * c, 0.7);
    roughness = 0.35 + 0.3 * c;
}
"""

#: a runtime glass shader: the pane's colour tinted by a band of its
#: height, its opacity scaled (reads `color`, `opacity` and `hitpoint`)
GLASS_TINT = """
fn shade() {
    let band = step(0.5, fract(hitpoint.y * 1.5));
    color = color * vec3(1.0, 0.7 + 0.3 * band, 0.9);
    opacity = opacity * (0.6 + 0.3 * band);
}
"""

#: a runtime 2D shader: 20-pixel bands of two colours over the grid-space
#: position, plus half the texel's colour
RECT_BANDS = """
fn shade() {
    let band = step(0.5, fract(hitpoint.x * 0.025));
    color = mix(vec3(0.9, 0.5, 0.2), vec3(0.2, 0.4, 0.9), band) + color * 0.5;
}
"""


def build_map_runtime_shader_scene(width: int, height: int, device=None, rooms_x: int = 5,
                                   rooms_y: int = 5):
    """-> (Rasterizer, scene, assets): the map (build_map_scene; rooms_x x
    rooms_y rooms, 5 x 5 in the bench) with a floor in every room under a
    runtime shader. The map has no floor batches (its open doorways leave
    MapScript no closed sector), so each room gets a 10 x 10 floor quad at
    height 0 with the "floor" checkerboard, its uv the world position in
    units, under FLOOR_CHECKER, which reads its inputs (the texel's colour
    and the hit point) and so runs at every frame: the split path (B2 on
    the Morton order, then shade_pass)."""
    assets = _map_assets()
    script = MapScript(assets)
    m = script.compile(_map_source(["move_forward(2)"], rooms_x, rooms_y))
    scene = Scene.empty()
    D3Builder().build(m, assets, scene)
    floor_src = PixelSource.tile_id(script._get_texture("floor"))
    for ry in range(rooms_y):
        for rx in range(rooms_x):
            x0, z0 = 10.0 * rx, 10.0 * ry
            corners = [(x0, z0), (x0 + 10.0, z0), (x0 + 10.0, z0 + 10.0), (x0, z0 + 10.0)]
            floor = Batch3D.new(
                [(x, 0.0, z, 1.0) for x, z in corners], [(0, 1, 2), (0, 2, 3)],
                [(x, z) for x, z in corners],
            ).set_cull_mode(CullMode.Off).set_source(floor_src).with_computed_normals()
            scene.d3_static.append(floor.set_shader(0))
    scene.add_shader(FLOOR_CHECKER)
    scene.touch()
    return _map_lights_and_camera(scene, width, height, device), scene, assets


def build_map_runtime_shader_refl_scene(width: int, height: int, device=None,
                                        rooms_x: int = 5, rooms_y: int = 5):
    """-> (Rasterizer, scene, assets): build_map_runtime_shader_scene with
    the shadowed reflection map's settings (build_map_shadow_refl_scene: a
    sun, the GGX BRDF, one reflection ray per pixel, shadow maps at
    set_shadows' defaults) plus the bench's AO (8 samples within 0.6
    world units) and the sky light."""
    rast, scene, assets = build_map_runtime_shader_scene(width, height, device, rooms_x,
                                                         rooms_y)
    rast.sun_dir = np.array([0.4, -1.0, 0.25], np.float32)
    rast.sun_color = np.array([1.0, 1.0, 0.95], np.float32)
    rast.day_factor = 1.0
    rast.set_brdf("ggx").set_reflections(1).set_shadows(True)
    rast.set_ambient_occlusion(True, samples=8, radius=0.6).set_sky_light(True)
    return rast, scene, assets


def build_map_glass_shader_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): the glazed map (build_map_glass_scene)
    with every glass batch under the runtime shader GLASS_TINT, which
    shades each depth-peeled layer's panes."""
    rast, scene, assets = build_map_glass_scene(width, height, device=device)
    for b in scene.all_d3_opacity_batches(include_dynamic=False):
        b.set_shader(0)
    scene.add_shader(GLASS_TINT)
    scene.touch()
    return rast, scene, assets


def build_cube_2d_shader_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): the bench's cube (build_cube_scene)
    with its 2D rectangle under the runtime 2D shader RECT_BANDS (a 2D
    batch's shader never bakes)."""
    rast, scene, assets = build_cube_scene(width, height, device=device)
    scene.d2_static[0].set_shader(0)
    scene.add_shader(RECT_BANDS)
    scene.touch()
    return rast, scene, assets


def _billboard(x: float, z: float, opacity: bool = False) -> Batch3D:
    """A 1 x 2-unit upright quad facing +z at (x, z): an entity billboard
    (a translucent one for the opacity list)."""
    color = (90, 170, 230, 150) if opacity else (210, 90, 60, 255)
    corners = [(x - 0.5, 0.0), (x + 0.5, 0.0), (x + 0.5, 2.0), (x - 0.5, 2.0)]
    return Batch3D.new(
        [(cx, cy, z, 1.0) for cx, cy in corners], [(0, 1, 2), (0, 2, 3)],
        [(0.0, 1.0), (1.0, 1.0), (1.0, 0.0), (0.0, 0.0)],
    ).set_cull_mode(CullMode.Off).set_source(PixelSource.pixel(color)).with_computed_normals()


def move_dynamic(scene, t: float):
    """Place build_map_dynamic_scene's dynamic batches for frame time `t`:
    the two billboards walk along x in the camera's room and the 2D
    rectangle slides right."""
    scene.d3_dynamic[:] = [_billboard(8.0 + 1.5 * t, 9.0)]
    scene.d3_dynamic_opacity[:] = [_billboard(9.5 - 1.2 * t, 7.5, opacity=True)]
    scene.d2_dynamic[:] = [Batch2D.from_rectangle(20.0 + 40.0 * t, 20.0, 160.0, 90.0)
                           .set_source(PixelSource.pixel((240, 200, 60, 160)))]
    scene.touch_dynamic()


def build_map_dynamic_scene(width: int, height: int, device=None):
    """-> (Rasterizer, scene, assets): the bench's shadowed map
    (build_map_shadow_scene) with dynamic batches, as a game frame has
    them: an opaque billboard and a translucent one (Scene.d3_dynamic and
    d3_dynamic_opacity) and a 2D rectangle (d2_dynamic), placed by
    move_dynamic(scene, t); shadows keep `dynamic_casters` on, so the
    billboards cast into the cached maps every frame."""
    rast, scene, assets = build_map_shadow_scene(width, height, device=device)
    move_dynamic(scene, 0.0)
    return rast, scene, assets


# the minigame world: the JAX package's tests/test_minigame.py sources
MINIGAME_WORLD_RXM = """
set("sky_tex", "sky")
set_default("wall_tex", "brickwall")
set_default("floor_tex", "brickfloor")
set_default("wall_height", 2.0)

box_size = 15

wall(box_size)
turn_right()
wall(box_size)
turn_right()
wall(box_size)
add_point_light("#ffffbb", 2.0, 2.0, 13.0)
turn_right()
wall(box_size)

move_to(10, 10.5)
add_entity("Orc", "Monster", "brickwall")

move_to(6, 4.5)
add_entity("Shabby", "Player", "brickwall")
"""

MINIGAME_PLAYER_RXE = """
fn event(name, value) {
    if name == "startup" {
        set_attr("health", 10);
    }
}

fn user_event(name, value) {
    match name {
        "key_down" {
            if value == "w" { action("forward"); }
            if value == "a" { action("left"); }
            if value == "d" { action("right"); }
            if value == "s" { action("backward"); }
        }
        "key_up" { action("none"); }
        _ { }
    }
}
"""

MINIGAME_PLAYER_TOML = "[attributes]\nplayer = true\n"

MINIGAME_MONSTER_RXE = """
fn event(name, value) {
    if name == "startup" {
        random_walk(2.0, 1.0, 1.0);
    }
}
"""

MINIGAME_CONFIG_TOML = """
[viewport]
width = 160
height = 120

[game]
target_fps = 30
game_tick_ms = 250
start_region = "world"
auto_create_player = true
player_class = "Player"
"""


def build_minigame(device=None):
    """-> Rusterix: the minigame world booted (regions created, the server
    started, the player registered), its frames and traces on `device`.
    The caller stops it with `rx.server.stop()`. The monster walks by
    Python's global `random`: seed it first for a repeatable run."""
    from .rusterix import Rusterix

    rx = Rusterix(device=device)
    rx.assets.textures["brickwall"] = Texture.checkerboard(16, 4)
    rx.assets.textures["brickfloor"] = Texture.checkerboard(16, 8)
    rx.assets.textures["sky"] = Texture.from_color((60, 60, 120, 255))
    rx.assets.map_sources["world"] = MINIGAME_WORLD_RXM
    rx.assets.entities = {
        "Player": (MINIGAME_PLAYER_RXE, MINIGAME_PLAYER_TOML),
        "Monster": (MINIGAME_MONSTER_RXE, ""),
    }
    rx.assets.config = MINIGAME_CONFIG_TOML
    rx.create_regions()
    rx.setup_client()
    return rx


def minigame_tick(rx) -> None:
    """One engine tick of the minigame loop (bench.py's minigame cell):
    the server tick, the entity mirror and the billboard rebuild."""
    world = rx.assets.maps["world"]
    rx.update_server()
    rx.apply_entities_items(world)
    rx.build_entities_items_d3(world)


def build_tracer_scene():
    """-> (scene, camera, assets): the bench's path-tracer scene (bench.py
    measure_tracer): a 4x4 floor slab, a red box and an emissive pillar
    (Emissive, value 0.4) under a point light of intensity 0.4; an orbit
    camera at azimuth 0.8, elevation 0.5, distance 4."""
    from .models import Material, MaterialModifier, MaterialRole

    scene = Scene.from_static(
        [],
        [
            Batch3D.from_box(-2.0, -0.6, -2.0, 4.0, 0.1, 4.0)
            .set_source(PixelSource.pixel((200, 200, 200, 255)))
            .with_computed_normals(),
            Batch3D.from_box(-0.4, -0.5, -0.4, 0.8, 0.8, 0.8)
            .set_source(PixelSource.pixel((220, 90, 60, 255)))
            .with_computed_normals(),
            Batch3D.from_box(0.8, -0.5, -0.8, 0.4, 1.4, 0.4)
            .set_source(PixelSource.pixel((255, 240, 200, 255)))
            .set_material(Material(MaterialRole.Emissive, MaterialModifier.Nothing, 0.4, 0.0))
            .with_computed_normals(),
        ],
    ).set_lights(
        [Light(LightType.Point).with_position([1.5, 2.0, 1.5]).with_intensity(0.4).compile()]
    )
    camera = D3OrbitCamera()
    camera.azimuth = 0.8
    camera.elevation = 0.5
    camera.set_parameter_f32("distance", 4.0)
    return scene, camera, Assets.default()


def build_huge_scene(n_boxes: int = 10600, seed: int = 3):
    """-> (scene, camera, assets): `n_boxes` random boxes (12 triangles
    each) over a 200x200 field in three pixel-source batches under a point
    light, the JAX package's tools/bench_huge.py scene (10,600 boxes:
    127,200 triangles, 131,072 slots after the pack's power-of-two padding,
    so 2,048 B3 cells)."""
    rng = np.random.default_rng(seed)
    batches = []
    # one batch of many boxes keeps the host pack fast; colors per box ride
    # a handful of pixel sources
    colors = [(200, 140, 90, 255), (90, 160, 200, 255), (140, 200, 120, 255)]
    per = n_boxes // len(colors)
    for col in colors:
        verts, tris, uvs = [], [], []
        for _b in range(per):
            x, z = rng.uniform(-100, 100, 2)
            y = 0.0
            w, h, d = rng.uniform(0.5, 3.0, 3)
            base = len(verts)
            bx = Batch3D.from_box(x, y, z, w, h, d)
            verts.extend(bx.vertices.tolist())
            tris.extend((bx.indices + base).tolist())
            uvs.extend(bx.uvs.tolist())
        batch = Batch3D.new(
            np.asarray(verts, np.float32),
            np.asarray(tris, np.int32),
            np.asarray(uvs, np.float32),
        ).set_source(PixelSource.pixel(col))
        batches.append(batch.with_computed_normals())

    scene = Scene.from_static([], batches)
    scene.set_lights(
        [Light(LightType.Point).with_position([0.0, 8.0, 0.0])
         .with_intensity(2.0).compile()]
    )
    cam = D3FirstPCamera()
    cam.set_parameter_vec3("position", [0.0, 12.0, 60.0])
    cam.set_parameter_vec3("center", [0.0, 0.0, 0.0])
    return scene, cam, Assets.default()


def huge_rasterizer(cam, width: int, height: int, device=None):
    """The Rasterizer tools/bench_huge.py renders the huge scene with: its
    camera, an ambient of (0.3, 0.3, 0.35) and a sun at full day."""
    from .ops.raster import Rasterizer

    rast = Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(width, height),
                            device=device).ambient([0.3, 0.3, 0.35, 1.0])
    rast.sun_dir = np.array([0.4, -1.0, 0.25], np.float32)
    rast.day_factor = 1.0
    return rast

"""map_refl_1080p: the procedural map of the reference's
benches/rasterize_map.rs (bench.py's map_1920x1080_ggx_refl1) with a sun,
the GGX BRDF and one GGX reflection ray per pixel.

The scene is built through the port's public API from a copy of the
builder code of rusterix_tpu_torch/scenes.py (build_map_scene,
build_map_refl_scene), so that a later change there leaves the yardstick
as it is. The sizes come from map_refl_1080p.json. `System` is what the
harness drives: the port set up for the configuration, and its frame
call."""

from __future__ import annotations

import numpy as np

from rxbench.lib.traffic import camera, dynamic_parts


def map_source(cfg: dict, doorway: list) -> str:
    """The map's MapScript: a grid of rooms whose sides are a wall, the
    doorway commands and a wall, with a point light in every
    `light_every`-th room (scenes._map_source)."""
    side = (cfg["room_size"] - cfg["doorway"]) / 2
    pl = cfg["point_light"]
    lines = ['set_default("wall_tex", "brick")', 'set_default("floor_tex", "floor")',
             'set_default("ceiling_tex", "floor")',
             f'set_default("wall_height", {cfg["wall_height"]})']
    for ry in range(cfg["rooms_y"]):
        for rx in range(cfg["rooms_x"]):
            ox, oy = rx * cfg["room_size"], ry * cfg["room_size"]
            lines.append(f"move_to({ox}, {oy})")
            for _ in range(4):
                lines.append(f"wall({side:g})")
                lines.extend(doorway)
                lines.append(f"wall({side:g})")
                lines.append("turn_right()")
            if (rx + ry) % cfg["light_every"] == 0:
                half = cfg["room_size"] / 2
                lines.append(f"move_to({ox + half:g}, {oy + half:g})")
                lines.append(f'add_point_light("{pl["color"]}", {pl["intensity"]}, '
                             f'{pl["start"]}, {pl["end"]})')
    return "\n".join(lines)


def build_scene(cfg: dict):
    """-> (scene, assets) of the map (scenes.build_map_scene)."""
    from rusterix_tpu_torch.builders import D3Builder, MapScript
    from rusterix_tpu_torch.models import Assets, Light, LightType, Scene, Texture

    assets = Assets.default()
    assets.textures["brick"] = Texture.checkerboard(*cfg["wall_texture"])
    assets.textures["floor"] = Texture.checkerboard(*cfg["floor_texture"])
    m = MapScript(assets).compile(map_source(cfg, [f"move_forward({cfg['doorway']:g})"]))
    scene = Scene.empty()
    D3Builder().build(m, assets, scene)
    sp, al = cfg["spot_light"], cfg["ambient_light"]
    spot = Light(LightType.Spot).with_position(sp["position"]).with_intensity(sp["intensity"])
    spot.end_distance = sp["end"]
    amb = Light(LightType.Ambient).with_position(al["position"]).with_intensity(al["intensity"])
    amb.end_distance = al["end"]
    scene.lights = [spot.compile(), amb.compile()]
    return scene, assets


def make_rasterizer(cfg: dict, view, proj, device):
    """A Rasterizer for one frame's camera with the configuration's
    settings (scenes._map_lights_and_camera, build_map_refl_scene)."""
    from rusterix_tpu_torch.ops.raster import Rasterizer

    rast = Rasterizer.setup(None, view, proj, device=device).ambient(cfg["ambient"])
    rast.sun_dir = np.array(cfg["sun_dir"], np.float32)
    rast.sun_color = np.array(cfg["sun_color"], np.float32)
    rast.day_factor = cfg["day_factor"]
    rast.set_brdf(cfg["brdf"]).set_reflections(cfg["reflection_samples"])
    return rast


def place_dynamic(scene, specs: list):
    """Set the scene's dynamic lists to a frame's batches (the port's API,
    as a game's entity update does) and mark them changed."""
    parts = dynamic_parts(specs, "port")
    scene.d3_dynamic[:] = parts["opaque"]
    scene.d3_dynamic_opacity[:] = parts["opacity"]
    scene.d2_dynamic[:] = parts["d2"]
    scene.touch_dynamic()


class System:
    """The port, set up with the configuration's scene: each frame is one
    `Rasterizer.rasterize(scene, width, height, assets=assets)` with its
    default readback (the RGBA8 frame in host memory), on a Rasterizer
    made for the frame's camera."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, device
        self.scene, self.assets = build_scene(cfg)

    def frame(self, fr: dict, readback: bool = True):
        view, proj = camera(fr, self.cfg)
        if fr["dynamic"]:
            place_dynamic(self.scene, fr["dynamic"])
        rast = make_rasterizer(self.cfg, view, proj, self.device)
        return rast.rasterize(self.scene, self.cfg["width"], self.cfg["height"],
                              assets=self.assets, readback=readback)

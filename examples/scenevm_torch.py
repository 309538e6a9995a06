#!/usr/bin/env python
"""SceneVM shading showcase on the PyTorch / CUDA port (the counterpart of
examples/scenevm.py): shadow maps, screen-space ambient occlusion, the GGX
BRDF and one GGX reflection ray a pixel at once over a Doom-style room,
driven by RenderSettings as the reference game client's 3D path is
(src/client/mod.rs:596-667). On the card: B1's GGX variant with the
shadow table and the AO factor, B2 for the pre-pass, B3 for the
reflection rays. Saves scenevm_torch.png.

    python examples/scenevm_torch.py                 # on the GPU
    python examples/scenevm_torch.py --device cpu    # the plain torch versions
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rusterix_tpu_torch import (  # noqa: E402
    Assets,
    D3FirstPCamera,
    Light,
    LightType,
    Rasterizer,
    RenderSettings,
    Scene,
    Texture,
)
from rusterix_tpu_torch.builders import D3Builder, MapScript  # noqa: E402
from rusterix_tpu_torch.profiling import counters  # noqa: E402

WORLD = """
set_default("wall_tex", "brick")
set_default("floor_tex", "floor")
set_default("wall_height", 3.0)

wall(12)
turn_right()
wall(12)
turn_right()
wall(12)
turn_right()
wall(12)

move_to(4, 5)
wall(1)
turn_right()
wall(1)
turn_right()
wall(1)
turn_right()
wall(1)

move_to(9, 8)
add_point_light("#ffcc88", 2.2, 2.0, 9.0)
"""

WIDTH, HEIGHT = 800, 600


def build(device, width: int = WIDTH, height: int = HEIGHT):
    """-> (Rasterizer on `device`, scene, assets) of the example at width x height."""
    assets = Assets.default()
    assets.textures["brick"] = Texture.checkerboard(32, 8)
    assets.textures["floor"] = Texture.checkerboard(32, 4)
    scene = Scene.empty()
    D3Builder().build(MapScript(assets).compile(WORLD), assets, scene)
    # a second light type so the shadow bake covers sun + cube maps
    spot = Light(LightType.Spot).with_position([5.0, 2.6, 5.0]).with_intensity(1.4)
    spot.end_distance = 10.0
    scene.lights.append(spot.compile())

    camera = D3FirstPCamera()
    camera.set_parameter_vec3("position", [9.5, 1.7, 10.5])
    camera.set_parameter_vec3("center", [4.0, 0.8, 4.0])
    # the SceneVM uniform block, verbatim keys (render_settings.rs:10-70)
    rs = RenderSettings(
        sun_direction=(0.8, -1.0, 0.55), sun_intensity=1.7, ambient_color=(0.22, 0.22, 0.28),
        ambient_strength=0.8, ao_samples=6, ao_radius=0.6, reflection_samples=1,
        max_shadow_distance=50.0, fog_density=0.0,
    )
    rast = (
        Rasterizer.setup(None, camera.view_matrix(), camera.projection_matrix(width, height),
                         device=device)
        .apply_render_settings(rs)
        .set_shadows(True)
        .set_ambient_occlusion(True)
        .set_brdf("ggx")
    )
    return rast, scene, assets


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="scenevm_torch.png", help="the PNG to write")
    opts = ap.parse_args()

    rast, scene, assets = build(opts.device)
    before = (counters["b1.launch"], counters["b2.launch"], counters["b3.walk_launch"])
    frame = rast.rasterize(scene, WIDTH, HEIGHT, 40, assets)

    from PIL import Image

    Image.fromarray(frame, "RGBA").save(opts.out)
    tris = sum(len(b.indices) for b in scene.all_d3_batches())
    after = (counters["b1.launch"], counters["b2.launch"], counters["b3.walk_launch"])
    b1, b2, b3 = (a - b for a, b in zip(after, before))
    print(f"scenevm: {tris} triangles, shadows+AO+GGX+reflections on {rast.device} "
          f"(B1 {b1}, B2 {b2}, B3 {b3} launches), saved {opts.out}")


if __name__ == "__main__":
    main()

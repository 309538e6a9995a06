#!/usr/bin/env python
"""Map example on the PyTorch / CUDA port (the counterpart of
examples/map.py, reference examples/map.rs): a procedural Doom-style map
built with the MapScript DSL, first-person camera, the render graph's sky
at hour 14 and point lights, rendered at 800x600 by rusterix_tpu_torch.
Saves map_torch.png.

    python examples/map_torch.py                 # on the GPU, through B1
    python examples/map_torch.py --device cpu    # the plain torch versions
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rusterix_tpu_torch import (  # noqa: E402
    Assets,
    D3FirstPCamera,
    Rasterizer,
    Scene,
    Texture,
)
from rusterix_tpu_torch.builders import D3Builder, MapScript  # noqa: E402
from rusterix_tpu_torch.profiling import counters  # noqa: E402
from rusterix_tpu_torch.shapefx import ShapeFXGraph  # noqa: E402

WORLD = """
set_default("wall_tex", "brick")
set_default("floor_tex", "floor")
set_default("wall_height", 3.0)

wall(12)
turn_right()
wall(12)
turn_right()
wall(5)
add_point_light("#ffddaa", 2.5, 2.0, 10.0)
wall(7)
turn_right()
wall(12)

move_to(4, 4)
add_point_light("#aaddff", 1.5, 1.0, 6.0)
"""

WIDTH, HEIGHT = 800, 600


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="map_torch.png", help="the PNG to write")
    opts = ap.parse_args()

    assets = Assets.default()
    assets.textures["brick"] = Texture.checkerboard(32, 8)
    assets.textures["floor"] = Texture.checkerboard(32, 4)

    script = MapScript(assets)
    world = script.compile(WORLD)

    scene = Scene.empty()
    D3Builder().build(world, assets, scene)

    camera = D3FirstPCamera()
    camera.set_parameter_vec3("position", [6.0, 1.6, 10.0])
    camera.set_parameter_vec3("center", [6.0, 1.2, 0.0])

    rast = Rasterizer.setup(
        None, camera.view_matrix(), camera.projection_matrix(WIDTH, HEIGHT),
        device=opts.device,
    )
    rast.render_graph = ShapeFXGraph.default_render_graph(with_sky=True)
    rast.hour = 14.0
    before = counters["b1.launch"]
    frame = rast.rasterize(scene, WIDTH, HEIGHT, 64, assets)

    from PIL import Image

    Image.fromarray(frame, "RGBA").save(opts.out)
    tris = sum(len(b.indices) for b in scene.all_d3_batches())
    print(f"map: {tris} triangles, sun_dir={rast.sun_dir}, megakernel launches "
          f"{counters["b1.launch"] - before} on {rast.device}, saved {opts.out}")


if __name__ == "__main__":
    main()

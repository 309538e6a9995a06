#!/usr/bin/env python
"""Cube example on the PyTorch / CUDA port (the counterpart of
examples/cube.py, reference examples/cube.rs): a textured box, a textured
200x200 2D rectangle, the gray gradient background and a point light
circling the box, under an orbit camera, rendered at 640x480 by
rusterix_tpu_torch. Renders 30 frames and saves the last as cube_torch.png.

    python examples/cube_torch.py                 # on the GPU, through B1
    python examples/cube_torch.py --device cpu    # the plain torch versions
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from rusterix_tpu_torch import (  # noqa: E402
    Assets,
    Batch2D,
    Batch3D,
    CullMode,
    D3OrbitCamera,
    Light,
    LightType,
    Material,
    MaterialModifier,
    MaterialRole,
    PixelSource,
    Rasterizer,
    Scene,
    Texture,
    Tile,
    VGrayGradientShader,
)
from rusterix_tpu_torch.profiling import counters  # noqa: E402

WIDTH, HEIGHT = 640, 480


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="cube_torch.png", help="the PNG to write")
    opts = ap.parse_args()

    scene = Scene.from_static(
        [Batch2D.from_rectangle(0.0, 0.0, 200.0, 200.0).set_source(
            PixelSource.static_tile_index(0)
        )],
        [
            Batch3D.from_box(-0.5, -0.5, -0.5, 1.0, 1.0, 1.0)
            .set_source(PixelSource.static_tile_index(0))
            .set_cull_mode(CullMode.Off)
            .set_material(
                Material(MaterialRole.Metallic, MaterialModifier.Saturation, 0.6, 0.0)
            )
            .with_computed_normals()
        ],
    ).set_lights(
        [Light(LightType.Point).with_intensity(1.0).with_color([1.0, 1.0, 0.95]).compile()]
    ).set_background(VGrayGradientShader())

    assets = Assets.default().with_textures([Tile.from_texture(Texture.checkerboard(128, 16))])
    camera = D3OrbitCamera()
    camera.set_parameter_f32("distance", 1.5)

    before = counters["b1.launch"]
    frame, rast = None, None
    t0 = time.time()
    n = 30
    for i in range(n):
        elapsed = i / 30.0 * 1.5
        scene.lights[0].position = np.array(
            [2.0 * math.cos(elapsed), 0.8, 2.0 * math.sin(elapsed)], np.float32
        )
        rast = Rasterizer.setup(
            None, camera.view_matrix(), camera.projection_matrix(WIDTH, HEIGHT),
            device=opts.device,
        ).ambient([0.1, 0.1, 0.1, 1.0])
        frame = rast.rasterize(scene, WIDTH, HEIGHT, 64, assets)
    dt = (time.time() - t0) / n

    from PIL import Image

    Image.fromarray(frame, "RGBA").save(opts.out)
    print(f"cube: {dt * 1000:.2f} ms/frame at {WIDTH}x{HEIGHT} (host wall, with readback), "
          f"megakernel launches {counters["b1.launch"] - before} on {rast.device}, "
          f"2D pass {rast.frame_args['has_d2']}, saved {opts.out}")


if __name__ == "__main__":
    main()

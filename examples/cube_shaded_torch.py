#!/usr/bin/env python
"""Cube-shaded example on the PyTorch / CUDA port (the counterpart of
examples/cube_shaded.py, reference examples/cube_shaded.rs): a unit box
under a procedural wood rusteria shader and a point light, over the gray
gradient background, rendered at 800x600 by rusterix_tpu_torch (the bench's
cube_shaded configuration: `scenes.build_cube_shaded_scene`). The shader
bakes to an atlas tile when the scene is first packed, on the rasterizer's
device, and its constant roughness rides B1's has_material variant.
Renders 20 frames and saves the last as cube_shaded_torch.png.

    python examples/cube_shaded_torch.py                 # on the GPU, through B1
    python examples/cube_shaded_torch.py --device cpu    # the plain torch versions
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rusterix_tpu_torch.profiling import counters  # noqa: E402
from rusterix_tpu_torch.scenes import build_cube_shaded_scene  # noqa: E402

WIDTH, HEIGHT = 800, 600


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="cube_shaded_torch.png", help="the PNG to write")
    opts = ap.parse_args()

    rast, scene, assets = build_cube_shaded_scene(WIDTH, HEIGHT, device=opts.device)
    t0 = time.time()
    frame = rast.rasterize(scene, WIDTH, HEIGHT, 64, assets)  # packs and bakes
    first = time.time() - t0
    before = counters["b1.launch"]
    n = 20
    t0 = time.time()
    for _ in range(n):
        frame = rast.rasterize(scene, WIDTH, HEIGHT, 64, assets)
    dt = (time.time() - t0) / n

    from PIL import Image

    Image.fromarray(frame, "RGBA").save(opts.out)
    print(f"cube_shaded: first frame (with the shader bake) {first * 1000:.2f} ms, then "
          f"{dt * 1000:.2f} ms/frame at {WIDTH}x{HEIGHT} (host wall, with readback), "
          f"megakernel launches {counters["b1.launch"] - before} on {rast.device}, "
          f"has_material {rast.frame_args['has_material']}, saved {opts.out}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""OBJ example on the PyTorch / CUDA port (the counterpart of examples/obj.py,
reference examples/obj.rs): a wavefront mesh with back-face culling and the
depth test under an orbit camera, through B1. The mesh is a procedural
torus written as OBJ text (the reference ships teapot.obj); no file is
read. Saves obj_torch.png.

    python examples/obj_torch.py                 # on the GPU, through B1
    python examples/obj_torch.py --device cpu    # the plain torch versions
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rusterix_tpu_torch import (  # noqa: E402
    Assets,
    CullMode,
    D3OrbitCamera,
    Light,
    LightType,
    PixelSource,
    Rasterizer,
    Scene,
    Texture,
    Tile,
    VGrayGradientShader,
    Wavefront,
)
from rusterix_tpu_torch.ops import megakernel  # noqa: E402

WIDTH, HEIGHT = 640, 480


def torus_obj(R=0.7, r=0.3, nu=32, nv=16) -> str:
    """The torus of examples/obj.py as OBJ text (vertices, normals, uvs, quads)."""
    lines = []
    for i in range(nu):
        for j in range(nv):
            a = 2 * math.pi * i / nu
            b = 2 * math.pi * j / nv
            x = (R + r * math.cos(b)) * math.cos(a)
            y = r * math.sin(b)
            z = (R + r * math.cos(b)) * math.sin(a)
            lines.append(f"v {x:.5f} {y:.5f} {z:.5f}")
            nx = math.cos(b) * math.cos(a)
            ny = math.sin(b)
            nz = math.cos(b) * math.sin(a)
            lines.append(f"vn {nx:.5f} {ny:.5f} {nz:.5f}")
            lines.append(f"vt {i/nu:.4f} {j/nv:.4f}")
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j + 1
            b = ((i + 1) % nu) * nv + j + 1
            c = ((i + 1) % nu) * nv + (j + 1) % nv + 1
            d = i * nv + (j + 1) % nv + 1
            lines.append(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c} {d}/{d}/{d}")
    return "\n".join(lines)


def build(device):
    """-> (Rasterizer on `device`, scene, assets) of the example."""
    batch = (
        Wavefront.parse_string(torus_obj())
        .to_batch()
        .set_source(PixelSource.static_tile_index(0))
        .set_cull_mode(CullMode.Back)
    )
    scene = Scene.from_static([], [batch]).set_lights(
        [Light(LightType.Point).with_position([2.0, 2.0, 2.0]).with_intensity(1.2).compile()]
    ).set_background(VGrayGradientShader())
    assets = Assets.default().with_textures([Tile.from_texture(Texture.checkerboard(64, 8))])
    camera = D3OrbitCamera()
    camera.azimuth = 0.8
    camera.set_parameter_f32("distance", 2.5)
    rast = Rasterizer.setup(
        None, camera.view_matrix(), camera.projection_matrix(WIDTH, HEIGHT), device=device
    ).ambient([0.8, 0.8, 0.8, 1.0])
    return rast, scene, assets


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="obj_torch.png", help="the PNG to write")
    opts = ap.parse_args()

    rast, scene, assets = build(opts.device)
    before = megakernel.launches
    frame = rast.rasterize(scene, WIDTH, HEIGHT, 64, assets)

    from PIL import Image

    Image.fromarray(frame, "RGBA").save(opts.out)
    tris = sum(len(b.indices) for b in scene.all_d3_batches())
    print(f"obj: {tris} triangles, megakernel launches {megakernel.launches - before} on "
          f"{rast.device}, saved {opts.out}")


if __name__ == "__main__":
    main()

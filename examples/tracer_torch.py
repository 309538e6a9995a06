#!/usr/bin/env python
"""Path-tracer example on the PyTorch / CUDA port (the counterpart of
examples/tracer.py, reference Client::trace): progressive wavefront tracing
of an emissive + diffuse scene by rusterix_tpu_torch's Tracer. Saves the
accumulated image.

    python examples/tracer_torch.py                 # on the GPU
    python examples/tracer_torch.py --device cpu    # on the CPU
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rusterix_tpu_torch.scenes import build_tracer_scene  # noqa: E402
from rusterix_tpu_torch.tracer import AccumBuffer, Tracer  # noqa: E402

WIDTH, HEIGHT = 320, 240
SAMPLES = 8


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--samples", type=int, default=SAMPLES, help="samples per pixel")
    ap.add_argument("--out", default="tracer_torch.png", help="the PNG to write")
    opts = ap.parse_args()

    scene, cam, assets = build_tracer_scene()
    buf = AccumBuffer(WIDTH, HEIGHT, device=opts.device)
    tracer = Tracer(device=opts.device)
    tracer.trace(cam, scene, buf, 64, assets)  # warm-up: packs the scene
    buf.reset()

    def sync():
        if buf.device.type == "cuda":
            torch.cuda.synchronize(buf.device)

    sync()
    t0 = time.time()
    for _ in range(opts.samples):
        tracer.trace(cam, scene, buf, 64, assets)
    sync()
    dt = (time.time() - t0) / opts.samples
    print(f"tracer: {dt * 1000:.1f} ms/sample at {WIDTH}x{HEIGHT}, {opts.samples} samples "
          f"on {buf.device}")

    from PIL import Image

    Image.fromarray(buf.to_u8(), "RGBA").save(opts.out)
    print(f"saved {opts.out}")


if __name__ == "__main__":
    main()

"""Huge-scene benchmark of the PyTorch / CUDA port: ~128K triangle slots
through the megakernel (B1), the port's form of tools/bench_huge.py.

Renders `scenes.build_huge_scene(n_boxes)` (10,600 boxes by default:
127,200 triangles in 131,072 slots) at width x height with the JAX tool's
ambient and sun, and prints one JSON line: the slots, the live triangles,
the first frame's wall seconds (the pack and the upload; on the card also
the kernels' build when it is not cached), and the median ms per frame of
`frames` steady `rasterize(readback=False)` calls with fps, timed by CUDA
events on the card (the wall clock with `-d cpu`), with the device's name.

Usage: python tools/bench_huge_torch.py [n_boxes] [width height] [-d cuda|cpu] [-n frames]
"""

import argparse
import json
import os
import statistics
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_boxes", nargs="?", type=int, default=10600)
    ap.add_argument("width", nargs="?", type=int, default=1920)
    ap.add_argument("height", nargs="?", type=int, default=1080)
    ap.add_argument("-d", "--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("-n", "--frames", type=int, default=20)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from rusterix_tpu_torch.device import resolve_device
    from rusterix_tpu_torch.ops import raster
    from rusterix_tpu_torch.scenes import build_huge_scene, huge_rasterizer

    dev = resolve_device(args.device)
    w, h = args.width, args.height
    scene, cam, assets = build_huge_scene(args.n_boxes)
    rast = huge_rasterizer(cam, w, h, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    rast.rasterize(scene, w, h, 40, assets, readback=False)
    sync()
    first_s = time.perf_counter() - t0
    packed = next(iter(raster._SCENE_CACHE.values()))["packed"]
    times = []
    for _ in range(args.frames):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rast.rasterize(scene, w, h, 40, assets, readback=False)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            rast.rasterize(scene, w, h, 40, assets, readback=False)
            times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    print(json.dumps({
        "metric": f"huge_map_{w}x{h}_fps",
        "slots": int(packed.d3.pos.shape[0]),
        "live_tris": int((packed.d3.valid > 0.5).sum()),
        "first_frame_s": first_s,
        "ms_per_frame": ms,
        "fps": 1e3 / ms,
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

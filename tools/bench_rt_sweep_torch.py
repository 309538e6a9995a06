"""Sweep B3's tuning knobs on the GGX-reflection map at 1920x1080, the port's
form of tools/bench_rt_sweep.py: one configuration a run.

RUSTERIX_TPU_RT_CELL, RUSTERIX_TPU_RT_BH and RUSTERIX_TPU_RT_BW are read
when the port is imported (ops/rt_kernel.py `rt_knobs`, which refuses what
the kernels cannot take, such as RT_BH x RT_BW > 1024); values other than
the defaults (64, 8, 128) are passed to nvcc as -D flags into a build
directory of their own under rusterix_tpu_torch/_build/, and the default
build stays where and what it was. Prints one JSON line: the knobs, the
first frame's wall seconds (the build included when it is not cached), the
median ms per frame by CUDA events and fps, B3's walk and preparation
launches of a steady frame, and the frame's sha256 (equal across the knobs
where no ray hits two triangles at one t from two cells).

Usage: RUSTERIX_TPU_RT_CELL=32 python tools/bench_rt_sweep_torch.py [-n frames] [--out frame.png]
"""

import argparse
import hashlib
import json
import os
import statistics
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", "--frames", type=int, default=20)
    ap.add_argument("--out", help="also save the frame as this PNG (to compare the knobs' frames)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from rusterix_tpu_torch import _cuda
    from rusterix_tpu_torch.ops import rt_kernel
    from rusterix_tpu_torch.scenes import build_map_refl_scene

    w, h = 1920, 1080
    rast, scene, assets = build_map_refl_scene(w, h, device="cuda")
    t0 = time.perf_counter()
    rast.rasterize(scene, w, h, 40, assets, readback=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(args.frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rast.rasterize(scene, w, h, 40, assets, readback=False)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    rt_kernel.launches = rt_kernel.prepare_launches = 0
    rt_kernel.prepare_cluster_launches = rt_kernel.prepare_large_launches = 0
    frame = rast.rasterize(scene, w, h, 40, assets)
    ms = statistics.median(times)
    if args.out:
        from PIL import Image

        Image.fromarray(frame, "RGBA").save(args.out)
    print(json.dumps({
        "cell": rt_kernel.RT_CELL, "bh": rt_kernel.RT_BH, "bw": rt_kernel.RT_BW,
        "build_dir": os.path.relpath(_cuda.BUILD_DIR, os.path.dirname(_cuda._PKG)),
        "first_frame_s": first_s, "ms": ms, "fps": 1e3 / ms,
        "walk_launches": rt_kernel.launches,
        "prepare_launches": [rt_kernel.prepare_launches, rt_kernel.prepare_cluster_launches,
                             rt_kernel.prepare_large_launches],
        "frame_sha256": hashlib.sha256(frame.tobytes()).hexdigest(),
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

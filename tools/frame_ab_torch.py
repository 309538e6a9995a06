"""Frame times of one tree of the PyTorch / CUDA port, for comparing two
trees on one card in turns (parent, change, change, parent in one call):
paths A (the opaque map), B (the GGX reflection map) and, when asked, R (A
in 8 row slabs of the card, `rasterize(mesh=make_mesh(8, "cuda"))`) at
1920x1080, 3 warm-up frames, then the median and the minimum of 30
`rasterize(readback=False)` frames by CUDA events.

Usage: python tools/frame_ab_torch.py TREE [PATHS]   (TREE holds
       rusterix_tpu_torch/, e.g. a `git archive` of the parent commit
       unpacked into _parent/; PATHS a comma-separated subset of A,B,R,
       default A,B)
"""

import statistics
import sys


def main(tree: str, paths: str = "A,B") -> int:
    sys.path.insert(0, tree)
    import torch

    from rusterix_tpu_torch import _cuda, parallel, scenes

    _cuda.library()
    w, h = 1920, 1080
    builds = {"A": scenes.build_map_scene, "B": scenes.build_map_refl_scene,
              "R": scenes.build_map_scene}
    for name in paths.split(","):
        rast, scene, assets = builds[name](w, h, device="cuda")
        mesh = parallel.make_mesh(8, "cuda") if name == "R" else None
        for _ in range(3):
            rast.rasterize(scene, w, h, 40, assets, readback=False, mesh=mesh)
        torch.cuda.synchronize()
        times = []
        for _ in range(30):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rast.rasterize(scene, w, h, 40, assets, readback=False, mesh=mesh)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        print(tree, name, "median", statistics.median(times), "min", min(times), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(*sys.argv[1:3]))

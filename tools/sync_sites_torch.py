"""The host synchronisations of one steady sharded frame of the port, by
the Python line that made each one, beside those of the same path's single
frame.

    python tools/sync_sites_torch.py [--cards] [--size WxH] [--paths R,S,JA,I,T8,V,M]

The paths are chip_smoke.py's MC paths (chip_smoke.MC_PATHS, built by
chip_smoke.mc_scene): R the opaque map (scenes.build_map_scene), S the
shadowed GGX reflection map with ambient occlusion and sky light, JA the
glazed map with GGX reflections and AO, I the glazed map, T8 the map under a
runtime floor shader (the split path), V the shadowed map with dynamic
billboards, casters and a dynamic 2D rectangle (moved before every frame),
M the bench's cube with its 2D rectangle (800x600). Each renders through
`Rasterizer.rasterize(mesh=...)` over eight slabs of one card
(`make_mesh(8, "cuda")`), or with `--cards` over every card of the machine
(`card_mesh()`), and without a mesh. Two frames are rendered first; the
third runs under `torch.cuda.set_sync_debug_mode("warn")`, and every
warning it raises is printed with the port's innermost frame of its stack
(file:line and the source line), counted by site. `--size` sets the size
of every path (default: each path's own, 1920x1080 but M). Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import linecache
import os
import sys
import traceback
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PORT = os.sep + "rusterix_tpu_torch" + os.sep


def port_site(stack) -> str:
    """The innermost frame of `stack` inside the port -> "file:line  source"."""
    for fr in reversed(stack):
        if PORT in fr.filename:
            rel = fr.filename[fr.filename.index(PORT) + 1:]
            return f"{rel}:{fr.lineno}  {linecache.getline(fr.filename, fr.lineno).strip()}"
    return "(outside the port)"


def sync_sites(fn) -> collections.Counter:
    """Run fn() under sync debug mode "warn" -> Counter of port sites."""
    import torch

    sites: collections.Counter = collections.Counter()
    shown = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            sites[port_site(traceback.extract_stack()[:-1])] += 1
        else:
            shown(message, category, filename, lineno, file, line)

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    sync()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
    sync()
    return sites


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", action="store_true", help="one slab a card (card_mesh())")
    ap.add_argument("--size", default=None)
    ap.add_argument("--paths", default="R,S,JA,I,T8,V,M")
    a = ap.parse_args()
    import chip_smoke
    from rusterix_tpu_torch import parallel

    if a.size:
        size = tuple(int(v) for v in a.size.split("x"))
        chip_smoke.SIZES = {k: size for k in chip_smoke.MC_PATHS}
    mesh = parallel.card_mesh() if a.cards else parallel.make_mesh(8, "cuda")
    for key in a.paths.split(","):
        rast, scene, assets, w, h, move = chip_smoke.mc_scene(key, mesh[0])
        for label, m in (("single frame", None),
                         (f"{len(mesh)} slabs on {len(set(mesh))} device(s)", mesh)):
            def frame(m=m):
                move()
                return rast.rasterize(scene, w, h, 40, assets, mesh=m, readback=False)

            frame()
            frame()
            sites = sync_sites(frame)
            print(f"path {key}, {label}, {w}x{h}: {sum(sites.values())} synchronisations at "
                  f"{len(sites)} sites", flush=True)
            for site, n in sites.most_common():
                print(f"  {n:4d}  {site}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

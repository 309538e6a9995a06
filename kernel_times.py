"""Times of the port's CUDA kernels alone, for one tree or two in turns.

    python3 kernel_times.py                   # this checkout
    python3 kernel_times.py --against DIR     # DIR, this, this, DIR on one card

Builds the kernels of a tree's `rusterix_tpu_torch`, takes the kernels' own
inputs from the two 1920x1080 map frames chip_smoke.py drives (opaque, and
with the sun, GGX and one reflection ray per pixel) and times, per call of
each wrapper: the wrapper (CUDA events, median of 40), and under
torch.profiler (20 calls) all device time of the call and the device time
of each hand-written kernel by name. The megakernel is timed at stage_cut
0, 1 and 2 on both frames' inputs, so the differences split its time into
the scan, the interpolation + texel fetch, and the lighting + fog + pack;
the opaque frame itself (`rasterize`, path A) is timed the same way, which
gives its device ops per frame. B3's preparation is timed on path B's rays
and on chip_smoke.py's C12 scene (1080p rays over 28,700 cells, both kinds
of keys), through whichever route each tree's `rt_prepare_cuda` takes.
Where the tree has the shadowed map (`scenes.build_map_shadow_scene`), the
megakernel is also timed on its inputs with and without the shadow table;
where it has the glazed map (`scenes.build_map_glass_scene`), on its inputs
with its transmittance and tonemap variants and without each; where it has
the blended map (`scenes.build_map_blend_scene`), on its inputs with and
without the has_blend variant; where it has the baked-shader paths
(`scenes.build_cube_shaded_scene`, `scenes.build_map_material_scene`), on
the shaded cube's inputs (800x600) with and without has_material and on the
material map's with has_matmap, with has_material alone and without either.
Each tree's line also gives the megakernel's registers, shared memory,
resident blocks an SM and ptxas's spill report (of each material form where
the tree compiles the kernel as a template of them).

With `--against DIR` the same measurement runs in a process of its own for
each turn (DIR holds another version of the package, for example the parent
commit unpacked with `git archive`): the other tree, this one, this one,
the other tree, all on the same card, so that two designs are compared
within one run. DIR's package must take `stage_cut` in `mega_render`:
kernel_times_first_design.patch gives it to the first design of the kernels
(commit 4d3d6b2) and says how to unpack and patch that tree. Every line
names the card and its power limit. Needs a GPU; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KERNEL_SYMBOLS = ("mega_kernel", "visibility_kernel", "rt_kernel", "rt_prepare_kernel",
                  "rt_prepare_cluster_kernel", "rt_prepare_large_kernel")


def measure(tree: str) -> dict:
    """The times of the package under `tree` (a directory that holds
    rusterix_tpu_torch/), in ms per call."""
    import chip_smoke as cs  # this checkout's, whatever the tree holds

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from rusterix_tpu_torch import _cuda, scenes
    from rusterix_tpu_torch.ops import megakernel, rt_kernel, visibility_pallas
    from rusterix_tpu_torch.ops.raster import frame_inputs
    from rusterix_tpu_torch.scenes import build_map_refl_scene, build_map_scene

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: torch.cuda.is_available() is False")
    _cuda.build(force=True)
    _cuda.library()

    def timed(fn) -> dict:
        wrapper = cs.median(cs.cuda_times(fn, 40))
        prof = cs.profile_calls(fn, 20)
        out = {"wrapper_ms": wrapper, "device_ms": None, "device_ops": None}
        if prof is not None:
            out["device_ms"], out["device_ops"] = prof["device_ms"], prof["ops"]
            for name, (ms, count) in prof["by_name"].items():
                for symbol in KERNEL_SYMBOLS:
                    if cs.is_kernel(name, symbol):  # one launch per call
                        out[symbol + "_ms"] = out.get(symbol + "_ms", 0.0) + ms / count
        return out

    times = {}
    for label, build in (("opaque", build_map_scene), ("ggx", build_map_refl_scene)):
        rast, scene, assets = build(cs.W, cs.H, device="cuda")
        rast.rasterize(scene, cs.W, cs.H, 40, assets)
        fi = frame_inputs(**rast.frame_args)
        args, kwargs = fi["mega_args"], fi["mega_kwargs"]
        for cut in (0, 1, 2):
            times[f"B1 {label} stage_cut={cut}"] = timed(
                lambda: megakernel.mega_render(*args, **kwargs, stage_cut=cut))
        if label == "opaque":  # the whole frame: its device ops are mostly plain torch
            times["frame A rasterize(readback=False)"] = timed(
                lambda: rast.rasterize(scene, cs.W, cs.H, 40, assets, readback=False))
    b1 = _cuda.resources("mega", args[0].shape[0] // 128, len(kwargs["light_spec"]),
                         int(args[8].shape[0]))
    with open(_cuda.BUILD_LOG) as f:
        log = f.read()
    if hasattr(_cuda, "ptxas_report"):
        b1["ptxas"] = _cuda.ptxas_report(log, "mega_kernel")
    else:  # an older tree: csrc/megakernel.cu compiles first, one entry
        b1["ptxas"] = {"mega_kernel": [ln.strip() for ln in log.splitlines() if "spill" in ln][0]}
    kin = cs.reflection_kernel_inputs(rast, fi)
    b2_in, b3_in = kin["b2_in"], kin["b3_in"]
    times["B2"] = timed(lambda: visibility_pallas.visibility_pass_pallas(*b2_in))
    times["B3 (preparation + walk)"] = timed(lambda: rt_kernel.intersect_rays_pallas(*b3_in))
    times["B3 preparation"] = timed(lambda: rt_kernel.rt_prepare_cuda(*b3_in))
    for kind in cs.SWEEP_KEYS:  # whichever route the tree gives C12's scene
        c12_in = cs.c12_inputs(cs.C12_CELLS, kind)
        times[f"B3 preparation C12 ({kind} keys)"] = timed(
            lambda: rt_kernel.rt_prepare_cuda(*c12_in))
        del c12_in
    if hasattr(scenes, "build_map_shadow_scene"):
        rast, scene, assets = scenes.build_map_shadow_scene(cs.W, cs.H, device="cuda")
        rast.rasterize(scene, cs.W, cs.H, 40, assets)
        fi = frame_inputs(**rast.frame_args)
        args, kwargs = fi["mega_args"], fi["mega_kwargs"]
        times["B1 shadowed map"] = timed(lambda: megakernel.mega_render(*args, **kwargs))
        no_table = dict(kwargs, shadow_rows=None, shadow_spec=None)
        times["B1 shadowed map without the table"] = timed(
            lambda: megakernel.mega_render(*args, **no_table))
    if hasattr(scenes, "build_map_glass_scene"):
        rast, scene, assets = scenes.build_map_glass_scene(cs.W, cs.H, device="cuda")
        rast.rasterize(scene, cs.W, cs.H, 40, assets)
        fi = frame_inputs(**rast.frame_args)
        args, kwargs = fi["mega_args"], fi["mega_kwargs"]
        no_trans = dict(kwargs, shadow_spec=cs.opaque_maps(kwargs["shadow_spec"]))
        for label, kw in (("", kwargs), (" without the tonemap", dict(kwargs, tonemap=False)),
                          (" without the transmittance", no_trans)):
            times["B1 glazed map" + label] = timed(
                lambda kw=kw: megakernel.mega_render(*args, **kw))
    if hasattr(scenes, "build_map_blend_scene"):
        rast, scene, assets = scenes.build_map_blend_scene(cs.W, cs.H, device="cuda")
        rast.rasterize(scene, cs.W, cs.H, 40, assets)
        fi = frame_inputs(**rast.frame_args)
        args, kwargs = fi["mega_args"], fi["mega_kwargs"]
        for label, kw in (("", kwargs), (" without has_blend", dict(kwargs, has_blend=False))):
            times["B1 blended map" + label] = timed(
                lambda kw=kw: megakernel.mega_render(*args, **kw))
    if hasattr(scenes, "build_map_material_scene"):
        for name, build, (w, h) in (("shaded cube", scenes.build_cube_shaded_scene, (800, 600)),
                                    ("material map", scenes.build_map_material_scene,
                                     (cs.W, cs.H))):
            rast, scene, assets = build(w, h, device="cuda")
            rast.rasterize(scene, w, h, 40, assets)
            fi = frame_inputs(**rast.frame_args)
            args, kwargs = fi["mega_args"], fi["mega_kwargs"]
            forms = [("", kwargs)]
            if kwargs["has_matmap"]:
                forms.append((" has_material alone", dict(kwargs, has_matmap=False)))
            forms.append((" without the material", dict(kwargs, has_material=False,
                                                          has_matmap=False)))
            for label, kw in forms:
                times[f"B1 {name}" + label] = timed(
                    lambda kw=kw: megakernel.mega_render(*args, **kw))
    gpu = cs._run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return {"tree": os.path.abspath(tree), "gpu": gpu.splitlines()[0], "b1": b1,
            "times": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)),
                    help="directory that holds the rusterix_tpu_torch to measure")
    ap.add_argument("--against", help="another tree: measure it, this, this, it")
    ns = ap.parse_args()
    if not ns.against:
        print(json.dumps(measure(ns.tree)))
        return 0
    here = os.path.abspath(__file__)
    turns = []
    for tree in (ns.against, ns.tree, ns.tree, ns.against):
        proc = subprocess.run([sys.executable, here, "--tree", tree], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]))
    gpu = turns[0]["gpu"]
    for t in turns[:2]:
        print(f"B1 of {t['tree']}: {t['b1']}")
    keys = list(dict.fromkeys(k for t in turns for k in t["times"]))  # a tree may lack some
    for key in keys:
        for field in sorted({f for t in turns for f in t["times"].get(key, {})}):
            vals = [t["times"].get(key, {}).get(field) for t in turns]
            shown = ", ".join("-" if v is None else f"{v:.4f}" for v in vals)
            print(f"{key} {field} [other, this, this, other]: {shown} on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of rusterix_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from rusterix_tpu_torch/csrc and drives the port's
two main paths through `rusterix_tpu_torch.Rasterizer.rasterize` at
1920x1080 on the bench's procedural map: the opaque frame (the megakernel,
B1) and the frame with a sun, the GGX BRDF and one GGX reflection ray per
pixel (B1's GGX variant, the visibility pre-pass B2 and the ray intersect
B3). For each path it checks that the frame went through every kernel of
the path (launch counts read right after it), holds every kernel against
its plain torch version on the frame's own inputs, checks the CUDA frames
against the CPU frames at a small size, times the frames, the kernels and
the plain versions with CUDA events, and breaks the frames down: host wall
time per step, and under torch.profiler the device time, device ops, busy
share and each kernel's device time per frame. Every phase raises on
failure; nothing falls back to the CPU or to a plain version. The last line
is the JSON result; it is printed only when every phase passed. Imports no
jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 1920, 1080
SMALL_W, SMALL_H = 256, 128
# B1 vs its plain version on the same inputs: z_eff equal, rgba within 1
RGBA_TOL = 1
# the card's published peaks (H100 SXM data sheet): HBM bytes/s, f32 ops/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per visibility test (three edge planes and the 1/z plane,
# a multiply and an add each), per Möller-Trumbore test (arithmetic of the
# kernel's expression: 9 + 5 + 1 + 3 + 6 + 9 + 6 + 1 + 6) and per ray-box
# slab test (6 subtractions, 6 multiplies, 12 min/max)
OPS_PER_VIS_TEST = 8
OPS_PER_MT_TEST = 46
OPS_PER_SLAB_TEST = 24


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_times(fn, iters: int, warmup: int = 2) -> list:
    """Sorted milliseconds of `iters` calls, each between two CUDA events
    recorded on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)


def summary(times: list) -> str:
    """median, 75th percentile, n"""
    n = len(times)
    return f"median {times[n // 2]:.4f} ms, p75 {times[(3 * n) // 4]:.4f} ms, n={n}"


def median(times: list) -> float:
    return times[len(times) // 2]


def wall_ms(fn, iters: int = 20) -> float:
    """Median host milliseconds of `fn`, the device synchronized before and
    after each call (the steps of a frame are host-bound)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)[iters // 2]


def profile_calls(fn, n: int):
    """Device activity of `n` calls of `fn` under torch.profiler -> None
    when the profiler recorded no device activity, else per call: device ms
    (the union of the device intervals: kernels, copies, memsets), device
    ops, and device ms and op count by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    busy, reach = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    by_name = {}
    for e in events:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, count + 1)
    return {
        "device_ms": busy / 1e3 / n,
        "ops": len(events) / n,
        "by_name": {k: (ms / n, c / n) for k, (ms, c) in by_name.items()},
    }


def is_kernel(name: str, symbol: str) -> bool:
    """Does the profiler's kernel name denote the __global__ function
    `symbol` (demangled "symbol(...)" or mangled "_Z<len>symbol...")?"""
    name = name.removeprefix("void ")
    return name == symbol or name.startswith(symbol + "(") or name.startswith(
        f"_Z{len(symbol)}{symbol}")


def report_profile(label, prof, frame_ms, gpu, kernels: dict) -> dict:
    """Print a frame's profile; -> {kernel: device ms per frame}, each named
    kernel seen exactly once per frame."""
    if prof is None:
        print(f"profiler, {label}: no device activity recorded; device time not measured")
        return {k: None for k in kernels}
    out = {}
    for key, symbol in kernels.items():
        seen = [(ms, c) for name, (ms, c) in prof["by_name"].items() if is_kernel(name, symbol)]
        if len(seen) != 1 or seen[0][1] != 1:
            raise SystemExit(f"profiler, {label}: expected one {symbol} launch per frame, "
                             f"saw {seen}")
        out[key] = seen[0][0]
    each = ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())
    print(f"profiler, {label}: device {prof['device_ms']:.4f} ms per frame, "
          f"{prof['ops']:.1f} device ops per frame, busy share "
          f"{prof['device_ms'] / frame_ms:.4f} of the {frame_ms:.4f} ms frame median, "
          f"{each} per frame on {gpu}")
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
    for name, (ms, c) in top:
        print(f"  device {ms:.4f} ms, {c:.1f} ops per frame: {name[:100]}")
    return out


def bound(nbytes: int, ops: int) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from rusterix_tpu_torch import _cuda
    from rusterix_tpu_torch.ops import megakernel, reflect, rt_kernel, visibility_pallas
    from rusterix_tpu_torch.ops.raster import frame_inputs, visibility_prepass
    from rusterix_tpu_torch.ops.setup_pass import setup_pass
    from rusterix_tpu_torch.ops.shade import gbuffer_pass
    from rusterix_tpu_torch.scenes import build_map_refl_scene, build_map_scene

    kernel_modules = {"B1": megakernel, "B2": visibility_pallas, "B3": rt_kernel}

    def zero_counts():
        for mod in kernel_modules.values():
            mod.launches = 0

    def read_counts() -> dict:
        return {k: mod.launches for k, mod in kernel_modules.items()}

    def rgba_diff(a, b):
        """per-channel |a - b| of two packed RGBA8 frames"""
        return (megakernel.unpack_frame_u32(a).int() - megakernel.unpack_frame_u32(b).int()).abs()

    gpu = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    gpu = gpu.splitlines()[0]
    # 1. environment
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(_run([_cuda.nvcc_path(), "--version"]).splitlines()[-1])
    print(f"gpu: {gpu}")

    # 2. build the kernel library from the checkout's sources
    t0 = time.perf_counter()
    _cuda.build(force=True)
    _cuda.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    with open(_cuda.BUILD_LOG) as f:
        for line in f:
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("ptxas:", line.strip())

    # 3. main path A: the opaque map at 1920x1080 through rasterize
    rast, scene, assets = build_map_scene(W, H, device="cuda")
    zero_counts()
    frame = rast.rasterize(scene, W, H, 40, assets)
    torch.cuda.synchronize()
    counts_a = read_counts()
    if counts_a["B1"] < 1:
        raise SystemExit(f"opaque path did not launch the megakernel: {counts_a}")
    if frame.shape != (H, W, 4) or frame.dtype != np.uint8:
        raise SystemExit(f"frame is {frame.shape} {frame.dtype}, not ({H}, {W}, 4) uint8")
    bg = np.array(rast.background_color or (0, 0, 0, 0), np.uint8)
    covered = int((frame != bg).any(axis=-1).sum())
    print(f"main path A (opaque map): frame {frame.shape} {frame.dtype}, launches {counts_a}, "
          f"covered px {covered}")
    if covered < W * H // 20:
        raise SystemExit(f"only {covered} pixels covered: the map did not render")

    # 4. main path B: the map with the sun, GGX and one reflection ray per pixel
    rast_r, scene_r, assets_r = build_map_refl_scene(W, H, device="cuda")
    zero_counts()
    frame_r = rast_r.rasterize(scene_r, W, H, 40, assets_r)
    torch.cuda.synchronize()
    counts_b = read_counts()
    if min(counts_b.values()) < 1:
        raise SystemExit(f"reflection path did not launch every kernel: {counts_b}")
    if frame_r.shape != (H, W, 4) or frame_r.dtype != np.uint8:
        raise SystemExit(f"reflection frame is {frame_r.shape} {frame_r.dtype}")
    rast_o, scene_o, assets_o = build_map_refl_scene(W, H, device="cuda")
    frame_o = rast_o.set_reflections(0).rasterize(scene_o, W, H, 40, assets_o)
    reflected = int((np.abs(frame_r.astype(int) - frame_o.astype(int)).max(-1) > 1).sum())
    print(f"main path B (GGX reflection map): frame {frame_r.shape} {frame_r.dtype}, "
          f"launches {counts_b}, px changed by the reflections {reflected}")
    if reflected < W * H // 50:
        raise SystemExit(f"the reflections changed only {reflected} pixels")
    launches = {k: counts_a[k] + counts_b[k] for k in counts_a}

    # 5. every kernel against its plain version on the frames' own inputs
    fi_o = frame_inputs(**rast.frame_args)
    args, kwargs = fi_o["mega_args"], fi_o["mega_kwargs"]
    rgba_k, z_k = megakernel.mega_render(*args, **kwargs)
    rgba_p, z_p, b1_tests = megakernel.mega_render_reference(*args, **kwargs, return_work=True)
    torch.cuda.synchronize()
    if not torch.equal(z_k, z_p):
        raise SystemExit(f"B1: z_eff differs from the plain version at {int((z_k != z_p).sum())} px")
    diff = rgba_diff(rgba_k, rgba_p)
    b1_err = int(diff.max())
    print(f"B1 vs plain (opaque map): z_eff equal, rgba max diff {b1_err} (tolerance {RGBA_TOL}), "
          f"px differing {int((diff.amax(-1) > 0).sum())}, visibility tests {b1_tests}")

    fi = frame_inputs(**rast_r.frame_args)
    gargs, gkwargs = fi["mega_args"], fi["mega_kwargs"]
    if not gkwargs["brdf_ggx"]:
        raise SystemExit("the reflection frame's megakernel call is not the GGX variant")
    rgba_k, z_k = megakernel.mega_render(*gargs, **gkwargs)
    rgba_p, z_p, ggx_tests = megakernel.mega_render_reference(*gargs, **gkwargs, return_work=True)
    torch.cuda.synchronize()
    if not torch.equal(z_k, z_p):
        raise SystemExit(f"B1 GGX: z_eff differs at {int((z_k != z_p).sum())} px")
    diff = rgba_diff(rgba_k, rgba_p)
    ggx_err = int(diff.max())
    print(f"B1 brdf_ggx vs plain (reflection map): z_eff equal, rgba max diff {ggx_err} "
          f"(tolerance {RGBA_TOL}), px differing {int((diff.amax(-1) > 0).sum())}, "
          f"visibility tests {ggx_tests}")
    b1_err = max(b1_err, ggx_err)
    if b1_err > RGBA_TOL:
        raise SystemExit("the megakernel disagrees with its plain version")

    b2_in = (fi["vis_s"], fi["alive_s"], fi["bbox_s"], W, H)
    z2, i2, h2 = visibility_pallas.visibility_pass_pallas(*b2_in)
    z2p, i2p, h2p = visibility_pallas.visibility_pass_pallas_reference(*b2_in)
    torch.cuda.synchronize()
    b2_err = float((z2 - z2p).abs().max())
    print(f"B2 vs plain (reflection map pre-pass): idx px differing {int((i2 != i2p).sum())}, "
          f"z max diff {b2_err}, covered px {int(h2.sum())}")
    if not (torch.equal(i2, i2p) and torch.equal(z2, z2p)):
        raise SystemExit("the visibility kernel disagrees with its plain version")
    b2_tests = visibility_pallas.scan_work(*b2_in)

    z_pre, idx_pre, hit_pre = visibility_prepass(fi, W, H)
    fa = rast_r.frame_args
    g = gbuffer_pass(z_pre, idx_pre, hit_pre, fi["attr"], fi["tri_id"], fa["d3"], fa["atlas"],
                     fa["uniforms"], W, H, fa["sample_mode"])
    rays = reflect.reflection_rays(g, hit_pre, W, H, 0)
    b3_in = (fa["d3"]["pos"], fa["d3"]["valid"], rays["o_x"], rays["o_y"], rays["o_z"],
             rays["d_x"], rays["d_y"], rays["d_z"], float(fa["uniforms"]["refl_dist"]), H, W)
    t3, i3 = rt_kernel.intersect_rays_pallas(*b3_in)
    t3p, i3p, b3_work = rt_kernel.intersect_rays_pallas_reference(*b3_in, return_work=True)
    torch.cuda.synchronize()
    both = (i3 >= 0) & (i3p >= 0)
    b3_err = float((t3[both] - t3p[both]).abs().max()) if bool(both.any()) else 0.0
    t_diff = int(((t3 != t3p) & ~(torch.isinf(t3) & torch.isinf(t3p))).sum())
    print(f"B3 vs plain (reflection map rays, {int(rays['ok'].sum())} cast): idx rays differing "
          f"{int((i3 != i3p).sum())}, t rays differing {t_diff}, t max diff {b3_err}, "
          f"hits {int((i3 >= 0).sum())}, work {b3_work}")
    if not (torch.equal(i3, i3p) and torch.equal(t3, t3p)):
        raise SystemExit("the ray-intersect kernel disagrees with its plain version")

    # 6. the CUDA frames against the CPU (plain) frames at a small size
    for label, build in (("opaque", build_map_scene), ("reflection", build_map_refl_scene)):
        small = []
        for dev in ("cuda", "cpu"):
            r, s, a = build(SMALL_W, SMALL_H, device=dev)
            small.append(r.rasterize(s, SMALL_W, SMALL_H, 40, a).astype(np.int32))
        d = np.abs(small[0] - small[1]).max(-1)
        print(f"cuda vs cpu {label} frame at {SMALL_W}x{SMALL_H}: max diff {int(d.max())}, "
              f"px differing {int((d > 0).sum())}")
        if d.max() > RGBA_TOL:
            raise SystemExit(f"the CUDA {label} frame disagrees with the CPU frame")

    # 7. steady-state times (the rasterize figures include their host work)
    frame_t = cuda_times(lambda: rast.rasterize(scene, W, H, 40, assets, readback=False), 40)
    frame_r_t = cuda_times(
        lambda: rast_r.rasterize(scene_r, W, H, 40, assets_r, readback=False), 20)
    b1_t = cuda_times(lambda: megakernel.mega_render(*args, **kwargs), 40)
    b1_plain_t = cuda_times(lambda: megakernel.mega_render_reference(*args, **kwargs), 3, warmup=1)
    ggx_t = cuda_times(lambda: megakernel.mega_render(*gargs, **gkwargs), 40)
    b2_t = cuda_times(lambda: visibility_pallas.visibility_pass_pallas(*b2_in), 40)
    b2_plain_t = cuda_times(lambda: visibility_pallas.visibility_pass_pallas_reference(*b2_in), 3,
                            warmup=1)
    b3_t = cuda_times(lambda: rt_kernel.intersect_rays_pallas(*b3_in), 40)
    b3_plain_t = cuda_times(lambda: rt_kernel.intersect_rays_pallas_reference(*b3_in), 3, warmup=1)
    print(f"rasterize(readback=False) opaque {W}x{H}: {summary(frame_t)} on {gpu}")
    print(f"rasterize(readback=False) GGX reflections {W}x{H}: {summary(frame_r_t)} on {gpu}")
    print(f"B1 mega_render (opaque map): {summary(b1_t)} on {gpu}")
    print(f"plain mega_render_reference (opaque map): {summary(b1_plain_t)} on {gpu}")
    print(f"B1 mega_render brdf_ggx (reflection map): {summary(ggx_t)} on {gpu}")
    print(f"B2 visibility_pass_pallas: {summary(b2_t)} on {gpu}")
    print(f"plain visibility_pass_pallas_reference: {summary(b2_plain_t)} on {gpu}")
    print(f"B3 intersect_rays_pallas: {summary(b3_t)} on {gpu}")
    print(f"plain intersect_rays_pallas_reference: {summary(b3_plain_t)} on {gpu}")
    frame_ms, frame_r_ms = median(frame_t), median(frame_r_t)

    # 8. where the frames' time goes: host wall per step (synchronized)
    fa_o = rast.frame_args
    d3, unif = fa_o["d3"], fa_o["uniforms"]
    view = torch.from_numpy(unif["view"]).cuda()
    proj = torch.from_numpy(unif["proj"]).cuda()

    def run_setup():
        return setup_pass(d3["pos"], d3["uv"], d3["nrm"], d3["valid"], d3["cull"],
                          view, proj, W, H)

    vis, attr, bbox, alive, tri_id = run_setup()

    def run_table():
        return megakernel.pack_mega_table(attr, tri_id, d3, fa_o["atlas"],
                                          int(unif["anim_frame"]), False)

    table = run_table()
    sky = torch.from_numpy(np.asarray(fa["uniforms"]["refl_sky"], np.float32))
    t_hit = torch.where(rays["ok"], i3, -1)
    steps = {
        "opaque rasterize() with readback": lambda: rast.rasterize(scene, W, H, 40, assets),
        "opaque rasterize(readback=False)": lambda: rast.rasterize(
            scene, W, H, 40, assets, readback=False),
        "opaque frame_inputs (setup + table + sort + packs)": lambda: frame_inputs(**fa_o),
        "opaque setup_pass": run_setup,
        "opaque pack_mega_table": run_table,
        "opaque morton_ftb_sort": lambda: megakernel.morton_ftb_sort(
            vis, bbox, alive.float(), table, W, H),
        "opaque mega_render": lambda: megakernel.mega_render(*args, **kwargs),
        "reflection rasterize(readback=False)": lambda: rast_r.rasterize(
            scene_r, W, H, 40, assets_r, readback=False),
        "reflection frame_inputs (setup + table + sort + packs)": lambda: frame_inputs(**fa),
        "reflection visibility_prepass (B2 + remap)": lambda: visibility_prepass(fi, W, H),
        "reflection mega_render brdf_ggx": lambda: megakernel.mega_render(*gargs, **gkwargs),
        "reflection gbuffer_pass": lambda: gbuffer_pass(
            z_pre, idx_pre, hit_pre, fi["attr"], fi["tri_id"], fa["d3"], fa["atlas"],
            fa["uniforms"], W, H, fa["sample_mode"]),
        "reflection reflection_rays": lambda: reflect.reflection_rays(g, hit_pre, W, H, 0),
        "reflection intersect_rays_pallas (prep + B3)": lambda: rt_kernel.intersect_rays_pallas(
            *b3_in),
        "reflection _shade_reflection_hits": lambda: reflect._shade_reflection_hits(
            t3, t_hit, *b3_in[2:8], fa["d3"], fa["atlas"], fa["lights"], fa["uniforms"],
            fa["sample_mode"], sky),
    }
    for name, fn in steps.items():
        print(f"step wall {name}: median {wall_ms(fn):.4f} ms (n=20) on {gpu}")

    # device time per frame under torch.profiler; the busy share's
    # denominator is the unprofiled frame median above (same run)
    n_prof = 20
    dev_a = report_profile(
        f"opaque rasterize(readback=False) x{n_prof}",
        profile_calls(lambda: rast.rasterize(scene, W, H, 40, assets, readback=False), n_prof),
        frame_ms, gpu, {"B1": "mega_kernel"})
    dev_b = report_profile(
        f"reflection rasterize(readback=False) x{n_prof}",
        profile_calls(lambda: rast_r.rasterize(scene_r, W, H, 40, assets_r, readback=False),
                      n_prof),
        frame_r_ms, gpu, {"B1": "mega_kernel", "B2": "visibility_kernel", "B3": "rt_kernel"})

    # 9. bounds: each input read once and each output written once over the
    # memory rate, against the visibility / ray tests this data needs over
    # the f32 rate
    b1_bytes = nbytes(*[a for a in args if isinstance(a, torch.Tensor)], rgba_k, z_k)
    b1_bound = bound(b1_bytes, b1_tests * OPS_PER_VIS_TEST)
    b2_bytes = nbytes(*b2_in[:3], z2, i2)
    b2_bound = bound(b2_bytes, b2_tests * OPS_PER_VIS_TEST)
    b3_bytes = nbytes(*b3_in[:8], t3, i3)
    b3_ops = b3_work["ray_triangle"] * OPS_PER_MT_TEST + b3_work["ray_box"] * OPS_PER_SLAB_TEST
    b3_bound = bound(b3_bytes, b3_ops)
    for key, (ms, by), nb, ops in (("B1", b1_bound, b1_bytes, b1_tests * OPS_PER_VIS_TEST),
                                   ("B2", b2_bound, b2_bytes, b2_tests * OPS_PER_VIS_TEST),
                                   ("B3", b3_bound, b3_bytes, b3_ops)):
        print(f"bound {key}: {nb} bytes, {ops} f32 ops -> {ms:.6f} ms, bound by {by}")

    kernels = [
        {
            "name": "mega_render", "route": "cuda",
            "source": "rusterix_tpu_torch/csrc/megakernel.cu",
            "replaces": "rusterix_tpu/ops/megakernel.py:250",
            "launches": launches["B1"], "max_abs_err": b1_err,
            "ms": median(b1_t), "plain_ms": median(b1_plain_t),
            "bound_ms": b1_bound[0], "bound_by": b1_bound[1], "library_ms": None,
            "device_ms": dev_a["B1"],
        },
        {
            "name": "visibility_pass_pallas", "route": "cuda",
            "source": "rusterix_tpu_torch/csrc/visibility.cu",
            "replaces": "rusterix_tpu/ops/visibility_pallas.py:42",
            "launches": launches["B2"], "max_abs_err": b2_err,
            "ms": median(b2_t), "plain_ms": median(b2_plain_t),
            "bound_ms": b2_bound[0], "bound_by": b2_bound[1], "library_ms": None,
            "device_ms": dev_b["B2"],
        },
        {
            "name": "intersect_rays_pallas", "route": "cuda",
            "source": "rusterix_tpu_torch/csrc/rt_kernel.cu",
            "replaces": "rusterix_tpu/ops/rt_kernel.py:79",
            "launches": launches["B3"], "max_abs_err": b3_err,
            "ms": median(b3_t), "plain_ms": median(b3_plain_t),
            "bound_ms": b3_bound[0], "bound_by": b3_bound[1], "library_ms": None,
            "device_ms": dev_b["B3"],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

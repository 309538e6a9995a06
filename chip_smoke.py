"""Smoke run of rusterix_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from rusterix_tpu_torch/csrc and drives the port's
main paths through `rusterix_tpu_torch.Rasterizer.rasterize` at 1920x1080:
A, the bench's procedural map opaque (the megakernel, B1); B, the map with
a sun, the GGX BRDF and one GGX reflection ray per pixel (B1's GGX variant,
the visibility pre-pass B2 and the ray intersect B3 with its preparation
kernel); C, the map with ambient occlusion (B2, the AO pass, B1's ao_img
variant); D, the sky-light floor scene with AO (B2, B1 with ao_img, one sky
ray per pixel through B3); E, the GGX-reflection map with its reflections
at half scale (B3 on 960x540 rays); F, the map with 2x2 SSAA (B1 at
3840x2160); G, the bench's shadowed map (a sun and shadow maps: B1's shadow
variant reading four cube maps and the sun's, baked in plain torch on the
first frame); H, the GGX-reflection map with shadow maps (B1's GGX variant
with shadows, B2, B3, and the maps looked up at the reflection hits); I,
the glazed map under the render graph's sky and fog (B1's transmittance
and tonemap variants, the sky miss pass, two depth-peeled opacity layers in
plain torch, the bake with transmittance layers); J, I with GGX
reflections (B1's GGX variant with both, B2, and B3 on the opaque frame's
rays and on each layer's). For
each path it checks that the frame went through exactly
the kernels of the path (launch counts zeroed before it and read right
after it),
holds every kernel against its plain torch version on the frame's own
inputs (B1 also at the profiling cuts stage_cut 1 and 2; with shadows bit
for bit), checks the CUDA
frames against the CPU frames at a small size, times the frames, the
kernels and the plain versions with CUDA events (B1's kernel alone at
stage_cut 0, 1 and 2, which splits its time into the scan, the texel stage
and the lighting; on G with and without the shadow table; on I with and
without each of its variants), times the shadow bake apart from the
steady frames, and breaks the frames down: host wall time per step (on I
also the layer loop and the sky miss pass), and
under torch.profiler the device time, device ops, busy share and each
kernel's device time per frame. It prints each kernel's registers, shared
memory and resident blocks an SM, and its bound. Every phase raises on
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
# launches per frame of the later paths (B1, B2, B3 walk, B3 preparation)
EXPECTED_LAUNCHES = {
    "C": {"B1": 1, "B2": 1, "B3": 0, "B3prep": 0},
    "D": {"B1": 1, "B2": 1, "B3": 1, "B3prep": 1},
    "E": {"B1": 1, "B2": 1, "B3": 1, "B3prep": 1},
    "F": {"B1": 1, "B2": 0, "B3": 0, "B3prep": 0},
    "G": {"B1": 1, "B2": 0, "B3": 0, "B3prep": 0},
    "H": {"B1": 1, "B2": 1, "B3": 1, "B3prep": 1},
    # the opacity layers run through the plain visibility pass, as the JAX
    # package runs them through XLA; with reflections the walk and its
    # preparation run once for the opaque frame and once per layer
    "I": {"B1": 1, "B2": 0, "B3": 0, "B3prep": 0},
    "J": {"B1": 1, "B2": 1, "B3": 3, "B3prep": 3},
}
# the shadowed paths: B1 equals its plain version bit for bit, and their
# steady frames are counted after a first frame that bakes the maps
SHADOWED = ("G", "H", "I", "J")
# the paths with glass: their maps carry transmittance layers
GLASS = ("I", "J")
# frames profiled on the glass paths (~9,000-13,000 device ops a frame
# each: the profiler's records take longer to read than the frames)
N_PROF_GLASS = 5
# pixels where a later path's CUDA frame differs from its CPU frame at the
# small size (each within RGBA_TOL); see PERF.md
SMALL_PINNED = {"C": 0, "D": 0, "E": 0, "F": 0, "G": 0, "H": 0, "I": 0, "J": 0}
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
# B1's stages 2-6, f32 operations per covered pixel, counted from the
# expressions of the plain version (megakernel.mega_render_reference) as the
# counts above were: every multiply, add, subtract, divide, square root,
# floor, exp, min/max and compare-to-float is one operation; integer index
# arithmetic is not counted.
OPS_INTERP = 30          # z = 1/best, six planes (2 mul + 2 add), u and v quotients, repeat decode
OPS_TEXEL_NEAREST = 43   # repeat/clamp of u and v, texel coordinates, four channels resolved
OPS_TEXEL_BILINEAR_EXTRA = 64  # three more taps, four weights, the weighted channel sums
OPS_SHADE_FIXED = 204    # view + world position, view and normal directions, albedo, hemisphere
                         # ambient, batch ambient, sRGB encode, fullbright blend, fog, quantize
OPS_PER_OCC_BOX = 6      # four compares, a select and a min
OPS_SUN_EXTRA = 6        # has_sun * colour, accumulated (the BRDF is counted by its type)
# one light of a type (LightType codes: 0 point, 1 and 2 ambient, 3 spot, 4
# area, 5 daylight) up to its radiance and the accumulation, without the BRDF
OPS_PER_LIGHT = {0: 54, 1: 34, 2: 34, 3: 61, 4: 72, 5: 56}
OPS_BRDF = {False: 58, True: 94}  # fast Blinn-Phong + Schlick; Cook-Torrance GGX
OPS_AO = 1  # the ao_img variant: hemi * ao
# the shadow variant (shadow.shadow_factor's expressions; a fused product
# counts as two, abs as one), per texel read: a cube lookup (receiver minus
# light 3, |.| 3 and max 2, range compare, offset 2, normal offset 6, |.| 3,
# face tests 5, max 2, signs 3, u/v products 3, face sign tests 3, max 1, two
# texel coordinates 6 each, depth compare 4, radiance scale 1) and a sun
# lookup (receiver minus camera 3, depth dot 5, max, footprint 2, offset 2,
# normal offset 6, minus camera 3, three dots 15, max, two texel coordinates
# 5 each, range tests 5, depth compare 4, sun colour scale 3)
OPS_CUBE_SHADOW = 52
OPS_SUN_SHADOW = 60
# the transmittance variant, per layer step of a live lookup: two texel
# reads (counted as bytes), the two depth tests (2 subtractions, 2
# compares) and the factor's (1 - alpha) and multiply
OPS_TRANS_STEP = 6
# the tonemap variant, per shaded pixel, beyond the sRGB encode it replaces
# (max, square root, 3 multiplies and a subtraction a channel): Reinhard
# (max, add, divide), max, logf, multiply and expf a channel, counting
# expf and logf as 8 f32 operations each (a special-function-unit op at a
# quarter of the f32 rate, with its range reduction and correction)
OPS_TONEMAP_EXTRA = 3 * (3 + 1 + 8 + 1 + 8) - 3 * 6
# f32 operations per ray of the preparation (12 min/max + 6 NaN tests + the
# live test) and per (block, cell) key (gaps, distance, cull, compares)
OPS_PREP_PER_RAY = 19
OPS_PREP_PER_KEY = 40


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


def profile_calls(fn, n: int, host_records: bool = True):
    """Device activity of `n` calls of `fn` under torch.profiler -> None
    when the profiler recorded no device activity, else "calls" (n), per
    call the device ms (the union of the device intervals: kernels, copies,
    memsets) and the device ops, and by name the total device ms and the
    number of records over all n calls. The profiler can lose records of a
    long run, so a reader that needs one kernel's time divides its total by
    its own count of records, not by n. `host_records=False` records the
    device activity alone (the host's operator records of a call with
    hundreds of thousands of ops take long to read)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_records else [])
    with profile(activities=activities) as prof:
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
    return {"calls": n, "device_ms": busy / 1e3 / n, "ops": len(events) / n, "by_name": by_name}


def is_kernel(name: str, symbol: str) -> bool:
    """Does the profiler's kernel name denote the __global__ function
    `symbol` (demangled "symbol(...)" or "symbol<...>(...)", or mangled
    "_Z<len>symbol...")?"""
    name = name.removeprefix("void ")
    return name == symbol or name.startswith(
        (symbol + "(", symbol + "<", f"_Z{len(symbol)}{symbol}"))


def report_profile(label, prof, frame_ms, gpu, kernels: dict) -> dict:
    """Print a frame's profile; -> {kernel: device ms per launch}. `kernels`
    maps a key to the kernel's symbol, or to (symbol, launches per frame)
    where a frame launches it more than once (the launch counters hold
    those counts), so more records than that is an error; fewer means the
    profiler lost records, and then the frame's device ms and ops are lower
    bounds."""
    if prof is None:
        print(f"profiler, {label}: no device activity recorded; device time not measured")
        return {k: None for k in kernels}
    out, n, lost = {}, prof["calls"], False
    for key, symbol in kernels.items():
        symbol, per = symbol if isinstance(symbol, tuple) else (symbol, 1)
        seen = [(ms, c) for name, (ms, c) in prof["by_name"].items() if is_kernel(name, symbol)]
        if len(seen) != 1 or not 1 <= seen[0][1] <= n * per:
            raise SystemExit(f"profiler, {label}: expected {per} {symbol} launches per frame, "
                             f"saw (total ms, records) {seen} in {n} frames")
        out[key] = seen[0][0] / seen[0][1]
        lost = lost or seen[0][1] < n * per
    if lost:
        print(f"profiler, {label}: the profiler lost records of some launches; the frame's "
              f"device ms and ops below are lower bounds, each kernel's ms is per record kept")
    each = ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())
    print(f"profiler, {label}: device {prof['device_ms']:.4f} ms per frame, "
          f"{prof['ops']:.1f} device ops per frame, busy share "
          f"{prof['device_ms'] / frame_ms:.4f} of the {frame_ms:.4f} ms frame median, "
          f"{each} per frame on {gpu}")
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
    for name, (ms, c) in top:
        print(f"  device {ms / n:.4f} ms, {c / n:.1f} ops per frame: {name[:100]}")
    return out


def bound(nbytes: int, ops: int) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def shade_ops(covered: int, stage_cut: int, kwargs: dict, n_occ: int, sample_mode: int) -> int:
    """f32 operations of B1's stages 2-6 for `covered` pixels with a winner,
    up to the stage the cut keeps, for this frame's lights, BRDF, sun and
    sampling mode."""
    if stage_cut == 1:
        return 0
    texel = OPS_TEXEL_NEAREST + (OPS_TEXEL_BILINEAR_EXTRA if sample_mode else 0)
    per_px = OPS_INTERP + texel
    if stage_cut == 0:
        brdf = OPS_BRDF[bool(kwargs.get("brdf_ggx", False))]
        per_px += OPS_SHADE_FIXED + OPS_PER_OCC_BOX * n_occ
        if not kwargs.get("sun_off", False):
            per_px += brdf + OPS_SUN_EXTRA
        per_px += sum(OPS_PER_LIGHT[int(t)] + brdf for _row, t in kwargs["light_spec"])
        if kwargs.get("ao_img") is not None:
            per_px += OPS_AO
    return covered * per_px


def reflection_kernel_inputs(rast_r, fi, scale: int = 1, sky: bool = False) -> dict:
    """The inputs B2 and B3 get on the frame that `rast_r` last rendered at
    W x H (fi: its frame_inputs): "b2_in", the arguments of
    visibility_pass_pallas; "pre", the pre-pass's (z, idx, hit); "g", the
    G-buffer; "rays", the reflection rays (sample 0; every scale-th pixel
    when `scale` > 1) or with `sky` the sky-light rays; "b3_in", the
    arguments of intersect_rays_pallas."""
    from rusterix_tpu_torch.ops import reflect
    from rusterix_tpu_torch.ops.raster import visibility_prepass
    from rusterix_tpu_torch.ops.shade import gbuffer_pass

    fa = rast_r.frame_args
    pre = visibility_prepass(fi, W, H)
    hs, ws = H // scale, W // scale
    sl = (slice(0, hs * scale, scale), slice(0, ws * scale, scale))
    z, idx, hit = (t[sl] for t in pre)
    g = gbuffer_pass(z, idx, hit, fi["attr"], fi["tri_id"], fa["d3"], fa["atlas"],
                     fa["uniforms"], ws, hs, fa["sample_mode"], stride=scale)
    rays = reflect.sky_rays(g, hit) if sky else reflect.reflection_rays(g, hit, ws, hs, 0, scale)
    b3_in = (fa["d3"]["pos"], fa["d3"]["valid"], rays["o_x"], rays["o_y"], rays["o_z"],
             rays["d_x"], rays["d_y"], rays["d_z"], float(fa["uniforms"]["refl_dist"]), hs, ws)
    return {"b2_in": (fi["vis_s"], fi["alive_s"], fi["bbox_s"], W, H), "pre": pre, "g": g,
            "rays": rays, "b3_in": b3_in}


def bake_call(rast, shadow):
    """A function of no arguments that bakes the shadow maps of the frame
    `rast` last rendered, as its Rasterizer baked them (shadow: the port's
    ops.shadow module; with the transmittance layers where its maps have
    them) -> (flat table, params, spec)."""
    fa = rast.frame_args
    sun_entry, cubes = fa["shadow_spec"]
    params, d3 = fa["shadow_params"], fa["d3"]
    with_trans = any(c[3] >= 0 for c in cubes) or (sun_entry is not None and sun_entry[2] >= 0)
    bounds = shadow.scene_bounds(d3["pos"].cpu().numpy(), d3["valid"].cpu().numpy())
    cfg = rast.shadow_settings
    return lambda: shadow.bake_shadow_pack(
        d3, fa["d3_op"] if with_trans else None, fa["lights"], [c[0] for c in cubes],
        rast.sun_dir if sun_entry is not None else None, res=cfg["res"],
        sun_res=cfg["sun_res"], with_trans=with_trans,
        trans_steps=int(np.clip(rast._rs_shadow_steps, 1, 4)),
        max_shadow_distance=float(params[0]), bias=float(params[1]), bounds=bounds)


def opaque_maps(spec):
    """A shadow spec with its transmittance layers taken out (the depth
    maps alone), to measure B1 without the transmittance variant."""
    sun_entry, cubes = spec
    sun = None if sun_entry is None else (sun_entry[0], sun_entry[1], -1, sun_entry[3])
    return sun, tuple(tuple(c[:3]) + (-1, c[4]) for c in cubes)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    def phase(label):
        print(f"[{time.perf_counter() - t_start:.1f} s] phase {label}", flush=True)
    from rusterix_tpu_torch import _cuda
    from rusterix_tpu_torch.ops import megakernel, reflect, rt_kernel, shadow, visibility_pallas
    from rusterix_tpu_torch.ops.composite import sky_miss_pass
    from rusterix_tpu_torch.ops.raster import (
        ambient_occlusion,
        frame_inputs,
        opacity_layers,
        visibility_prepass,
    )
    from rusterix_tpu_torch.ops.setup_pass import setup_pass
    from rusterix_tpu_torch.ops.shade import gbuffer_pass
    from rusterix_tpu_torch.scenes import (
        build_map_ao_scene,
        build_map_glass_refl_scene,
        build_map_glass_scene,
        build_map_refl_half_scene,
        build_map_refl_scene,
        build_map_scene,
        build_map_shadow_refl_scene,
        build_map_shadow_scene,
        build_map_ssaa2_scene,
        build_sky_light_scene,
    )

    counters = {"B1": (megakernel, "launches"), "B2": (visibility_pallas, "launches"),
                "B3": (rt_kernel, "launches"), "B3prep": (rt_kernel, "prepare_launches")}

    def zero_counts():
        for mod, name in counters.values():
            setattr(mod, name, 0)

    def read_counts() -> dict:
        return {k: getattr(mod, name) for k, (mod, name) in counters.items()}

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

    phase("3")
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

    phase("4")
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
    phase("4b")
    # 4b. the later paths C-F at 1920x1080, each with its exact launch counts
    later = {
        "C": ("AO map", build_map_ao_scene),
        "D": ("sky-light floor scene with AO", build_sky_light_scene),
        "E": ("GGX reflection map, reflections at half scale", build_map_refl_half_scene),
        "F": ("SSAA2 map, 3840x2160 inside", build_map_ssaa2_scene),
        "G": ("shadowed map", build_map_shadow_scene),
        "H": ("shadowed GGX reflection map", build_map_shadow_refl_scene),
        "I": ("glazed map under the sky, two layers, scenevm tonemap", build_map_glass_scene),
        "J": ("glazed map under the sky with GGX reflections", build_map_glass_refl_scene),
    }
    paths = {}
    for key, (label, build) in later.items():
        r_, s_, a_ = build(W, H, device="cuda")
        first_ms = None
        if key in SHADOWED:
            # the first frame bakes the maps; the launches are counted on a
            # steady frame after it (the bake launches none of the kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r_.rasterize(s_, W, H, 40, a_, readback=False)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
        zero_counts()
        f_ = r_.rasterize(s_, W, H, 40, a_)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != EXPECTED_LAUNCHES[key]:
            raise SystemExit(f"path {key} ({label}) launched {counts}, expected "
                             f"{EXPECTED_LAUNCHES[key]}")
        if f_.shape != (H, W, 4) or f_.dtype != np.uint8:
            raise SystemExit(f"path {key} frame is {f_.shape} {f_.dtype}")
        fa_ = r_.frame_args
        print(f"main path {key} ({label}): frame {f_.shape} {f_.dtype}, rendered at "
              f"{fa_['width']}x{fa_['height']}, launches {counts}")
        paths[key] = {"label": label, "rast": r_, "scene": s_, "assets": a_, "frame": f_,
                      "counts": counts, "first_ms": first_ms}
    # what each path adds to the opaque map, in pixels that changed by more than 1
    for key, base in (("C", frame), ("E", frame_o), ("F", frame)):
        d = np.abs(paths[key]["frame"].astype(int) - base.astype(int)).max(-1)
        changed = int((d > 1).sum())
        print(f"path {key}: px changed by more than 1 against the frame without its feature "
              f"{changed}")
        if changed < W * H // 1000:
            raise SystemExit(f"path {key}'s feature changed only {changed} pixels")
    # what the shadow maps change in G and H (the bench map's walls shade
    # each other only in a few places)
    for key in ("G", "H"):
        p_ = paths[key]
        r_, s_, a_ = p_["rast"], p_["scene"], p_["assets"]
        off = r_.set_shadows(False).rasterize(s_, W, H, 40, a_)
        r_.set_shadows(True).rasterize(s_, W, H, 40, a_)  # the cached maps again
        d = np.abs(p_["frame"].astype(int) - off.astype(int)).max(-1)
        print(f"path {key}: px changed by the shadow maps {int((d > 0).sum())} "
              f"(by more than 1: {int((d > 1).sum())})")
        if int((d > 0).sum()) == 0:
            raise SystemExit(f"path {key}'s shadow maps changed no pixel")
    launches = {k: counts_a[k] + counts_b[k] + sum(p_["counts"][k] for p_ in paths.values())
                for k in counts_a}

    phase("5")
    # 5. every kernel against its plain version on the frames' own inputs
    fi_o = frame_inputs(**rast.frame_args)
    args, kwargs = fi_o["mega_args"], fi_o["mega_kwargs"]
    rgba_k, z_k = megakernel.mega_render(*args, **kwargs)
    rgba_p, z_p, work = megakernel.mega_render_reference(*args, **kwargs, return_work=True)
    b1_tests = work["vis_tests"]
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
    rgba_p, z_p, work = megakernel.mega_render_reference(*gargs, **gkwargs, return_work=True)
    ggx_tests = work["vis_tests"]
    torch.cuda.synchronize()
    if not torch.equal(z_k, z_p):
        raise SystemExit(f"B1 GGX: z_eff differs at {int((z_k != z_p).sum())} px")
    diff = rgba_diff(rgba_k, rgba_p)
    ggx_err = int(diff.max())
    print(f"B1 brdf_ggx vs plain (reflection map): z_eff equal, rgba max diff {ggx_err} "
          f"(tolerance {RGBA_TOL}), px differing {int((diff.amax(-1) > 0).sum())}, "
          f"visibility tests {ggx_tests}")
    if max(b1_err, ggx_err) > RGBA_TOL:
        raise SystemExit("the megakernel disagrees with its plain version")
    # the profiling cuts: 1 = the scan's winning slot and 1/z, 2 = the texel
    covered = {}
    for label, (a_, k_) in (("opaque map", (args, kwargs)), ("reflection map", (gargs, gkwargs))):
        for cut in (1, 2):
            out_k = megakernel.mega_render(*a_, **k_, stage_cut=cut)
            out_p = megakernel.mega_render_reference(*a_, **k_, stage_cut=cut)
            torch.cuda.synchronize()
            if not (torch.equal(out_k[0], out_p[0]) and torch.equal(out_k[1], out_p[1])):
                raise SystemExit(
                    f"B1 stage_cut={cut} ({label}) differs from the plain version at "
                    f"{int((out_k[0] != out_p[0]).sum())} px (first output), "
                    f"{int((out_k[1] != out_p[1]).sum())} px (second)")
            if cut == 1:
                covered[label] = int((out_k[0] >= 0).sum())
        print(f"B1 stage_cut 1 and 2 vs plain ({label}): both outputs equal, "
              f"px with a winner {covered[label]}")

    kin = reflection_kernel_inputs(rast_r, fi)
    b2_in, b3_in, g, rays = kin["b2_in"], kin["b3_in"], kin["g"], kin["rays"]
    z_pre, idx_pre, hit_pre = kin["pre"]
    z2, i2, h2 = visibility_pallas.visibility_pass_pallas(*b2_in)
    z2p, i2p, h2p = visibility_pallas.visibility_pass_pallas_reference(*b2_in)
    torch.cuda.synchronize()
    b2_err = float((z2 - z2p).abs().max())
    print(f"B2 vs plain (reflection map pre-pass): idx px differing {int((i2 != i2p).sum())}, "
          f"z max diff {b2_err}, covered px {int(h2.sum())}")
    if not (torch.equal(i2, i2p) and torch.equal(z2, z2p)):
        raise SystemExit("the visibility kernel disagrees with its plain version")
    b2_tests = visibility_pallas.scan_work(*b2_in)

    fa = rast_r.frame_args
    prep_k = rt_kernel.rt_prepare_cuda(*b3_in)
    prep_p = rt_kernel.rt_prepare(*b3_in)
    torch.cuda.synchronize()
    prep_bad = [k for k in ("boxes", "tnear", "slist", "tab", "cbox", "tcap")
                if not torch.equal(prep_k[k], prep_p[k])]
    prep_err = float((prep_k["tnear"] - prep_p["tnear"]).abs().max())
    print(f"B3 preparation kernel vs plain rt_prepare ({prep_k['tnear'].shape[0]} blocks x "
          f"{prep_k['ncells']} cells): block boxes, tnear and slist "
          f"{'equal' if not prep_bad else 'DIFFER in ' + ', '.join(prep_bad)}, "
          f"tnear max diff {prep_err}")
    if prep_bad:
        raise SystemExit("the preparation kernel disagrees with rt_prepare")
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

    phase("5b")
    # 5b. the later paths' kernels against their plain versions on each
    # frame's own inputs: B1 (with the AO factor on C and D, at 3840x2160 on
    # F), B2 (C, D, E), the preparation and the walk on the sky rays (D) and
    # on the 960x540 reflection rays (E)
    for key, p_ in paths.items():
        r_ = p_["rast"]
        fa_ = r_.frame_args
        fi_ = frame_inputs(**fa_)
        a_, k_ = fi_["mega_args"], dict(fi_["mega_kwargs"])
        if fa_["ao_taps"]:
            p_["pre"] = visibility_prepass(fi_, W, H)
            k_["ao_img"] = ambient_occlusion(p_["pre"], fa_["uniforms"], H, fa_["ao_taps"])
        p_["mega"] = (a_, k_)
        if key in SHADOWED and not (k_["shadow_rows"] is not None and k_["shadow_rows"].is_cuda):
            raise SystemExit(f"path {key}: the frame's B1 call has no shadow table on the card")
        rgba_l, z_l = megakernel.mega_render(*a_, **k_)
        rgba_lp, z_lp, work_b1 = megakernel.mega_render_reference(*a_, **k_, return_work=True)
        tests = work_b1["vis_tests"]
        p_["shadow_reads"] = (work_b1["cube_reads"], work_b1["sun_reads"])
        p_["trans_steps"] = work_b1["trans_steps"]
        cut1 = megakernel.mega_render(*a_, **k_, stage_cut=1)[0]
        torch.cuda.synchronize()
        if not torch.equal(z_l, z_lp):
            raise SystemExit(f"B1 path {key}: z_eff differs at {int((z_l != z_lp).sum())} px")
        diff = rgba_diff(rgba_l, rgba_lp)
        p_["b1_err"], p_["b1_tests"], p_["covered"] = int(diff.max()), tests, int((cut1 >= 0).sum())
        # the shadow table counts the texels read (at most its size): a
        # depth texel per lookup, a depth and an alpha texel per layer step
        reads = sum(p_["shadow_reads"]) + 2 * p_["trans_steps"]
        table = k_.get("shadow_rows")
        p_["b1_bytes"] = nbytes(*[a for a in a_ if isinstance(a, torch.Tensor)], rgba_l, z_l,
                                *([k_["ao_img"]] if "ao_img" in k_ else [])) + (
            0 if table is None else min(4 * reads, nbytes(table)))
        print(f"B1 vs plain (path {key}, {fa_['width']}x{fa_['height']}"
              f"{', ao_img' if 'ao_img' in k_ else ''}): z_eff equal, rgba max diff "
              f"{p_['b1_err']} (tolerance {RGBA_TOL}), px differing "
              f"{int((diff.amax(-1) > 0).sum())}, visibility tests {tests}, "
              f"px with a winner {p_['covered']}")
        if p_["b1_err"] > (0 if key in SHADOWED else RGBA_TOL):
            raise SystemExit(f"B1 path {key}: the megakernel disagrees with its plain version")
        if key in SHADOWED:
            cube_reads, sun_reads = p_["shadow_reads"]
            print(f"B1 shadow lookups (path {key}): {cube_reads} cube texels and {sun_reads} sun "
                  f"texels read, table {k_['shadow_rows'].numel()} f32, spec "
                  f"{k_['shadow_spec']}")
            if cube_reads == 0 or sun_reads == 0:
                raise SystemExit(f"B1 path {key}: a shadow lookup read no texel")
        if key in GLASS:
            # what the new variants and passes do on this frame
            no_trans, _ = megakernel.mega_render(
                *a_, **dict(k_, shadow_spec=opaque_maps(k_["shadow_spec"])))
            srgb, _ = megakernel.mega_render(*a_, **dict(k_, tonemap=False))
            torch.cuda.synchronize()
            by_trans = int((no_trans != rgba_l).sum())
            by_tonemap = int((srgb != rgba_l).sum())
            sky_px = int((z_l >= 1.0).sum())
            layers = opacity_layers(fa_["d3_op"], fa_["atlas"], fa_["uniforms"], W, H,
                                    fa_["sample_mode"], fa_["transparency_layers"])
            glass_px = [int(((zo < 1.0) & (z_l > zo)).sum()) for _c, zo in layers]
            p_["sky_px"], p_["glass_px"] = sky_px, glass_px
            print(f"path {key}: {p_['trans_steps']} transmittance layer steps read; px changed "
                  f"by the transmittance {by_trans}, by the tonemap {by_tonemap}; px the sky "
                  f"miss pass paints (z_eff 1) {sky_px}; px of each opacity layer in front "
                  f"of the opaque frame {glass_px}")
            if not (p_["trans_steps"] and by_trans and by_tonemap > W * H // 20
                    and sky_px > W * H // 50 and min(glass_px) > 0):
                raise SystemExit(f"path {key}: a new variant or pass did nothing")
        if key in ("F", "G", "I"):
            continue
        kin_ = reflection_kernel_inputs(r_, fi_, scale=fa_["refl_scale"], sky=key == "D")
        z2_, i2_, _h2 = visibility_pallas.visibility_pass_pallas(*kin_["b2_in"])
        z2p_, i2p_, _h2p = visibility_pallas.visibility_pass_pallas_reference(*kin_["b2_in"])
        torch.cuda.synchronize()
        print(f"B2 vs plain (path {key} pre-pass): idx px differing {int((i2_ != i2p_).sum())}, "
              f"z px differing {int((z2_ != z2p_).sum())}")
        if not (torch.equal(i2_, i2p_) and torch.equal(z2_, z2p_)):
            raise SystemExit(f"B2 path {key}: the visibility kernel disagrees with its plain "
                             "version")
        if key == "C":
            continue
        p_["kin"] = kin_
        b3_in_ = kin_["b3_in"]
        prep_k_ = rt_kernel.rt_prepare_cuda(*b3_in_)
        prep_p_ = rt_kernel.rt_prepare(*b3_in_)
        t3_, i3_ = rt_kernel.intersect_rays_pallas(*b3_in_)
        t3p_, i3p_, work_ = rt_kernel.intersect_rays_pallas_reference(*b3_in_, return_work=True)
        torch.cuda.synchronize()
        bad_ = [k for k in ("boxes", "tnear", "slist", "tab", "cbox", "tcap")
                if not torch.equal(prep_k_[k], prep_p_[k])]
        p_["prep"], p_["b3_work"], p_["b3_out"] = prep_k_, work_, (t3_, i3_)
        print(f"B3 vs plain (path {key}, {b3_in_[-1]}x{b3_in_[-2]} rays, "
              f"{int(kin_['rays']['live' if key == 'D' else 'ok'].sum())} cast): preparation "
              f"{'equal' if not bad_ else 'DIFFERS in ' + ', '.join(bad_)}; walk idx rays "
              f"differing {int((i3_ != i3p_).sum())}, t rays differing "
              f"{int(((t3_ != t3p_) & ~(torch.isinf(t3_) & torch.isinf(t3p_))).sum())}, "
              f"hits {int((i3_ >= 0).sum())}, work {work_}")
        if bad_ or not (torch.equal(i3_, i3p_) and torch.equal(t3_, t3p_)):
            raise SystemExit(f"B3 path {key}: a ray kernel disagrees with its plain version")

    phase("6")
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
    for key, (label, build) in later.items():
        sw, sh = (SMALL_W // 2, SMALL_H // 2) if key == "F" else (SMALL_W, SMALL_H)
        small = []
        for dev in ("cuda", "cpu"):
            r, s, a = build(sw, sh, device=dev)
            small.append(r.rasterize(s, sw, sh, 40, a).astype(np.int32))
        d = np.abs(small[0] - small[1]).max(-1)
        print(f"cuda vs cpu path {key} frame at {sw}x{sh}: max diff {int(d.max())}, "
              f"px differing {int((d > 0).sum())} (pinned {SMALL_PINNED[key]})")
        if d.max() > RGBA_TOL or int((d > 0).sum()) != SMALL_PINNED[key]:
            raise SystemExit(f"the CUDA path {key} frame disagrees with the CPU frame")

    phase("7")
    # 7. steady-state times (the rasterize figures include their host work)
    frame_t = cuda_times(lambda: rast.rasterize(scene, W, H, 40, assets, readback=False), 40)
    frame_r_t = cuda_times(
        lambda: rast_r.rasterize(scene_r, W, H, 40, assets_r, readback=False), 20)
    b1_t = cuda_times(lambda: megakernel.mega_render(*args, **kwargs), 40)
    b1_plain_t = cuda_times(lambda: megakernel.mega_render_reference(*args, **kwargs), 3, warmup=1)
    ggx_t = cuda_times(lambda: megakernel.mega_render(*gargs, **gkwargs), 40)
    ggx_plain_t = cuda_times(lambda: megakernel.mega_render_reference(*gargs, **gkwargs), 3,
                             warmup=1)
    b2_t = cuda_times(lambda: visibility_pallas.visibility_pass_pallas(*b2_in), 40)
    b2_plain_t = cuda_times(lambda: visibility_pallas.visibility_pass_pallas_reference(*b2_in), 3,
                            warmup=1)
    b3_t = cuda_times(lambda: rt_kernel.intersect_rays_pallas(*b3_in), 40)
    b3_plain_t = cuda_times(lambda: rt_kernel.intersect_rays_pallas_reference(*b3_in), 2,
                            warmup=1)
    prep_t = cuda_times(lambda: rt_kernel.rt_prepare_cuda(*b3_in), 40)
    prep_plain_t = cuda_times(lambda: rt_kernel.rt_prepare(*b3_in), 10)
    fields = rt_kernel._ray_fields(*b3_in[2:8])
    walk_t = cuda_times(lambda: rt_kernel._launch(prep_k, fields), 40)
    # the sort's yardstick: one torch.sort of the same keys (the port does
    # not call it on this path)
    keys = torch.empty_like(prep_k["tnear"]).scatter_(1, prep_k["slist"].long(), prep_k["tnear"])
    sort_t = cuda_times(lambda: torch.sort(keys, dim=1, stable=True), 40)
    # B1's kernel alone (inputs prepared once) at the three cuts
    cut_t = {}
    for label, (a_, k_) in (("opaque", (args, kwargs)), ("ggx", (gargs, gkwargs))):
        for cut in (0, 1, 2):
            cut_t[label, cut] = median(cuda_times(
                megakernel.prepare_launch(*a_, **k_, stage_cut=cut), 100))
    # the kernel's fixed cost (no super scanned: s_near below every 1/z)
    no_scan = dict(kwargs, s_near=torch.full_like(kwargs["s_near"], -1e30))
    no_scan_t = median(cuda_times(megakernel.prepare_launch(*args, **no_scan, stage_cut=1), 100))
    print(f"rasterize(readback=False) opaque {W}x{H}: {summary(frame_t)} on {gpu}")
    print(f"rasterize(readback=False) GGX reflections {W}x{H}: {summary(frame_r_t)} on {gpu}")
    print(f"B1 mega_render (opaque map): {summary(b1_t)} on {gpu}")
    print(f"plain mega_render_reference (opaque map): {summary(b1_plain_t)} on {gpu}")
    print(f"B1 mega_render brdf_ggx (reflection map): {summary(ggx_t)} on {gpu}")
    print(f"plain mega_render_reference brdf_ggx (reflection map): {summary(ggx_plain_t)} "
          f"on {gpu}")
    print(f"B2 visibility_pass_pallas: {summary(b2_t)} on {gpu}")
    print(f"plain visibility_pass_pallas_reference: {summary(b2_plain_t)} on {gpu}")
    print(f"B3 intersect_rays_pallas: {summary(b3_t)} on {gpu}")
    print(f"plain intersect_rays_pallas_reference: {summary(b3_plain_t)} on {gpu}")
    print(f"B3 walk kernel alone (prepared inputs): {summary(walk_t)} on {gpu}")
    print(f"B3 preparation rt_prepare_cuda (scene tables in torch + kernel): {summary(prep_t)} "
          f"on {gpu}")
    print(f"plain rt_prepare: {summary(prep_plain_t)} on {gpu}")
    print(f"torch.sort of the same keys (stable): {summary(sort_t)} on {gpu}")
    print(f"B1 kernel alone (opaque map inputs), no super scanned (set-up, copies and writes "
          f"only, stage_cut 1): {no_scan_t:.4f} ms (median of 100) on {gpu}")
    for label in ("opaque", "ggx"):
        c0, c1, c2 = (cut_t[label, c] for c in (0, 1, 2))
        print(f"B1 kernel alone ({label} map inputs), "
              f"stage_cut 0 / 1 / 2: {c0:.4f} / {c1:.4f} / {c2:.4f} ms -> scan {c1:.4f}, "
              f"interpolation + texel {c2 - c1:.4f}, lighting + fog + pack {c0 - c2:.4f} ms "
              f"(medians of 100) on {gpu}")
    frame_ms, frame_r_ms = median(frame_t), median(frame_r_t)
    # the later paths: frames, B1 (wrapper, plain, alone; C also without its
    # AO factor), the sky rays' and the 960x540 rays' walk and preparation
    # alone, the AO pass in plain torch
    for key, p_ in paths.items():
        r_, s_, as_ = p_["rast"], p_["scene"], p_["assets"]
        a_, k_ = p_["mega"]
        p_["frame_t"] = cuda_times(lambda: r_.rasterize(s_, W, H, 40, as_, readback=False), 20)
        p_["b1_t"] = cuda_times(lambda: megakernel.mega_render(*a_, **k_), 40)
        p_["b1_plain_t"] = cuda_times(lambda: megakernel.mega_render_reference(*a_, **k_), 3,
                                      warmup=1)
        p_["alone"] = median(cuda_times(megakernel.prepare_launch(*a_, **k_), 100))
        print(f"rasterize(readback=False) path {key} ({p_['label']}) {W}x{H}: "
              f"{summary(p_['frame_t'])} on {gpu}")
        print(f"B1 mega_render path {key}: {summary(p_['b1_t'])}; plain "
              f"{summary(p_['b1_plain_t'])}; kernel alone {p_['alone']:.4f} ms (median of 100) "
              f"on {gpu}")
        if "kin" in p_:
            b3_in_, prep_k_ = p_["kin"]["b3_in"], p_["prep"]
            fields_ = rt_kernel._ray_fields(*b3_in_[2:8])
            p_["walk_t"] = cuda_times(lambda: rt_kernel._launch(prep_k_, fields_), 40)
            p_["prep_t"] = cuda_times(lambda: rt_kernel.rt_prepare_cuda(*b3_in_), 40)
            p_["b3_t"] = cuda_times(lambda: rt_kernel.intersect_rays_pallas(*b3_in_), 40)
            p_["b3_plain_t"] = cuda_times(
                lambda: rt_kernel.intersect_rays_pallas_reference(*b3_in_), 2, warmup=1)
            print(f"B3 path {key} ({b3_in_[-1]}x{b3_in_[-2]} rays): walk alone "
                  f"{summary(p_['walk_t'])}; rt_prepare_cuda {summary(p_['prep_t'])}; "
                  f"intersect_rays_pallas {summary(p_['b3_t'])}; plain "
                  f"{summary(p_['b3_plain_t'])} on {gpu}")
    # G: B1 alone on the same inputs without the shadow table (the lookup's
    # own cost), and the bake apart from the steady frames
    a_g, k_g = paths["G"]["mega"]
    no_shadow_alone = median(cuda_times(
        megakernel.prepare_launch(*a_g, **dict(k_g, shadow_rows=None, shadow_spec=None)), 100))
    print(f"B1 kernel alone on the shadowed map's inputs (stage_cut 0): with the shadow table "
          f"{paths['G']['alone']:.4f} ms, without {no_shadow_alone:.4f} ms (medians of 100) "
          f"on {gpu}")
    # I: B1 alone with and without each of its new variants
    a_i, k_i = paths["I"]["mega"]
    variants_i = {"both": k_i, "without the tonemap": dict(k_i, tonemap=False),
                  "without the transmittance": dict(k_i, shadow_spec=opaque_maps(
                      k_i["shadow_spec"])),
                  "without either": dict(k_i, tonemap=False,
                                         shadow_spec=opaque_maps(k_i["shadow_spec"]))}
    alone_i = {name: median(cuda_times(megakernel.prepare_launch(*a_i, **kw), 100))
               for name, kw in variants_i.items()}
    print("B1 kernel alone on the glazed map's inputs (stage_cut 0): "
          + ", ".join(f"{name} {ms:.4f} ms" for name, ms in alone_i.items())
          + f" (medians of 100) on {gpu}")
    for key in SHADOWED:
        p_ = paths[key]
        if key in ("H", "J"):  # the maps of G and I again: the first frame only
            print(f"first frame (path {key}, with the bake of path "
                  f"{ {'H': 'G', 'J': 'I'}[key]}'s maps): {p_['first_ms']:.4f} ms of wall time "
                  f"on {gpu}")
            continue
        bake = bake_call(p_["rast"], shadow)
        if not torch.equal(bake()[0], p_["rast"].frame_args["shadow_rows"]):
            raise SystemExit(f"path {key}: the bake timed here is not the frame's bake")
        n_bake = 1 if key in GLASS else 2
        p_["bake_ms"] = wall_ms(bake, n_bake)
        bake_prof = profile_calls(bake, 1, host_records=False)
        bake_dev = ("device time not measured" if bake_prof is None else
                    f"device {bake_prof['device_ms']:.4f} ms in {bake_prof['ops']:.1f} device ops")
        layers_txt = (", with 4 transmittance layers a map (1 + 4 peels a camera)"
                      if key in GLASS else "")
        print(f"shadow bake (path {key}, plain torch, 25 depth renders{layers_txt}): first frame "
              f"{p_['first_ms']:.4f} ms of wall time with the bake; bake alone median "
              f"{p_['bake_ms']:.4f} ms of wall time (n={n_bake}), {bake_dev} on {gpu}")
    a_c, k_c = paths["C"]["mega"]
    no_ao_alone = median(cuda_times(
        megakernel.prepare_launch(*a_c, **dict(k_c, ao_img=None)), 100))
    print(f"B1 kernel alone on the AO map's inputs (stage_cut 0): with ao_img "
          f"{paths['C']['alone']:.4f} ms, without {no_ao_alone:.4f} ms (medians of 100) on {gpu}")
    fa_c = paths["C"]["rast"].frame_args

    def run_ssao():
        return ambient_occlusion(paths["C"]["pre"], fa_c["uniforms"], H, fa_c["ao_taps"])

    ssao_t = cuda_times(run_ssao, 40)
    ssao_prof = profile_calls(run_ssao, 20)
    ssao_dev = ("device time not measured" if ssao_prof is None else
                f"device {ssao_prof['device_ms']:.4f} ms in {ssao_prof['ops']:.1f} device ops")
    print(f"ssao_pass (plain torch, {len(fa_c['ao_taps'])} taps, {W}x{H}): {summary(ssao_t)}; "
          f"{ssao_dev} per call on {gpu}")

    phase("8")
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
    # I's plain passes after B1: the layer loop (a setup pass of the opacity
    # pack, a visibility pass and _shade_opacity a layer) and the sky miss
    # pass, each as host wall, events and profiler
    fa_i = paths["I"]["rast"].frame_args
    frame_i = torch.rand((H, W, 4), device="cuda")
    z_i = megakernel.mega_render(*a_i, **k_i)[1]
    glass_steps = {
        "layer loop": lambda: opacity_layers(fa_i["d3_op"], fa_i["atlas"], fa_i["uniforms"], W, H,
                                             fa_i["sample_mode"], fa_i["transparency_layers"]),
        "sky_miss_pass": lambda: sky_miss_pass(frame_i, z_i, fa_i["sky_pre"], fa_i["uniforms"],
                                               W, H),
    }
    for name, fn in glass_steps.items():
        wall = wall_ms(fn, 5)
        ev = cuda_times(fn, 5, warmup=1)
        prof = profile_calls(fn, 2)
        dev = ("device time not measured" if prof is None else
               f"device {prof['device_ms']:.4f} ms in {prof['ops']:.1f} device ops")
        print(f"step path I {name} (plain torch, {W}x{H}): wall median {wall:.4f} ms (n=5), "
              f"events {summary(ev)}, {dev} per call on {gpu}")

    # device time per frame under torch.profiler; the busy share's
    # denominator is the unprofiled frame median above (same run)
    n_prof = 10
    dev_a = report_profile(
        f"opaque rasterize(readback=False) x{n_prof}",
        profile_calls(lambda: rast.rasterize(scene, W, H, 40, assets, readback=False), n_prof),
        frame_ms, gpu, {"B1": "mega_kernel"})
    dev_b = report_profile(
        f"reflection rasterize(readback=False) x{n_prof}",
        profile_calls(lambda: rast_r.rasterize(scene_r, W, H, 40, assets_r, readback=False),
                      n_prof),
        frame_r_ms, gpu, {"B1": "mega_kernel", "B2": "visibility_kernel", "B3": "rt_kernel",
                          "B3prep": "rt_prepare_kernel"})

    path_kernels = {"C": {"B1": "mega_kernel", "B2": "visibility_kernel"},
                    "D": {"B1": "mega_kernel", "B2": "visibility_kernel", "B3": "rt_kernel",
                          "B3prep": "rt_prepare_kernel"},
                    "F": {"B1": "mega_kernel"}}
    path_kernels["E"] = path_kernels["H"] = path_kernels["D"]
    path_kernels["G"] = path_kernels["I"] = path_kernels["F"]
    path_kernels["J"] = {"B1": "mega_kernel", "B2": "visibility_kernel",
                         "B3": ("rt_kernel", 3), "B3prep": ("rt_prepare_kernel", 3)}
    for key, p_ in paths.items():
        r_, s_, as_ = p_["rast"], p_["scene"], p_["assets"]
        n_key = N_PROF_GLASS if key in GLASS else n_prof
        p_["dev"] = report_profile(
            f"path {key} rasterize(readback=False) x{n_key}",
            profile_calls(lambda: r_.rasterize(s_, W, H, 40, as_, readback=False), n_key),
            median(p_["frame_t"]), gpu, path_kernels[key])

    phase("9")
    # 9. what each kernel takes on the card (registers a thread, shared
    # memory a block, blocks an SM holds at once: occupancy API)
    ns = fi["vis_s"].shape[0] // 128
    n_occ = int(args[8].shape[0])
    res = {
        "B1": _cuda.resources("mega", ns, len(kwargs["light_spec"]), n_occ),
        "B2": _cuda.resources("visibility", ns),
        "B3": _cuda.resources("rt_walk"),
        "B3prep": _cuda.resources("rt_prepare", prep_k["ncells"]),
    }
    a_g, k_g = paths["G"]["mega"]
    res["B1 shadows (G)"] = _cuda.resources("mega", a_g[0].shape[0] // 128,
                                            len(k_g["light_spec"]), int(a_g[8].shape[0]))
    res["B1 glass (I)"] = _cuda.resources("mega", a_i[0].shape[0] // 128,
                                          len(k_i["light_spec"]), int(a_i[8].shape[0]))
    for key, r in res.items():
        warps = 32 if key == "B3" else 8  # B3's walk: 1024 threads a block, the others 256
        print(f"resources {key}: {r['registers']} registers, "
              f"{r['smem_static'] + r['smem_dynamic']} B shared memory a block, "
              f"{r['blocks_per_sm']} blocks of {warps * 32} threads an SM "
              f"({r['blocks_per_sm'] * warps} of 64 warps) on {gpu}")

    phase("10")
    # 10. bounds: each input read once and each output written once over the
    # memory rate, against the f32 operations this data needs over the f32
    # rate: visibility tests, B1's stages 2-6 per pixel with a winner (by
    # this frame's lights and BRDF), ray tests, the preparation's reductions
    # and keys. The 67 TFLOP/s peak counts a fused multiply-add as two
    # operations; these kernels execute unfused multiplies and adds for bit
    # parity, so half of that peak is the most they can reach. The published
    # peak stays the yardstick.
    b1_bytes = nbytes(*[a for a in args if isinstance(a, torch.Tensor)], rgba_k, z_k)
    b1_bounds = {}
    for label, k_, tests, n_cov in (("opaque", kwargs, b1_tests, covered["opaque map"]),
                                    ("ggx", gkwargs, ggx_tests, covered["reflection map"])):
        for cut in (0, 1, 2):
            ops = tests * OPS_PER_VIS_TEST + shade_ops(n_cov, cut, k_, n_occ, int(args[11]))
            b1_bounds[label, cut] = bound(b1_bytes, ops)
            ms, by = b1_bounds[label, cut]
            print(f"bound B1 {label} stage_cut={cut}: {b1_bytes} bytes, {ops} f32 ops "
                  f"({tests} tests, {n_cov} px shaded) -> {ms:.6f} ms, bound by {by}; "
                  f"kernel alone {cut_t[label, cut]:.4f} ms")
    b2_bytes = nbytes(*b2_in[:3], z2, i2)
    b2_bound = bound(b2_bytes, b2_tests * OPS_PER_VIS_TEST)
    b3_bytes = nbytes(*b3_in[:8], t3, i3)
    b3_ops = b3_work["ray_triangle"] * OPS_PER_MT_TEST + b3_work["ray_box"] * OPS_PER_SLAB_TEST
    b3_bound = bound(b3_bytes, b3_ops)
    prep_bytes = nbytes(*b3_in[2:8], prep_k["cbox"], prep_k["boxes"], prep_k["tnear"],
                        prep_k["slist"])
    prep_ops = H * W * OPS_PREP_PER_RAY + prep_k["tnear"].numel() * OPS_PREP_PER_KEY
    prep_bound = bound(prep_bytes, prep_ops)
    for key, (ms, by), nb, ops in (("B2", b2_bound, b2_bytes, b2_tests * OPS_PER_VIS_TEST),
                                   ("B3 walk", b3_bound, b3_bytes, b3_ops),
                                   ("B3 preparation", prep_bound, prep_bytes, prep_ops)):
        print(f"bound {key}: {nb} bytes, {ops} f32 ops -> {ms:.6f} ms, bound by {by}")
    print("bounds: 67 TFLOP/s counts an FMA as two operations; these kernels execute unfused "
          "multiplies and adds (-fmad=false, bit parity), so half of that peak is their ceiling")
    later_rows = []
    for key, name in (("C", "mega_render ao_img (AO map)"),
                      ("D", "mega_render ao_img (sky-light scene)"),
                      ("F", "mega_render 3840x2160 (SSAA2 map)"),
                      ("G", "mega_render shadows (shadowed map)"),
                      ("H", "mega_render brdf_ggx shadows (shadowed reflection map)"),
                      ("I", "mega_render shadows transmittance tonemap (glazed map)"),
                      ("J", "mega_render brdf_ggx shadows transmittance tonemap (glazed "
                            "reflection map)")):
        p_ = paths[key]
        a_, k_ = p_["mega"]
        n_occ_ = int(a_[8].shape[0])
        cube_reads, sun_reads = p_["shadow_reads"]
        ops = (p_["b1_tests"] * OPS_PER_VIS_TEST
               + shade_ops(p_["covered"], 0, k_, n_occ_, int(a_[11]))
               + cube_reads * OPS_CUBE_SHADOW + sun_reads * OPS_SUN_SHADOW
               + p_["trans_steps"] * OPS_TRANS_STEP
               + (p_["covered"] * OPS_TONEMAP_EXTRA if k_.get("tonemap") else 0))
        ms, by = bound(p_["b1_bytes"], ops)
        print(f"bound B1 path {key}: {p_['b1_bytes']} bytes, {ops} f32 ops "
              f"({p_['b1_tests']} tests, {p_['covered']} px shaded) -> {ms:.6f} ms, bound by {by}; "
              f"kernel alone {p_['alone']:.4f} ms")
        later_rows.append({
            "name": name, "route": "cuda", "source": "rusterix_tpu_torch/csrc/megakernel.cu",
            "replaces": "rusterix_tpu/ops/megakernel.py:250",
            "launches": p_["counts"]["B1"], "max_abs_err": p_["b1_err"],
            "ms": median(p_["b1_t"]), "plain_ms": median(p_["b1_plain_t"]),
            "bound_ms": ms, "bound_by": by, "library_ms": None,
            "device_ms": p_["dev"]["B1"], "alone_ms": p_["alone"],
            **_cuda.resources("mega", a_[0].shape[0] // 128, len(k_["light_spec"]), n_occ_),
        })
    for key, name in (("D", "intersect_rays_pallas (sky rays)"),
                      ("E", "intersect_rays_pallas (960x540 reflection rays)"),
                      ("J", "intersect_rays_pallas (glazed reflection map, the opaque "
                            "frame's rays; 3 launches a frame)")):
        p_ = paths[key]
        b3_in_, (t3_, i3_), work_ = p_["kin"]["b3_in"], p_["b3_out"], p_["b3_work"]
        nb = nbytes(*b3_in_[:8], t3_, i3_)
        ops = work_["ray_triangle"] * OPS_PER_MT_TEST + work_["ray_box"] * OPS_PER_SLAB_TEST
        ms, by = bound(nb, ops)
        print(f"bound B3 walk path {key}: {nb} bytes, {ops} f32 ops -> {ms:.6f} ms, bound by {by}")
        later_rows.append({
            "name": name, "route": "cuda", "source": "rusterix_tpu_torch/csrc/rt_kernel.cu",
            "replaces": "rusterix_tpu/ops/rt_kernel.py:79",
            "launches": p_["counts"]["B3"], "max_abs_err": 0.0,
            "ms": median(p_["b3_t"]), "plain_ms": median(p_["b3_plain_t"]),
            "bound_ms": ms, "bound_by": by, "library_ms": None,
            "device_ms": p_["dev"]["B3"], "alone_ms": median(p_["walk_t"]), **res["B3"],
        })
    # B1 has one entry per main path: each launch with its own frame's
    # inputs, times, bound and profile
    b1_rows = (
        ("mega_render (opaque map)", "opaque", counts_a["B1"], b1_err, b1_t, b1_plain_t, dev_a),
        ("mega_render brdf_ggx (reflection map)", "ggx", counts_b["B1"], ggx_err, ggx_t,
         ggx_plain_t, dev_b),
    )
    kernels = [
        {
            "name": name, "route": "cuda",
            "source": "rusterix_tpu_torch/csrc/megakernel.cu",
            "replaces": "rusterix_tpu/ops/megakernel.py:250",
            "launches": n, "max_abs_err": err,
            "ms": median(t), "plain_ms": median(plain_t),
            "bound_ms": b1_bounds[label, 0][0], "bound_by": b1_bounds[label, 0][1],
            "library_ms": None, "device_ms": dev["B1"], "alone_ms": cut_t[label, 0],
            **res["B1"],
        }
        for name, label, n, err, t, plain_t, dev in b1_rows
    ] + [
        {
            "name": "visibility_pass_pallas", "route": "cuda",
            "source": "rusterix_tpu_torch/csrc/visibility.cu",
            "replaces": "rusterix_tpu/ops/visibility_pallas.py:42",
            "launches": launches["B2"], "max_abs_err": b2_err,
            "ms": median(b2_t), "plain_ms": median(b2_plain_t),
            "bound_ms": b2_bound[0], "bound_by": b2_bound[1], "library_ms": None,
            "device_ms": dev_b["B2"], **res["B2"],
        },
        {
            "name": "intersect_rays_pallas", "route": "cuda",
            "source": "rusterix_tpu_torch/csrc/rt_kernel.cu",
            "replaces": "rusterix_tpu/ops/rt_kernel.py:79",
            "launches": launches["B3"], "max_abs_err": b3_err,
            "ms": median(b3_t), "plain_ms": median(b3_plain_t),
            "bound_ms": b3_bound[0], "bound_by": b3_bound[1], "library_ms": None,
            "device_ms": dev_b["B3"], "alone_ms": median(walk_t), **res["B3"],
        },
        {
            "name": "rt_prepare_cuda", "route": "cuda",
            "source": "rusterix_tpu_torch/csrc/rt_kernel.cu",
            "replaces": "rusterix_tpu/ops/rt_kernel.py:286-354",
            "launches": launches["B3prep"], "max_abs_err": prep_err,
            "ms": median(prep_t), "plain_ms": median(prep_plain_t),
            "bound_ms": prep_bound[0], "bound_by": prep_bound[1],
            "library_ms": median(sort_t),
            "device_ms": dev_b["B3prep"], **res["B3prep"],
        },
    ] + later_rows
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the build to the last check")
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

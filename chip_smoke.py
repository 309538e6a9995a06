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
rays and on each layer's); K, the map with closed doorways and vertex-
blended floors (B1's has_blend variant); L, K with a sun, GGX and one
reflection ray per pixel (B1's GGX and has_blend variants, B2, the
G-buffer's blend branch, B3); M, the bench's cube at 800x600 (B1, then
the 2D pass over the bench's 2D rectangle); N, the 2D map view of K's map
(the 3D pass off: B1 over no candidate, then the 2D pass's ~800 triangle
steps lit by the map's lights with its walls blocking them); O, the bench's
shaded cube at 800x600 (a rusteria wood shader baked at pack time on the
card, B1's has_material variant); P, the cube under the bench's
time-dependent shader (16 baked animation frames, two of them rendered);
Q, the map under per-pixel shader materials with a sun, GGX and one
reflection ray per pixel (B1's has_material + has_matmap variant with GGX,
B2, the G-buffer's matmap branch, B3); R, A's map row-sharded through
`rasterize(mesh=make_mesh(8, "cuda"))` (8 slabs of 135 rows on the card:
B1 at its row offset once a slab), with a frame in 7 slabs (the padded
overhang) and a `render_frame_sharded` call with the generic light loop
(`light_spec=None`); S, H with AO and sky light in 8 slabs (B1 GGX with
shadows and the AO factor at its row offset, B2 at its row offset, B3 for
each slab's reflection and sky rays); T, the map with floors under a
runtime rusteria shader that reads the texel's colour and the hit point
(the split path: the setup pass, `morton_sort`, B2 over the Morton-ordered
candidates, `shade_pass` with `Program.shade` on the frame's registers,
`compose_opaque`; no B1); U, T with a sun, GGX, one reflection ray a
pixel, shadow maps, AO and sky light (B2 once, B3 for the reflection and
sky rays, the G-buffer's shader branch); V, the shadowed map with dynamic
batches (an opaque and a translucent billboard and a 2D rectangle, moved
before every frame, packed per frame and concatenated after the static
pack: B1 over the concatenated pack) with dynamic casters (their depth
composited into the cached maps each frame); W, the bench's cube with a
runtime 2D shader on its rectangle (800x600: B2, shade_pass, the 2D
pass's shader branch); one sharded frame each of I, M and T (T8); and at
256x128 only, I with a runtime shader on its glass (Ig: each peeled layer
shaded); then the engine loop and the path tracer (engine_paths): X, the
minigame world through the Rusterix facade at 640x400 (server tick, entity
mirror, billboards, client.draw_d3: B1 over the static pack and the
monster's billboard; device-only frames by CUDA events beside host-synced
frames and the host tick alone; the 160x120 frame after seeded ticks
byte-equal to the CPU's); Y, the path tracer on the bench's scene at
320x240 and 800x600 (samples a second, device time, peak memory; the
64x48 buffer after 2 samples held to the CPU's); Z, the facade's
trace_scene on the minigame world, trace_sharded over a mesh of 4
byte-equal to 4 trace() calls, and draw_scene's 2D view; Bl and Blg,
path B with B3's preparation sent through its cluster route
(rt_prepare_cluster_kernel, the route of scenes above
rt_kernel.PREPARE_MAX_CELLS) and its global route (rt_prepare_large_boxes,
_count and four passes of rt_prepare_large_kernel, above
rt_kernel.CLUSTER_MAX_CELLS), byte-equal to path B's frame; HG,
the huge scene of tools/bench_huge.py (scenes.build_huge_scene: 10,600
boxes, 131,072 slots) opaque at 1920x1080 (B1), and HGR, HG with GGX
reflections (B1's GGX variant, B2, B3's walk and its cluster preparation
over 2,048 cells), their B1, B2 and walk held to the plain versions on a
band of rows and their small frames taken on the scene cut to 300 boxes;
C12,
both routes alone on 1080p rays over 28,700 cells (keys that all tie, and
keys that spread) against rt_prepare and torch.sort, with their bound; GL,
the global route at its own size (1080p rays over 131,072 cells, the limits
as they stand) the same way; and the sweep, every preparation route at 32
to 106,496 cells beside torch.sort.
Every unsharded frame sends its per-frame leaves to the card in one copy
(ops/arena.py): phase 4h counts the host-to-device copies of a steady
frame of every path where PyTorch dispatches them (HostCopies; A's also by
the profiler's Memcpy HtoD records), one on A, B, G, K, X's draw_d3, HG
and HGR or the run fails, the others printed; checks
that each went through the arena, and prints profiling.frame_breakdown of
A (and of HG in its phase).
The sharded frames are held to the single frames: equal but for the
pinned pixels of the tie class (tie_pixels: two candidates
tie on 1/z bit for bit and a slab's scan order keeps another). For
each path it checks that the frame went through exactly
the kernels of the path (launch counts zeroed before it and read right
after it),
holds every kernel against its plain torch version on the frame's own
inputs (B1 also at the profiling cuts stage_cut 1 and 2; with shadows and
on K-N bit for bit), checks the CUDA
frames against the CPU frames at a small size, times the frames, the
kernels and the plain versions with CUDA events (B1's kernel alone at
stage_cut 0, 1 and 2, which splits its time into the scan, the texel stage
and the lighting; on G with and without the shadow table; on I with and
without each of its variants; on K with and without has_blend), times the
shadow bake apart from the steady frames, and breaks the frames down: host
wall time per step (on I also the layer loop and the sky miss pass), and
under torch.profiler the device time, device ops, busy share and each
kernel's device time per frame (on T also its split path step by step:
the setup and sort, B2, shade_pass and the shader's evaluation alone). It
prints each kernel's registers, shared
memory and resident blocks an SM, and its bound. Every phase raises on
failure; nothing falls back to the CPU or to a plain version. The last line
is the JSON result; it is printed only when every phase passed. Imports no
jax.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

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
    "K": {"B1": 1, "B2": 0, "B3": 0, "B3prep": 0},
    "L": {"B1": 1, "B2": 1, "B3": 1, "B3prep": 1},
    # the 2D pass is plain torch (XLA code in the JAX package); N's 3D pass
    # is off, and B1 still composes the (empty) opaque frame, as in the JAX
    # package
    "M": {"B1": 1, "B2": 0, "B3": 0, "B3prep": 0},
    "N": {"B1": 1, "B2": 0, "B3": 0, "B3prep": 0},
    # the baked shaders: the bakes launch none of the kernels
    "O": {"B1": 1, "B2": 0, "B3": 0, "B3prep": 0},
    "P": {"B1": 1, "B2": 0, "B3": 0, "B3prep": 0},
    "Q": {"B1": 1, "B2": 1, "B3": 1, "B3prep": 1},
    # the row-sharded paths, a frame in N_SLABS slabs: B1 (and with S, B2)
    # once a slab, B3 and its preparation twice a slab (reflection and sky
    # rays)
    "R": {"B1": 8, "B2": 0, "B3": 0, "B3prep": 0},
    "R7": {"B1": 7, "B2": 0, "B3": 0, "B3prep": 0},
    "S": {"B1": 8, "B2": 8, "B3": 16, "B3prep": 16},
    "I8": {"B1": 8, "B2": 0, "B3": 0, "B3prep": 0},
    "M8": {"B1": 8, "B2": 0, "B3": 0, "B3prep": 0},
    # runtime shaders take the split path: B2 over the Morton-ordered
    # candidates, then plain torch (shade_pass, Program.shade), no B1; U's
    # one B2 feeds the AO, the shading, the reflection and sky rays (B3 and
    # its preparation twice)
    "T": {"B1": 0, "B2": 1, "B3": 0, "B3prep": 0},
    "U": {"B1": 0, "B2": 1, "B3": 2, "B3prep": 2},
    "W": {"B1": 0, "B2": 1, "B3": 0, "B3prep": 0},
    "T8": {"B1": 0, "B2": 8, "B3": 0, "B3prep": 0},
    # dynamic batches: B1 over the concatenated pack
    "V": {"B1": 1, "B2": 0, "B3": 0, "B3prep": 0},
}
# no path but Bl and Blg (engine_paths) takes the cluster (B3prepC) or the
# global (B3prepL) preparation route
EXPECTED_LAUNCHES = {k: dict(v, B3prepC=0, B3prepL=0) for k, v in EXPECTED_LAUNCHES.items()}
# slabs of the sharded paths (one card), and the slab whose inputs the
# kernels are held on
N_SLABS = 8
MID_SLAB = N_SLABS // 2
# pixels where a sharded frame differs from its single frame; every one of
# them must be of the tie class (tie_pixels)
SHARDED_PINNED = {"R": 0, "R7": 55, "S": 0, "I8": 3100, "M8": 0, "T8": 0}
# the frame size of a path where it is not 1920x1080 (M, O, P, W: the bench's cubes)
# the later paths at 1920x1080 (but SIZES): label, scenes.py builder
LATER = {
    "C": ("AO map", "build_map_ao_scene"),
    "D": ("sky-light floor scene with AO", "build_sky_light_scene"),
    "E": ("GGX reflection map, reflections at half scale", "build_map_refl_half_scene"),
    "F": ("SSAA2 map, 3840x2160 inside", "build_map_ssaa2_scene"),
    "G": ("shadowed map", "build_map_shadow_scene"),
    "H": ("shadowed GGX reflection map", "build_map_shadow_refl_scene"),
    "I": ("glazed map under the sky, two layers, scenevm tonemap", "build_map_glass_scene"),
    "J": ("glazed map under the sky with GGX reflections", "build_map_glass_refl_scene"),
    "K": ("map with vertex-blended floors", "build_map_blend_scene"),
    "L": ("blended map with GGX reflections", "build_map_blend_refl_scene"),
    "M": ("the bench's cube with its 2D rectangle, 800x600", "build_cube_scene"),
    "N": ("2D map view, 3D off", "build_map_2d_scene"),
    "O": ("the bench's shaded cube (a baked wood shader), 800x600", "build_cube_shaded_scene"),
    "P": ("the bench's cube under a time-dependent shader, 800x600",
          "build_cube_timeshader_scene"),
    "Q": ("the map under per-pixel shader materials with GGX reflections",
          "build_map_material_scene"),
    "T": ("the map with floors under a runtime shader (the split path)",
          "build_map_runtime_shader_scene"),
    "U": ("T with a sun, GGX, one reflection ray a pixel, shadow maps, AO and sky light",
          "build_map_runtime_shader_refl_scene"),
    "V": ("the shadowed map with dynamic billboards, a dynamic 2D rectangle and dynamic "
          "casters", "build_map_dynamic_scene"),
    "W": ("the bench's cube with a runtime 2D shader on its rectangle, 800x600",
          "build_cube_2d_shader_scene"),
}
# the paths whose steady frame must make exactly one host-to-device copy
# (the arena's; X: Client.draw_d3's)
ONE_COPY = ("A", "B", "G", "K", "X", "HG", "HGR")
SIZES = {"M": (800, 600), "O": (800, 600), "P": (800, 600), "W": (800, 600)}
# the split paths (runtime shaders): B2 on the Morton order bit for bit
SPLIT = ("T", "U", "W")
# the paths whose first frame bakes shadow maps but that are not B1's
# shadow paths above: U (split), V (its maps take the dynamic casters every
# frame)
BAKED_FIRST = ("U", "V")
# V's dynamic batches at frame time t (scenes.move_dynamic): the first frame,
# the counted frame, and a third; its timed frames walk on from there
V_TIMES = (0.0, 0.5, 1.0)
# the slice's paths: B1 equals its plain version bit for bit at stage_cut 0,
# 1 and 2 on their inputs
BLEND_2D = ("K", "L", "M", "N")
# the baked-shader paths: B1 bit for bit at stage_cut 0, 1 and 2 as well;
# their first frame packs the scene and bakes the shaders on the card
SHADED = ("O", "P", "Q")
# frames timed a later path where not 10: N's take ~2.7 s (the 2D pass is
# one torch step a triangle)
N_FRAMES = {"N": 3}
# frames profiled: 10 on A and B, 4 on the later paths, fewer on the slow
# ones (N's 158,773 device ops a frame take ~25 s a frame to read)
N_PROF_LATER = 4
N_PROF_2D = 3
N_PROF_N = 1
# the shadowed paths: B1 equals its plain version bit for bit, and their
# steady frames are counted after a first frame that bakes the maps
SHADOWED = ("G", "H", "I", "J")
# the paths with glass: their maps carry transmittance layers
GLASS = ("I", "J")
# frames profiled on the glass paths and V (8,000-23,000 device ops a
# frame: the profiler's records take longer to read than the frames)
N_PROF_GLASS = 2
# pixels where a later path's CUDA frame differs from its CPU frame at the
# small size (each within RGBA_TOL); see PERF.md
SMALL_PINNED = {k: 0 for k in "CDEFGHIJKLMNOPQTUVW"}
SMALL_PINNED["Ig"] = 0
# the small frames' shadow maps (cube faces, the sun's map): smaller than
# set_shadows' defaults, which take the CPU frames half a minute to bake
SMALL_SHADOW_RES = (32, 64)
# the CUDA bake against the CPU bake: at most this far apart in a texel byte
BAKE_TOL = 1
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
# the has_blend variant, per shaded pixel: a second texel (counted as the
# first: OPS_TEXEL_NEAREST, or with the bilinear extra), the weight plane
# (2 multiplies, 2 adds, the divide by 1/w; its clip is counted with the
# mix) and the mix (the gate, 1 - w, a multiply-add pair a channel); the
# table's 16 more floats a row are in its bytes
OPS_BLEND_WEIGHT = 5
OPS_BLEND_MIX = 8
# the has_material variant, per shaded pixel: the clipped roughness and
# metallic (4), F0 per channel (3 each), the largest F0 (2), the diffuse
# scale and albedo (3 + 3), the ambient scale and albedo (2 + 3), and with
# the fast BRDF the shininess (max, square, divide, subtract, clip: 6) or
# with GGX its constants (clip 2, square, square, add, square, multiply: 7);
# per BRDF call beyond the default material's: the Fresnel per channel (3
# more multiply-add pairs), and the fast BRDF's power exp2(s * log2(n.h))
# (max, log2 and exp2 at 8 each, a multiply, a compare and a select, less
# the three multiplies of n.h^6) or GGX's (1 - metallic) factor (2)
OPS_MATERIAL = 4 + 9 + 2 + 6 + 5
OPS_MATERIAL_CONST = {False: 6, True: 7}
OPS_MATERIAL_BRDF = {False: 6 + (1 + 8 + 8 + 1 + 2 - 3), True: 6 + 2}
# the has_matmap variant, per shaded pixel: two more texels (M1, M2: as the
# base texel), the normal decode (3 multiply-add pairs, a three-term dot 5,
# square root, compare, reciprocal, 3 multiplies), the replacement or the
# mix (3 selects, or 9 + dot 5 + square root + divide + 3 multiplies), the
# per-pixel roughness and metallic selects (2) and the emissive (a product,
# 3 multiplies and 3 adds)
OPS_MATMAP = 6 + 5 + 4 + 3 + 3 + 2 + 7
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


def timed_once(fn) -> tuple:
    """fn() once between two CUDA events -> (its result, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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
    when the profiler recorded no device activity, else "calls" (n), per
    call the device ms (the union of the device intervals: kernels, copies,
    memsets) and the device ops, and by name the total device ms and the
    number of records over all n calls. The profiler can lose records of a
    long run, so a reader that needs one kernel's time divides its total by
    its own count of records, not by n. Only the device activity is
    recorded: the host's operator records of a frame with thousands of ops
    take longer to read than the frame."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def b1_bytes(args, outs, work, extra=()) -> int:
    """The bytes one B1 call must move: each input read once, the atlas
    (args[4]) as the distinct texels this frame reads (4 bytes each, from
    the plain version's work counts), each output written once."""
    ins = [a for i, a in enumerate(args) if isinstance(a, torch.Tensor) and i != 4]
    return nbytes(*ins, *outs, *extra) + 4 * work["atlas_texels"]


def light_types(kwargs: dict, lights) -> list:
    """The type codes B1's light loop visits: light_spec's, or with the
    generic loop (light_spec None) every row of the packed light table
    `lights` (L, 24), typed by its one-hot columns as the kernel types it
    (3 point, 21 ambient, 22 spot, 23 area, none of them daylight)."""
    if kwargs["light_spec"] is not None:
        return [int(t) for _row, t in kwargs["light_spec"]]
    onehot = lights[:, [3, 21, 22, 23]].cpu().numpy() != 0
    return [(0, 1, 3, 4)[int(np.argmax(row))] if row.any() else 5 for row in onehot]


def shade_ops(covered: int, stage_cut: int, kwargs: dict, n_occ: int, sample_mode: int,
              lights=None) -> int:
    """f32 operations of B1's stages 2-6 for `covered` pixels with a winner,
    up to the stage the cut keeps, for this frame's lights (`lights`, the
    packed table, where light_spec is None), BRDF, sun and sampling
    mode."""
    if stage_cut == 1:
        return 0
    types = light_types(kwargs, lights)
    texel = OPS_TEXEL_NEAREST + (OPS_TEXEL_BILINEAR_EXTRA if sample_mode else 0)
    per_px = OPS_INTERP + texel
    if stage_cut == 0:
        brdf = OPS_BRDF[bool(kwargs.get("brdf_ggx", False))]
        per_px += OPS_SHADE_FIXED + OPS_PER_OCC_BOX * n_occ
        if not kwargs.get("sun_off", False):
            per_px += brdf + OPS_SUN_EXTRA
        per_px += sum(OPS_PER_LIGHT[t] + brdf for t in types)
        if kwargs.get("ao_img") is not None:
            per_px += OPS_AO
        if kwargs.get("has_material"):
            ggx = bool(kwargs.get("brdf_ggx", False))
            calls = len(types) + (0 if kwargs.get("sun_off", False) else 1)
            per_px += (OPS_MATERIAL + OPS_MATERIAL_CONST[ggx]
                       + calls * OPS_MATERIAL_BRDF[ggx])
        if kwargs.get("has_matmap"):
            per_px += 2 * texel + OPS_MATMAP
    if kwargs.get("has_blend"):
        per_px += texel + OPS_BLEND_WEIGHT + OPS_BLEND_MIX
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
                     fa["uniforms"], ws, hs, fa["sample_mode"],
                     has_blend=fa.get("has_blend", False),
                     has_material=fa.get("has_material", False),
                     has_matmap=fa.get("has_matmap", False), shaders=fa.get("shaders", ()),
                     stride=scale)
    rays = reflect.sky_rays(g, hit) if sky else reflect.reflection_rays(g, hit, ws, hs, 0, scale)
    b3_in = (fa["d3"]["pos"], fa["d3"]["valid"], rays["o_x"], rays["o_y"], rays["o_z"],
             rays["d_x"], rays["d_y"], rays["d_z"], float(fa["uniforms"]["refl_dist"]), hs, ws)
    return {"b2_in": (fi["vis_s"], fi["alive_s"], fi["bbox_s"], W, H), "pre": pre, "g": g,
            "rays": rays, "b3_in": b3_in}


def tie_pixels(mesh, d3, uniforms, atlas, width: int, height: int, has_blend: bool = False,
               **_frame):
    """The pixels where the sharded frame may differ from the single frame
    -> (H, W) bool on the mesh's first device: where two candidates tie on
    1/z bit for bit, the scan keeps the first in its order, and a slab's
    order (its supers sorted by the near bound over its own rows) can put
    another of them first than the whole frame's order does. Found as the
    pixels whose visibility pre-pass (B2) winner differs between the slab
    and the whole frame at an equal 1/z. Takes render_frame_sharded's
    arguments (the frame_args of the frame). The tests of the sharded
    frames use it too."""
    from rusterix_tpu_torch.ops.megakernel import morton_ftb_sort
    from rusterix_tpu_torch.ops.raster import visibility_prepass
    from rusterix_tpu_torch.ops.setup_pass import setup_pass
    from rusterix_tpu_torch.parallel import check_mesh

    mesh = check_mesh(mesh)
    dev = mesh[0]
    n = len(mesh)
    rows = -(-height // n)
    view = torch.from_numpy(np.asarray(uniforms["view"], np.float32)).to(dev)
    proj = torch.from_numpy(np.asarray(uniforms["proj"], np.float32)).to(dev)
    cap = int(d3["valid"].shape[0])
    # the slabs' candidates, padded to the mesh as render_frame_sharded pads
    # them; the whole frame's are the first 2 * cap slots
    pad = (-cap) % n
    d3 = {k: torch.cat([v.to(dev), v.new_zeros((pad,) + tuple(v.shape[1:])).to(dev)])
          for k, v in d3.items()}
    vis, _attr, bbox, alive, _tri = setup_pass(
        d3["pos"], d3["uv"], d3["nrm"], d3["valid"], d3["cull"], view, proj, width, height,
        bw=d3["bw"] if has_blend else None)

    def prepass(y0, n_rows, slots):
        vis_s, bbox_s, alive_s, _t, _sn, perm = morton_ftb_sort(
            vis[:slots], bbox[:slots], alive[:slots].float(), torch.zeros((slots, 4), device=dev),
            width, height, y0g=y0, rows_local=n_rows, return_perm=True)
        fi = {"vis_s": vis_s, "alive_s": alive_s, "bbox_s": bbox_s, "sort_perm": perm}
        return visibility_prepass(fi, width, n_rows, y0)

    z_w, idx_w, _hit = prepass(0, height, 2 * cap)
    out = []
    for k in range(n):
        y0 = k * rows
        n_rows = min(rows, height - y0)
        if n_rows <= 0:
            break
        z, idx, _hit = prepass(y0, rows, vis.shape[0])
        z, idx = z[:n_rows], idx[:n_rows]
        out.append((z == z_w[y0:y0 + n_rows]) & (idx != idx_w[y0:y0 + n_rows]))
    return torch.cat(out)


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


# X: the minigame loop (bench.py's minigame cell): frames after a warm-up,
# the size, and the small size whose CUDA frame is held to the CPU frame
def _counters() -> dict:
    from rusterix_tpu_torch.ops import megakernel, rt_kernel, visibility_pallas

    return {"B1": (megakernel, "launches"), "B2": (visibility_pallas, "launches"),
            "B3": (rt_kernel, "launches"), "B3prep": (rt_kernel, "prepare_launches"),
            "B3prepC": (rt_kernel, "prepare_cluster_launches"),
            "B3prepL": (rt_kernel, "prepare_large_launches")}


def zero_counts():
    """Every kernel's launch count to 0."""
    for mod, name in _counters().values():
        setattr(mod, name, 0)


def read_counts() -> dict:
    """Every kernel's launch count since zero_counts."""
    return {k: getattr(mod, name) for k, (mod, name) in _counters().items()}


def host_copies(fn) -> tuple:
    """The host-to-device copies one call of `fn` makes, counted where
    PyTorch dispatches them (HostCopies) -> (count, {op: count})."""
    counter = HostCopies()
    with counter:
        fn()
    torch.cuda.synchronize()
    return sum(counter.ops.values()), dict(counter.ops)


class HostCopies(TorchDispatchMode):
    """A `with` block whose `ops` counts, by op, what PyTorch dispatches
    inside it that moves host data to the card: a copy from a host tensor
    into a card tensor (the arena's pinned copy among them), a tensor made
    on the card from host data (torch.tensor(..., device=), dispatched as
    lift_fresh of its result), and any other op on the card that takes a
    host tensor of one or more dimensions (a list or array index, copied
    on the way); a 0-d host tensor elsewhere is a scalar argument."""

    COPIES = ("aten.copy_.default", "aten._to_copy.default", "aten._copy_from.default",
              "aten._copy_from_and_resize.default")

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(t.is_cuda for t in ins + outs):
            name = str(func)
            host = [t for t in ins if not t.is_cuda]
            if ((name == "aten.lift_fresh.default" and outs[0].is_cuda)
                    or any(t.dim() > 0 or name in self.COPIES for t in host)):
                self.ops[name] += 1
        return out


def h2d_copies(fn) -> int:
    """The host-to-device copies one call of `fn` makes: the profiler's
    Memcpy HtoD records (pageable and pinned). Raises when the profiler
    recorded no device activity (the count would not be measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise SystemExit("h2d_copies: the profiler recorded no device activity")
    return sum("HtoD" in e.name for e in events)


def arena_host_ms(rast) -> dict:
    """The arena's host work a frame on `rast`'s last frame, in host ms
    (wall_ms: synchronised), and the alternative it was chosen over:
    "derive", the packs B1 derives from the lights and uniforms built on
    the host (they join the arena); "pack_upload", pack_arena of the
    per-frame tree and its pinned copy enqueued; "derive_on_device", the
    same packs computed by torch ops from the arena's device views of the
    lights and uniforms instead (derived_on_device), "ops" the device ops
    that takes."""
    from rusterix_tpu_torch.ops import arena
    from rusterix_tpu_torch.ops.megakernel import light_param_rows, mega_param_row, occ_param_rows

    fa = rast.frame_args
    lights, uni = dict(fa["lights"]), dict(fa["uniforms"])

    def derive():
        return {"light_params": light_param_rows(lights), "occ_params": occ_param_rows(uni),
                "mega_params": mega_param_row(uni, fa["width"], fa["height"],
                                              fa["atlas"]["w"], fa["has_fog"], 0,
                                              fa["shadow_params"])}

    derived = derive()

    def pack_upload():
        words, _layout = arena.pack_arena((None, None, None, lights, uni, derived))
        arena.upload(words, rast.device)

    def on_device():
        return derived_on_device(fa["lights"].dev, fa["uniforms"].dev, fa, rast.device)

    got = on_device()
    same = [k for k, v in derived.items() if torch.equal(got[k].cpu(), torch.from_numpy(v))]
    prof = profile_calls(on_device, 3)
    return {"derive": wall_ms(derive), "pack_upload": wall_ms(pack_upload),
            "derive_on_device": wall_ms(on_device),
            "ops": None if prof is None else prof["ops"], "bit_equal": same}


def derived_on_device(lv: dict, uv: dict, fa: dict, dev) -> dict:
    """megakernel.light_param_rows, occ_param_rows and mega_param_row (at
    row 0) computed on the device from the lights' and uniforms' device
    views `lv`, `uv`: the alternative to deriving them on the host that
    arena_host_ms times."""
    f32 = torch.float32
    n = lv["position"].shape[0]
    t = lv["type"].to(torch.int32)
    rows = torch.zeros((n, 24), dtype=f32, device=dev)
    rows[:, 0:3] = lv["position"]
    rows[:, 3] = (t == 0).to(f32)
    rows[:, 21] = ((t == 1) | (t == 2)).to(f32)
    rows[:, 22] = (t == 3).to(f32)
    rows[:, 23] = (t == 4).to(f32)
    rows[:, 4] = lv["start"]
    rows[:, 5] = lv["end"]
    rows[:, 6] = lv["intensity"] * lv["flicker_factor"]
    rows[:, 7:10] = lv["color"]
    rows[:, 10:13] = lv["direction"]
    rows[:, 13] = torch.cos(lv["cone_angle"].double()).to(f32)
    rows[:, 14] = lv["width"]
    rows[:, 15] = lv["height"]
    rows[:, 16:19] = lv["normal"]
    rows[:, 19] = lv["from_linedef"]
    rows[:, 20] = lv["valid"]
    if "occ_box" in uv:
        occ = torch.cat([uv["occ_box"], uv["occ_val"][:, None]], dim=1)
    else:
        occ = torch.tensor([[1e9, 1e9, -1e9, -1e9, 1.0]], device=dev)
    p = torch.zeros(80, dtype=f32, device=dev)
    p[75] = uv["bump_strength"]
    if fa["shadow_params"] is not None:
        p[59:75] = torch.from_numpy(np.asarray(fa["shadow_params"], np.float32)[:16]).to(dev)
    p[0:16] = uv["inv_proj"].reshape(-1)
    p[16:32] = uv["inv_view"].reshape(-1)
    p[32:35] = uv["camera_pos"]
    p[35] = uv["has_ambient"]
    p[36:39] = uv["ambient"][:3]
    p[41], p[42] = fa["width"], fa["height"]
    p[43] = uv["has_sun"]
    p[44:47] = uv["sun_dir"]
    p[47] = uv["day_factor"]
    p[48] = 1.0 if fa["has_fog"] else 0.0
    p[49:52] = uv["fog_color"][:3]
    p[52] = uv["fog_end"]
    p[53] = uv["fog_fade"]
    p[54] = fa["atlas"]["w"]
    p[55:58] = uv["sun_color"]
    p[76] = uv["fog_mode"]
    p[77] = uv["fog_density"]
    return {"light_params": rows, "occ_params": occ, "mega_params": p}


def check_route(key: str, r: dict):
    """Print path `key`'s arena_route and hold it to the arena (one upload,
    no frame leaf by leaf, no refusal) and, on ONE_COPY's paths, to one
    host-to-device copy."""
    print(f"path {key} steady frame: {r['copies']} host-to-device copies {r['ops']}, "
          f"{r['arena_uploads']} arena upload(s), {r['leaf_frames']} frame(s) leaf by leaf, "
          f"{r['refusals']} arena refusal(s)")
    if (r["arena_uploads"], r["leaf_frames"], r["refusals"]) != (1, 0, 0):
        raise SystemExit(f"path {key}'s frame did not go through the arena: {r}")
    if key in ONE_COPY and r["copies"] != 1:
        raise SystemExit(f"path {key}'s steady frame made {r['copies']} host-to-device copies, "
                         f"not 1")


def arena_route(fn) -> dict:
    """A steady call of `fn` -> its host-to-device copies (host_copies: the
    count and the ops that made them) and how its frame reached the device: arena uploads, frames uploaded leaf by
    leaf and trees the arena refused (ops/arena.py's counters). `fn` runs
    once before the counted call: the scene cache holds one scene a
    process, so a path's frame after another path's packs its scene
    again."""
    from rusterix_tpu_torch.ops import arena

    fn()
    before = (arena.uploads, arena.leaf_frames, arena.refusals)
    copies, ops = host_copies(fn)
    after = (arena.uploads, arena.leaf_frames, arena.refusals)
    up, leaf, refused = (a - b for a, b in zip(after, before))
    return {"copies": copies, "ops": ops, "arena_uploads": up, "leaf_frames": leaf,
            "refusals": refused}


X_FRAMES = 30
X_SIZE = (640, 400)
X_SMALL = (160, 120)
X_TICKS = 4
# Y: the tracer's sizes, trace() calls timed at each, and the small size at
# which the CUDA buffer is held to the CPU buffer after Y_SAMPLES samples
Y_SIZES = ((320, 240), (800, 600))
Y_TRACES = 20
Y_SMALL = (64, 48)
Y_SAMPLES = 2
Y_ATOL = 1e-5
# pixels of the small buffer whose path may take another branch on the card
# (sin and cos, the functions whose last bit differs from the CPU's, steer
# the diffuse bounces); the count is printed
Y_BRANCH_PIXELS = 16
# Z: the sharded tracer's mesh (one card), and the facade's traces
Z_MESH = 4
Z_TRACES = 4
# C12: the preparation's scene above the rank sort's old limit of 28,672
# cells (cells of 64 slots) at 1080p rays, and the limit that sends path B
# through the cluster route (Bl) and, lowered as well, the global route (Blg)
C12_CELLS = 28700
C12_LIMIT = 4
# the preparation routes timed at these cell counts on 1080p rays (the
# sweep), with the keys of both kinds of c12_inputs, up to the most cells the
# cluster kernel holds (8 * CLUSTER_SPAN_MAX)
SWEEP_CELLS = (32, 256, 384, 512, 2048, 6200, 28672, 32768, 65536, 106496)
SWEEP_KEYS = ("ties", "spread")
# the most cells rt_prepare_kernel holds (RT_MAX_CELLS in csrc/rt_kernel.cu)
RANK_MAX_CELLS = 28672
# preparation calls profiled for each route of a sweep point
SWEEP_CALLS = 3
# the kernels of each preparation route and their launches a call (the global
# route: the boxes, the count and four passes)
ROUTE_KERNELS = {"rank": {"rt_prepare_kernel": 1},
                 "cluster": {"rt_prepare_cluster_kernel": 1},
                 "global": {"rt_prepare_large_boxes": 1, "rt_prepare_large_count": 1,
                            "rt_prepare_large_kernel": 4}}
# GL: the global route at its own size, 1080p rays over this many cells of
# 64 slots (8,388,608 triangles), above rt_kernel.CLUSTER_MAX_CELLS with the
# limits as they stand
GL_CELLS = 131072


def c12_inputs(ncells: int, keys: str = "ties", seed: int = 12) -> tuple:
    """intersect_rays_pallas's arguments on 1920x1080 rays over `ncells`
    cells of 64 seeded random triangles. "ties": triangles anywhere in
    [-10, 10]^3 and origins anywhere in [-8, 8]^3, so that every ray block's
    origin box meets every cell and every live key is 0 (the sort keeps
    cell order); "spread": each cell's triangles within 0.6 of a random
    centre and the origins following the pixel across a plane, so that a
    block's keys spread over distinct gaps (the sort does all its passes)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tcount = 64 * ncells

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    if keys == "ties":
        a = rand(tcount, 3) * 20.0 - 10.0
        pos = torch.stack([a, a + rand(tcount, 3) * 3 - 1.5, a + rand(tcount, 3) * 3 - 1.5], 1)
    else:
        a = (rand(ncells, 3) * 20.0 - 10.0).repeat_interleave(64, 0) + rand(tcount, 3) * 0.6 - 0.3
        pos = torch.stack([a, a + rand(tcount, 3) * 0.6 - 0.3, a + rand(tcount, 3) * 0.6 - 0.3], 1)
    pos = torch.cat([pos, torch.ones((tcount, 3, 1), device="cuda")], 2)
    valid = (rand(tcount) > 0.2).float()
    if keys == "ties":
        o = rand(3, H, W) * 16.0 - 8.0
    else:
        ys, xs = torch.meshgrid(torch.arange(H, device="cuda"), torch.arange(W, device="cuda"),
                                indexing="ij")
        o = torch.stack([xs / W * 16.0 - 8.0, ys / H * 16.0 - 8.0, rand(H, W) * 0.1 - 0.05])
    d = torch.randn((3, H, W), generator=gen, device="cuda")
    d = d / d.norm(dim=0, keepdim=True)
    return (pos, valid, *o, *d, 25.0, H, W)


class route_limits:
    """Set rt_kernel's routing limits for a `with` block and restore them."""

    def __init__(self, **limits):
        from rusterix_tpu_torch.ops import rt_kernel

        self.mod, self.limits = rt_kernel, limits

    def __enter__(self):
        self.saved = {k: getattr(self.mod, k) for k in self.limits}
        for k, v in self.limits.items():
            setattr(self.mod, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.mod, k, v)


def prep_device_ms(fn, kernels, calls: int = SWEEP_CALLS, split: dict = None) -> float:
    """Device ms of one call of `fn` under the profiler, over `calls` calls:
    with `kernels` ({symbol: launches a call}, a preparation route's
    kernels, the only device activity of a call) the sum of each kernel's
    ms a record kept times its launches (and each kernel's share into
    `split`); with None (any call) the union of the device intervals a call,
    provided every kernel's records are a whole number a call. Where the
    profiler records nothing twice, or lost records of a library call (it
    does so late in a long process), the median of CUDA events around
    single calls, and a line says so."""
    for _ in range(2):
        prof = profile_calls(fn, calls)
        if prof is not None:
            break
    if prof is None or (kernels is None and any(
            c % calls for _ms, c in prof["by_name"].values())):
        ms = median(cuda_times(fn, 2 * calls))
        print(f"profiler recorded {'nothing' if prof is None else 'part'} of "
              f"{', '.join(kernels or ['a library call'])}: CUDA events instead, {ms:.4f} ms")
        return ms
    if kernels is None:
        return prof["device_ms"]
    total = 0.0
    for symbol, per in kernels.items():
        seen = [(ms, c) for name, (ms, c) in prof["by_name"].items() if is_kernel(name, symbol)]
        if len(seen) != 1 or not 1 <= seen[0][1] <= calls * per:
            raise SystemExit(f"profiled {symbol}: records {prof['by_name']}")
        total += seen[0][0] / seen[0][1] * per
        if split is not None:
            split[symbol] = seen[0][0] / seen[0][1] * per
    if len(prof["by_name"]) != len(kernels):
        raise SystemExit(f"profiled {list(kernels)}: records {prof['by_name']}")
    return total


def gl_phase(gpu: str) -> dict:
    """GL: B3's global preparation route at its own size, on 1080p rays over
    GL_CELLS cells with the keys of both kinds of c12_inputs and the limits
    as they stand: the route `prepare_route` picks must be "global" and the
    only one launched; boxes, tnear and slist bit for bit against
    rt_prepare; the wrapper (CUDA events), the kernels alone on prepared
    inputs (events, and the profiler's device ms, split by kernel), the
    plain rt_prepare, torch.sort of the same keys in cell order and the
    bound (C12's rule). -> the numbers by kind of keys, with the bound."""
    from rusterix_tpu_torch.ops import rt_kernel

    out = {}
    for kind in SWEEP_KEYS:
        torch.cuda.reset_peak_memory_stats()
        args = c12_inputs(GL_CELLS, kind)
        sizes_ = rt_kernel._sizes(args[0].shape[0], H, W)
        nb = sizes_["nby"] * sizes_["nbx"]
        route = rt_kernel.prepare_route(GL_CELLS, nb)
        if route["route"] != "global" or sizes_["ncells"] != GL_CELLS:
            raise SystemExit(f"GL: {GL_CELLS} cells take the {route['route']} route")
        zero_counts()
        prep = rt_kernel.rt_prepare_cuda(*args)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts["B3prepL"] != 1 or counts["B3prep"] or counts["B3prepC"]:
            raise SystemExit(f"GL: the global route did not run alone: {counts}")
        ref = rt_kernel.rt_prepare(*args)
        for key in ("boxes", "tnear", "slist"):
            if not torch.equal(prep[key], ref[key]):
                raise SystemExit(f"GL ({kind}): the global route's {key} differs from "
                                 f"rt_prepare's")
        live = int((prep["tnear"] < 3e37).sum())
        distinct = int(torch.unique(prep["tnear"][0]).numel())
        nbytes_ = nbytes(*args[2:8], prep["cbox"], prep["boxes"], prep["tnear"], prep["slist"])
        ops = H * W * OPS_PREP_PER_RAY + prep["tnear"].numel() * OPS_PREP_PER_KEY
        ms_b, by = bound(nbytes_, ops)
        del prep
        t_w = cuda_times(lambda: rt_kernel.rt_prepare_cuda(*args), 5)
        scene = rt_kernel.scene_tables(args[0], args[1], args[8], GL_CELLS, sizes_["cell"])
        alone = rt_kernel.prepare_launch(scene, rt_kernel._ray_fields(*args[2:8]), args[8],
                                         sizes_)
        t_a = cuda_times(alone, 5)
        split = {}
        dev = prep_device_ms(alone, ROUTE_KERNELS["global"], split=split)
        del alone, scene
        t_p = cuda_times(lambda: rt_kernel.rt_prepare(*args), 2, warmup=1)
        keys = ref["tnear"].gather(1, ref["slist"].long().argsort(1))  # cell order
        del ref
        t_sort = cuda_times(lambda: torch.sort(keys, dim=1, stable=True), 5)
        dev_sort = prep_device_ms(lambda: torch.sort(keys, dim=1, stable=True), None)
        del keys, args
        out[kind] = {"wrapper": median(t_w), "alone": median(t_a), "device": dev,
                     "split": split, "plain": median(t_p), "sort": median(t_sort),
                     "sort_device": dev_sort,
                     "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
        out["bound"] = [ms_b, by]
        print(f"GL global route ({kind} keys; {nb} ray blocks x {GL_CELLS} cells, {live} live "
              f"keys, {distinct} distinct in block 0's row; {route['tiles']} tiles a row, "
              f"{route['scratch']} B scratch): boxes, tnear, slist equal to rt_prepare; "
              f"wrapper {summary(t_w)}; kernels alone {summary(t_a)}, device {dev:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"); plain rt_prepare {median(t_p):.4f} ms; torch.sort of the keys "
              f"{median(t_sort):.4f} ms (device {dev_sort:.4f}); bound {ms_b:.6f} ms "
              f"({nbytes_} bytes, {ops} f32 ops, by {by}); peak device memory "
              f"{out[kind]['peak_gb']:.2f} GiB on {gpu}")
        torch.cuda.empty_cache()
    return out


def prep_sweep(gpu: str) -> list:
    """The preparation routes at SWEEP_CELLS cells on 1080p rays
    (c12_inputs of each kind): every route that takes a size (the rank sort
    up to RANK_MAX_CELLS; the cluster route with CLUSTER_SPAN as it is and
    at CLUSTER_SPAN_MAX, which give the cluster size the limits pick and the
    smallest one that holds the row; the global route), each held to rt_prepare
    bit for bit and timed by the profiler (device ms of the kernel alone on
    prepared inputs), beside torch.sort of the same keys in cell order.
    Prints a line a point and returns the points."""
    from rusterix_tpu_torch.ops import rt_kernel

    points = []
    for n in SWEEP_CELLS:
        for kind in SWEEP_KEYS:
            args = c12_inputs(n, kind)
            pos, valid, rays, t_cap = args[0], args[1], args[2:8], args[8]
            sizes_ = rt_kernel._sizes(pos.shape[0], H, W)
            nb = sizes_["nby"] * sizes_["nbx"]
            scene = rt_kernel.scene_tables(pos, valid, t_cap, n, sizes_["cell"])
            fields = rt_kernel._ray_fields(*rays)
            ref = rt_kernel.rt_prepare(*args)
            routes = []
            if n <= RANK_MAX_CELLS:
                routes.append(("rank", {"PREPARE_MAX_CELLS": RANK_MAX_CELLS}))
            for span in (rt_kernel.CLUSTER_SPAN, rt_kernel.CLUSTER_SPAN_MAX):
                routes.append(("cluster", {"PREPARE_MAX_CELLS": 0, "CLUSTER_SPAN": span,
                                           "CLUSTER_MAX_CELLS": 8 * rt_kernel.CLUSTER_SPAN_MAX}))
            routes.append(("global", {"PREPARE_MAX_CELLS": 0, "CLUSTER_MAX_CELLS": 0}))
            point = {"cells": n, "keys": kind, "ray_blocks": nb,
                     "distinct_keys_row0": int(torch.unique(ref["tnear"][0]).numel()),
                     "route": rt_kernel.prepare_route(n, nb)["route"], "ms": {}}
            for label, limits in routes:
                with route_limits(**limits):
                    route = rt_kernel.prepare_route(n, nb)
                    fn = rt_kernel.prepare_launch(scene, fields, t_cap, sizes_)
                if route["route"] != label:
                    raise SystemExit(f"sweep: {limits} gave the {route['route']} route")
                if label == "cluster":
                    label = f"cluster C={route['cluster']}"
                    if label in point["ms"]:
                        continue
                outs = fn()
                torch.cuda.synchronize()
                for key, got in zip(("boxes", "tnear", "slist"), outs):
                    if not torch.equal(got, ref[key]):
                        raise SystemExit(f"sweep {n} cells ({kind}): the {label} route's {key} "
                                         f"differs from rt_prepare's")
                point["ms"][label] = prep_device_ms(fn, ROUTE_KERNELS[route["route"]])
            keys = ref["tnear"].gather(1, ref["slist"].long().argsort(1))  # cell order
            point["ms"]["torch.sort"] = prep_device_ms(
                lambda: torch.sort(keys, dim=1, stable=True), None)
            del ref, keys, scene, fields, args
            shown = ", ".join(f"{k} {v:.4f}" for k, v in point["ms"].items())
            print(f"sweep {n} cells ({kind} keys, {point['distinct_keys_row0']} distinct in "
                  f"block 0's row; {nb} ray blocks), routes held to rt_prepare bit for bit, "
                  f"device ms: {shown}; the limits send it to the {point['route']} route; "
                  f"on {gpu}")
            points.append(point)
    return points


HG_BOXES = 10600
# B1, B2 and B3's walk are held to their plain versions on a band of rows
# (at their row offset; the walk on the band's rays), each plain version
# run once: over 131,072 slots the plain B1 took 6.4 s and the plain B2
# 17.5 s on 135 rows of an H100, so the whole 1080p frame would take minutes
HG_BAND = (540, 64)
# the CUDA frame against the CPU frame at 256x128 takes the scene cut to 300
# boxes (4,096 slots, 64 cells: HGR's small frame sent through the cluster
# route by a lowered rank limit): the plain versions over 131,072 slots take
# minutes on the host's CPU
HG_SMALL_BOXES = 300
HG_SMALL_PREPARE_MAX = 32
HG_FRAMES = 20
N_PROF_HG = 5
HG_KEYS = ("HG", "HGR")


def huge_paths(gpu: str, phase) -> list:
    """Paths HG (scenes.build_huge_scene, 10,600 boxes: 131,072 slots,
    opaque at 1920x1080 with tools/bench_huge.py's sun and ambient: B1) and
    HGR (HG with the GGX BRDF and one reflection ray a pixel: B1's GGX
    variant, B2, B3's walk and its cluster preparation route over 2,048
    cells). For each: the first frame's wall time, the launches and the
    host-to-device copies of a steady frame, the frame times and profile,
    the kernels against their plain versions (B1, B2 and the walk on the
    rows HG_BAND, the preparation on the whole frame), the CUDA frame
    against the CPU frame at 256x128 on the cut scene, and HG's
    frame_breakdown. Raises on a failed check -> the kernels line's rows."""
    from rusterix_tpu_torch import _cuda
    from rusterix_tpu_torch.ops import megakernel, rt_kernel, visibility_pallas
    from rusterix_tpu_torch.ops.raster import frame_inputs
    from rusterix_tpu_torch.profiling import frame_breakdown
    from rusterix_tpu_torch.scenes import build_huge_scene, huge_rasterizer

    rows = []
    y0, band = HG_BAND
    scene, cam, assets = build_huge_scene(HG_BOXES)
    small_scene, small_cam, small_assets = build_huge_scene(HG_SMALL_BOXES)
    for key in HG_KEYS:
        phase(key)
        rast = huge_rasterizer(cam, W, H, "cuda")
        if key == "HGR":
            rast.set_brdf("ggx").set_reflections(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rast.rasterize(scene, W, H, 40, assets, readback=False)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        zero_counts()
        frame = rast.rasterize(scene, W, H, 40, assets)
        torch.cuda.synchronize()
        counts = read_counts()
        refl = key == "HGR"
        want = {"B1": 1, "B2": int(refl), "B3": int(refl), "B3prep": 0,
                "B3prepC": int(refl), "B3prepL": 0}
        if counts != want:
            raise SystemExit(f"path {key} launched {counts}, expected {want}")
        fa = rast.frame_args
        slots = int(fa["d3"]["pos"].shape[0])
        live = int((fa["d3"]["valid"] > 0.5).sum())
        cells = slots // rt_kernel.RT_CELL
        covered = int((frame[..., :3] != frame[0, 0, :3]).any(-1).sum())
        print(f"path {key} (the huge scene, {slots} slots, {live} live triangles, {cells} B3 "
              f"cells{', GGX reflections' if refl else ''}): frame {frame.shape} {frame.dtype}, "
              f"launches {counts}, first frame {first_ms:.1f} ms of host wall, px unlike the "
              f"corner {covered}")
        if frame.shape != (H, W, 4) or covered < W * H // 20:
            raise SystemExit(f"path {key}: the huge scene did not render")

        check_route(key, arena_route(lambda: rast.rasterize(scene, W, H, 40, assets)))

        def frame_fn():
            return rast.rasterize(scene, W, H, 40, assets, readback=False)

        frame_t = cuda_times(frame_fn, HG_FRAMES)
        print(f"path {key} frame (CUDA events, readback=False): {summary(frame_t)} on {gpu}")
        names = {"B1": "mega_kernel"}
        if refl:
            names.update(B2="visibility_kernel", B3="rt_kernel",
                         B3prepC="rt_prepare_cluster_kernel")
        dev = report_profile(f"path {key} frame x{N_PROF_HG}", profile_calls(frame_fn, N_PROF_HG),
                             median(frame_t), gpu, names)

        # B1 on the band against its plain version
        fi_b = frame_inputs(**dict(fa, background=fa["background"][y0:y0 + band]), y0=y0,
                            rows=band)
        a_, k_ = fi_b["mega_args"], fi_b["mega_kwargs"]
        rgba_k, z_k = megakernel.mega_render(*a_, **k_)
        (rgba_p, z_p, work), b1_plain = timed_once(
            lambda: megakernel.mega_render_reference(*a_, **k_, return_work=True))
        win = megakernel.mega_render(*a_, **k_, stage_cut=1)[0]
        torch.cuda.synchronize()
        if not torch.equal(z_k, z_p):
            raise SystemExit(f"path {key}: B1 z_eff differs from the plain version on rows "
                             f"{y0}-{y0 + band} at {int((z_k != z_p).sum())} px")
        b1_err = int((megakernel.unpack_frame_u32(rgba_k).int()
                      - megakernel.unpack_frame_u32(rgba_p).int()).abs().max())
        if b1_err > RGBA_TOL:
            raise SystemExit(f"path {key}: B1 disagrees with its plain version ({b1_err})")
        b1_t = cuda_times(lambda: megakernel.mega_render(*a_, **k_), 10)
        b1_alone = median(cuda_times(megakernel.prepare_launch(*a_, **k_), 10))
        n_occ = int(a_[8].shape[0])
        ops = (work["vis_tests"] * OPS_PER_VIS_TEST
               + shade_ops(int((win >= 0).sum()), 0, k_, n_occ, int(a_[11])))
        nb = b1_bytes(a_, (rgba_k, z_k), work)
        ms_b, by = bound(nb, ops)
        print(f"path {key} B1 vs plain on rows {y0}-{y0 + band}: z_eff equal, rgba max diff "
              f"{b1_err}; wrapper {summary(b1_t)}, kernel alone {b1_alone:.4f} ms, plain "
              f"{b1_plain:.4f} ms; bound {nb} bytes, {ops} f32 ops -> {ms_b:.6f} ms, "
              f"bound by {by} on {gpu}")
        rows.append({
            "name": f"mega_render{' brdf_ggx' if refl else ''} ({key}: the huge scene, 131,072 "
                    f"slots; held and timed on rows {y0}-{y0 + band})",
            "route": "cuda", "source": "rusterix_tpu_torch/csrc/megakernel.cu",
            "replaces": "rusterix_tpu/ops/megakernel.py:250", "launches": counts["B1"],
            "max_abs_err": b1_err, "ms": median(b1_t), "plain_ms": b1_plain,
            "bound_ms": ms_b, "bound_by": by, "library_ms": None, "device_ms": dev["B1"],
            "alone_ms": b1_alone, "frame_ms": median(frame_t),
            **_cuda.resources("mega", a_[0].shape[0] // 128, len(k_["light_spec"]), n_occ),
        })
        if refl:
            rows += _huge_refl_rows(rast, fa, fi_b, counts, dev, gpu)

        # the CUDA frame against the CPU frame at 256x128, on the cut scene
        small = {}
        for d in ("cuda", "cpu"):
            r_s = huge_rasterizer(small_cam, SMALL_W, SMALL_H, d)
            if refl:
                r_s.set_brdf("ggx").set_reflections(1)
            with route_limits(PREPARE_MAX_CELLS=HG_SMALL_PREPARE_MAX):
                zero_counts()
                small[d] = r_s.rasterize(small_scene, SMALL_W, SMALL_H, 40, small_assets)
                small[d + " counts"] = read_counts()
        if refl and small["cuda counts"]["B3prepC"] != 1:
            raise SystemExit(f"path {key} small: not the cluster route: {small['cuda counts']}")
        d_ = int((small["cuda"] != small["cpu"]).any(-1).sum())
        print(f"path {key} {SMALL_W}x{SMALL_H} ({HG_SMALL_BOXES} boxes): CUDA vs CPU frame, "
              f"{d_} pixels differ; CUDA launches {small['cuda counts']}")
        if d_:
            raise SystemExit(f"path {key}: the CUDA frame is not byte-equal to the CPU frame")
        if not refl:
            print(f"frame_breakdown path HG ({W}x{H}, CUDA events, medians of 20): "
                  f"{json.dumps(frame_breakdown(rast, scene, assets, W, H))} on {gpu}")
    return rows


def _huge_refl_rows(rast, fa, fi_b, counts, dev, gpu) -> list:
    """HGR's B2 (on the band), B3's walk (the band's reflection rays) and
    its cluster preparation (the whole frame's rays over 2,048 cells)
    against their plain versions -> their kernels-line rows."""
    from rusterix_tpu_torch import _cuda
    from rusterix_tpu_torch.ops import rt_kernel, visibility_pallas
    from rusterix_tpu_torch.ops.raster import frame_inputs

    y0, band = HG_BAND
    out = []
    b2_in = (fi_b["vis_s"], fi_b["alive_s"], fi_b["bbox_s"], W, band, y0)
    z2, i2, _h2 = visibility_pallas.visibility_pass_pallas(*b2_in)
    (z2p, i2p, _h2p), b2_plain = timed_once(
        lambda: visibility_pallas.visibility_pass_pallas_reference(*b2_in))
    if not (torch.equal(z2, z2p) and torch.equal(i2, i2p)):
        raise SystemExit("path HGR: B2 disagrees with its plain version on the band")
    b2_t = cuda_times(lambda: visibility_pallas.visibility_pass_pallas(*b2_in), 10)
    b2_alone = median(cuda_times(visibility_pallas.prepare_launch(*b2_in), 10))
    tests = visibility_pallas.scan_work(*b2_in)
    nb = nbytes(*b2_in[:3], z2, i2)
    ms_b, by = bound(nb, tests * OPS_PER_VIS_TEST)
    print(f"path HGR B2 vs plain on rows {y0}-{y0 + band}: z and idx equal; wrapper "
          f"{summary(b2_t)}, kernel alone {b2_alone:.4f} ms, plain {b2_plain:.4f} ms; "
          f"bound {nb} bytes, {tests * OPS_PER_VIS_TEST} f32 ops -> {ms_b:.6f} ms, bound by {by}")
    out.append({
        "name": f"visibility_pass_pallas (HGR: the huge scene; held and timed on rows "
                f"{y0}-{y0 + band})", "route": "cuda",
        "source": "rusterix_tpu_torch/csrc/visibility.cu",
        "replaces": "rusterix_tpu/ops/visibility_pallas.py:42", "launches": counts["B2"],
        "max_abs_err": float((z2 - z2p).abs().max()), "ms": median(b2_t),
        "plain_ms": b2_plain, "bound_ms": ms_b, "bound_by": by, "library_ms": None,
        "device_ms": dev["B2"], "alone_ms": b2_alone,
        **_cuda.resources("visibility", -(-b2_in[0].shape[0] // 128)),
    })

    kin = reflection_kernel_inputs(rast, frame_inputs(**fa))
    b3_in = kin["b3_in"]
    ncells = b3_in[0].shape[0] // rt_kernel.RT_CELL
    route = rt_kernel.prepare_route(ncells, (H // 8) * -(-W // 128))
    if route["route"] != "cluster":
        raise SystemExit(f"path HGR: {ncells} cells take the {route['route']} route")
    zero_counts()
    prep_k = rt_kernel.rt_prepare_cuda(*b3_in)
    prep_p, prep_plain = timed_once(lambda: rt_kernel.rt_prepare(*b3_in))
    if read_counts()["B3prepC"] != 1:
        raise SystemExit(f"path HGR: the preparation took another route: {read_counts()}")
    bad = [k for k in ("boxes", "tnear", "slist") if not torch.equal(prep_k[k], prep_p[k])]
    if bad:
        raise SystemExit(f"path HGR: the cluster preparation's {bad} differ from rt_prepare's")
    prep_t = cuda_times(lambda: rt_kernel.rt_prepare_cuda(*b3_in), 10)
    keys = prep_p["tnear"].gather(1, prep_p["slist"].long().argsort(1))  # cell order
    sort_t = cuda_times(lambda: torch.sort(keys, dim=1, stable=True), 10)
    nb = nbytes(*b3_in[2:8], prep_k["cbox"], prep_k["boxes"], prep_k["tnear"], prep_k["slist"])
    ops = H * W * OPS_PREP_PER_RAY + prep_k["tnear"].numel() * OPS_PREP_PER_KEY
    ms_b, by = bound(nb, ops)
    live = int((prep_k["tnear"] < 3e37).sum())
    print(f"path HGR B3 cluster preparation vs plain rt_prepare ({prep_k['tnear'].shape[0]} "
          f"ray blocks x {ncells} cells, clusters of {route['cluster']} blocks, {live} live "
          f"keys): boxes, tnear, slist equal; wrapper {summary(prep_t)}, plain "
          f"{prep_plain:.4f} ms, torch.sort of the keys {summary(sort_t)}; bound {nb} "
          f"bytes, {ops} f32 ops -> {ms_b:.6f} ms, bound by {by} on {gpu}")
    out.append({
        "name": f"rt_prepare_cuda cluster route (HGR: 1080p reflection rays over {ncells} "
                f"cells)", "route": "cuda", "source": "rusterix_tpu_torch/csrc/rt_kernel.cu",
        "replaces": "rusterix_tpu/ops/rt_kernel.py:286-354", "launches": counts["B3prepC"],
        "max_abs_err": 0.0, "ms": median(prep_t), "plain_ms": prep_plain,
        "bound_ms": ms_b, "bound_by": by, "library_ms": median(sort_t),
        "device_ms": dev["B3prepC"], "cluster": route["cluster"],
        **_cuda.resources("rt_prepare_cluster", ncells, route["cluster"]),
    })
    del keys, prep_p

    ox, oy, oz, dx, dy, dz = (r[y0:y0 + band] for r in b3_in[2:8])
    walk_in = (b3_in[0], b3_in[1], ox, oy, oz, dx, dy, dz, b3_in[8], band, W)
    t3, i3 = rt_kernel.intersect_rays_pallas(*walk_in)
    (t3p, i3p, work), walk_plain = timed_once(
        lambda: rt_kernel.intersect_rays_pallas_reference(*walk_in, return_work=True))
    if not (torch.equal(t3, t3p) and torch.equal(i3, i3p)):
        raise SystemExit("path HGR: the walk disagrees with its plain version on the band")
    walk_t = cuda_times(lambda: rt_kernel.intersect_rays_pallas(*walk_in), 10)
    nb = nbytes(*walk_in[:8], t3, i3)
    ops = work["ray_triangle"] * OPS_PER_MT_TEST + work["ray_box"] * OPS_PER_SLAB_TEST
    ms_b, by = bound(nb, ops)
    both = (i3 >= 0) & (i3p >= 0)
    print(f"path HGR B3 walk vs plain on the rows {y0}-{y0 + band}'s rays: t and idx equal, "
          f"hits {int((i3 >= 0).sum())}; wrapper {summary(walk_t)}, plain "
          f"{walk_plain:.4f} ms; work {work}; bound {nb} bytes, {ops} f32 ops -> "
          f"{ms_b:.6f} ms, bound by {by} on {gpu}")
    out.append({
        "name": f"intersect_rays_pallas (HGR: the huge scene's reflection rays over {ncells} "
                f"cells; held and timed on rows {y0}-{y0 + band})", "route": "cuda",
        "source": "rusterix_tpu_torch/csrc/rt_kernel.cu",
        "replaces": "rusterix_tpu/ops/rt_kernel.py:79", "launches": counts["B3"],
        "max_abs_err": float((t3[both] - t3p[both]).abs().max()) if bool(both.any()) else 0.0,
        "ms": median(walk_t), "plain_ms": walk_plain, "bound_ms": ms_b,
        "bound_by": by, "library_ms": None, "device_ms": dev["B3"],
        **_cuda.resources("rt_walk"),
    })
    return out


def engine_paths(gpu: str, phase) -> list:
    """Paths X (the minigame loop through the Rusterix facade), Y (the path
    tracer), Z (the facade's trace_scene, trace_sharded and 2D view), Bl
    and Blg (path B through the cluster and the global preparation route),
    C12's phase (both routes alone on 1080p rays over C12_CELLS cells), GL
    (gl_phase: the global route over GL_CELLS cells) and the sweep
    (prep_sweep). Raises on a failed check -> the kernels line's rows for
    the cluster and the global preparation route (GL's numbers under the
    latter's "gl")."""
    import random

    from rusterix_tpu_torch import _cuda
    from rusterix_tpu_torch.ops import megakernel, rt_kernel, visibility_pallas
    from rusterix_tpu_torch.parallel import make_mesh
    from rusterix_tpu_torch.scenes import (
        build_map_refl_scene,
        build_minigame,
        build_tracer_scene,
        minigame_tick,
    )
    from rusterix_tpu_torch.tracer import AccumBuffer, Tracer


    phase("X")
    # X. the minigame loop at 640x400: server tick, entity mirror, billboard
    # rebuild, then client.draw_d3(readback=False)
    xw, xh = X_SIZE
    random.seed(7)
    rx = build_minigame("cuda")
    rx.local_player_event("key_down", "w")
    ambient = [0.4, 0.4, 0.4, 1.0]

    packs = []  # the (scene, revision) each frame renders: the scene cache's key

    def x_frame():
        minigame_tick(rx)
        out = rx.client.draw_d3(xw, xh, rx.assets, ambient, readback=False)
        scene = rx.client.scene
        packs.append((scene._cache_uid, scene.revision))
        return out

    x_frame()  # warm-up: packs the world on the card
    zero_counts()
    f = x_frame()
    torch.cuda.synchronize()
    counts_x = read_counts()
    if counts_x != {"B1": 1, "B2": 0, "B3": 0, "B3prep": 0, "B3prepC": 0, "B3prepL": 0}:
        raise SystemExit(f"path X launched {counts_x}, expected one B1 a frame")
    if f.shape != (xh, xw, 4) or f.dtype != torch.uint8 or f.device.type != "cuda":
        raise SystemExit(f"path X frame is {tuple(f.shape)} {f.dtype} on {f.device}")
    covered = int((f[..., 3] == 255).sum())
    dyn = len(rx.client.scene.d3_dynamic)
    # the copies of a frame: Client.draw_d3's, and the server tick's apart
    tick_copies, tick_ops = host_copies(lambda: minigame_tick(rx))
    check_route("X", arena_route(lambda: rx.client.draw_d3(xw, xh, rx.assets, ambient,
                                                             readback=False)))
    print(f"path X: the server tick before a frame made {tick_copies} host-to-device copies "
          f"{tick_ops}")
    dev_t = cuda_times(x_frame, X_FRAMES, warmup=1)
    synced = []
    for _ in range(X_FRAMES):
        t0 = time.perf_counter()
        float(x_frame()[0, 0, 0])
        synced.append((time.perf_counter() - t0) * 1e3)
    synced.sort()
    host = []
    for _ in range(X_FRAMES):
        t0 = time.perf_counter()
        minigame_tick(rx)
        host.append((time.perf_counter() - t0) * 1e3)
    host.sort()
    repacks = len(set(packs)) - 1
    print(f"path X (minigame loop, {xw}x{xh}): launches {counts_x} a frame, covered px "
          f"{covered}, {dyn} dynamic billboard(s), scene revision {rx.client.scene.revision}, "
          f"static repacks after the warm-up {repacks} in {len(packs)} frames")
    x_dev = median(dev_t)
    x_sync = median(synced)
    print(f"path X device-only frames (CUDA events, readback=False): {summary(dev_t)} on {gpu}")
    print(f"path X host-synced frames (one scalar pulled a frame, host wall): {summary(synced)} "
          f"on {gpu}")
    print(f"path X host tick alone (server tick + mirror + billboards, host wall): "
          f"{summary(host)}")
    print(f"path X host-synced / device-only: {x_sync / x_dev:.4f}; fps {1e3 / x_sync:.2f} "
          f"host-synced, {1e3 / x_dev:.2f} device-only on {gpu}")
    report_profile(f"path X minigame frame x6", profile_calls(x_frame, 6), x_dev, gpu,
                   {"B1": "mega_kernel"})
    rx.server.stop()
    sw, sh = X_SMALL
    small = {}
    for dev in ("cuda", "cpu"):
        random.seed(7)
        rx_s = build_minigame(dev)
        rx_s.local_player_event("key_down", "w")
        for _ in range(X_TICKS):
            minigame_tick(rx_s)
        small[dev] = rx_s.draw_scene(rx_s.assets.maps["world"], sw, sh, ambient=ambient)
        pos = {e.get_attr_string("class_name"): tuple(float(v) for v in e.position)
               for e in rx_s.server.instances[0].ctx.entities}
        rx_s.server.stop()
        small[dev + " positions"] = pos
    if small["cuda positions"] != small["cpu positions"]:
        raise SystemExit(f"path X: the seeded ticks moved the entities differently: {small}")
    x_diff = int((small["cuda"] != small["cpu"]).any(-1).sum())
    print(f"path X {sw}x{sh} after {X_TICKS} seeded ticks: CUDA vs CPU frame, {x_diff} pixels "
          f"differ (entities at {small['cuda positions']})")
    if x_diff:
        raise SystemExit("path X: the CUDA frame is not byte-equal to the CPU frame")

    phase("Y")
    # Y. the path tracer on the bench's scene: trace() calls timed by CUDA
    # events, device time under the profiler, peak memory
    scene_y, cam_y, assets_y = build_tracer_scene()
    for yw, yh in Y_SIZES:
        tracer = Tracer("cuda")
        buf = AccumBuffer(yw, yh, device="cuda")
        tracer.trace(cam_y, scene_y, buf, 64, assets_y)  # warm-up: packs the scene
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # what the earlier paths still hold
        t_y = cuda_times(lambda: tracer.trace(cam_y, scene_y, buf, 64, assets_y), Y_TRACES,
                         warmup=1)
        peak = torch.cuda.max_memory_allocated() - base
        img = buf._dev
        if not bool(torch.isfinite(img).all()) or float(img[..., :3].max()) <= 0.0:
            raise SystemExit(f"path Y {yw}x{yh}: the buffer is not finite or not lit")
        ms = median(t_y)
        print(f"path Y tracer {yw}x{yh} ({tracer.bounces} bounces, {buf.frame} samples in the "
              f"buffer): trace() {summary(t_y)}, {1e3 / ms:.2f} samples/s, peak memory "
              f"{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held before on {gpu}")
        report_profile(f"path Y tracer {yw}x{yh} trace() x3",
                       profile_calls(lambda: tracer.trace(cam_y, scene_y, buf, 64, assets_y), 3),
                       ms, gpu, {})
    yw, yh = Y_SMALL
    bufs = {}
    for dev in ("cuda", "cpu"):
        tracer, buf = Tracer(dev), AccumBuffer(yw, yh, device=dev)
        for _ in range(Y_SAMPLES):
            tracer.trace(cam_y, scene_y, buf, 64, assets_y)
        bufs[dev] = buf.pixels
    err = np.abs(bufs["cuda"] - bufs["cpu"])
    far = int((err > Y_ATOL).any(-1).sum())
    print(f"path Y {yw}x{yh} after {Y_SAMPLES} samples: CUDA vs CPU buffer, {far} pixels past "
          f"{Y_ATOL} (at most {Y_BRANCH_PIXELS} allowed), max |diff| {float(err.max()):.3g}")
    if far > Y_BRANCH_PIXELS:
        raise SystemExit("path Y: the CUDA buffer is not the CPU buffer")

    phase("Z")
    # Z. the facade: trace_scene on the minigame world at its config size,
    # trace_sharded over a mesh of Z_MESH devices (byte-equal to Z_MESH
    # trace() calls), draw_scene in the 2D mode
    random.seed(7)
    rx = build_minigame("cuda")
    minigame_tick(rx)
    zw, zh = rx.client.config.width, rx.client.config.height
    buf = AccumBuffer(zw, zh, device="cuda")
    rx.trace_scene(rx.client.camera_d3, buf)
    t_z = cuda_times(lambda: rx.trace_scene(rx.client.camera_d3, buf), Z_TRACES, warmup=0)
    img = buf.pixels
    if not np.isfinite(img).all() or img[..., :3].max() <= 0.0:
        raise SystemExit("path Z: trace_scene's buffer is not finite or not lit")
    print(f"path Z Rusterix.trace_scene (minigame world, {zw}x{zh}): {summary(t_z)}, "
          f"{buf.frame} samples on {gpu}")
    seq, shard = AccumBuffer(zw, zh, device="cuda"), AccumBuffer(zw, zh, device="cuda")
    for _ in range(Z_MESH):
        rx._tracer.trace(rx.client.camera_d3, rx.client.scene, seq, 64, rx.assets)
    mesh = make_mesh(Z_MESH, "cuda")
    t0 = time.perf_counter()
    rx._tracer.trace_sharded(rx.client.camera_d3, rx.client.scene, shard, 64, rx.assets, mesh)
    torch.cuda.synchronize()
    t_sh = (time.perf_counter() - t0) * 1e3
    if shard.frame != Z_MESH or not torch.equal(shard._dev, seq._dev):
        raise SystemExit("path Z: trace_sharded is not byte-equal to sequential traces")
    print(f"path Z trace_sharded over make_mesh({Z_MESH}, 'cuda'): byte-equal to {Z_MESH} "
          f"trace() calls, {t_sh:.4f} ms of host wall on {gpu}")
    world = rx.assets.maps["world"]
    rx.set_d2()
    rx.build_scene(world)
    zero_counts()
    d2 = rx.draw_scene(world, zw, zh)
    counts_z = read_counts()
    rx.server.stop()
    random.seed(7)
    rx_c = build_minigame("cpu")
    minigame_tick(rx_c)
    rx_c.set_d2()
    rx_c.build_scene(rx_c.assets.maps["world"])
    d2_cpu = rx_c.draw_scene(rx_c.assets.maps["world"], zw, zh)
    rx_c.server.stop()
    walls = int((d2[..., 3] == 255).sum())
    print(f"path Z Rusterix.draw_scene D2 ({zw}x{zh}): launches {counts_z}, {walls} wall-strip "
          f"pixels, CUDA vs CPU {int((d2 != d2_cpu).any(-1).sum())} pixels differ")
    if counts_z["B1"] != 1 or walls == 0 or not np.array_equal(d2, d2_cpu):
        raise SystemExit("path Z: the 2D view did not render as on the CPU")

    phase("Bl")
    # Bl. path B (the GGX reflection map) at 1920x1080 with the preparation
    # sent through the cluster route, and Blg through the global route:
    # byte-equal to path B's frame
    rast_b, scene_b, assets_b = build_map_refl_scene(W, H, device="cuda")
    frame_b = rast_b.rasterize(scene_b, W, H, 40, assets_b)
    counts_bl = {}
    for label, limits, key in (
            ("Bl", {"PREPARE_MAX_CELLS": C12_LIMIT}, "B3prepC"),
            ("Blg", {"PREPARE_MAX_CELLS": C12_LIMIT, "CLUSTER_MAX_CELLS": C12_LIMIT}, "B3prepL")):
        with route_limits(**limits):
            zero_counts()
            frame_l = rast_b.rasterize(scene_b, W, H, 40, assets_b)
            torch.cuda.synchronize()
            counts = read_counts()
        want = {"B1": 1, "B2": 1, "B3": 1, "B3prep": 0, "B3prepC": 0, "B3prepL": 0, key: 1}
        if counts != want:
            raise SystemExit(f"path {label} launched {counts}, expected {want}")
        if not np.array_equal(frame_l, frame_b):
            raise SystemExit(f"path {label}: the frame through its route differs from path B's")
        print(f"path {label} (B with {limits}): launches {counts}, frame byte-equal to path B's")
        counts_bl[key] = counts[key]

    phase("C12")
    # C12. the cluster route alone on 1080p rays over C12_CELLS cells of
    # seeded random triangles (its limit raised to what the kernel holds:
    # C12 lies just above CLUSTER_MAX_CELLS), with both kinds of keys, and
    # the global route on the same inputs: bit for bit against rt_prepare,
    # timed against it and against torch.sort of its keys
    rows, c12_rows = [], []
    for key, symbol, limits in (("B3prepC", "rt_prepare_cluster_kernel",
                                 {"CLUSTER_MAX_CELLS": 8 * rt_kernel.CLUSTER_SPAN_MAX}),
                                ("B3prepL", "rt_prepare_large_kernel",
                                 {"CLUSTER_MAX_CELLS": C12_LIMIT})):
        row = {}
        for kind in SWEEP_KEYS:
            c12_in = c12_inputs(C12_CELLS, kind)
            with route_limits(**limits):
                route = rt_kernel.prepare_route(C12_CELLS, (H // 8) * -(-W // 128))
                zero_counts()
                prep = rt_kernel.rt_prepare_cuda(*c12_in)
                torch.cuda.synchronize()
                if read_counts()[key] != 1 or prep["ncells"] != C12_CELLS:
                    raise SystemExit(f"C12: the {route['route']} route did not run: "
                                     f"{read_counts()}")
                ref = rt_kernel.rt_prepare(*c12_in)
                for out in ("boxes", "tnear", "slist"):
                    if not torch.equal(prep[out], ref[out]):
                        raise SystemExit(f"C12 ({kind}): the {route['route']} route's {out} "
                                         f"differs from rt_prepare's")
                live = int((prep["tnear"] < 3e37).sum())
                distinct = int(torch.unique(prep["tnear"][0]).numel())
                print(f"C12 {symbol} ({kind} keys; {prep['tnear'].shape[0]} ray blocks x "
                      f"{C12_CELLS} cells, {live} live keys, {distinct} distinct in block 0's "
                      f"row): boxes, tnear, slist equal to rt_prepare")
                t_w = cuda_times(lambda: rt_kernel.rt_prepare_cuda(*c12_in), 10)
                sizes_ = rt_kernel._sizes(c12_in[0].shape[0], H, W)
                scene = rt_kernel.scene_tables(c12_in[0], c12_in[1], 25.0, C12_CELLS,
                                               sizes_["cell"])
                alone = rt_kernel.prepare_launch(scene, rt_kernel._ray_fields(*c12_in[2:8]),
                                                 25.0, sizes_)
                t_a = cuda_times(alone, 10)
                dev = prep_device_ms(alone, ROUTE_KERNELS[route["route"]])
                if key == "B3prepC":  # the plain version and the library call, once a kind
                    t_p = cuda_times(lambda: rt_kernel.rt_prepare(*c12_in), 3, warmup=1)
                    keys = ref["tnear"].gather(1, ref["slist"].long().argsort(1))  # cell order
                    t_sort = cuda_times(lambda: torch.sort(keys, dim=1, stable=True), 10)
                    dev_sort = prep_device_ms(lambda: torch.sort(keys, dim=1, stable=True), None)
                    row[kind] = {"plain": median(t_p), "sort": median(t_sort),
                                 "sort_device": dev_sort}
                    del keys
                else:
                    row[kind] = dict(c12_rows[0][kind])
                row[kind].update({"wrapper": median(t_w), "alone": median(t_a), "device": dev})
                nb = nbytes(*c12_in[2:8], prep["cbox"], prep["boxes"], prep["tnear"],
                            prep["slist"])
                ops = H * W * OPS_PREP_PER_RAY + prep["tnear"].numel() * OPS_PREP_PER_KEY
                row["bound"] = bound(nb, ops)
                print(f"C12 {route['route']} route ({kind} keys): wrapper {summary(t_w)}; "
                      f"kernel alone {summary(t_a)}, device {dev:.4f} ms; plain rt_prepare "
                      f"{row[kind]['plain']:.4f} ms; torch.sort of the keys "
                      f"{row[kind]['sort']:.4f} ms (device {row[kind]['sort_device']:.4f}) "
                      f"on {gpu}")
                del ref, prep, scene, alone
        ms_b, by = row["bound"]
        res = (_cuda.resources("rt_prepare_cluster", C12_CELLS, route["cluster"])
               if key == "B3prepC" else _cuda.resources("rt_prepare_large"))
        static = (rt_kernel.CLUSTER_SMEM_STATIC if key == "B3prepC"
                  else rt_kernel.GLOBAL_SMEM_STATIC)
        if res["smem_static"] != static:
            raise SystemExit(f"{symbol}: rt_kernel's static shared memory is {static}, the "
                             f"kernel's {res}")
        print(f"bound C12 {route['route']} route: {nb} bytes, {ops} f32 ops -> {ms_b:.6f} ms, "
              f"bound by {by}")
        print(f"resources {key}: {res['registers']} registers, "
              f"{res['smem_static'] + res['smem_dynamic']} B shared memory a block, "
              f"{res['blocks_per_sm']} blocks of 512 threads an SM" + (f", clusters of {route['cluster']} blocks, {res['clusters']} clusters "
                       f"at once" if key == "B3prepC" else "") + f" on {gpu}")
        c12_rows.append(row)
        spread = row["spread"]
        rows.append({
            "name": f"rt_prepare_cuda {route['route']} route ({symbol}; timed on 1080p rays "
                    f"over {C12_CELLS} cells with spread keys, launched on path "
                    f"{'Bl' if key == 'B3prepC' else 'Blg'})",
            "route": "cuda", "source": "rusterix_tpu_torch/csrc/rt_kernel.cu",
            "replaces": "rusterix_tpu/ops/rt_kernel.py:286-354",
            "launches": counts_bl[key], "max_abs_err": 0.0,
            "ms": spread["wrapper"], "plain_ms": spread["plain"], "bound_ms": ms_b,
            "bound_by": by, "library_ms": spread["sort"], "device_ms": spread["device"],
            "alone_ms": spread["alone"], "ties": row["ties"],
            **({"cluster": route["cluster"]} if key == "B3prepC" else {}), **res,
        })

    phase("GL")
    rows[-1]["gl"] = gl_phase(gpu)

    phase("C12 sweep")
    # 6. the routes across cell counts, with torch.sort beside them
    prep_sweep(gpu)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    def phase(label):
        print(f"[{time.perf_counter() - t_start:.1f} s] phase {label}", flush=True)
    from rusterix_tpu_torch import _cuda
    from rusterix_tpu_torch.ops import (
        megakernel,
        raster,
        reflect,
        rt_kernel,
        scene_pack,
        shadow,
        visibility_pallas,
    )
    from rusterix_tpu_torch.ops.composite import d2_pass, sky_miss_pass
    from rusterix_tpu_torch.ops.raster import (
        ambient_occlusion,
        frame_inputs,
        opacity_layers,
        visibility_prepass,
    )
    from rusterix_tpu_torch.ops.scene_pack import PackedScene
    from rusterix_tpu_torch.ops.setup_pass import setup_pass
    from rusterix_tpu_torch.ops.shade import gbuffer_pass, shade_pass, shader_state
    from rusterix_tpu_torch.parallel import (
        make_mesh,
        render_frame_sharded,
        sharded_inputs,
    )
    from rusterix_tpu_torch.scenes import (
        build_map_refl_scene,
        build_map_scene,
        build_map_shadow_refl_scene,
        build_map_glass_shader_scene,
        move_dynamic,
    )


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
    if (min(v for k, v in counts_b.items() if k not in ("B3prepC", "B3prepL")) < 1
            or counts_b["B3prepC"] or counts_b["B3prepL"]):
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
    from rusterix_tpu_torch import scenes as scenes_mod

    later = {k: (label, getattr(scenes_mod, name)) for k, (label, name) in LATER.items()}
    paths = {}
    for key, (label, build) in later.items():
        pw, ph = SIZES.get(key, (W, H))
        r_, s_, a_ = build(pw, ph, device="cuda")
        if key == "V":
            move_dynamic(s_, V_TIMES[0])
        first_ms = None
        if key in SHADOWED + SHADED + BAKED_FIRST:
            # the first frame bakes the maps (G-J) or packs the scene with its
            # shader bakes (O-Q); the launches are counted on a steady frame
            # after it (the bakes launch none of the kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r_.rasterize(s_, pw, ph, 40, a_, readback=False)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
        if key == "V":
            move_dynamic(s_, V_TIMES[1])  # the billboards move before the counted frame
        zero_counts()
        f_ = r_.rasterize(s_, pw, ph, 40, a_)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != EXPECTED_LAUNCHES[key]:
            raise SystemExit(f"path {key} ({label}) launched {counts}, expected "
                             f"{EXPECTED_LAUNCHES[key]}")
        if f_.shape != (ph, pw, 4) or f_.dtype != np.uint8:
            raise SystemExit(f"path {key} frame is {f_.shape} {f_.dtype}")
        fa_ = r_.frame_args
        print(f"main path {key} ({label}): frame {f_.shape} {f_.dtype}, rendered at "
              f"{fa_['width']}x{fa_['height']}, launches {counts}")
        paths[key] = {"label": label, "rast": r_, "scene": s_, "assets": a_, "frame": f_,
                      "counts": counts, "first_ms": first_ms, "size": (pw, ph)}
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
    # the slice's frames: K and L are the map with floors (more covered
    # pixels than A); M's 2D rectangle leaves the gradient opaque; N draws
    # the wall strips, lit unevenly by the map's lights
    cov_k = int((paths["K"]["frame"] != bg).any(axis=-1).sum())
    f_m, f_n = paths["M"]["frame"], paths["N"]["frame"]
    walls = f_n[..., 3] > 0
    lit = f_n[..., 0][walls].astype(int)
    print(f"path K: covered px {cov_k} (A: {covered}); path M: opaque px "
          f"{int((f_m[..., 3] == 255).sum())} of {f_m.shape[0] * f_m.shape[1]}; path N: wall "
          f"px {int(walls.sum())}, red channel {int(lit.min())}-{int(lit.max())}")
    if not (cov_k > covered and (f_m[..., 3] == 255).all() and walls.sum() > W * H // 200
            and lit.max() > lit.min() + 30):
        raise SystemExit("a frame of the slice (K, M or N) did not render as expected")
    # the baked shaders: the packs' bake slots, the bakes on the card against
    # the CPU's, P's animation frames, what the materials change
    for key in SHADED:
        p_ = paths[key]
        packs = {dev: PackedScene.from_scene(p_["scene"], p_["assets"], static_only=True,
                                             device=dev) for dev in ("cuda", "cpu")}
        ai = {dev: pk.atlas_index for dev, pk in packs.items()}
        if not (ai["cuda"].shader_slots == ai["cpu"].shader_slots
                and ai["cuda"].shader_mat_slots == ai["cpu"].shader_mat_slots
                and packs["cuda"].runtime_shaders == () == packs["cpu"].runtime_shaders):
            raise SystemExit(f"path {key}: the CUDA and CPU packs differ in their shader slots")
        d = np.abs(ai["cuda"].atlas.data.astype(int) - ai["cpu"].atlas.data.astype(int))
        p_["bake_diff"] = (int(d.max()), int((d > 0).sum()))
        frames = ai["cuda"].atlas.tile_count[ai["cuda"].shader_slots[0][0]]
        print(f"path {key}: shader slots {ai['cuda'].shader_slots}, material slots "
              f"{ai['cuda'].shader_mat_slots}, {frames} bake frame(s); CUDA bake vs CPU bake: "
              f"max diff {p_['bake_diff'][0]} (tolerance {BAKE_TOL}), texel bytes differing "
              f"{p_['bake_diff'][1]} of {d.size}; first frame (pack + bakes) "
              f"{p_['first_ms']:.4f} ms of wall time on {gpu}")
        if p_["bake_diff"][0] > BAKE_TOL:
            raise SystemExit(f"path {key}: the CUDA bake differs from the CPU bake")
    fa_p = paths["P"]["rast"].frame_args
    if not (fa_p["has_material"] and paths["Q"]["rast"].frame_args["has_matmap"]):
        raise SystemExit("paths P and Q did not take B1's material variants")
    p_ = paths["P"]
    p_["scene"].animation_frame = 5
    f_p5 = p_["rast"].rasterize(p_["scene"], *p_["size"], 40, p_["assets"])
    p_["scene"].animation_frame = 0
    moved = int((np.abs(f_p5.astype(int) - p_["frame"].astype(int)).max(-1) > 0).sum())
    print(f"path P: px differing between animation frames 0 and 5: {moved}")
    if moved < 1000:
        raise SystemExit("path P's animation frames do not differ")
    # the split paths: each frame took the runtime shaders, and they changed
    # it (against the same scene with its shaders dropped, rendered by B1)
    for key in SPLIT:
        p_ = paths[key]
        fa_ = p_["rast"].frame_args
        if not fa_["shaders"]:
            raise SystemExit(f"path {key} has no runtime shader")
        r0, s0, a0 = later[key][1](*p_["size"], device="cuda")
        s0.shaders.clear()
        s0.shaders_with_opacity.clear()
        s0.touch()
        f0 = r0.rasterize(s0, *p_["size"], 40, a0)
        by_shader = int((np.abs(p_["frame"].astype(int) - f0.astype(int)).max(-1) > 1).sum())
        p_["by_shader"] = by_shader
        print(f"path {key}: {len(fa_['shaders'])} runtime shader(s); px changed by more than 1 "
              f"against the scene without its shaders {by_shader}")
        if by_shader < 1000:
            raise SystemExit(f"path {key}'s runtime shader changed only {by_shader} pixels")
    # V: a third frame with the billboards moved again, the frames differ
    # where they moved, and the dynamic casters darken the maps
    p_ = paths["V"]
    r_, s_, a_ = p_["rast"], p_["scene"], p_["assets"]
    fa_ = r_.frame_args
    # the dynamic d3 pack (16 slots) follows the static one: the billboard's
    # two triangles live there
    if not (fa_["has_opacity"] and fa_["has_d2"] and int(fa_["d3"]["valid"][-16:].sum()) == 2):
        raise SystemExit("path V's frame lacks its dynamic batches")
    move_dynamic(s_, V_TIMES[2])
    zero_counts()
    f_v3 = r_.rasterize(s_, W, H, 40, a_)
    torch.cuda.synchronize()
    if read_counts() != EXPECTED_LAUNCHES["V"]:
        raise SystemExit(f"path V's third frame launched {read_counts()}")
    moved = int((np.abs(f_v3.astype(int) - p_["frame"].astype(int)).max(-1) > 1).sum())
    r_.set_shadows(True, dynamic_casters=False)
    f_static = r_.rasterize(s_, W, H, 40, a_)
    r_.set_shadows(True)
    by_casters = int((np.abs(f_v3.astype(int) - f_static.astype(int)).max(-1) > 0).sum())
    p_["moved"], p_["by_casters"] = moved, by_casters
    print(f"path V: frames at t = {V_TIMES[1]} and {V_TIMES[2]} differ by more than 1 at {moved} "
          f"px; the dynamic casters change {by_casters} px of the t = {V_TIMES[2]} frame")
    if moved < 1000 or by_casters == 0:
        raise SystemExit("path V's dynamic batches did not move or cast")
    phase("4h")
    # 4h. the host-to-device copies of a steady frame of every unsharded
    # path (the profiler's Memcpy HtoD records), and how the frame reached
    # the device: one arena upload a frame (ops/arena.py), no frame leaf by
    # leaf, no refusal; A, B, G and K make exactly one copy
    routes = {"A": arena_route(lambda: rast.rasterize(scene, W, H, 40, assets))}
    # the profiler's Memcpy HtoD records of A's steady frame beside the count
    profiled_a = h2d_copies(lambda: rast.rasterize(scene, W, H, 40, assets))
    routes["B"] = arena_route(lambda: rast_r.rasterize(scene_r, W, H, 40, assets_r))
    for key, p_ in paths.items():
        pw, ph = p_["size"]
        clock = iter(range(1 << 30))

        def steady():
            if key == "V":  # the billboards move before every frame
                move_dynamic(p_["scene"], V_TIMES[2] + 0.1 * next(clock))
            return p_["rast"].rasterize(p_["scene"], pw, ph, 40, p_["assets"])
        routes[key] = arena_route(steady)
    for key, r in routes.items():
        check_route(key, r)
    print(f"path A steady frame by the profiler: {profiled_a} Memcpy HtoD record(s)")
    ah = arena_host_ms(rast)
    print(f"path A arena on the host (host wall, synchronised, medians of 20): the packs B1 "
          f"derives built on the host {ah['derive']:.4f} ms (they join the arena), pack_arena "
          f"+ the pinned copy enqueued {ah['pack_upload']:.4f} ms; the same packs computed on "
          f"the device from the arena's views instead {ah['derive_on_device']:.4f} ms in "
          f"{ah['ops']} device ops (bit-equal to the host's: {ah['bit_equal']}), on {gpu}")
    from rusterix_tpu_torch.profiling import frame_breakdown

    print(f"frame_breakdown path A ({W}x{H}, CUDA events, medians of 20): "
          f"{json.dumps(frame_breakdown(rast, scene, assets, W, H))} on {gpu}")
    phase("4c")
    # 4c. the row-sharded frame (parallel.render_frame_sharded) through
    # rasterize(mesh=): R, A's map in N_SLABS slabs of the card; R7, in 7
    # (the overhang of the last slab padded and cropped); Rg, R's frame
    # through render_frame_sharded with the generic light loop; S, H with AO
    # and sky light; I8 and M8, one frame each of I and M. Each is held to
    # its single frame: the pixels that differ are counted, pinned and all of
    # the tie class.
    mesh = make_mesh(N_SLABS, "cuda")

    def held_to_single(key, sharded, single, mesh_, fa_):
        differ = np.abs(sharded.astype(int) - single.astype(int)).max(-1) > 0
        ties = tie_pixels(mesh_, **fa_).cpu().numpy()
        n_diff, off = int(differ.sum()), int((differ & ~ties).sum())
        print(f"path {key}: px differing from the single frame {n_diff} (pinned "
              f"{SHARDED_PINNED[key]}), outside the tie class {off}; tie px {int(ties.sum())}")
        if off or n_diff != SHARDED_PINNED[key]:
            raise SystemExit(f"path {key}: the sharded frame differs from the single frame")

    def drive_sharded(key, rast_, scene_, assets_, mesh_, size=(W, H)):
        zero_counts()
        out = rast_.rasterize(scene_, *size, 40, assets_, mesh=mesh_)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != EXPECTED_LAUNCHES[key]:
            raise SystemExit(f"path {key} launched {counts}, expected {EXPECTED_LAUNCHES[key]}")
        if out.shape != (size[1], size[0], 4) or out.dtype != np.uint8:
            raise SystemExit(f"path {key} frame is {out.shape} {out.dtype}")
        print(f"main path {key} ({len(mesh_)} slabs): frame {out.shape} {out.dtype}, "
              f"launches {counts}")
        return out, counts

    frame_rs, counts_r = drive_sharded("R", rast, scene, assets, mesh)
    held_to_single("R", frame_rs, frame, mesh, rast.frame_args)
    mesh7 = make_mesh(7, "cuda")
    frame_r7, _counts = drive_sharded("R7", rast, scene, assets, mesh7)
    held_to_single("R7", frame_r7, frame, mesh7, rast.frame_args)
    fa_r = {k: v for k, v in rast.frame_args.items() if k != "refl_scale"}
    zero_counts()
    frame_rg = render_frame_sharded(mesh, **dict(fa_r, light_spec=None)).cpu().numpy()
    counts_rg = read_counts()
    print(f"path Rg (render_frame_sharded, light_spec None, {N_SLABS} slabs): launches "
          f"{counts_rg}, px differing from R's frame "
          f"{int((frame_rg != frame_rs).any(-1).sum())}")
    if counts_rg != EXPECTED_LAUNCHES["R"] or not np.array_equal(frame_rg, frame_rs):
        raise SystemExit("the generic light loop's frame differs from the specialised frame")
    rast_s, scene_s, assets_s = build_map_shadow_refl_scene(W, H, device="cuda")
    rast_s.set_ambient_occlusion(True).set_sky_light(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame_s1 = rast_s.rasterize(scene_s, W, H, 40, assets_s)  # bakes the maps
    torch.cuda.synchronize()
    first_s = (time.perf_counter() - t0) * 1e3
    fa_s = {k: v for k, v in rast_s.frame_args.items() if k != "refl_scale"}
    if not (fa_s["ao_taps"] and fa_s["sky_light"] and fa_s["refl_samples"]
            and fa_s["shadow_spec"] is not None and fa_s["brdf_ggx"]):
        raise SystemExit("path S is not H with AO and sky light")
    frame_ss, counts_s = drive_sharded("S", rast_s, scene_s, assets_s, mesh)
    held_to_single("S", frame_ss, frame_s1, mesh, rast_s.frame_args)
    for key, path in (("I8", "I"), ("M8", "M"), ("T8", "T")):
        p_ = paths[path]
        f_, counts_ = drive_sharded(key, p_["rast"], p_["scene"], p_["assets"], mesh, p_["size"])
        held_to_single(key, f_, p_["frame"], mesh, p_["rast"].frame_args)
        if key == "T8":
            counts_t8 = counts_
    launches = {k: counts_a[k] + counts_b[k] + counts_r[k] + counts_s[k] + counts_t8[k]
                + sum(p_["counts"][k] for p_ in paths.values()) for k in counts_a}

    phase("5")
    # 5. every kernel against its plain version on the frames' own inputs
    fi_o = frame_inputs(**rast.frame_args)
    args, kwargs = fi_o["mega_args"], fi_o["mega_kwargs"]
    rgba_k, z_k = megakernel.mega_render(*args, **kwargs)
    rgba_p, z_p, work = megakernel.mega_render_reference(*args, **kwargs, return_work=True)
    b1_tests = work["vis_tests"]
    b1_nbytes = {"opaque": b1_bytes(args, (rgba_k, z_k), work)}
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
    b1_nbytes["ggx"] = b1_bytes(gargs, (rgba_k, z_k), work)
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
        if key in SPLIT:
            # the split path: B2 over the Morton-ordered candidates (its only
            # visibility pass), bit for bit; U's reflection rays through B3
            pw, ph = p_["size"]
            if not fi_["split"]:
                raise SystemExit(f"path {key} did not take the split path")
            b2_in_ = (fi_["vis_s"], fi_["alive_s"], fi_["bbox_s"], pw, ph)
            z2_, i2_, h2_ = visibility_pallas.visibility_pass_pallas(*b2_in_)
            z2p_, i2p_, _h2p = visibility_pallas.visibility_pass_pallas_reference(*b2_in_)
            torch.cuda.synchronize()
            p_["b2_in"], p_["b2_out"] = b2_in_, (z2_, i2_)
            p_["b2_err"] = float((z2_ - z2p_).abs().max())
            p_["b2_tests"] = visibility_pallas.scan_work(*b2_in_)
            print(f"B2 vs plain (path {key}, the Morton order, {pw}x{ph}): idx px differing "
                  f"{int((i2_ != i2p_).sum())}, z px differing {int((z2_ != z2p_).sum())}, "
                  f"covered px {int(h2_.sum())}, visibility tests {p_['b2_tests']}")
            if not (torch.equal(i2_, i2p_) and torch.equal(z2_, z2p_)):
                raise SystemExit(f"B2 path {key}: the visibility kernel disagrees with its "
                                 "plain version on the Morton order")
            if key != "U":
                continue
            kin_ = reflection_kernel_inputs(r_, fi_)
            b3_in_ = kin_["b3_in"]
            prep_k_ = rt_kernel.rt_prepare_cuda(*b3_in_)
            prep_p_ = rt_kernel.rt_prepare(*b3_in_)
            t3_, i3_ = rt_kernel.intersect_rays_pallas(*b3_in_)
            t3p_, i3p_, work_ = rt_kernel.intersect_rays_pallas_reference(*b3_in_,
                                                                          return_work=True)
            torch.cuda.synchronize()
            bad_ = [k for k in ("boxes", "tnear", "slist", "tab", "cbox", "tcap")
                    if not torch.equal(prep_k_[k], prep_p_[k])]
            p_["kin"], p_["prep"], p_["b3_work"], p_["b3_out"] = kin_, prep_k_, work_, (t3_, i3_)
            print(f"B3 vs plain (path {key}, {int(kin_['rays']['ok'].sum())} reflection rays cast "
                  f"from the shaded G-buffer): preparation "
                  f"{'equal' if not bad_ else 'DIFFERS in ' + ', '.join(bad_)}; walk idx rays "
                  f"differing {int((i3_ != i3p_).sum())}, hits {int((i3_ >= 0).sum())}, "
                  f"work {work_}")
            if bad_ or not (torch.equal(i3_, i3p_) and torch.equal(t3_, t3p_)):
                raise SystemExit(f"B3 path {key}: a ray kernel disagrees with its plain version")
            continue
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
        p_["b1_bytes"] = b1_bytes(a_, (rgba_l, z_l), work_b1,
                                  [k_["ao_img"]] if "ao_img" in k_ else []) + (
            0 if table is None else min(4 * reads, nbytes(table)))
        print(f"B1 vs plain (path {key}, {fa_['width']}x{fa_['height']}"
              f"{', ao_img' if 'ao_img' in k_ else ''}): z_eff equal, rgba max diff "
              f"{p_['b1_err']} (tolerance {RGBA_TOL}), px differing "
              f"{int((diff.amax(-1) > 0).sum())}, visibility tests {tests}, "
              f"px with a winner {p_['covered']}")
        if p_["b1_err"] > (0 if key in SHADOWED + BLEND_2D + SHADED + ("V",) else RGBA_TOL):
            raise SystemExit(f"B1 path {key}: the megakernel disagrees with its plain version")
        if key in BLEND_2D + SHADED:
            for cut in (1, 2):
                out_k = megakernel.mega_render(*a_, **k_, stage_cut=cut)
                out_p = megakernel.mega_render_reference(*a_, **k_, stage_cut=cut)
                torch.cuda.synchronize()
                if not (torch.equal(out_k[0], out_p[0]) and torch.equal(out_k[1], out_p[1])):
                    raise SystemExit(f"B1 path {key} stage_cut={cut} differs from the plain "
                                     "version")
            print(f"B1 stage_cut 1 and 2 vs plain (path {key}): both outputs equal")
        if key in ("K", "L"):
            no_blend, _ = megakernel.mega_render(*a_, **dict(k_, has_blend=False))
            torch.cuda.synchronize()
            p_["by_blend"] = int((no_blend != rgba_l).sum())
            print(f"path {key}: has_blend {k_['has_blend']}, table {a_[3].shape[1]} columns, "
                  f"px changed by the blend {p_['by_blend']}")
            if not (k_["has_blend"] and p_["by_blend"] > W * H // 20):
                raise SystemExit(f"path {key}: B1's blend branch did nothing")
        if key in SHADED:
            no_mat, _ = megakernel.mega_render(*a_, **dict(k_, has_material=False,
                                                           has_matmap=False))
            torch.cuda.synchronize()
            p_["by_material"] = int((no_mat != rgba_l).sum())
            print(f"path {key}: has_material {k_['has_material']}, has_matmap "
                  f"{k_['has_matmap']}, table {a_[3].shape[1]} columns, px changed by the "
                  f"material {p_['by_material']}")
            if not (k_["has_material"] and p_["by_material"] > 100):
                raise SystemExit(f"path {key}: B1's material branch did nothing")
        if key in SHADOWED + ("V",):
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
        if key in ("F", "G", "I", "K", "M", "N", "O", "P", "V"):
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

    phase("5c")
    # 5c. the row-sharded paths' kernels against their plain versions on the
    # middle slab's own inputs (parallel.sharded_inputs): B1 at its row offset
    # on R (stage_cut 0, 1, 2), with the generic light loop on R (also
    # against the specialised launch), at its row offset on S (GGX, shadows,
    # the AO factor; stage_cut 0, 1, 2), and B2 at its row offset on S. All
    # bit for bit.
    slab_r = sharded_inputs(mesh, **fa_r)[MID_SLAB]
    slab_s = sharded_inputs(mesh, **fa_s)[MID_SLAB]
    sharded_forms = {
        "R": (slab_r["mega_args"], slab_r["mega_kwargs"]),
        "Rg": (slab_r["mega_args"], dict(slab_r["mega_kwargs"], light_spec=None)),
        "S": (slab_s["mega_args"], slab_s["mega_kwargs"]),
    }
    slab_forms = {}
    for key, (a_, k_) in sharded_forms.items():
        rgba_k, z_k = megakernel.mega_render(*a_, **k_)
        rgba_p, z_p, work_ = megakernel.mega_render_reference(*a_, **k_, return_work=True)
        cuts = [megakernel.mega_render(*a_, **k_, stage_cut=c) for c in (1, 2)]
        cuts_p = [megakernel.mega_render_reference(*a_, **k_, stage_cut=c) for c in (1, 2)]
        torch.cuda.synchronize()
        equal = torch.equal(rgba_k, rgba_p) and torch.equal(z_k, z_p) and all(
            torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) for x, y in zip(cuts, cuts_p))
        n_cov = int((cuts[0][0] >= 0).sum())
        reads = work_["cube_reads"] + work_["sun_reads"] + 2 * work_["trans_steps"]
        table = k_.get("shadow_rows")
        extra = [k_["ao_img"]] if k_.get("ao_img") is not None else []
        slab_forms[key] = {
            "err": int(rgba_diff(rgba_k, rgba_p).max()), "covered": n_cov, "work": work_,
            "bytes": b1_bytes(a_, (rgba_k, z_k), work_, extra)
            + (0 if table is None else min(4 * reads, nbytes(table))),
        }
        print(f"B1 vs plain (path {key}, slab {MID_SLAB} of {N_SLABS}: rows "
              f"{slab_r['y0']}-{slab_r['y0'] + slab_r['rows'] - 1}, light_spec "
              f"{'None' if k_['light_spec'] is None else len(k_['light_spec'])}"
              f"{', ao_img' if extra else ''}): stage_cut 0, 1, 2 "
              f"{'bit-equal' if equal else 'DIFFER'}, px with a winner {n_cov}, visibility "
              f"tests {work_['vis_tests']}")
        if not equal:
            raise SystemExit(f"B1 path {key}: the kernel at the row offset disagrees with its "
                             "plain version")
    spec_rgba, spec_z = megakernel.mega_render(*sharded_forms["R"][0], **sharded_forms["R"][1])
    gen_rgba, gen_z = megakernel.mega_render(*sharded_forms["Rg"][0], **sharded_forms["Rg"][1])
    torch.cuda.synchronize()
    if not (torch.equal(spec_rgba, gen_rgba) and torch.equal(spec_z, gen_z)):
        raise SystemExit("B1's generic light loop differs from the specialised launch")
    print(f"B1 generic light loop (R's slab {MID_SLAB}): {sharded_forms['Rg'][0][7].shape[0]} "
          f"light rows visited, {len(sharded_forms['R'][1]['light_spec'])} valid; equal to the "
          "specialised launch")
    b2s_in = (slab_s["vis_s"], slab_s["alive_s"], slab_s["bbox_s"], W, slab_s["rows"],
              slab_s["y0"])
    z2s, i2s, h2s = visibility_pallas.visibility_pass_pallas(*b2s_in)
    z2sp, i2sp, _h = visibility_pallas.visibility_pass_pallas_reference(*b2s_in)
    torch.cuda.synchronize()
    print(f"B2 vs plain (path S, slab {MID_SLAB}, y0 {slab_s['y0']}): idx px differing "
          f"{int((i2s != i2sp).sum())}, z px differing {int((z2s != z2sp).sum())}, covered px "
          f"{int(h2s.sum())}")
    if not (torch.equal(i2s, i2sp) and torch.equal(z2s, z2sp)):
        raise SystemExit("B2 at the row offset disagrees with its plain version")
    b2s_tests = visibility_pallas.scan_work(*b2s_in)

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
        phase(f"6 {key}")
        small, one_pack = [], None
        for dev in ("cuda", "cpu"):
            r, s, a = build(sw, sh, device=dev)
            if r.shadow_settings is not None:
                r.set_shadows(True, res=SMALL_SHADOW_RES[0], sun_res=SMALL_SHADOW_RES[1])
            if key in SHADED:
                # both frames from one PackedScene (one bake)
                one_pack = one_pack or PackedScene.from_scene(s, a, static_only=True,
                                                              device="cpu")
            small.append(r.rasterize(s, sw, sh, 40, a, packed=one_pack).astype(np.int32))
        d = np.abs(small[0] - small[1]).max(-1)
        print(f"cuda vs cpu path {key} frame at {sw}x{sh}: max diff {int(d.max())}, "
              f"px differing {int((d > 0).sum())} (pinned {SMALL_PINNED[key]})")
        if d.max() > RGBA_TOL or int((d > 0).sum()) != SMALL_PINNED[key]:
            raise SystemExit(f"the CUDA path {key} frame disagrees with the CPU frame")
    # I's glazed doorways with a runtime shader on the glass (each peeled
    # layer shaded by it), correctness only
    phase("6 Ig")
    small = []
    for dev in ("cuda", "cpu"):
        r, s, a = build_map_glass_shader_scene(SMALL_W, SMALL_H, device=dev)
        r.set_shadows(True, res=SMALL_SHADOW_RES[0], sun_res=SMALL_SHADOW_RES[1])
        small.append(r.rasterize(s, SMALL_W, SMALL_H, 40, a).astype(np.int32))
        if not (r.frame_args["shaders"] and r.frame_args["has_opacity"]):
            raise SystemExit("path Ig has no runtime shader on its opacity batches")
    d = np.abs(small[0] - small[1]).max(-1)
    print(f"cuda vs cpu path Ig (I with a runtime shader on the glass) at {SMALL_W}x{SMALL_H}: "
          f"max diff {int(d.max())}, px differing {int((d > 0).sum())} (pinned "
          f"{SMALL_PINNED['Ig']})")
    if d.max() > RGBA_TOL or int((d > 0).sum()) != SMALL_PINNED["Ig"]:
        raise SystemExit("the CUDA path Ig frame disagrees with the CPU frame")

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
    b2_alone = median(cuda_times(visibility_pallas.prepare_launch(*b2_in), 100))
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
    print(f"plain visibility_pass_pallas_reference: {summary(b2_plain_t)}; B2 kernel alone "
          f"{b2_alone:.4f} ms (median of 100) on {gpu}")
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
    def frame_call(key):
        """A steady frame of path `key` (readback=False); V's dynamic
        batches move a step before each one."""
        p_ = paths[key]
        r_, s_, as_ = p_["rast"], p_["scene"], p_["assets"]
        pw, ph = p_["size"]
        if key != "V":
            return lambda: r_.rasterize(s_, pw, ph, 40, as_, readback=False)
        clock = iter(range(1 << 30))

        def moving():
            move_dynamic(s_, V_TIMES[2] + 0.02 * (next(clock) % 50))
            return r_.rasterize(s_, pw, ph, 40, as_, readback=False)
        return moving

    for key, p_ in paths.items():
        phase(f"7 {key}")
        pw, ph = p_["size"]
        p_["frame_t"] = cuda_times(frame_call(key), N_FRAMES.get(key, 10))
        print(f"rasterize(readback=False) path {key} ({p_['label']}) {pw}x{ph}: "
              f"{summary(p_['frame_t'])} on {gpu}")
        if key in SPLIT:
            b2_in_ = p_["b2_in"]
            p_["b2_t"] = cuda_times(lambda: visibility_pallas.visibility_pass_pallas(*b2_in_), 40)
            p_["b2_plain_t"] = cuda_times(
                lambda: visibility_pallas.visibility_pass_pallas_reference(*b2_in_), 3, warmup=1)
            p_["b2_alone"] = median(cuda_times(visibility_pallas.prepare_launch(*b2_in_), 100))
            print(f"B2 visibility_pass_pallas path {key} (the Morton order): "
                  f"{summary(p_['b2_t'])}; plain {summary(p_['b2_plain_t'])}; kernel alone "
                  f"{p_['b2_alone']:.4f} ms (median of 100) on {gpu}")
        else:
            a_, k_ = p_["mega"]
            p_["b1_t"] = cuda_times(lambda: megakernel.mega_render(*a_, **k_), 40)
            p_["b1_plain_t"] = cuda_times(lambda: megakernel.mega_render_reference(*a_, **k_), 2,
                                          warmup=1)
            p_["alone"] = median(cuda_times(megakernel.prepare_launch(*a_, **k_), 100))
            print(f"B1 mega_render path {key}: {summary(p_['b1_t'])}; plain "
                  f"{summary(p_['b1_plain_t'])}; kernel alone {p_['alone']:.4f} ms (median of "
                  f"100) on {gpu}")
        if "kin" in p_:
            b3_in_, prep_k_ = p_["kin"]["b3_in"], p_["prep"]
            fields_ = rt_kernel._ray_fields(*b3_in_[2:8])
            p_["walk_t"] = cuda_times(lambda: rt_kernel._launch(prep_k_, fields_), 40)
            p_["prep_t"] = cuda_times(lambda: rt_kernel.rt_prepare_cuda(*b3_in_), 40)
            p_["b3_t"] = cuda_times(lambda: rt_kernel.intersect_rays_pallas(*b3_in_), 40)
            # L's, Q's and U's plain walks take seconds a call: one
            p_["b3_plain_t"] = cuda_times(
                lambda: rt_kernel.intersect_rays_pallas_reference(*b3_in_),
                1 if key in ("L", "Q", "U") else 2, warmup=1)
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
        # G's bake is profiled; I's 463,332 device ops (PR 9) take a
        # minute to read
        bake_prof = None if key in GLASS else profile_calls(bake, 1)
        bake_dev = ("device time not measured" if bake_prof is None else
                    f"device {bake_prof['device_ms']:.4f} ms in {bake_prof['ops']:.1f} device ops")
        layers_txt = (", with 4 transmittance layers a map (1 + 4 peels a camera)"
                      if key in GLASS else "")
        print(f"shadow bake (path {key}, plain torch, 25 depth renders{layers_txt}): first frame "
              f"{p_['first_ms']:.4f} ms of wall time with the bake; bake alone median "
              f"{p_['bake_ms']:.4f} ms of wall time (n={n_bake}), {bake_dev} on {gpu}")
    # O and Q: B1 alone with and without the material (and the matmap)
    for key in ("O", "Q"):
        a_m, k_m = paths[key]["mega"]
        forms = {"without the material": dict(k_m, has_material=False, has_matmap=False)}
        if k_m["has_matmap"]:
            forms["has_material alone"] = dict(k_m, has_matmap=False)
        alone_m = {name: median(cuda_times(megakernel.prepare_launch(*a_m, **kw), 100))
                   for name, kw in forms.items()}
        print(f"B1 kernel alone on path {key}'s inputs (stage_cut 0): with "
              + ("has_matmap" if k_m["has_matmap"] else "has_material")
              + f" {paths[key]['alone']:.4f} ms, "
              + ", ".join(f"{name} {ms:.4f} ms" for name, ms in alone_m.items())
              + f" (medians of 100) on {gpu}")
    # K: B1 alone with and without its blend branch, beside A's
    a_k, k_k = paths["K"]["mega"]
    no_blend_alone = median(cuda_times(
        megakernel.prepare_launch(*a_k, **dict(k_k, has_blend=False)), 100))
    print(f"B1 kernel alone on the blended map's inputs (stage_cut 0): with has_blend "
          f"{paths['K']['alone']:.4f} ms, without {no_blend_alone:.4f} ms; the opaque map (A) "
          f"{cut_t['opaque', 0]:.4f} ms (medians of 100) on {gpu}")
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
    # the sharded paths: frames (R beside A's, S beside its single frame),
    # B1's three forms on the middle slab (wrapper, plain, alone), B2 at its
    # row offset
    frame_rs_t = cuda_times(
        lambda: rast.rasterize(scene, W, H, 40, assets, readback=False, mesh=mesh), 20)
    frame_rg_t = cuda_times(
        lambda: render_frame_sharded(mesh, **dict(fa_r, light_spec=None)), 10)
    frame_ss_t = cuda_times(
        lambda: rast_s.rasterize(scene_s, W, H, 40, assets_s, readback=False, mesh=mesh),
        10)
    frame_s1_t = cuda_times(
        lambda: rast_s.rasterize(scene_s, W, H, 40, assets_s, readback=False), 10)
    print(f"rasterize(readback=False) path R ({N_SLABS} slabs) {W}x{H}: {summary(frame_rs_t)}; "
          f"A single {summary(frame_t)} on {gpu}")
    print(f"render_frame_sharded path Rg (light_spec None, {N_SLABS} slabs): "
          f"{summary(frame_rg_t)} on {gpu}")
    print(f"rasterize(readback=False) path S ({N_SLABS} slabs) {W}x{H}: {summary(frame_ss_t)}; "
          f"its single frame {summary(frame_s1_t)}; first single frame (the bake) "
          f"{first_s:.4f} ms of wall time on {gpu}")
    for key, (a_, k_) in sharded_forms.items():
        f_ = slab_forms[key]
        f_["t"] = cuda_times(lambda: megakernel.mega_render(*a_, **k_), 40)
        f_["plain_t"] = cuda_times(lambda: megakernel.mega_render_reference(*a_, **k_), 3,
                                   warmup=1)
        f_["alone"] = median(cuda_times(megakernel.prepare_launch(*a_, **k_), 100))
        print(f"B1 mega_render path {key} slab {MID_SLAB}: {summary(f_['t'])}; plain "
              f"{summary(f_['plain_t'])}; kernel alone {f_['alone']:.4f} ms (median of 100) "
              f"on {gpu}")
    b2s_t = cuda_times(lambda: visibility_pallas.visibility_pass_pallas(*b2s_in), 40)
    b2s_plain_t = cuda_times(
        lambda: visibility_pallas.visibility_pass_pallas_reference(*b2s_in), 3, warmup=1)
    b2s_alone = median(cuda_times(visibility_pallas.prepare_launch(*b2s_in), 100))
    print(f"B2 visibility_pass_pallas path S slab {MID_SLAB} (row offset {slab_s['y0']}): "
          f"{summary(b2s_t)}; plain {summary(b2s_plain_t)}; kernel alone {b2s_alone:.4f} ms "
          f"(median of 100) on {gpu}")

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
    # N's frame is its 2D pass but for B1 over no candidate (its profile
    # below): the lights and their wall test, then one step a triangle
    fa_n = paths["N"]["rast"].frame_args
    print(f"path N: {int(fa_n['d2']['valid'].sum())} 2D triangles, "
          f"{int(fa_n['uniforms']['seg_valid'].sum())} wall segments, "
          f"{len(fa_n['light_spec'])} lights")
    for name, fn in glass_steps.items():
        wall = wall_ms(fn, 5)
        ev = cuda_times(fn, 5, warmup=1)
        prof = profile_calls(fn, 2)
        dev = ("device time not measured" if prof is None else
               f"device {prof['device_ms']:.4f} ms in {prof['ops']:.1f} device ops")
        print(f"step path I {name} (plain torch, {W}x{H}): wall median {wall:.4f} ms (n=5), "
              f"events {summary(ev)}, {dev} per call on {gpu}")
    # T's split path step by step: the setup pass and the Morton sort, B2
    # with the remap, shade_pass (the G-buffer with the runtime shader, the
    # lights), the shader's evaluation alone on the frame's registers
    fa_t = paths["T"]["rast"].frame_args
    fi_t = frame_inputs(**fa_t)
    pre_t = visibility_prepass(fi_t, W, H)
    g_t = gbuffer_pass(*pre_t, fi_t["attr"], fi_t["tri_id"], fa_t["d3"], fa_t["atlas"],
                       fa_t["uniforms"], W, H, fa_t["sample_mode"])
    zeros_t = torch.zeros_like(g_t["roughness"])
    state_t = shader_state(zeros_t, zeros_t, g_t["base"], g_t["roughness"], g_t["metallic"],
                           g_t["emissive"], g_t["opacity"], g_t["normal"], g_t["world"],
                           fa_t["uniforms"])
    prog_t = fa_t["shaders"][0]
    split_steps = {
        "frame_inputs (setup pass + morton_sort)": lambda: frame_inputs(**fa_t),
        "visibility_prepass (B2 + remap)": lambda: visibility_prepass(fi_t, W, H),
        "shade_pass (G-buffer with the shader, lights)": lambda: shade_pass(
            *pre_t, fi_t["attr"], fi_t["tri_id"], fa_t["d3"], fa_t["atlas"], fa_t["lights"],
            fa_t["uniforms"], W, H, fa_t["sample_mode"], shaders=fa_t["shaders"],
            has_fog=fa_t["has_fog"]),
        "Program.shade (FLOOR_CHECKER, every pixel)": lambda: prog_t.shade(dict(state_t)),
    }
    for name, fn in split_steps.items():
        wall = wall_ms(fn, 10)
        ev = cuda_times(fn, 10, warmup=1)
        prof = profile_calls(fn, 3)
        dev = ("device time not measured" if prof is None else
               f"device {prof['device_ms']:.4f} ms in {prof['ops']:.1f} device ops")
        print(f"step path T {name} ({W}x{H}): wall median {wall:.4f} ms (n=10), "
              f"events {summary(ev)}, {dev} per call on {gpu}")
    # V's per-frame work beside B1: the dynamic lists packed on the host
    # and uploaded, the casters' depth composited into the maps, the
    # dynamic pane's layer, the dynamic rectangle's 2D pass (its 2D lights
    # and the map's walls over the whole frame)
    p_v = paths["V"]
    s_v = p_v["scene"]
    # a frame of V again: the scene and shadow caches hold the last scene
    # rendered, and the steps read V's
    p_v["rast"].rasterize(s_v, W, H, 40, p_v["assets"], readback=False)
    fa_v = p_v["rast"].frame_args
    (cache_v,) = [c for k, c in raster._SCENE_CACHE.items() if k[0] == s_v._cache_uid]
    (cams_v,) = [e[3] for k, e in raster._SHADOW_CACHE.items()
                 if k[0][0] == s_v._cache_uid and e[2] == fa_v["shadow_spec"]]
    dyn_v = {k: v[-16:] for k, v in fa_v["d3"].items()}
    frame_v = torch.rand((H, W, 4), device="cuda")
    dynamic_steps = {
        "pack_dynamic (host) + upload": lambda: [
            torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for part in scene_pack.pack_dynamic(s_v, cache_v["packed"].atlas_index,
                                                *cache_v["dyn_caps"])[:3]
            for v in vars(part).values()],
        "composite_dynamic_depth (25 depth renders of the dynamic pack)":
            lambda: shadow.composite_dynamic_depth(
                fa_v["shadow_rows"], fa_v["shadow_spec"], cams_v, dyn_v["pos"], dyn_v["uv"],
                dyn_v["nrm"], dyn_v["valid"]),
        "opacity layer (the dynamic pane)": lambda: opacity_layers(
            fa_v["d3_op"], fa_v["atlas"], fa_v["uniforms"], W, H, fa_v["sample_mode"],
            fa_v["transparency_layers"]),
        "d2_pass (the dynamic rectangle, 2D lights and walls)": lambda: d2_pass(
            frame_v, fa_v["d2"], fa_v["atlas"], fa_v["lights"], fa_v["uniforms"], W, H,
            fa_v["sample_mode"], fa_v["preserve_transparency"], has_lights=fa_v["has_lights"],
            has_ambient=fa_v["has_ambient"]),
    }
    for name, fn in dynamic_steps.items():
        wall = wall_ms(fn, 5)
        ev = cuda_times(fn, 5, warmup=1)
        prof = profile_calls(fn, 2)
        dev = ("device time not measured" if prof is None else
               f"device {prof['device_ms']:.4f} ms in {prof['ops']:.1f} device ops")
        print(f"step path V {name} ({W}x{H}): wall median {wall:.4f} ms (n=5), "
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
    path_kernels["L"] = path_kernels["D"]
    path_kernels["K"] = path_kernels["M"] = path_kernels["N"] = path_kernels["F"]
    path_kernels["O"] = path_kernels["P"] = path_kernels["F"]
    path_kernels["Q"] = path_kernels["D"]
    path_kernels["T"] = path_kernels["W"] = {"B2": "visibility_kernel"}
    path_kernels["U"] = {"B2": "visibility_kernel", "B3": ("rt_kernel", 2),
                         "B3prep": ("rt_prepare_kernel", 2)}
    path_kernels["V"] = path_kernels["F"]
    for key, p_ in paths.items():
        phase(f"8 {key}")
        n_key = (N_PROF_GLASS if key in GLASS + ("V",) else N_PROF_N if key == "N"
                 else N_PROF_LATER)
        p_["dev"] = report_profile(
            f"path {key} rasterize(readback=False) x{n_key}",
            profile_calls(frame_call(key), n_key),
            median(p_["frame_t"]), gpu, path_kernels[key])
    per_slab = {"B1": ("mega_kernel", N_SLABS)}
    dev_r = report_profile(
        f"path R rasterize(readback=False, mesh) x{N_PROF_LATER}",
        profile_calls(lambda: rast.rasterize(scene, W, H, 40, assets, readback=False,
                                             mesh=mesh), N_PROF_LATER),
        median(frame_rs_t), gpu, per_slab)
    dev_rg = report_profile(
        f"path Rg render_frame_sharded(light_spec=None) x{N_PROF_2D}",
        profile_calls(lambda: render_frame_sharded(mesh, **dict(fa_r, light_spec=None)),
                      N_PROF_2D),
        median(frame_rg_t), gpu, per_slab)
    dev_s = report_profile(
        f"path S rasterize(readback=False, mesh) x{N_PROF_2D}",
        profile_calls(lambda: rast_s.rasterize(scene_s, W, H, 40, assets_s, readback=False,
                                               mesh=mesh), N_PROF_2D),
        median(frame_ss_t), gpu,
        dict(per_slab, B2=("visibility_kernel", N_SLABS), B3=("rt_kernel", 2 * N_SLABS),
             B3prep=("rt_prepare_kernel", 2 * N_SLABS)))

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
    for key, mat in (("O", 1), ("Q", 2)):
        a_m, k_m = paths[key]["mega"]
        res[f"B1 material form {mat} ({key})"] = _cuda.resources(
            "mega", a_m[0].shape[0] // 128, len(k_m["light_spec"]), int(a_m[8].shape[0]), mat)
    a_rg = sharded_forms["Rg"][0]
    res["B1 generic loop (Rg)"] = _cuda.resources("mega", a_rg[0].shape[0] // 128,
                                                  int(a_rg[7].shape[0]), int(a_rg[8].shape[0]))
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
    b1_bounds = {}
    for label, k_, tests, n_cov in (("opaque", kwargs, b1_tests, covered["opaque map"]),
                                    ("ggx", gkwargs, ggx_tests, covered["reflection map"])):
        for cut in (0, 1, 2):
            ops = tests * OPS_PER_VIS_TEST + shade_ops(n_cov, cut, k_, n_occ, int(args[11]))
            b1_bounds[label, cut] = bound(b1_nbytes[label], ops)
            ms, by = b1_bounds[label, cut]
            print(f"bound B1 {label} stage_cut={cut}: {b1_nbytes[label]} bytes, {ops} f32 ops "
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
                            "reflection map)"),
                      ("K", "mega_render has_blend (blended map)"),
                      ("L", "mega_render brdf_ggx has_blend (blended reflection map)"),
                      ("M", "mega_render (the bench's cube, 800x600)"),
                      ("N", "mega_render (2D map view, no 3D candidate)"),
                      ("O", "mega_render has_material (shaded cube, 800x600)"),
                      ("P", "mega_render has_material (animated shaded cube, 800x600)"),
                      ("Q", "mega_render brdf_ggx has_material has_matmap (material map)"),
                      ("V", "mega_render shadows (V: the shadowed map with dynamic batches and "
                            "dynamic casters)")):
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
            **_cuda.resources("mega", a_[0].shape[0] // 128, len(k_["light_spec"]), n_occ_,
                              2 if k_.get("has_matmap") else 1 if k_.get("has_material") else 0),
        })
    for key, name in (("D", "intersect_rays_pallas (sky rays)"),
                      ("E", "intersect_rays_pallas (960x540 reflection rays)"),
                      ("J", "intersect_rays_pallas (glazed reflection map, the opaque "
                            "frame's rays; 3 launches a frame)"),
                      ("L", "intersect_rays_pallas (blended reflection map)"),
                      ("Q", "intersect_rays_pallas (material map)"),
                      ("U", "intersect_rays_pallas (U: reflection rays of the runtime-shaded "
                            "G-buffer)")):
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
    # the split paths: B2 over the Morton-ordered candidates, the only
    # visibility pass of T, U and W
    for key, name in (("T", "visibility_pass_pallas Morton order (T: the split path, runtime "
                            "floor shader)"),
                      ("U", "visibility_pass_pallas Morton order (U: T with GGX reflections, "
                            "shadows, AO, sky light)"),
                      ("W", "visibility_pass_pallas Morton order (W: the cube with a runtime 2D "
                            "shader, 800x600)")):
        p_ = paths[key]
        b2_in_, (z_, i_) = p_["b2_in"], p_["b2_out"]
        nb = nbytes(*b2_in_[:3], z_, i_)
        ops = p_["b2_tests"] * OPS_PER_VIS_TEST
        ms, by = bound(nb, ops)
        print(f"bound B2 path {key} (Morton order): {nb} bytes, {ops} f32 ops -> {ms:.6f} ms, "
              f"bound by {by}")
        later_rows.append({
            "name": name, "route": "cuda", "source": "rusterix_tpu_torch/csrc/visibility.cu",
            "replaces": "rusterix_tpu/ops/visibility_pallas.py:42",
            "launches": p_["counts"]["B2"], "max_abs_err": p_["b2_err"],
            "ms": median(p_["b2_t"]), "plain_ms": median(p_["b2_plain_t"]),
            "bound_ms": ms, "bound_by": by, "library_ms": None,
            "device_ms": p_["dev"]["B2"], "alone_ms": p_["b2_alone"],
            **_cuda.resources("visibility", -(-b2_in_[0].shape[0] // 128)),
        })
    # the row-sharded paths' forms, on the middle slab's inputs: B1 at its
    # row offset (R), with the generic light loop (Rg), at its row offset
    # with GGX, shadows and the AO factor (S); B2 at its row offset (S)
    for key, name, counts, dev in (
            ("R", "mega_render row offset (R: A's map, slab 4 of 8)", counts_r, dev_r),
            ("Rg", "mega_render light_spec=None, the generic light loop (Rg, slab 4 of 8)",
             counts_rg, dev_rg),
            ("S", "mega_render brdf_ggx shadows ao_img row offset (S, slab 4 of 8)", counts_s,
             dev_s)):
        f_ = slab_forms[key]
        a_, k_ = sharded_forms[key]
        n_occ_ = int(a_[8].shape[0])
        work_ = f_["work"]
        ops = (work_["vis_tests"] * OPS_PER_VIS_TEST
               + shade_ops(f_["covered"], 0, k_, n_occ_, int(a_[11]), lights=a_[7])
               + work_["cube_reads"] * OPS_CUBE_SHADOW + work_["sun_reads"] * OPS_SUN_SHADOW
               + work_["trans_steps"] * OPS_TRANS_STEP)
        ms, by = bound(f_["bytes"], ops)
        print(f"bound B1 path {key} slab {MID_SLAB}: {f_['bytes']} bytes, {ops} f32 ops "
              f"({work_['vis_tests']} tests, {f_['covered']} px shaded) -> {ms:.6f} ms, bound "
              f"by {by}; kernel alone {f_['alone']:.4f} ms")
        later_rows.append({
            "name": name, "route": "cuda", "source": "rusterix_tpu_torch/csrc/megakernel.cu",
            "replaces": "rusterix_tpu/ops/megakernel.py:250",
            "launches": counts["B1"], "max_abs_err": f_["err"],
            "ms": median(f_["t"]), "plain_ms": median(f_["plain_t"]),
            "bound_ms": ms, "bound_by": by, "library_ms": None,
            "device_ms": dev["B1"], "alone_ms": f_["alone"],
            **_cuda.resources("mega", a_[0].shape[0] // 128, int(a_[7].shape[0])
                              if k_["light_spec"] is None else len(k_["light_spec"]), n_occ_),
        })
    b2s_bytes = nbytes(*b2s_in[:3], z2s, i2s)
    b2s_bound = bound(b2s_bytes, b2s_tests * OPS_PER_VIS_TEST)
    print(f"bound B2 path S slab {MID_SLAB}: {b2s_bytes} bytes, {b2s_tests * OPS_PER_VIS_TEST} "
          f"f32 ops -> {b2s_bound[0]:.6f} ms, bound by {b2s_bound[1]}")
    later_rows.append({
        "name": "visibility_pass_pallas row offset (S, slab 4 of 8)", "route": "cuda",
        "source": "rusterix_tpu_torch/csrc/visibility.cu",
        "replaces": "rusterix_tpu/ops/visibility_pallas.py:42",
        "launches": counts_s["B2"], "max_abs_err": float((z2s - z2sp).abs().max()),
        "ms": median(b2s_t), "plain_ms": median(b2s_plain_t),
        "bound_ms": b2s_bound[0], "bound_by": b2s_bound[1], "library_ms": None,
        "device_ms": dev_s["B2"], "alone_ms": b2s_alone, **res["B2"],
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
            "device_ms": dev_b["B2"], "alone_ms": b2_alone, **res["B2"],
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
    ] + later_rows + huge_paths(gpu, phase) + engine_paths(gpu, phase)
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

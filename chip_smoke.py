"""Smoke run of rusterix_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA megakernel from rusterix_tpu_torch/csrc, renders the
bench's procedural map scene at 1920x1080 through
`rusterix_tpu_torch.Rasterizer.rasterize`, checks that the frame went
through the kernel, holds the kernel against its plain torch version on the
frame's own inputs, checks the CUDA frame against the CPU frame at a small
size, times the frame, the kernel and the plain version with CUDA events
(medians in the JSON line), and breaks the frame down: host wall time per
step, and under torch.profiler the device time, device ops and busy share
per frame. Every phase raises on failure; nothing falls back to the CPU or
to the plain version. The last line is the JSON result; it is printed only
when every phase passed. Imports no jax.
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
    """median, 75th percentile (at least ten samples above it at n=40), n"""
    n = len(times)
    return f"median {times[n // 2]:.4f} ms, p75 {times[(3 * n) // 4]:.4f} ms, n={n}"


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from rusterix_tpu_torch import _cuda
    from rusterix_tpu_torch.ops import megakernel
    from rusterix_tpu_torch.ops.raster import mega_inputs
    from rusterix_tpu_torch.ops.setup_pass import setup_pass
    from rusterix_tpu_torch.scenes import build_map_scene

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
            if "registers" in line or "spill" in line or "smem" in line:
                print("ptxas:", line.strip())

    # 3-4. the main path: bench map scene at 1920x1080 through rasterize
    rast, scene, assets = build_map_scene(W, H, device="cuda")
    megakernel.launches = 0
    frame = rast.rasterize(scene, W, H, 40, assets)
    torch.cuda.synchronize()
    launches = megakernel.launches
    if launches < 1:
        raise SystemExit("main path did not launch the megakernel")
    if frame.shape != (H, W, 4) or frame.dtype != np.uint8:
        raise SystemExit(f"frame is {frame.shape} {frame.dtype}, not ({H}, {W}, 4) uint8")
    bg = np.array(rast.background_color or (0, 0, 0, 0), np.uint8)
    covered = int((frame != bg).any(axis=-1).sum())
    print(f"main path: frame {frame.shape} {frame.dtype}, megakernel launches {launches}, "
          f"covered px {covered}")
    if covered < W * H // 20:
        raise SystemExit(f"only {covered} pixels covered: the map did not render")

    # 5. B1 against its plain version on the frame's own inputs
    args, kwargs = mega_inputs(**rast.frame_args)
    rgba_k, z_k = megakernel.mega_render(*args, **kwargs)
    rgba_p, z_p = megakernel.mega_render_reference(*args, **kwargs)
    torch.cuda.synchronize()
    if not torch.equal(z_k, z_p):
        n = int((z_k != z_p).sum())
        raise SystemExit(f"z_eff differs from the plain version at {n} px")
    ck = megakernel.unpack_frame_u32(rgba_k).int()
    cp = megakernel.unpack_frame_u32(rgba_p).int()
    diff = (ck - cp).abs()
    max_err = int(diff.max())
    print(f"B1 vs plain: z_eff equal, rgba max diff {max_err} (tolerance {RGBA_TOL}), "
          f"px differing {int((diff.amax(-1) > 0).sum())}")
    if max_err > RGBA_TOL:
        raise SystemExit("megakernel disagrees with its plain version")

    # the CUDA frame against the CPU (plain) frame at a small size
    small = []
    for dev in ("cuda", "cpu"):
        r, s, a = build_map_scene(SMALL_W, SMALL_H, device=dev)
        small.append(r.rasterize(s, SMALL_W, SMALL_H, 40, a).astype(np.int32))
    small_err = int(np.abs(small[0] - small[1]).max())
    print(f"cuda vs cpu frame at {SMALL_W}x{SMALL_H}: max diff {small_err}")
    if small_err > RGBA_TOL:
        raise SystemExit("the CUDA frame disagrees with the CPU frame")

    # 6. steady-state times (the rasterize figure includes its host work)
    frame_t = cuda_times(lambda: rast.rasterize(scene, W, H, 40, assets, readback=False), 40)
    b1_t = cuda_times(lambda: megakernel.mega_render(*args, **kwargs), 40)
    plain_t = cuda_times(lambda: megakernel.mega_render_reference(*args, **kwargs), 3, warmup=1)
    print(f"rasterize(readback=False) {W}x{H}: {summary(frame_t)} on {gpu}")
    print(f"B1 mega_render: {summary(b1_t)} on {gpu}")
    print(f"plain mega_render_reference: {summary(plain_t)} on {gpu}")
    b1_ms, plain_ms = b1_t[len(b1_t) // 2], plain_t[len(plain_t) // 2]
    frame_ms = frame_t[len(frame_t) // 2]

    # 7. where the frame's time goes: host wall per step (synchronized)
    fa = rast.frame_args
    d3, unif = fa["d3"], fa["uniforms"]
    view = torch.from_numpy(unif["view"]).cuda()
    proj = torch.from_numpy(unif["proj"]).cuda()

    def run_setup():
        return setup_pass(d3["pos"], d3["uv"], d3["nrm"], d3["valid"], d3["cull"],
                          view, proj, W, H)

    vis, attr, bbox, alive, tri_id = run_setup()

    def run_table():
        return megakernel.pack_mega_table(attr, tri_id, d3, fa["atlas"],
                                          int(unif["anim_frame"]), False)

    table = run_table()
    steps = {
        "rasterize() with readback": lambda: rast.rasterize(scene, W, H, 40, assets),
        "rasterize(readback=False)": lambda: rast.rasterize(
            scene, W, H, 40, assets, readback=False),
        "mega_inputs (setup + table + sort + packs)": lambda: mega_inputs(**fa),
        "setup_pass": run_setup,
        "pack_mega_table": run_table,
        "morton_ftb_sort": lambda: megakernel.morton_ftb_sort(
            vis, bbox, alive.float(), table, W, H),
        "mega_render": lambda: megakernel.mega_render(*args, **kwargs),
    }
    for name, fn in steps.items():
        print(f"step wall {name}: median {wall_ms(fn):.4f} ms (n=20) on {gpu}")

    # device time per frame under torch.profiler; the busy share's
    # denominator is the unprofiled frame median above (same run)
    n_prof = 20
    prof = profile_calls(lambda: rast.rasterize(scene, W, H, 40, assets, readback=False), n_prof)
    b1_device_ms = None
    if prof is None:
        print("profiler: no device activity recorded; device time not measured")
    else:
        b1 = [(ms, c) for name, (ms, c) in prof["by_name"].items() if "mega_kernel" in name]
        if len(b1) != 1 or b1[0][1] != 1:
            raise SystemExit(f"profiler: expected one mega_kernel launch per frame, saw {b1}")
        b1_device_ms = b1[0][0]
        print(f"profiler, rasterize(readback=False) x{n_prof}: device {prof['device_ms']:.4f} ms "
              f"per frame, {prof['ops']:.1f} device ops per frame, busy share "
              f"{prof['device_ms'] / frame_ms:.4f} of the {frame_ms:.4f} ms frame median, "
              f"B1 mega_kernel {b1_device_ms:.4f} ms per frame on {gpu}")
        top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
        for name, (ms, c) in top:
            print(f"  device {ms:.4f} ms, {c:.1f} ops per frame: {name[:100]}")

    kernels = [{
        "name": "mega_render",
        "route": "cuda",
        "source": "rusterix_tpu_torch/csrc/megakernel.cu",
        "replaces": "rusterix_tpu/ops/megakernel.py:250",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": b1_ms,
        "plain_ms": plain_ms,
        "device_ms": b1_device_ms,
    }]
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

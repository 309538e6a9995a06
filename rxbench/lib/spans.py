"""The port's own spans and counters (rusterix_tpu_torch/profiling.py), read
in a traced run: where each device operation of a frame was launched, what
the host was doing while the device sat idle, and the host's waits.

`gather(rd)` runs once a run, after everything the other metrics read has
been gathered (a metric's `read` calls it; the result is kept on
`rd.spans`). It turns the port's tracing on and renders the profiled
frames again (`rd.prof_frames`, through the timed loop's own call) under
torch.profiler with CPU and CUDA activity, then HOST_FRAMES more frames
without the profiler, and turns tracing off. In the profile each span of
the port is a host range on the profiler's clock (its record_function),
and each kernel, copy and fill on the device carries the correlation id
of the runtime call that launched it: `split` places each device
operation in the innermost span open at its launch, and splits each gap
of the device's work over the innermost span open during it (`outside`
where no `frame` span is: the harness, the camera, the Rasterizer made
for each frame). The unprofiled frames give the host's own times by span
(`take()`'s records on time.perf_counter_ns) and the waits counted in
`sync.*`. One line a span goes to standard error.

A program without the tracing (no `profiling.enable`) gives None, and so
do its metrics: nothing is rendered then."""

from __future__ import annotations

import bisect
import collections
import json
import sys
import time
from pathlib import Path

#: frames rendered after the profiled ones, for the host's times and waits
HOST_FRAMES = 5
#: the layers that own the device's work in a frame
DEVICE_LAYERS = ("render", "arena", "readback")
OUTSIDE = "outside"
UNPLACED = "unplaced"

#: the chrome trace's categories of the host's launches and the device's ops
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def gather(rd):
    """-> the run's span numbers (`numbers`), or None where the run has no
    card or the program has no tracing. Kept on rd.spans."""
    if hasattr(rd, "spans"):
        return rd.spans
    rd.spans = None
    if rd.device == "cpu" or not rd.prof_frames:
        return None
    from rusterix_tpu_torch import profiling

    if not all(hasattr(profiling, n) for n in ("enable", "take", "counters", "span")):
        return None
    rd.spans = measure(rd, profiling)
    return rd.spans


def measure(rd, profiling) -> dict:
    """Profile rd.prof_frames again with the port's tracing on, then
    HOST_FRAMES frames without the profiler -> `numbers`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    frames = list(rd.prof_frames)
    more = range(frames[-1] + 1, frames[-1] + 1 + HOST_FRAMES)

    def call(i):
        rd.system.frame(rd.traffic.frame(i), True)

    path = Path(rd.root) / ".rxbench_cache" / "spans_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    profiling.enable(True)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in frames:
                call(i)
            torch.cuda.synchronize()
        profiling.take()
        syncs = sync_count(profiling.counters)
        for i in more:
            call(i)
        torch.cuda.synchronize()
        records = profiling.take()
        syncs = sync_count(profiling.counters) - syncs
    finally:
        profiling.enable(False)
    prof.export_chrome_trace(str(path))
    try:
        trace = json.loads(path.read_text())
    finally:
        path.unlink()
    spans, launches, ops = parse(trace)
    out = numbers(split(spans, launches, ops), len(frames), host_ms(records, len(more)),
                  syncs / len(more))
    out["seconds"] = time.perf_counter() - t0
    report(out)
    return out


def sync_count(counters) -> int:
    return sum(v for k, v in counters.items() if k.startswith("sync."))


def parse(trace: dict) -> tuple:
    """A chrome trace of torch.profiler -> (spans [(name, t0, t1)], the
    user annotations; launches {correlation: t} of the runtime calls;
    device ops [(name, t0, t1, correlation)]), in us on the profiler's
    clock."""
    spans, launches, ops = [], {}, []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "ts" not in e:
            continue
        cat = e.get("cat")
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation":
            spans.append((e["name"], t0, t1))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = t0
        elif cat in DEVICE_CATS:
            ops.append((e["name"], t0, t1, corr))
    return spans, launches, ops


def timeline(spans) -> tuple:
    """Nested host ranges -> (starts, paths): from starts[k] on (to
    starts[k + 1]) the innermost open span has the path paths[k], a tuple
    of names from the outermost (() where none is open)."""
    starts, paths = [], []

    def mark(t, path):
        if starts and starts[-1] == t:
            paths[-1] = path
        else:
            starts.append(t)
            paths.append(path)

    stack = []  # (t1, path)
    for name, t0, t1 in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][0] <= t0:
            end, _p = stack.pop()
            mark(end, stack[-1][1] if stack else ())
        path = (stack[-1][1] if stack else ()) + (name,)
        stack.append((t1, path))
        mark(t0, path)
    while stack:
        end, _p = stack.pop()
        mark(end, stack[-1][1] if stack else ())
    return starts, paths


def _owner(path: tuple) -> str:
    """A timeline path -> the key it is booked under: the names joined by
    "/" from the outermost `frame`, or OUTSIDE."""
    if "frame" not in path:
        return OUTSIDE
    return "/".join(path[path.index("frame"):])


def split(spans, launches: dict, ops) -> dict:
    """Place the device ops and the device's idle in the host spans.

    spans: the host ranges [(name, t0, t1)], nested; launches {correlation:
    host time of the runtime call}; ops [(name, t0, t1, correlation)] on the
    device. The window runs from the first `frame` span's start to the
    later of the last frame's end and the device's last work. -> {"spans":
    {key: {"device_us", "ops", "idle_us"}} (each op in the innermost span
    open at its launch, UNPLACED where its launch is not in the profile;
    each idle interval of the window split over the innermost span open in
    it, OUTSIDE where no frame is), "window_us", "busy_us", "idle_us"
    (window less the union of the ops)}."""
    starts, paths = timeline(spans)
    frames = [(t0, t1) for name, t0, t1 in spans if name == "frame"]
    by = collections.defaultdict(lambda: {"device_us": 0.0, "ops": 0, "idle_us": 0.0})
    if not frames:
        return {"spans": {}, "window_us": 0.0, "busy_us": 0.0, "idle_us": 0.0}
    lo = min(t0 for t0, _t1 in frames)
    hi = max([t1 for _t0, t1 in frames] + [t1 for _n, _t0, t1, _c in ops])

    def path_at(t):
        k = bisect.bisect_right(starts, t) - 1
        return paths[k] if k >= 0 else ()

    for _name, t0, t1, corr in ops:
        launch = launches.get(corr)
        key = UNPLACED if launch is None else _owner(path_at(launch))
        by[key]["device_us"] += t1 - t0
        by[key]["ops"] += 1

    # the device's gaps in the window, each split at the timeline's marks
    busy, reach = 0.0, lo
    gaps = []
    for t0, t1 in sorted((max(t0, lo), min(t1, hi)) for _n, t0, t1, _c in ops):
        if t1 <= t0:
            continue
        if t0 > reach:
            gaps.append((reach, t0))
        if t1 > reach:
            busy += t1 - max(t0, reach)
            reach = t1
    if hi > reach:
        gaps.append((reach, hi))
    for a, b in gaps:
        k = bisect.bisect_right(starts, a) - 1
        t = a
        while t < b:
            end = min(b, starts[k + 1] if k + 1 < len(starts) else b)
            by[_owner(paths[k] if k >= 0 else ())]["idle_us"] += end - t
            t, k = end, k + 1
    window = hi - lo
    return {"spans": dict(by), "window_us": window, "busy_us": busy, "idle_us": window - busy}


def host_ms(records, frames: int) -> dict:
    """The port's span records (profiling.take()) -> {key: host ms a
    frame}, each span's whole duration under its path's key."""
    by_id = {r[1]: r for r in records}
    keys = {}

    def key(r):
        if r[1] not in keys:
            parent = by_id.get(r[2])
            keys[r[1]] = r[3] if parent is None else key(parent) + "/" + r[3]
        return keys[r[1]]

    out = collections.Counter()
    for r in records:
        out[key(r)] += (r[5] - r[4]) / 1e6 / frames
    return dict(out)


def _within(key: str, name: str) -> bool:
    return name in key.split("/")


def numbers(placed: dict, frames: int, host: dict, syncs: float) -> dict:
    """The metrics and the per-span table from split's placement of
    `frames` profiled frames, the host ms a frame by span and the waits a
    frame."""
    sp = placed["spans"]

    def device_ms(name):
        return sum(v["device_us"] for k, v in sp.items() if _within(k, name)) / 1e3 / frames

    total = sum(v["device_us"] for v in sp.values())
    owned = sum(v["device_us"] for k, v in sp.items()
                if any(_within(k, n) for n in DEVICE_LAYERS))
    idle_host = sum(v["idle_us"] for k, v in sp.items()
                    if k != OUTSIDE and not any(p.startswith("wait.") for p in k.split("/")))
    table = {}
    for key in sorted(set(sp) | set(host)):
        inside = [v for k, v in sp.items() if k == key or k.startswith(key + "/")]
        table[key] = {"host_ms": host.get(key),
                      "device_ms": sum(v["device_us"] for v in inside) / 1e3 / frames,
                      "ops": sum(v["ops"] for v in inside) / frames,
                      "idle_ms": sum(v["idle_us"] for v in inside) / 1e3 / frames}
    return {
        "d2_pass_ms": device_ms("d2"),
        "reflect_ms": device_ms("reflect"),
        "idle_host_ms": idle_host / 1e3 / frames,
        "host_wait_ms": sum(v for k, v in host.items() if k.split("/")[-1].startswith("wait.")),
        "host_syncs": syncs,
        "owned_share": owned / total if total else None,
        "idle_split_ms": sum(v["idle_us"] for v in sp.values()) / 1e3 / frames,
        "idle_ms": placed["idle_us"] / 1e3 / frames,
        "window_ms": placed["window_us"] / 1e3 / frames,
        "table": table,
    }


def report(out: dict):
    for key, v in out["table"].items():
        host = "not measured" if v["host_ms"] is None else f"{v['host_ms']:.3f}"
        print(f"rxbench span {key}: host_ms {host} device_ms {v['device_ms']:.3f} "
              f"ops/frame {v['ops']:.1f} idle_ms {v['idle_ms']:.3f}", file=sys.stderr)
    print(f"rxbench spans: device work under {'/'.join(DEVICE_LAYERS)} "
          f"{100 * (out['owned_share'] or 0):.3f} %, idle split {out['idle_split_ms']:.3f} of "
          f"{out['idle_ms']:.3f} ms a frame (window {out['window_ms']:.3f} ms), "
          f"{out['seconds']:.2f} s", file=sys.stderr)

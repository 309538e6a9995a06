"""rxbench: one run of one cell of the benchmark of rusterix_tpu_torch.

    python3 rxbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Each frame is one call of the port's `Rasterizer.rasterize(scene, width,
height, assets=assets)` with its default readback, so the RGBA8 frame
arrives in host memory as the reference's rasterize fills a game's pixel
buffer. Frames run in a closed loop, one after the other, as a game loop
renders, presents and renders again; the traffic file sets each frame's
camera and dynamic batches from the seed and the frame's index.

The harness only dispatches: the cell's configuration supplies the system
under test (rxbench/configs/<config>.py `System`, whose `frame(spec,
readback)` is the frame call) and its plain reference
(rxbench/reference/<config>.py `Reference`); the traffic generator
(rxbench/lib/traffic.py) turns rxbench/traffic/<mix>.json and the seed
into each frame's spec; every metric is read by rxbench/metrics/<name>.py
from what the run gathered (`RunData`).

Set-up (imports, the kernels' build, the scene, WARM_FRAMES frames of the
cell's traffic, and any metric's own `prepare`) is `setup_s`. Then frames
run for `--seconds`; with `--trace 0` the line reports the cell's
end-to-end metrics. With `--trace 1` it profiles PROFILE_FRAMES frames
first (a second time where a kernel's record was lost), counts one
frame's host-to-device copies, times the host's wall of each frame call
without its readback for the rest of the window and reports the cell's
per-layer metrics. After the window, CHECK_FRAMES frames drawn from the
seed among those the window finished are compared with the reference:
each compared number is printed beside its limit (rxbench/limits) on the
last lines of standard error and under "checks", the last key of the
result line, which is the last line of standard output.

As a script it runs under PYTHONHASHSEED=0, starting itself again where
the variable differs, so that every run draws the same string hashes.
Exits 2 without a result when the card count is short, 3 when a module
of JAX or of the JAX package is loaded once the window has closed."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the program and of its libraries, at fixed paths inside
# the checkout; the port builds its kernels into rusterix_tpu_torch/_build
CACHE = ROOT / ".rxbench_cache"
BANNED = ("jax", "jaxlib", "flax", "rusterix_tpu")
HASH_SEED = "0"
WARM_FRAMES = 3
CHECK_FRAMES = 3
PROFILE_FRAMES = 3
PROFILE_TRIES = 2


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def power_limit_w():
    """The card's power limit in W, as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Reservoir:
    """A uniform sample of `k` of the frames offered, drawn from `rng`."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


class RunData:
    """What a run gathers for the metrics (rxbench/metrics/<name>.py
    `read(rd)`; a metric's optional `prepare(rd)` runs at the end of
    set-up, inside `setup_s`)."""

    def __init__(self, root, system, traffic, cfg: dict, device):
        self.root, self.system, self.traffic, self.cfg, self.device = (
            root, system, traffic, cfg, device)
        self.setup_s = None
        self.times = []           # each window frame's host seconds (--trace 0)
        self.window_s = None      # the window's seconds
        self.completed = 0        # frames completed in the window
        self.prof = None          # trace.profile of PROFILE_FRAMES frames
        self.prof_frames = []     # their frame indices
        self.work = []            # the reference's work counts of those frames
        self.copies = None        # host-to-device copies of one frame
        self.host_ms = []         # host walls of the frame call without readback
        self._kernels = None

    @property
    def port_kernels(self) -> set:
        if self._kernels is None:
            from rxbench.lib.trace import port_kernels

            self._kernels = port_kernels(self.root)
        return self._kernels


def run_cell(cell: dict, manifest: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None, size: tuple = None, wrap=None) -> dict:
    """One run of `cell` -> the result line (a dict, "checks" last). `size`
    (width, height) overrides the configuration's (CPU tests); `wrap(call,
    ctx)` replaces the frame call (controls and fault tests)."""
    import numpy as np
    import torch

    from rxbench.lib import manifest as mf
    from rxbench.lib import trace as tr
    from rxbench.lib.traffic import Traffic

    t0 = time.perf_counter() if t0 is None else t0
    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = mf.config(cell["config_entry"])
    if size is not None:
        cfg = dict(cfg, width=size[0], height=size[1])
    limits = mf.limits(cell["name"])
    traffic = Traffic(mf.traffic(cell["traffic"]), cfg, seed)
    system = mf.module("configs", cell["config"]).System(cfg, device)

    def call(i: int, readback: bool = True):
        return system.frame(traffic.frame(i), readback)

    if wrap is not None:
        call = wrap(call, {"system": system, "traffic": traffic, "cfg": cfg,
                           "config": cell["config"], "device": device})
    rd = RunData(mf.ROOT, system, traffic, cfg, device)
    section = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: (m, mf.module("metrics", m["name"]))
               for m in mf.metrics_of(manifest, cell["name"], section)}
    for i in range(WARM_FRAMES):
        call(i)
    for _m, mod in readers.values():
        if hasattr(mod, "prepare"):
            mod.prepare(rd)
    sync()
    rd.setup_s = time.perf_counter() - t0
    nxt = WARM_FRAMES
    keep = Reservoir(CHECK_FRAMES, np.random.default_rng([seed % (1 << 63), 7]))
    attempted = failed = 0
    errors = []

    def attempt(readback: bool):
        nonlocal nxt, attempted, failed
        i, nxt = nxt, nxt + 1
        attempted += 1
        try:
            out = call(i, readback)
        except Exception as exc:  # a frame that raises is a failed answer
            failed += 1
            errors.append(f"frame {i}: {type(exc).__name__}: {exc}")
            return None
        keep.offer((i, out))
        return out

    if not trace:
        start = time.perf_counter()
        while True:
            a = time.perf_counter()
            attempt(True)
            b = time.perf_counter()
            rd.times.append(b - a)
            if b - start >= seconds:
                break
        rd.window_s = time.perf_counter() - start
        rd.completed = attempted - failed
    else:
        needed = {getattr(mod, "KERNEL", None) for _m, mod in readers.values()} - {None}
        if cuda:
            for attempt_no in range(PROFILE_TRIES):
                first = nxt
                prof = tr.profile(lambda: attempt(False), PROFILE_FRAMES)
                lost = [k for k in needed if prof is None or tr.kernel_ms(prof, k)[1] == 0]
                if prof is not None:
                    rd.prof, rd.prof_frames = prof, list(range(first, nxt))
                if not lost:
                    break
                print(f"rxbench: the profiler kept no record of {lost} "
                      f"(try {attempt_no + 1} of {PROFILE_TRIES})", file=sys.stderr)
            for k in needed:
                if rd.prof is None or tr.kernel_ms(rd.prof, k)[1] == 0:
                    print(f"rxbench: {k}'s device time not measured: no profiler record",
                          file=sys.stderr)
            counter = tr.HostCopies()
            with counter:
                attempt(False)
            sync()
            rd.copies = sum(counter.ops.values())
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            a = time.perf_counter()
            attempt(False)
            rd.host_ms.append((time.perf_counter() - a) * 1e3)
            sync()
    sync()
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the reference, once the window has closed, the peak is read and the
    # port's frames are read back
    kept = sorted((i, out.cpu().numpy() if torch.is_tensor(out) else out)
                  for i, out in keep.items)
    del keep
    if cuda:
        torch.cuda.empty_cache()
    ref = mf.module("reference", cell["config"]).Reference(cfg, device)
    nums = (ref.numbers([(out, traffic.frame(i)) for i, out in kept]) if kept
            else {k: float("inf") for k in limits})
    rd.work = [ref.work(traffic.frame(i)) for i in rd.prof_frames]
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    correct = bool(kept) and failed == 0 and all(nums[k] <= limits[k] for k in limits)
    for e in errors[:5]:
        print(f"rxbench: {e}", file=sys.stderr)

    metrics = {}
    for name, (m, mod) in readers.items():
        v = mod.read(rd)
        if v is not None:
            metrics[name] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(mem_peak),
           "power_limit_w": power_limit_w() if cuda else None}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and rd.prof is not None:
        dev["busy_s"] = rd.prof["busy_us"] / 1e6
        dev["window_s"] = rd.prof["window_us"] / 1e6
        result["breakdown"] = {"device_ops": tr.top_ops(rd.prof),
                               "idle_gaps": tr.idle_gaps(rd.prof)}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(ROOT))
    import torch

    from rxbench.lib import manifest as mf

    man = mf.load(ROOT)
    cell = mf.cell(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"rxbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(cell, man, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = banned_modules()
    if found:
        print(f"rxbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def fixed_hash_seed():
    """Run again under a fixed PYTHONHASHSEED, keeping the start time, so
    that every run hashes strings, and so orders the sets and dicts the
    program keys by them, alike."""
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        env = dict(os.environ, PYTHONHASHSEED=HASH_SEED, RXBENCH_T0=repr(T0))
        os.execve(sys.executable, [sys.executable, *sys.argv], env)
    return float(os.environ.get("RXBENCH_T0", T0))


if __name__ == "__main__":
    T0 = fixed_hash_seed()
    sys.exit(main())

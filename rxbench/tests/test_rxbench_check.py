"""A run of a cell end to end on the CPU at a small size: the port's
frames pass the comparison, the controls (the reference in bfloat16, and
with its shading alone in bfloat16, in the port's place) and each fault
planted under the timed path fail it, the window's statistics take every
frame, and no module of JAX or of the JAX package is loaded."""

import copy
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rxbench import run
from rxbench.lib import manifest as mf
from rxbench.lib.traffic import Traffic
from rxbench.tools.control import controls

MAN = mf.load()
ROOT = mf.ROOT
# the CPU tests' frame size: large enough for every cell's traffic
SIZE = (320, 180)
CELLS = [w["name"] for w in MAN["workloads"]]
SEED = 2 ** 31 + 977


def _run(cell, wrap=None, seconds=0.5, device="cpu", size=SIZE, seed=SEED):
    return run.run_cell(mf.cell(MAN, cell), MAN, seed, seconds, False, device, size=size,
                        wrap=wrap)


def _checks(res):
    return {k: v["value"] for k, v in res["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_the_ports_frames_pass(cell):
    res = _run(cell)
    assert res["correct"], _checks(res)
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


@pytest.mark.parametrize("control", ["control", "control_shade"])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell, control):
    res = _run(cell, wrap=controls()[control])
    assert not res["correct"], _checks(res)


def stale(call, ctx):
    """A step that returns its state unchanged: every frame is the first."""
    first = {}

    def f(i, readback=True):
        if "frame" not in first:
            first["frame"] = call(0, readback)
        return first["frame"]
    return f


def half_batches(call, ctx):
    """Half of the batch left out: the port renders the scene with every
    other batch of each chunk dropped (the reference keeps them all)."""
    system = copy.copy(ctx["system"])
    half = copy.deepcopy(system.scene)
    half.__dict__.pop("_cache_uid", None)
    for chunk in half.chunks.values():
        chunk.batches3d = chunk.batches3d[::2]
    half.touch()
    system.scene = half

    def f(i, readback=True):
        return system.frame(ctx["traffic"].frame(i), readback)
    return f


def altered(call, ctx):
    """An answer altered where it is produced: a block of a quarter of the
    frame's width and height at its centre has its colour bits flipped."""
    def f(i, readback=True):
        out = np.array(call(i, readback))
        h, w = out.shape[:2]
        out[h * 3 // 8:h * 5 // 8, w * 3 // 8:w * 5 // 8, :3] ^= 0x80
        return out
    return f


@pytest.mark.parametrize("fault", [stale, half_batches, altered])
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_fails(cell, fault):
    res = _run(cell, wrap=fault, seconds=1.0)
    assert not res["correct"], (fault.__name__, _checks(res))


def test_a_frame_that_raises_counts_as_failed():
    def flaky(call, ctx):
        def f(i, readback=True):
            if i == run.WARM_FRAMES:
                raise RuntimeError("planted")
            return call(i, readback)
        return f

    res = _run(CELLS[0], wrap=flaky, seconds=1.0)
    assert res["failed"] == 1 and res["attempted"] >= 1 and not res["correct"]


def _window(times):
    rd = SimpleNamespace(times=times, window_s=sum(times), completed=len(times))
    return {k: mf.module("metrics", k).read(rd) for k in ("frame_ms", "frame_p95_ms")}


def test_window_statistics_take_every_frame():
    times = [0.05] * 19
    base = _window(times)
    assert base["frame_ms"] == pytest.approx(50.0)
    assert base["frame_p95_ms"] == pytest.approx(50.0)
    stalled = times[:9] + [1.05] + times[10:]
    st = _window(stalled)
    assert st["frame_ms"] == pytest.approx(sum(stalled) * 1e3 / 19)
    assert st["frame_ms"] > base["frame_ms"] and st["frame_p95_ms"] > base["frame_p95_ms"]


def test_a_stalled_frame_inside_the_window_moves_both():
    def stall(call, ctx):
        def f(i, readback=True):
            if i == run.WARM_FRAMES:
                time.sleep(3.0)
            return call(i, readback)
        return f

    size = (96, 54)
    plain = _run(CELLS[0], seconds=1.0, size=size)["metrics"]
    slow = _run(CELLS[0], wrap=stall, seconds=1.0, size=size)["metrics"]
    for k in ("frame_ms", "frame_p95_ms"):
        assert slow[k]["value"] > plain[k]["value"] + 1000.0, k


def test_no_card_means_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""


def test_a_cpu_rehearsal_loads_no_jax():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r})\n"
            "from rxbench import run\nfrom rxbench.lib import manifest as mf\n"
            "man = mf.load()\n"
            f"res = run.run_cell(mf.cell(man, {CELLS[0]!r}), man, 3, 0.2, False, 'cpu', "
            "size=(96, 54))\n"
            "print(json.dumps(run.banned_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_port():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r})\n"
            "from rxbench.lib import manifest as mf\n"
            "from rxbench.lib.traffic import Traffic\n"
            "man = mf.load(); c = mf.cell(man, 'map_refl_1080p.entities')\n"
            "cfg = dict(mf.config(c['config_entry']), width=64, height=36)\n"
            "ref = mf.module('reference', c['config']).Reference(cfg, 'cpu')\n"
            "out = ref.frame(Traffic(mf.traffic('entities'), cfg, 5).frame(9))\n"
            "assert out['frame'].shape == (36, 64, 4)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"rusterix_tpu_torch", "rusterix_tpu", "jax", "jaxlib"}


def test_banned_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rusterix_tpu_torchx.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlibx", sys)
    assert not {"rusterix_tpu", "jaxlib"} & set(run.banned_modules())
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.banned_modules()


def test_every_per_layer_metric_reads_a_traced_run():
    """Each per-layer reader on what a traced run gathers: a profile with
    the port's kernels and the torch passes, the reference's work counts
    of the profiled frames, the copies and the host walls."""
    cell = mf.cell(MAN, "map_refl_1080p.entities")
    cfg = dict(mf.config(cell["config_entry"]), width=96, height=54)
    traffic = Traffic(mf.traffic(cell["traffic"]), cfg, SEED)
    ref = mf.module("reference", cell["config"]).Reference(cfg, "cpu")
    rd = run.RunData(ROOT, None, traffic, cfg, "cpu")
    events = []
    for f in range(3):
        t = 1000.0 * f
        events += [("void mega_kernel<0>(Args)", t, t + 50.0), ("rt_kernel(float const*)", t + 60, t + 90),
                   ("rt_kernel(float const*)", t + 95, t + 125),
                   ("void at::native::elementwise_kernel<128>", t + 130, t + 400),
                   ("Memcpy HtoD (Pinned -> Device)", t + 400, t + 410)]
    rd.prof = {"events": events, "busy_us": 3 * 390.0, "window_us": 3000.0, "calls": 3}
    rd.prof_frames = [5, 6, 7]
    rd.work = [ref.work(traffic.frame(i)) for i in rd.prof_frames]
    rd.copies, rd.host_ms = 1, [40.0, 42.0]
    got = {m["name"]: mf.module("metrics", m["name"]).read(rd)
           for m in mf.metrics_of(MAN, cell["name"], "per_layer")}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["torch_pass_ms"] == pytest.approx(0.27)
    assert got["device_idle"] == pytest.approx(61.0)
    assert got["h2d_copies"] == 1.0 and got["rasterize_host_ms"] == pytest.approx(41.0)
    assert got["b1_roofline"] < 100.0 and got["b3_walk_roofline"] < 100.0


def test_a_metrics_prepare_runs_inside_setup(monkeypatch):
    """A metric that measures in set-up (a level load) adds a file with a
    `prepare`: it runs after the warm frames and counts in setup_s."""
    seen = {}

    def prepare(rd):
        seen["frames_warm"] = rd.setup_s is None
        time.sleep(1.0)

    real = mf.module
    fake = SimpleNamespace(prepare=prepare, read=lambda rd: rd.setup_s)

    def module(folder, name):
        return fake if (folder, name) == ("metrics", "setup_s") else real(folder, name)

    monkeypatch.setattr(mf, "module", module)
    res = _run(CELLS[0], seconds=0.2, size=(96, 54))
    assert seen == {"frames_warm": True}
    assert res["metrics"]["setup_s"]["value"] >= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["control", "control_shade"])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_on_the_card_at_the_cells_size(cuda, cell, control):
    for k in range(3):
        res = run.run_cell(mf.cell(MAN, cell), MAN, 7_000_001 + k, 3.0, False, cuda,
                           wrap=controls()[control])
        assert not res["correct"], _checks(res)

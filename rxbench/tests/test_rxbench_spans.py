"""rxbench.lib.spans on a hand-made profile: each device operation lands in
the innermost span open at its launch (by the correlation id of its
runtime call), each idle gap of the device splits exactly over the
innermost span open in it (`outside` where no frame is), and the metrics
and the host's times follow; a program without tracing, or a run without
a card, gives None."""

from types import SimpleNamespace

import pytest

from rxbench.lib import spans as sp

# one frame (us): the arena, B1, a reflection with its walk, the 2D pass
# with its lists' wait, the readback with its wait; the harness after it
SPANS = [("frame", 0.0, 100.0), ("arena", 2.0, 10.0), ("render", 10.0, 80.0),
         ("b1", 12.0, 20.0), ("reflect", 20.0, 40.0), ("b3.walk", 25.0, 35.0),
         ("d2", 40.0, 78.0), ("wait.d2_lists", 42.0, 60.0), ("readback", 80.0, 98.0),
         ("wait.readback", 81.0, 97.0)]
LAUNCHES = {1: 3.0, 2: 13.0, 3: 26.0, 4: 41.0, 5: 81.5, 7: 110.0}
OPS = [("Memcpy HtoD (Pinned -> Device)", 11.0, 12.0, 1), ("mega_kernel", 14.0, 24.0, 2),
       ("rt_kernel", 30.0, 38.0, 3), ("elementwise_kernel", 45.0, 55.0, 4),
       ("Memcpy DtoH (Device -> Pageable)", 82.0, 90.0, 5), ("lost_launch", 91.0, 92.0, 6),
       ("harness_kernel", 111.0, 115.0, 7)]

DEVICE = {"frame/arena": 1.0, "frame/render/b1": 10.0, "frame/render/reflect/b3.walk": 8.0,
          "frame/render/d2": 10.0, "frame/readback/wait.readback": 8.0, sp.UNPLACED: 1.0,
          sp.OUTSIDE: 4.0}
IDLE = {"frame": 4.0, "frame/arena": 8.0, "frame/render": 3.0, "frame/render/b1": 2.0,
        "frame/render/reflect": 3.0, "frame/render/reflect/b3.walk": 5.0,
        "frame/render/d2": 20.0, "frame/render/d2/wait.d2_lists": 8.0,
        "frame/readback": 2.0, "frame/readback/wait.readback": 7.0, sp.OUTSIDE: 11.0}


def test_ops_land_in_the_innermost_span_of_their_launch():
    placed = sp.split(SPANS, LAUNCHES, OPS)
    got = {k: v["device_us"] for k, v in placed["spans"].items() if v["ops"]}
    assert got == DEVICE
    assert placed["busy_us"] == 42.0 and placed["window_us"] == 115.0


def test_idle_gaps_split_exactly_over_the_innermost_spans():
    placed = sp.split(SPANS, LAUNCHES, OPS)
    got = {k: v["idle_us"] for k, v in placed["spans"].items() if v["idle_us"]}
    assert got == IDLE
    assert sum(got.values()) == placed["idle_us"] == 73.0


def test_a_gap_before_the_device_starts_and_after_it_ends():
    spans = [("frame", 0.0, 10.0), ("render", 2.0, 8.0), ("frame", 20.0, 30.0)]
    placed = sp.split(spans, {1: 3.0}, [("k", 4.0, 6.0, 1)])
    idle = {k: v["idle_us"] for k, v in placed["spans"].items() if v["idle_us"]}
    assert idle == {"frame": 14.0, "frame/render": 4.0, sp.OUTSIDE: 10.0}
    assert placed["window_us"] == 30.0 and placed["idle_us"] == 28.0


def test_a_child_that_starts_with_its_parent_is_innermost():
    starts, paths = sp.timeline([("b", 5.0, 7.0), ("a", 5.0, 9.0)])
    assert starts == [5.0, 7.0, 9.0]
    assert paths == [("a", "b"), ("a",), ()]


def test_numbers_from_the_placement_and_the_host_records():
    # (frame, id, parent, name, t0_ns, t1_ns) of two unprofiled frames
    records = [(1, 1, 0, "frame", 0, 8_000_000), (1, 2, 1, "render", 1_000_000, 6_000_000),
               (1, 3, 2, "wait.d2_lists", 2_000_000, 4_000_000),
               (1, 4, 1, "wait.readback", 6_000_000, 7_000_000),
               (2, 5, 0, "frame", 10_000_000, 16_000_000),
               (2, 6, 5, "render", 10_000_000, 15_000_000),
               (2, 7, 6, "wait.d2_lists", 11_000_000, 12_000_000)]
    host = sp.host_ms(records, 2)
    assert host == {"frame": 7.0, "frame/render": 5.0, "frame/render/wait.d2_lists": 1.5,
                    "frame/wait.readback": 0.5}
    out = sp.numbers(sp.split(SPANS, LAUNCHES, OPS), 1, host, 3 / 2)
    assert out["d2_pass_ms"] == pytest.approx(0.010)
    assert out["reflect_ms"] == pytest.approx(0.008)
    # the frame's idle outside the two waits: 73 less 8 and 7 waited, 11 outside
    assert out["idle_host_ms"] == pytest.approx(0.047)
    assert out["host_wait_ms"] == pytest.approx(2.0)
    assert out["host_syncs"] == 1.5
    assert out["owned_share"] == pytest.approx(37.0 / 42.0)
    assert out["idle_split_ms"] == pytest.approx(out["idle_ms"]) == pytest.approx(0.073)
    row = out["table"]["frame/render"]
    assert row["host_ms"] == 5.0 and row["device_ms"] == pytest.approx(0.028)
    assert row["ops"] == 3 and row["idle_ms"] == pytest.approx(0.041)


def test_parse_reads_a_chrome_trace():
    trace = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "frame", "ts": 1.0, "dur": 9.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2.0, "dur": 0.5,
         "args": {"correlation": 11}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 3.0, "dur": 0.5,
         "args": {"correlation": 12}},
        {"ph": "X", "cat": "kernel", "name": "rt_kernel", "ts": 4.0, "dur": 2.0,
         "args": {"correlation": 11}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 6.0, "dur": 1.0,
         "args": {"correlation": 12}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 2.0, "dur": 1.0},
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 2.0, "id": 11},
    ]}
    spans, launches, ops = sp.parse(trace)
    assert spans == [("frame", 1.0, 10.0)]
    assert launches == {11: 2.0, 12: 3.0}
    assert ops == [("rt_kernel", 4.0, 6.0, 11), ("Memcpy DtoH", 6.0, 7.0, 12)]


def test_gather_gives_none_without_a_card_or_without_tracing(monkeypatch):
    import rusterix_tpu_torch

    rd = SimpleNamespace(device="cpu", prof_frames=[3, 4, 5])
    assert sp.gather(rd) is None and rd.spans is None
    monkeypatch.setattr(rusterix_tpu_torch, "profiling", SimpleNamespace(frame_breakdown=None))
    rd = SimpleNamespace(device="cuda", prof_frames=[3, 4, 5])
    assert sp.gather(rd) is None and rd.spans is None
    rd.spans = {"d2_pass_ms": 1.0}
    assert sp.gather(rd) == {"d2_pass_ms": 1.0}


def test_the_span_metrics_read_what_gather_kept():
    """The five per-layer metrics of the port's spans and counters are the
    entities cell's, and each gives the number `gather` kept on rd.spans."""
    from rxbench.lib import manifest as mf

    rd = SimpleNamespace(spans={"d2_pass_ms": 270.5, "reflect_ms": 31.25, "idle_host_ms": 12.5,
                                "host_wait_ms": 180.0, "host_syncs": 2})
    cell = [m["name"] for m in mf.metrics_of(mf.load(), "map_refl_1080p.entities", "per_layer")]
    assert set(rd.spans) <= set(cell)
    assert {n: mf.module("metrics", n).read(rd) for n in rd.spans} == rd.spans

"""The port's tracing (`rusterix_tpu_torch/profiling.py`) on the CPU, at
64x48 on the map with dynamic batches and one GGX reflection ray a pixel
(scenes.build_map_dynamic_scene: an opaque and a translucent billboard, a
2D rectangle, shadow maps with dynamic casters): with tracing off nothing
is recorded and the counters count; with it on a frame gives the span
tree of its layers in order, under one frame id, each span inside its
parent, one `wait.*` span for each `sync.*` count; the frame's bytes do not
change; the buffer keeps its cap. On the card: the synchronising calls
that `torch.cuda.set_sync_debug_mode("warn")` reports in a steady frame
are the frame's `sync.*` counts."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rusterix_tpu_torch import profiling  # noqa: E402
from rusterix_tpu_torch.scenes import build_map_dynamic_scene, move_dynamic  # noqa: E402

W, H = 64, 48

#: the steady frame's spans in start order, each with its depth under `frame`
TREE = [(0, "frame"), (1, "dynamic"), (1, "frame_state"), (1, "arena"), (1, "render"),
        (2, "leaves"), (2, "setup"), (2, "b2"), (2, "b1"), (2, "reflect"),
        (3, "b3.prepare"), (3, "b3.walk"), (2, "peel"), (3, "reflect"), (4, "b3.prepare"),
        (4, "b3.walk"), (2, "d2"), (3, "wait.d2_lists"), (3, "d2.lights"), (3, "d2.steps"),
        (1, "readback"), (2, "wait.readback")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracing_off():
    profiling.enable(False)
    profiling.take()
    yield
    profiling.enable(False)
    profiling.take()


def _scene(device):
    rast, scene, assets = build_map_dynamic_scene(W, H, device=device)
    rast.set_shadows(True, res=32, sun_res=64)
    rast.set_reflections(1)
    rast.rasterize(scene, W, H, assets=assets)  # the bake and the scene cache
    return rast, scene, assets


@pytest.fixture(scope="module")
def map_scene():
    return _scene("cpu")


def _frame(map_scene, t: float = 0.5):
    rast, scene, assets = map_scene
    move_dynamic(scene, t)
    return rast.rasterize(scene, W, H, assets=assets)


def _syncs() -> dict:
    return {k: v for k, v in profiling.counters.items() if k.startswith("sync.")}


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def test_tracing_off_records_nothing_and_the_counters_count(map_scene):
    names = ("frame", "arena.upload", "sync.d2_lists", "sync.readback")
    before = [profiling.counters[n] for n in names]
    _frame(map_scene)
    assert profiling.take() == []
    assert [profiling.counters[n] - b for n, b in zip(names, before)] == [1, 1, 1, 1]


def test_a_span_off_is_one_shared_object_and_a_wait_still_counts():
    before = profiling.counters["sync.probe"]
    assert profiling.span("frame") is profiling.span("d2") is profiling.wait("probe")
    with profiling.wait("probe"):
        pass
    assert profiling.counters["sync.probe"] == before + 2 and profiling.take() == []
    profiling.enable()
    with profiling.wait("probe"):
        pass
    assert profiling.counters["sync.probe"] == before + 3
    assert [r[3] for r in profiling.take()] == ["wait.probe"]
    del profiling.counters["sync.probe"]


def test_a_traced_frame_gives_the_span_tree_of_its_layers(map_scene):
    syncs = _syncs()
    profiling.enable()
    _frame(map_scene)
    profiling.enable(False)
    recs = profiling.take()
    by_id = {r[1]: r for r in recs}

    def depth(r):
        return 0 if r[2] == 0 else 1 + depth(by_id[r[2]])

    ordered = sorted(recs, key=lambda r: (r[4], r[1]))
    assert [(depth(r), r[3]) for r in ordered] == TREE
    frame_ids = {r[0] for r in recs}
    assert len(frame_ids) == 1 and frame_ids != {0}
    for r in recs:
        assert r[4] <= r[5]
        if r[2]:
            parent = by_id[r[2]]
            assert parent[4] <= r[4] and r[5] <= parent[5], (r[3], parent[3])
    waits = {}
    for r in recs:
        if r[3].startswith("wait."):
            site = "sync." + r[3][len("wait."):]
            waits[site] = waits.get(site, 0) + 1
    assert waits == _delta(syncs, _syncs()) == {"sync.d2_lists": 1, "sync.readback": 1}


def test_each_traced_frame_takes_a_frame_id_of_its_own(map_scene):
    profiling.enable()
    with profiling.span("before"):
        pass
    _frame(map_scene, 0.25)
    _frame(map_scene, 0.75)
    profiling.enable(False)
    recs = profiling.take()
    ids = {}
    for r in recs:
        ids.setdefault(r[0], set()).add(r[3])
    assert ids.pop(0) == {"before"}
    assert len(ids) == 2 and all(names >= {"frame", "render", "d2"} for names in ids.values())
    roots = [r for r in recs if r[3] == "frame"]
    assert [r[2] for r in roots] == [0, 0] and roots[0][0] < roots[1][0]


def test_a_span_left_by_an_exception_is_recorded_and_closed():
    profiling.enable()
    with pytest.raises(RuntimeError):
        with profiling.span("outer"):
            with profiling.span("inner"):
                raise RuntimeError("a pass failed")
    with profiling.span("next"):
        pass
    recs = profiling.take()
    assert [r[3] for r in recs] == ["inner", "outer", "next"]
    outer = recs[1]
    assert recs[0][2] == outer[1] and outer[2] == 0 and recs[2][2] == 0


def test_the_frames_bytes_do_not_depend_on_tracing(map_scene):
    off = _frame(map_scene, 0.25)
    profiling.enable()
    on = _frame(map_scene, 0.25)
    profiling.enable(False)
    assert profiling.take()
    assert on.dtype == np.uint8 and on.tobytes() == off.tobytes()


def test_the_buffer_drops_the_oldest_records_past_its_cap():
    profiling.enable()
    extra = 10
    for _ in range(profiling.CAP + extra):
        with profiling.span("s"):
            pass
    with profiling.span("last"):
        pass
    recs = profiling.take()
    assert len(recs) == profiling.CAP and recs[-1][3] == "last"
    ids = [r[1] for r in recs]
    assert ids == list(range(ids[0], ids[0] + profiling.CAP))
    assert profiling.take() == []


@pytest.mark.cuda
def test_the_synchronising_calls_of_a_frame_are_its_sync_counts():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the frame's waits are on the card)")
    scene = _scene(torch.device("cuda"))
    _frame(scene, 0.25)
    torch.cuda.synchronize()
    syncs = _syncs()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _frame(scene, 0.5)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reported = [w for w in seen if "called a synchronizing CUDA operation" in str(w.message)]
    counted = _delta(syncs, _syncs())
    assert len(reported) == sum(counted.values()), (counted, [str(w.message) for w in reported])
    assert counted == {"sync.d2_lists": 1, "sync.readback": 1}

"""B3's preparation routes by scene size (`rt_kernel.prepare_route`), in
plain Python: which route and cluster size each cell count gets, the shared
memory each block asks for, and which route allocates a global scratch.
The kernels themselves are held to rt_prepare on the card
(tests/test_torch_cuda.py)."""

import pytest

pytest.importorskip("torch")

from rusterix_tpu_torch.ops import rt_kernel  # noqa: E402

#: shared memory a block may take on the H100 (227 KB)
SMEM_PER_BLOCK = 232448
COUNTS = sorted({1, 2, 31, 32, 33, 511, 512, 513, 2047, 2048, 2049, 4096, 4097, 6200, 8192,
                 8193, 16384, 16385, 28672, 28673, 28700, 32768, 32769, 65536, 100003,
                 106495, 106496, 106497, 131072, 200000, 1 << 20})


def _expected(n: int) -> tuple:
    """(route, blocks a ray block) from the limits' definitions."""
    if n <= rt_kernel.PREPARE_MAX_CELLS:
        return "rank", 1
    if n <= rt_kernel.CLUSTER_MAX_CELLS:
        cl = next((c for c in (1, 2, 4) if -(-n // c) <= rt_kernel.CLUSTER_SPAN), 8)
        return "cluster", cl
    return "global", 1


def test_route_and_cluster_size_by_cell_count():
    assert rt_kernel.CLUSTER_MAX_CELLS <= 8 * rt_kernel.CLUSTER_SPAN_MAX
    assert rt_kernel.CLUSTER_SPAN <= rt_kernel.CLUSTER_SPAN_MAX
    seen = set()
    for n in COUNTS:
        r = rt_kernel.prepare_route(n, 2025)
        assert (r["route"], r["cluster"]) == _expected(n), n
        seen.add(r["route"])
        if r["route"] == "cluster":
            # the cluster's blocks hold the row, none of them more than a block can
            assert r["span"] * r["cluster"] >= n > r["span"] * (r["cluster"] - 1)
            assert r["span"] <= rt_kernel.CLUSTER_SPAN_MAX
            assert r["span"] <= rt_kernel.CLUSTER_SPAN or r["cluster"] == 8
    assert seen == {"rank", "cluster", "global"}


@pytest.mark.parametrize("n", COUNTS)
def test_shared_memory_a_block_asks_for_fits_the_card(n):
    r = rt_kernel.prepare_route(n, 2025)
    assert 0 < r["smem"] <= SMEM_PER_BLOCK
    if r["route"] == "cluster":
        assert r["smem"] == 16 * r["span"] + rt_kernel.CLUSTER_SMEM_STATIC


def _look_back_state(n: int, nblocks: int) -> int:
    """Bytes of the global route's per-row state: its counters and one
    look-back word a digit a tile."""
    tiles = -(-n // rt_kernel.GLOBAL_TILE)
    return 4 * nblocks * (rt_kernel.GLOBAL_ROW_WORDS + rt_kernel.GLOBAL_LOOK_WORDS * tiles)


@pytest.mark.parametrize("n", COUNTS)
def test_only_the_global_route_allocates_a_scratch(n):
    r = rt_kernel.prepare_route(n, 2025)
    if r["route"] == "global":
        # a u32 key and a u32 cell a (ray block, cell), not rounded up, and
        # the rows' counters and look-back words
        assert r["tiles"] == -(-n // rt_kernel.GLOBAL_TILE)
        assert r["span"] == min(n, rt_kernel.GLOBAL_TILE)
        assert r["scratch"] == 8 * n * 2025 + _look_back_state(n, 2025)
        assert r["smem"] == 8 * rt_kernel.GLOBAL_TILE + rt_kernel.GLOBAL_SMEM_STATIC
    else:
        assert r["scratch"] == 0


@pytest.mark.parametrize("n", [1, 2, 31, 32, 4095, 4096, 4097, 28700, 106497, 131072, 1 << 20])
@pytest.mark.parametrize("nblocks", [1, 3, 2025])
def test_global_scratch_is_eight_bytes_a_cell_and_the_look_back_state(monkeypatch, n, nblocks):
    """At every size the global route takes (the limits lowered below the
    small ones), the scratch is at most 8 bytes a cell a ray block plus the
    per-row state, and that state is a small share of it at the route's own
    sizes: one u32 a digit a tile of GLOBAL_TILE pairs."""
    monkeypatch.setattr(rt_kernel, "PREPARE_MAX_CELLS", 0)
    monkeypatch.setattr(rt_kernel, "CLUSTER_MAX_CELLS", 0)
    r = rt_kernel.prepare_route(n, nblocks)
    assert r["route"] == "global"
    assert r["scratch"] <= 8 * n * nblocks + _look_back_state(n, nblocks)
    assert r["scratch"] % 4 == 0
    if n > 106496:
        assert _look_back_state(n, nblocks) <= 0.04 * 8 * n * nblocks


def test_limits_are_read_at_call_time(monkeypatch):
    assert rt_kernel.prepare_route(32)["route"] == "rank"
    monkeypatch.setattr(rt_kernel, "PREPARE_MAX_CELLS", 4)
    assert rt_kernel.prepare_route(32) == {"route": "cluster", "cluster": 1, "span": 32,
                                           "smem": 16 * 32 + rt_kernel.CLUSTER_SMEM_STATIC,
                                           "scratch": 0}
    monkeypatch.setattr(rt_kernel, "CLUSTER_SPAN", 10)
    assert (rt_kernel.prepare_route(32)["cluster"], rt_kernel.prepare_route(32)["span"]) == (4, 8)
    monkeypatch.setattr(rt_kernel, "CLUSTER_MAX_CELLS", 4)
    assert rt_kernel.prepare_route(32, 3)["route"] == "global"
    assert rt_kernel.prepare_route(32, 3)["scratch"] == 8 * 32 * 3 + _look_back_state(32, 3)

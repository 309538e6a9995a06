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
    assert rt_kernel.CLUSTER_MAX_CELLS == 8 * rt_kernel.CLUSTER_SPAN_MAX
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


@pytest.mark.parametrize("n", COUNTS)
def test_only_the_global_route_allocates_a_scratch(n):
    r = rt_kernel.prepare_route(n, 2025)
    if r["route"] == "global":
        # one power-of-two row of u64 keys a ray block
        assert r["span"] >= n and r["span"] & (r["span"] - 1) == 0
        assert r["scratch"] == 8 * r["span"] * 2025
    else:
        assert r["scratch"] == 0


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
    assert rt_kernel.prepare_route(32, 3)["scratch"] == 8 * 32 * 3

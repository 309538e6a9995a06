"""rusterix_tpu_torch's reflection slice against the JAX package, module by
module, on identical numpy inputs: the visibility pre-pass (B2's plain
version), the ray-intersect walk (B3's plain version) and its preparation,
the G-buffer, the WGSL hash and the reflection hit shading. The JAX side
runs its Pallas kernels in interpret mode. The CUDA kernels' own checks are
in test_torch_cuda.py, which runs without jax.

Tolerances: winner and hit indices exactly; z, t and the shading allclose
as each test states (XLA's CPU build fuses some products into FMAs and
evaluates sin/cos with its own approximations, so the last bit of a float
may differ).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from rusterix_tpu.models.light import pack_lights  # noqa: E402
from rusterix_tpu.ops import megakernel as jm  # noqa: E402
from rusterix_tpu.ops import reflect as jr  # noqa: E402
from rusterix_tpu.ops import rt_kernel as jrt  # noqa: E402
from rusterix_tpu.ops import shade as js  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu.ops.setup_pass import setup_pass as jax_setup_pass  # noqa: E402
from rusterix_tpu.ops.visibility_pallas import (  # noqa: E402
    visibility_pass_pallas as jax_visibility_pass_pallas,
)
from rusterix_tpu_torch.ops import reflect as tr  # noqa: E402
from rusterix_tpu_torch.ops import rt_kernel as trt  # noqa: E402
from rusterix_tpu_torch.ops import shade as ts  # noqa: E402
from rusterix_tpu_torch.ops.raster import packed_to_torch  # noqa: E402
from rusterix_tpu_torch.profiling import counters  # noqa: E402
from rusterix_tpu_torch.ops.visibility_pallas import (  # noqa: E402
    visibility_pass_pallas_reference,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _map_frame(w, h):
    """The bench's GGX-reflection map, prepared by the JAX package at w x h
    (packed scene, lights, uniforms, setup pass, Morton + front-to-back
    sort) -> dict of numpy arrays and host dicts shared by both sides."""
    rast, scene, assets = bench.build_map_refl_scene(w, h)
    packed = PackedScene.from_scene(scene, assets, static_only=True)
    lights = pack_lights(scene.all_lights(), packed.lights["valid"].shape[0])
    lights["flicker_factor"] = rast._flicker_factors(lights)
    uniforms = rast._uniforms(scene)
    atlas_np = packed.atlas_index.atlas
    atlas = {
        "flat": jnp.asarray(atlas_np.data.reshape(-1, 4)),
        "w": jnp.int32(atlas_np.data.shape[1]),
        **{k: jnp.asarray(getattr(atlas_np, k)) for k in ("rects", "tile_first", "tile_count")},
    }
    d3 = {k: jnp.asarray(v) for k, v in vars(packed.d3).items()}
    vis, attr, bbox, alive, tri_id = jax_setup_pass(
        d3["pos"], d3["uv"], d3["nrm"], d3["valid"], d3["cull"],
        jnp.asarray(uniforms["view"]), jnp.asarray(uniforms["proj"]), w, h,
    )
    table = jm.pack_mega_table(attr, tri_id, d3, atlas, uniforms["anim_frame"], False)
    vis_s, bbox_s, alive_s, _table_s, _s_near, perm = jm.morton_ftb_sort(
        vis, bbox, alive.astype(jnp.float32), table, w, h, return_perm=True
    )
    return {
        "w": w, "h": h, "packed": packed, "jax_d3": d3, "jax_atlas": atlas,
        "lights": lights, "uniforms": {k: np.asarray(v) for k, v in uniforms.items()},
        "attr": np.array(attr), "tri_id": np.array(tri_id),
        "vis_s": np.array(vis_s), "bbox_s": np.array(bbox_s),
        "alive_s": np.array(alive_s), "perm": np.array(perm),
    }


@pytest.fixture(scope="module")
def map_128():
    return _map_frame(128, 64)


def _jax_gbuffer_and_rays(m):
    """The JAX package's pre-pass, G-buffer and reflection rays (sample 0)
    for the map frame -> (z, idx, hit, g, rays) as numpy."""
    w, h = m["w"], m["h"]
    z, i_s, hit = jax_visibility_pass_pallas(
        jnp.asarray(m["vis_s"]), jnp.asarray(m["alive_s"]), jnp.asarray(m["bbox_s"]),
        w, h, interpret=True,
    )
    idx = jnp.where(hit, jnp.asarray(m["perm"])[jnp.maximum(i_s, 0)], -1)
    g = jax.jit(lambda *a: js.gbuffer_pass(*a, w, h, 0))(
        z, idx, hit, jnp.asarray(m["attr"]), jnp.asarray(m["tri_id"]), m["jax_d3"],
        m["jax_atlas"], m["uniforms"],
    )
    pt = packed_to_torch(m["packed"], "cpu")
    port_g = ts.gbuffer_pass(_t(z), _t(idx), _t(hit), _t(m["attr"]), _t(m["tri_id"]),
                             pt["d3"], pt["atlas"], m["uniforms"], w, h)
    rays = tr.reflection_rays(port_g, _t(hit), w, h, 0)
    return z, idx, hit, g, port_g, rays


# ------------------------------------------------------------------- B2


def test_visibility_prepass_matches_jax_kernel():
    """B2's plain version against the JAX kernel in interpret mode on the
    map's sorted candidates at 192x96 (ragged 64x128 tiles).

    Pinned: the winner differs on 5 pixels, each a z-tie between coplanar
    duplicate walls. XLA's CPU build fuses the 1/z plane evaluation
    `(a*x + c) + b*y` into FMAs, where the port (and its CUDA kernel, built
    with -fmad=false, as the TPU kernel evaluates it) rounds each op on its
    own: there the later wall's 1/z comes out one ulp above the earlier
    one's, under the FMAs the two tie and the lower slot keeps the pixel.
    Their z agree (same depth), and coverage is identical."""
    m = _map_frame(192, 96)
    args = (m["vis_s"], m["alive_s"], m["bbox_s"])
    z_ref, i_ref, h_ref = jax_visibility_pass_pallas(*(jnp.asarray(a) for a in args), 192, 96,
                                                     interpret=True)
    z, idx, hit = visibility_pass_pallas_reference(*(_t(a) for a in args), 192, 96)
    assert int((idx.numpy() != np.asarray(i_ref)).sum()) == 5
    np.testing.assert_array_equal(hit.numpy(), np.asarray(h_ref))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=1e-6, atol=1e-6)
    assert int(hit.sum()) > 192 * 96 // 10


# ------------------------------------------------------------------- B3


def _random_scene(rng, tcount, spread=10.0, tri_size=1.5):
    a = rng.uniform(-spread, spread, (tcount, 3)).astype(np.float32)
    e1 = rng.uniform(-tri_size, tri_size, (tcount, 3)).astype(np.float32)
    e2 = rng.uniform(-tri_size, tri_size, (tcount, 3)).astype(np.float32)
    pos = np.stack([a, a + e1, a + e2], axis=1)
    return np.concatenate([pos, np.ones((tcount, 3, 1), np.float32)], axis=2)


def _random_rays(rng, h, w, spread=8.0):
    o = rng.uniform(-spread, spread, (3, h, w)).astype(np.float32)
    d = rng.normal(size=(3, h, w)).astype(np.float32)
    d /= np.maximum(np.linalg.norm(d, axis=0, keepdims=True), 1e-9)
    return o, d


def _case_random(rng):
    pos = _random_scene(rng, 300)  # 5 cells, a dead-slot tail
    valid = np.ones(300, np.float32)
    valid[rng.uniform(size=300) < 0.3] = 0.0
    return pos, valid, *_random_rays(rng, 24, 40), 25.0


def _case_range_cap(rng):
    pos = _random_scene(rng, 64, spread=4.0)
    return pos, np.ones(64, np.float32), *_random_rays(rng, 16, 16, spread=3.0), 2.0


def _case_parked(rng):
    pos = _random_scene(rng, 128, spread=5.0)
    o, d = _random_rays(rng, 16, 128, spread=4.0)
    dead = rng.uniform(size=(16, 128)) < 0.5
    o[:, dead] = 1e8
    d[:, dead] = np.array([0.0, -1.0, 0.0], np.float32)[:, None]
    return pos, np.ones(128, np.float32), o, d, 30.0


def _case_dead_block(rng):
    pos = _random_scene(rng, 64)
    o, d = _random_rays(rng, 16, 128)
    o[:, 8:] = 1e8  # the lower 8x128 block is parked whole
    return pos, np.ones(64, np.float32), o, d, 20.0


def _case_nonaligned(rng):
    pos = _random_scene(rng, 200)
    return pos, np.ones(200, np.float32), *_random_rays(rng, 19, 70), 25.0


RT_CASES = {  # tests/test_rt_kernel.py
    "random": (7, _case_random),
    "range_cap": (11, _case_range_cap),
    "parked": (3, _case_parked),
    "dead_block": (5, _case_dead_block),
    "nonaligned": (13, _case_nonaligned),
}


def _jax_rt(pos, valid, o, d, t_cap, h, w):
    t, i = jrt.intersect_rays_pallas(
        jnp.asarray(pos), jnp.asarray(valid), *(jnp.asarray(c) for c in o),
        *(jnp.asarray(c) for c in d), jnp.float32(t_cap), h, w, interpret=True,
    )
    return np.asarray(t), np.asarray(i)


def _assert_rt_close(t, i, t_ref, i_ref, pinned_idx_diff=0):
    assert int((i != i_ref).sum()) == pinned_idx_diff
    same = (i == i_ref) & (i_ref >= 0)
    np.testing.assert_allclose(t[same], t_ref[same], rtol=1e-6, atol=1e-6)
    assert np.all(np.isinf(t[i < 0]))


@pytest.mark.parametrize("case", list(RT_CASES))
def test_ray_intersect_matches_jax_kernel(case):
    seed, make = RT_CASES[case]
    pos, valid, o, d, t_cap = make(np.random.default_rng(seed))
    h, w = o.shape[1:]
    t_ref, i_ref = _jax_rt(pos, valid, o, d, t_cap, h, w)
    t, i = trt.intersect_rays_pallas_reference(
        _t(pos), _t(valid), *(_t(c) for c in o), *(_t(c) for c in d), t_cap, h, w
    )
    _assert_rt_close(t.numpy(), i.numpy(), t_ref, i_ref)
    if case == "dead_block":
        assert np.all(i.numpy()[8:] == -1)


def test_ray_intersect_prep_matches_jax(monkeypatch):
    """The shortlist keys and order (`tnear`, `slist`), the triangle and
    cell-box tables and the [t_cap | scene AABB] row equal the JAX
    package's, read off the arguments its kernel call receives; tied keys
    (gap 0, culled _BIG) keep cell order in both."""
    seen = {}

    def spy(kernel, out_shape, **kw):
        def run(*args):  # keep the arguments, skip the kernel
            seen["args"] = [np.asarray(a) for a in args]
            return [jnp.zeros(o.shape, o.dtype) for o in out_shape]
        return run

    monkeypatch.setattr(jrt.pl, "pallas_call", spy)
    pos, valid, o, d, t_cap = _case_random(np.random.default_rng(7))
    h, w = o.shape[1:]
    with jax.disable_jit():
        jrt.intersect_rays_pallas(
            jnp.asarray(pos), jnp.asarray(valid), *(jnp.asarray(c) for c in o),
            *(jnp.asarray(c) for c in d), jnp.float32(t_cap), h, w, interpret=True,
        )
    tnear, slist, tab, cbox, tcap = seen["args"][:5]
    prep = trt.rt_prepare(_t(pos), _t(valid), *(_t(c) for c in o), *(_t(c) for c in d),
                          t_cap, h, w)
    nb = prep["nby"] * prep["nbx"]
    np.testing.assert_array_equal(prep["tnear"].numpy(), tnear.reshape(nb, -1))
    np.testing.assert_array_equal(prep["slist"].numpy(), slist.reshape(nb, -1))
    np.testing.assert_array_equal(prep["tab"].numpy(), tab)
    np.testing.assert_array_equal(prep["cbox"].numpy(), cbox)
    np.testing.assert_array_equal(prep["tcap"].numpy(), tcap.reshape(-1))
    ties = (np.diff(tnear.reshape(nb, -1), axis=1) == 0).sum()
    assert ties > 0  # the order of tied keys was exercised


def test_ray_intersect_on_map_reflection_rays(map_128):
    """The map's own GGX reflection rays at 128x64 through both walks."""
    m = map_128
    *_, rays = _jax_gbuffer_and_rays(m)
    o = np.stack([rays["o_x"].numpy(), rays["o_y"].numpy(), rays["o_z"].numpy()])
    d = np.stack([rays["d_x"].numpy(), rays["d_y"].numpy(), rays["d_z"].numpy()])
    pos, valid = m["packed"].d3.pos, m["packed"].d3.valid
    t_ref, i_ref = _jax_rt(pos, valid, o, d, 50.0, 64, 128)
    t, i, work = trt.intersect_rays_pallas_reference(
        _t(pos), _t(valid), *(_t(c) for c in o), *(_t(c) for c in d), 50.0, 64, 128,
        return_work=True,
    )
    _assert_rt_close(t.numpy(), i.numpy(), t_ref, i_ref)
    assert int((i >= 0).sum()) > 500 and work["ray_triangle"] > 0


# ------------------------------------------------- G-buffer, hash, shading


def test_gbuffer_matches_jax(map_128):
    _z, _idx, hit, g, port_g, _rays = _jax_gbuffer_and_rays(map_128)
    hit = np.asarray(hit)
    for name in ("world", "view_dir", "normal", "base", "texel", "roughness", "metallic"):
        np.testing.assert_allclose(port_g[name].numpy()[hit], np.asarray(g[name])[hit],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(port_g["fullbright"].numpy(), np.asarray(g["fullbright"]))
    # the world positions the hash is seeded with round exactly alike
    np.testing.assert_array_equal(port_g["world"].numpy()[hit], np.asarray(g["world"])[hit])


def test_hash33_matches_jax():
    """On identical inputs, inside a jit as the reflection pass calls it."""
    rng = np.random.default_rng(1)
    p = [rng.uniform(lo, hi, 4096).astype(np.float32) for lo, hi in
         ((-100, 2000), (-100, 1000), (-50, 50))]
    ref = jax.jit(jr._hash33)(*p)
    out = tr._hash33(*(_t(c) for c in p))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_reflection_hit_shading_matches_jax(map_128):
    """_shade_reflection_hits on the same rays and hits (the JAX walk's),
    the lights and uniforms of the map frame."""
    m = map_128
    *_, rays = _jax_gbuffer_and_rays(m)
    names = ("o_x", "o_y", "o_z", "d_x", "d_y", "d_z")
    ray_np = [rays[k].numpy() for k in names]
    t_ref, i_ref = _jax_rt(m["packed"].d3.pos, m["packed"].d3.valid,
                           np.stack(ray_np[:3]), np.stack(ray_np[3:]), 50.0, 64, 128)
    i_ref = np.where(rays["ok"].numpy(), i_ref, -1)
    sky = m["uniforms"]["refl_sky"]
    ref = jax.jit(lambda *a: jr._shade_reflection_hits(*a, 0, jnp.asarray(sky)))(
        jnp.asarray(t_ref), jnp.asarray(i_ref), *(jnp.asarray(r) for r in ray_np),
        m["jax_d3"], m["jax_atlas"], jax.tree_util.tree_map(jnp.asarray, m["lights"]),
        m["uniforms"],
    )
    pt = packed_to_torch(m["packed"], "cpu")
    out = tr._shade_reflection_hits(_t(t_ref), _t(i_ref), *(_t(r) for r in ray_np), pt["d3"],
                                    pt["atlas"], m["lights"], m["uniforms"], 0, _t(sky))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert int((i_ref >= 0).sum()) > 500


def test_rt_prepare_sizes_and_padding():
    """The preparation's Python side: block and cell counts, the padded ray
    planes (parked origins, zero directions) and the shortlist shapes."""
    rng = np.random.default_rng(5)
    tcount, height, width = 300, 19, 150  # 5 cells, 3 x 2 ray blocks, ragged
    a = rng.uniform(-5, 5, (tcount, 3)).astype(np.float32)
    pos = np.stack([a, a + 1.0, a - 1.0], axis=1)
    pos = np.concatenate([pos, np.ones((tcount, 3, 1), np.float32)], axis=2)
    valid = np.ones(tcount, np.float32)
    o = rng.uniform(-4, 4, (3, height, width)).astype(np.float32)
    d = rng.normal(size=(3, height, width)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (pos, valid, *o, *d)]
    prep = trt.rt_prepare(*args, 30.0, height, width)
    assert (prep["cell"], prep["ncells"], prep["nby"], prep["nbx"]) == (64, 5, 3, 2)
    assert prep["rays"].shape == (6, 24, 256)
    assert prep["tab"].shape == (320, 16) and prep["cbox"].shape == (5, 8)
    assert prep["tnear"].shape == (6, 5) and prep["slist"].shape == (6, 5)
    assert prep["boxes"].shape == (6, 12)
    rays = prep["rays"].numpy()
    assert (rays[:3, height:, :] == 1e8).all() and (rays[:3, :, width:] == 1e8).all()
    assert (rays[3:, height:, :] == 0).all() and (rays[3:, :, width:] == 0).all()
    np.testing.assert_array_equal(rays[:, :height, :width], np.concatenate([o, d]))
    # every block's shortlist is a permutation of the cells, keys ascending
    assert (np.sort(prep["slist"].numpy(), axis=1) == np.arange(5)).all()
    assert (np.diff(prep["tnear"].numpy(), axis=1) >= 0).all()


def test_rt_prepare_block_boxes_skip_dead_rays_and_nans():
    """boxes: per 8x128 block the min and max of origin and direction over
    live rays; parked rays, padding lanes and NaN values do not count."""
    rng = np.random.default_rng(6)
    height, width = 11, 200
    o = rng.uniform(-4, 4, (3, height, width)).astype(np.float32)
    d = rng.normal(size=(3, height, width)).astype(np.float32)
    dead = rng.uniform(size=(height, width)) < 0.3
    o[:, dead] = 1e8
    d[1, 2, 5] = np.nan
    o[2, 9, 150] = np.nan
    o[:, 8:, 128:] = 1e8  # one block without a live ray
    pos = np.zeros((64, 3, 4), np.float32)
    pos[:, 1, 0] = pos[:, 2, 1] = 1.0
    args = [torch.from_numpy(x) for x in (pos, np.ones(64, np.float32), *o, *d)]
    boxes = trt.rt_prepare(*args, 30.0, height, width)["boxes"].numpy().reshape(2, 2, 12)
    fields = np.concatenate([o, d])
    live = o[0] < 1e7
    for by in range(2):
        for bx in range(2):
            ys, xs = slice(by * 8, by * 8 + 8), slice(bx * 128, bx * 128 + 128)
            m = live[ys, xs]
            for k in range(6):
                vals = fields[k][ys, xs][m]
                vals = vals[~np.isnan(vals)]
                lo = vals.min() if vals.size else np.float32(3e37)
                hi = vals.max() if vals.size else np.float32(-3e37)
                col = k if k < 3 else k + 3
                assert boxes[by, bx, col] == lo and boxes[by, bx, col + 3] == hi
    assert (boxes[1, 1, :3] == np.float32(3e37)).all()


def test_preparation_kernel_refuses_scenes_past_its_shared_memory():
    """The rank sort (rt_prepare_kernel) takes scenes up to
    PREPARE_MAX_CELLS cells, well inside what a block's shared memory holds
    (8 bytes a key, 224 KB); a scene with more cells is not refused: on
    CUDA tensors it takes the cluster route, rt_prepare_cluster_kernel (held
    to rt_prepare bit for bit on the card, tests/test_torch_cuda.py). On the
    CPU rt_prepare is the route, whatever the size, and no kernel of any
    route is counted."""
    assert trt.PREPARE_MAX_CELLS == 384 and trt.PREPARE_MAX_CELLS * 8 <= 224 * 1024
    assert trt.prepare_route(trt.PREPARE_MAX_CELLS + 1)["route"] == "cluster"
    tcount = 64 * (trt.PREPARE_MAX_CELLS + 1)
    pos = torch.zeros((1, 3, 4)).expand(tcount, 3, 4)
    rays = [torch.zeros((8, 128)) for _ in range(6)]
    names = ("b3.walk_launch", "b3.prepare.rank", "b3.prepare.cluster", "b3.prepare.global")
    before = [counters[c] for c in names]
    prep = trt.rt_prepare(pos, torch.zeros(tcount), *rays, 10.0, 8, 128)
    assert prep["ncells"] == trt.PREPARE_MAX_CELLS + 1
    assert prep["tnear"].shape == (1, trt.PREPARE_MAX_CELLS + 1)
    t, idx = trt.intersect_rays_pallas(pos, torch.zeros(tcount), *rays, 10.0, 8, 128)
    # CPU tensors: the plain version
    assert [counters[c] for c in names] == before
    assert t.shape == (8, 128) and int((idx >= 0).sum()) == 0

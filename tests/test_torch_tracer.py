"""The port's path tracer (`rusterix_tpu_torch.tracer`) against the JAX
package's, on the CPU.

- The threefry generator (`tracer/rng.py`) gives jax.random's bits:
  PRNGKey, split, fold_in and uniform, several seeds and shapes.
- The tracer's pack (the Morton-ordered d3 arrays, the per-triangle
  materials, the chunk boxes) is byte-equal to the JAX package's.
- One bounce's closest hits (t and the triangle) equal the JAX tracer's,
  read out of its chunk scan.
- On the scenes of tests/test_tracer.py (sky only, the lit box, the
  emissive box, the render graph's sky on the miss terminal, the material
  modifier per hit) and on the bench's tracer scene, the accumulation
  buffer after 2 samples at 32x24 is within TRACER_ATOL of the JAX
  tracer's (its row gather, onehot_limit = 0: its one-hot matmul is a TPU
  workaround) on every pixel but TRACER_PINNED. The draws are the same
  bits and every decision (hit, texel, specular choice, roulette) lands
  the same way; the values differ in the last bits where XLA's CPU build
  fuses products that the port leaves unfused (cos and sin, the colour
  polynomials), at most a few 1e-7.
- use_aabb_skip gives the brute force's pixels; trace_sharded over a mesh
  of two CPU devices is byte-equal to two trace() calls.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import rusterix_tpu as jx  # noqa: E402
import rusterix_tpu_torch as tx  # noqa: E402
from rusterix_tpu.tracer import tracer as jtr  # noqa: E402
from rusterix_tpu_torch.parallel import make_mesh  # noqa: E402
from rusterix_tpu_torch.tracer import rng  # noqa: E402
from rusterix_tpu_torch.tracer import tracer as ttr  # noqa: E402

#: |port - JAX| bound on the buffer's values, and the pixels allowed past it
TRACER_ATOL = 1e-5
TRACER_PINNED = 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [13, 7919 * 3 + 13, 0, 2**31 - 1, 2**32 - 5])
def test_threefry_bits_match_jax_random(seed):
    jkey = jax.random.PRNGKey(np.uint32(seed))
    key = rng.PRNGKey(seed)
    assert [int(x) for x in np.asarray(jkey)] == [key.k0, key.k1]
    jkeys = np.asarray(jax.random.split(jkey, 28))
    assert [[int(a), int(b)] for a, b in jkeys] == [[k.k0, k.k1] for k in key.split(28)]
    for data in (1, 17, 99, 2**31 + 5):
        folded = np.asarray(jax.random.fold_in(jkey, np.uint32(data)))
        k = key.fold_in(data)
        assert [int(x) for x in folded] == [k.k0, k.k1]
    sub = key.split(5)[3].fold_in(99)
    jsub = jax.random.fold_in(jax.random.split(jkey, 5)[3], 99)
    for shape in [(1,), (7,), (768, 2), (3, 5, 11)]:
        want = np.asarray(jax.random.uniform(jsub, shape))
        (got,) = rng.uniform_many([(sub, shape)], "cpu")
        got = got.numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(
        rng.uniform_bits([(sub, 33)], "cpu")[0].numpy().astype(np.uint32),
        np.asarray(jax.random.bits(jsub, (33,))))


def test_one_pass_draws_equal_separate_draws():
    key = rng.PRNGKey(77)
    draws = [(key.fold_in(1), (10, 2)), (key.fold_in(2), (7,)), (key.fold_in(3), (1,))]
    for got, draw in zip(rng.uniform_many(draws, "cpu"), draws):
        assert torch.equal(got, rng.uniform_many([draw], "cpu")[0])


def _box(pkg, x, y, z, s, color, material=None, tile=None):
    b = pkg.Batch3D.from_box(x, y, z, s, s, s).with_computed_normals()
    if tile is None:
        b.set_source(pkg.PixelSource.pixel(color))
    else:
        b.set_source(pkg.PixelSource.static_tile_index(tile))
    if material is not None:
        b.set_material(material)
    return b


def _many_boxes(pkg):
    """12 boxes (144 triangles: two chunks), one textured, two with
    materials, under a point and a spot light -> (scene, assets)."""
    mats = {3: pkg.Material(pkg.MaterialRole.Glossy, pkg.MaterialModifier.Luminance, 0.7, 0.0),
            7: pkg.Material(pkg.MaterialRole.Emissive, pkg.MaterialModifier.Nothing, 0.5, 0.0)}
    batches = [
        _box(pkg, -1.5 + 0.6 * (i % 4), -0.5 + 0.5 * (i // 4), -0.3 * (i % 3), 0.4,
             (40 + 17 * i, 200 - 9 * i, 90 + 11 * i, 255), mats.get(i), 0 if i == 5 else None)
        for i in range(12)
    ]
    scene = pkg.Scene.from_static([], batches).set_lights([
        pkg.Light(pkg.LightType.Point).with_position([1.0, 2.0, 2.0]).with_intensity(1.2)
        .compile(),
        pkg.Light(pkg.LightType.Spot).with_position([0.0, 3.0, 0.5]).with_intensity(0.8)
        .compile(),
    ])
    assets = pkg.Assets.default().with_textures(
        [pkg.Tile.from_texture(pkg.Texture.checkerboard(16, 4))])
    return scene, assets


def _bench(pkg):
    if pkg is tx:
        from rusterix_tpu_torch.scenes import build_tracer_scene

        scene, _cam, assets = build_tracer_scene()
        return scene, assets
    # bench.py measure_tracer's scene, built through the JAX package
    mats = pkg.Material(pkg.MaterialRole.Emissive, pkg.MaterialModifier.Nothing, 0.4, 0.0)
    scene = pkg.Scene.from_static([], [
        pkg.Batch3D.from_box(-2.0, -0.6, -2.0, 4.0, 0.1, 4.0)
        .set_source(pkg.PixelSource.pixel((200, 200, 200, 255))).with_computed_normals(),
        pkg.Batch3D.from_box(-0.4, -0.5, -0.4, 0.8, 0.8, 0.8)
        .set_source(pkg.PixelSource.pixel((220, 90, 60, 255))).with_computed_normals(),
        pkg.Batch3D.from_box(0.8, -0.5, -0.8, 0.4, 1.4, 0.4)
        .set_source(pkg.PixelSource.pixel((255, 240, 200, 255))).set_material(mats)
        .with_computed_normals(),
    ]).set_lights([pkg.Light(pkg.LightType.Point).with_position([1.5, 2.0, 1.5])
                   .with_intensity(0.4).compile()])
    return scene, pkg.Assets.default()


@pytest.mark.parametrize("build", [_many_boxes, _bench], ids=["many_boxes", "bench"])
def test_tracer_pack_matches_jax(build):
    packed_t, mats_t, boxes_t = ttr._pack_tracer_scene(*build(tx), device="cpu")
    packed_j, mats_j, boxes_j = jtr._pack_tracer_scene(*build(jx))
    d3_t, d3_j = vars(packed_t.d3), vars(packed_j.d3)
    assert d3_t.keys() == d3_j.keys()
    for k in d3_j:
        np.testing.assert_array_equal(np.asarray(d3_t[k]), np.asarray(d3_j[k]), err_msg=k)
    for got, want in ((mats_t, mats_j), (boxes_t, boxes_j)):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    for k in ("data", "rects", "tile_first", "tile_count"):
        np.testing.assert_array_equal(getattr(packed_t.atlas_index.atlas, k),
                                      getattr(packed_j.atlas_index.atlas, k))


def _camera(pkg, azimuth=0.9, distance=2.0, elevation=None):
    cam = pkg.D3OrbitCamera()
    cam.azimuth = azimuth
    if elevation is not None:
        cam.elevation = elevation
    cam.set_parameter_f32("distance", distance)
    return cam


#: ulps by which one bounce's t may differ from the JAX tracer's: XLA's CPU
#: build computes the camera rays' 1 / sqrt(|d|^2) with its own reciprocal
#: square root, which is not correctly rounded (1 ulp off on ~13% of inputs);
#: the port's (and CUDA's) is, so the rays and their t differ in the last bits
T_ULPS = 8


def test_one_bounce_hits_match_jax(monkeypatch):
    """The camera rays' closest hits over two chunks: the same triangle, and
    t within T_ULPS, the port's intersect_all against the JAX tracer's
    chunk scan (read out through jax.debug.callback)."""
    got_t, got_j = [], []
    real_port = ttr.intersect_all

    def port_intersect(*a, **k):
        out = real_port(*a, **k)
        got_t.append(tuple(x.numpy().copy() for x in out))
        return out

    monkeypatch.setattr(ttr, "intersect_all", port_intersect)
    real_scan = jax.lax.scan

    def scan(f, init, xs=None, *a, **k):
        out = real_scan(f, init, xs, *a, **k)
        if isinstance(init, tuple) and len(init) == 2:  # intersect_all's (best t, best index)
            jax.debug.callback(lambda t, i: got_j.append((np.asarray(t), np.asarray(i))),
                               *out[0])
        return out

    monkeypatch.setattr(jax.lax, "scan", scan)
    for pkg, buf, tr in ((tx, ttr.AccumBuffer(40, 30, device="cpu"), ttr.Tracer(device="cpu")),
                         (jx, jtr.AccumBuffer(40, 30), jtr.Tracer())):
        tr.bounces = 1
        if pkg is jx:
            tr.onehot_limit = 0
        scene, assets = _many_boxes(pkg)
        tr.trace(_camera(pkg, 0.5, 3.0, 0.3), scene, buf, 64, assets)
        buf.pixels
    (t_t, i_t), = got_t
    (t_j, i_j), = got_j
    np.testing.assert_array_equal(i_t, i_j)
    hit = i_t >= 0
    assert np.isinf(t_t[~hit]).all() and np.isinf(t_j[~hit]).all()
    ulps = np.abs(t_t[hit].view(np.int32).astype(np.int64) - t_j[hit].view(np.int32))
    assert int(ulps.max()) <= T_ULPS
    assert float((ulps == 0).mean()) > 0.5  # most hits bit for bit (75% here)
    assert 0 < int((i_t >= 128).sum()) and 0 < int(((i_t >= 0) & (i_t < 128)).sum())


def _lit_box(pkg, material=None, color=(200, 200, 200, 255)):
    """tests/test_tracer.py's _box_scene"""
    b = (pkg.Batch3D.from_box(-0.5, -0.5, -0.5, 1, 1, 1)
         .set_source(pkg.PixelSource.pixel(color)).with_computed_normals())
    if material is not None:
        b.set_material(material)
    return pkg.Scene.from_static([], [b]).set_lights(
        [pkg.Light(pkg.LightType.Point).with_position([2.0, 2.0, 2.0]).with_intensity(1.0)
         .compile()])


def _emissive(pkg):
    return pkg.Scene.from_static([], [
        pkg.Batch3D.from_box(-0.5, -0.5, -0.5, 1, 1, 1)
        .set_source(pkg.PixelSource.pixel((255, 120, 40, 255)))
        .set_material(pkg.Material(pkg.MaterialRole.Emissive, pkg.MaterialModifier.Nothing,
                                   1.0, 0.0))
        .with_computed_normals()])


def _glossy_inv(pkg):
    return _lit_box(pkg, pkg.Material(pkg.MaterialRole.Glossy,
                                      pkg.MaterialModifier.InvLuminance, 1.0, 0.0),
                    (30, 30, 30, 255))


SCENES = {
    "sky_only": (lambda pkg: (pkg.Scene.from_static([], []), pkg.Assets.default()),
                 dict(azimuth=0.0)),
    "lit_box": (lambda pkg: (_lit_box(pkg), pkg.Assets.default()), {}),
    "emissive": (lambda pkg: (_emissive(pkg), pkg.Assets.default()), {}),
    "render_graph_sky_miss": (lambda pkg: (pkg.Scene.from_static([], []), pkg.Assets.default()),
                              dict(azimuth=0.0, graph=True)),
    "modifier_per_hit": (lambda pkg: (_glossy_inv(pkg), pkg.Assets.default()), {}),
    "many_boxes_textured": (_many_boxes, dict(azimuth=0.5, distance=3.0)),
    "bench": (_bench, dict(azimuth=0.8, distance=4.0, elevation=0.5)),
}


def _trace(pkg, name, samples=2, width=32, height=24, skip=False):
    build, kw = SCENES[name]
    kw = dict(kw)
    graph = kw.pop("graph", False)
    if pkg is tx:
        buf, tr = ttr.AccumBuffer(width, height, device="cpu"), ttr.Tracer(device="cpu")
    else:
        buf, tr = jtr.AccumBuffer(width, height), jtr.Tracer()
        tr.onehot_limit = 0  # the JAX tracer's row gather
    tr.use_aabb_skip = skip
    if graph:
        shapefx = importlib.import_module(pkg.__name__ + ".shapefx")
        tr.set_render_graph(shapefx.ShapeFXGraph.default_render_graph(with_sky=True))
        tr.hour = 12.0
    scene, assets = build(pkg)
    cam = _camera(pkg, **kw)
    for _ in range(samples):
        tr.trace(cam, scene, buf, 64, assets)
    assert buf.frame == samples
    return buf.pixels


@pytest.mark.parametrize("name", list(SCENES))
def test_tracer_matches_jax(name):
    got, want = _trace(tx, name), _trace(jx, name)
    assert got.shape == want.shape == (24, 32, 4) and np.isfinite(got).all()
    far = (np.abs(got - want) > TRACER_ATOL).any(-1)
    assert int(far.sum()) == TRACER_PINNED, np.abs(got - want).max()
    assert float(np.abs(got[..., :3]).max()) > 0.05


def test_aabb_skip_matches_brute_force():
    """The chunk-box gate is a pure optimisation: identical pixels (and a
    scene with two chunks, so that a chunk can be skipped)."""
    for name in ("lit_box", "many_boxes_textured"):
        assert np.array_equal(_trace(tx, name, skip=True), _trace(tx, name, skip=False))


def test_trace_sharded_equals_sequential_traces():
    """trace_sharded over a mesh of two CPU devices: samples frame and
    frame + 1, gathered and folded in index order, byte-equal to two
    trace() calls; a second call goes on from frame 2."""
    scene, assets = _many_boxes(tx)
    cam = _camera(tx, 0.5, 3.0)
    seq = ttr.AccumBuffer(32, 24, device="cpu")
    tr = ttr.Tracer(device="cpu")
    for _ in range(4):
        tr.trace(cam, scene, seq, 64, assets)
    sharded = ttr.AccumBuffer(32, 24, device="cpu")
    mesh = make_mesh(2, "cpu")
    tr.trace_sharded(cam, scene, sharded, 64, assets, mesh)
    tr.trace_sharded(cam, scene, sharded, 64, assets, mesh)
    assert sharded.frame == seq.frame == 4
    np.testing.assert_array_equal(sharded.pixels, seq.pixels)


def test_accum_buffer_matches_jax():
    rng_ = np.random.default_rng(5)
    samples = rng_.uniform(0, 3, (5, 4, 6, 4)).astype(np.float32)
    got, want = ttr.AccumBuffer(6, 4, device="cpu"), jtr.AccumBuffer(6, 4)
    for s in samples[:2]:
        got.accumulate(s)
        want.accumulate(s)
    got.accumulate_batch(samples[2:])
    want.accumulate_batch(samples[2:])
    np.testing.assert_array_equal(got.pixels, want.pixels)
    np.testing.assert_array_equal(got.to_u8(), want.to_u8())
    got.reset()
    assert got.frame == 0


def test_rusterix_trace_scene_on_cpu():
    """The facade traces the client's scene (the minigame world) on its
    device."""
    import random

    from rusterix_tpu_torch.scenes import build_minigame, minigame_tick

    random.seed(7)
    rx = build_minigame("cpu")
    minigame_tick(rx)
    buf = ttr.AccumBuffer(32, 24, device="cpu")
    rx.trace_scene(rx.client.camera_d3, buf)
    rx.trace_scene(rx.client.camera_d3, buf)
    rx.server.stop()
    img = buf.pixels
    assert buf.frame == 2 and np.isfinite(img).all() and img[..., :3].max() > 0.0
    assert rx._tracer.device == torch.device("cpu")

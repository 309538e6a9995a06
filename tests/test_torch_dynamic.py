"""Dynamic batches and dynamic shadow casters in rusterix_tpu_torch against
the JAX package on the CPU: the scene of tests/test_shadow_render.py's
dynamic-caster tests (a floor and a torch, the wall a dynamic batch) with
a dynamic translucent pane and a dynamic 2D rectangle, over three frames
that move the wall, through both packages' `Rasterizer.rasterize` (the
JAX megakernel path, B1 in interpret mode; one JAX compile, its later
frames reuse it). Each frame packs the dynamic lists anew, concatenates
them after the cached static packs and min-composites the wall's depth
into the cached shadow maps.

Tolerance: the frames equal the JAX frames exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rusterix_tpu as jrt  # noqa: E402
import rusterix_tpu_torch as trt  # noqa: E402
from rusterix_tpu_torch.models import RenderMode  # noqa: E402
from rusterix_tpu_torch.ops.matrices import look_at_rh, perspective_fov_rh_zo  # noqa: E402
from rusterix_tpu_torch.ops.raster import _SCENE_CACHE, _SHADOW_CACHE  # noqa: E402

W, H = 128, 96
WALL_X = (2.0, 0.5, -2.2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wall(pkg, x):
    return (pkg.Batch3D.from_box(x, 0.0, -2.0, 0.2, 2.0, 4.0)
            .set_source(pkg.PixelSource.pixel((150, 100, 80, 255)))
            .set_cull_mode(pkg.CullMode.Off).with_computed_normals())


def _scene(pkg):
    """tests/test_shadow_render.py's _dyn_scene built by package `pkg`,
    with a dynamic pane in the opacity list and a dynamic 2D rectangle."""
    floor = (pkg.Batch3D.from_box(-5.0, -0.1, -5.0, 10.0, 0.1, 10.0)
             .set_source(pkg.PixelSource.pixel((200, 200, 200, 255)))
             .set_cull_mode(pkg.CullMode.Off).with_computed_normals())
    light = (pkg.Light(pkg.LightType.Point).with_position([0.0, 1.2, 0.0]).with_intensity(1.5)
             .with_color([1.0, 1.0, 1.0]).with_range(0.5, 30.0))
    scene = pkg.Scene.from_static([], [floor]).set_lights([light.compile()])
    scene.d3_dynamic.append(_wall(pkg, WALL_X[0]))
    scene.d3_dynamic_opacity.append(
        pkg.Batch3D.from_box(-1.0, 0.0, 1.0, 1.5, 1.5, 0.05)
        .set_source(pkg.PixelSource.pixel((60, 120, 220, 140))).set_cull_mode(pkg.CullMode.Off)
        .with_computed_normals())
    scene.d2_dynamic.append(pkg.Batch2D.from_rectangle(10.0, 10.0, 30.0, 20.0)
                            .set_source(pkg.PixelSource.pixel((240, 200, 60, 160))))
    scene.touch_dynamic()
    return scene


def _rasterizer(pkg, **kw):
    """tests/test_shadow_render.py's overhead camera, with shadow maps."""
    view = look_at_rh(np.array([0.0, 9.0, 5.0], np.float32), np.array([1.5, 0.0, 0.0], np.float32),
                      np.array([0.0, 1.0, 0.0], np.float32))
    proj = perspective_fov_rh_zo(1.2, float(W), float(H), 0.1, 100.0)
    r = pkg.Rasterizer.setup(None, view, proj, **kw)
    r.background((10, 10, 10, 255))
    r.ambient([0.12, 0.12, 0.12, 1.0])
    r.set_shadows(True)
    return r


@pytest.fixture(scope="module")
def frames():
    """-> (JAX frames, port frames, the port Rasterizer, its scene, its
    assets) over the three wall positions (one scene and one Assets a
    package, so the static packs and the maps stay cached)."""
    jr = _rasterizer(jrt)
    jr.use_pallas = True  # the megakernel path, in interpret mode here
    tr = _rasterizer(trt, device="cpu")
    js, ts = _scene(jrt), _scene(trt)
    ja, ta = jrt.Assets.default(), trt.Assets.default()
    want, got = [], []
    for x in WALL_X:
        js.d3_dynamic[0], ts.d3_dynamic[0] = _wall(jrt, x), _wall(trt, x)
        js.touch_dynamic()
        ts.touch_dynamic()
        want.append(jr.rasterize(js, W, H, 32, ja))
        got.append(tr.rasterize(ts, W, H, 32, ta))
    return want, got, tr, ts, ta


def _cached(cache, scene):
    """The entries of a module cache of ops.raster keyed by `scene`."""
    return [v for k, v in cache.items() if k[0] == scene._cache_uid or k[0][0] == scene._cache_uid]


def test_moving_dynamic_caster_frames_equal_jax(frames):
    want, got, tr, _ts, _ta = frames
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    fa = tr.frame_args
    assert fa["has_opacity"] and fa["has_d2"] and fa["shadow_spec"] is not None
    # the shadow moves with the wall
    assert int((np.abs(got[0].astype(int) - got[2].astype(int)).max(-1) > 10).sum()) > 1000


def test_dynamic_packs_follow_the_static_ones(frames):
    """The frame's packs are the cached static packs with the dynamic ones
    (capacities of stable_dynamic_caps: 16, 16 and 8) after them; the
    wall's 12 triangles live in the dynamic slots."""
    _want, _got, tr, ts, _ta = frames
    (cache,) = _cached(_SCENE_CACHE, ts)
    fa = tr.frame_args
    assert cache["dyn_caps"] == (16, 16, 8)
    for part, cap in (("d3", 16), ("d3_op", 16), ("d2", 8)):
        static = cache[part]["valid"]
        assert fa[part]["valid"].shape[0] == static.shape[0] + cap
        assert torch.equal(fa[part]["valid"][:static.shape[0]], static)
    assert int(fa["d3"]["valid"][-16:].sum()) == 12


def test_dynamic_casters_composite_into_the_cached_maps(frames):
    """With dynamic casters the frame's maps are the cached bake with the
    wall's depth min-composited in (nearer texels only); without them the
    frame takes the static bake as it is (a bake of its own: the setting is
    part of the cache key), and the wall casts no shadow."""
    _want, got, tr, ts, ta = frames
    (bake,) = _cached(_SHADOW_CACHE, ts)
    rows = tr.frame_args["shadow_rows"]
    assert bool((rows <= bake[0]).all()) and bool((rows < bake[0]).any())
    tr.set_shadows(True, dynamic_casters=False)
    off = tr.rasterize(ts, W, H, 32, ta)
    tr.set_shadows(True)
    assert torch.equal(tr.frame_args["shadow_rows"], bake[0])
    assert int((np.abs(off.astype(int) - got[2].astype(int)).max(-1) > 10).sum()) > 100


def test_3d_off_zeroes_the_dynamic_3d_slots(frames):
    """With the 3D pass off (render_2d) the static and dynamic 3D slots are
    dead and only the 2D batches draw."""
    _want, _got, tr, ts, ta = frames
    tr.set_render_mode(RenderMode.render_2d())
    try:
        frame = tr.rasterize(ts, W, H, 32, ta)
        fa = tr.frame_args
        assert not fa["d3"]["valid"].any() and not fa["has_opacity"] and fa["has_d2"]
        assert (frame[10:30, 10:40] != frame[60, 100]).any(-1).all()
    finally:
        tr.set_render_mode(RenderMode.render_all())

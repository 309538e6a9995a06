"""Shadowed frames of rusterix_tpu_torch through the public Rasterizer API
on the CPU: tests/test_shadow_render.py's room (a floor, a wall and a
point light, with the light's cube map and a sun map) and the bench's
shadowed map at a small size, each against the JAX Rasterizer's
megakernel path (use_pallas=True, interpret mode); then, in the port
alone, that the umbra darkens, that apply_render_settings'
max_shadow_distance drives the output and that a moving light re-bakes.
The shadowed 1080p frames are held to the CPU frames on the card
(chip_smoke.py, paths G and H).

Tolerances: frames within 1 per RGBA8 channel with the count of
differing pixels pinned (0 on both scenes: the bakes are equal texel for
texel and the lookups round as XLA's fused products).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench  # noqa: E402
from rusterix_tpu import Assets  # noqa: E402
from rusterix_tpu.models.render_settings import RenderSettings  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu_torch import Rasterizer  # noqa: E402
from tests.test_shadow_render import H, W, _rast, _scene, _umbra_vs_open  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SUN_DIR = np.array([0.6, -1.0, 0.0], np.float32)


def _port_rast(jax_rast):
    """The port's Rasterizer with the JAX one's camera, background, ambient
    and sun."""
    r = Rasterizer.setup(None, jax_rast.view_matrix, jax_rast.projection_matrix, device="cpu")
    r.background_color, r.ambient_color = jax_rast.background_color, jax_rast.ambient_color
    r.sun_dir, r.sun_color, r.day_factor = (jax_rast.sun_dir, jax_rast.sun_color,
                                            jax_rast.day_factor)
    return r


def _assert_pinned(ref, out, pinned_differing):
    diff = np.abs(ref.astype(np.int32) - out.astype(np.int32)).max(axis=-1)
    assert int((diff > 1).sum()) == 0
    assert int((diff > 0).sum()) == pinned_differing


def test_room_shadow_frame_matches_jax_megakernel():
    """The point light's cube map and the sun's map at 128x96 (maps of 128²
    and 256², set_shadows' defaults)."""
    scene, assets = _scene(), Assets.default()
    packed = PackedScene.from_scene(scene, assets, static_only=True)
    jax_rast = _rast(use_pallas=True)
    jax_rast.sun_dir, jax_rast.day_factor = SUN_DIR, 1.0
    jax_rast.set_shadows(True)
    ref = jax_rast.rasterize(scene, W, H, 32, assets, packed=packed)
    port = _port_rast(jax_rast).set_shadows(True)
    out = port.rasterize(scene, W, H, 32, assets, packed=packed)
    assert port.frame_args["shadow_spec"][0] is not None  # the sun's map
    _assert_pinned(ref, out, 0)
    unshadowed = port.set_shadows(False).rasterize(scene, W, H, 32, assets, packed=packed)
    assert int((np.abs(out.astype(int) - unshadowed.astype(int)).max(-1) > 8).sum()) > 300


def test_map_shadow_frame_matches_jax_megakernel():
    """The bench's map_1920x1080_shadow_fps scene at 128x64, with maps of
    32² and a sun map of 64² to keep the bakes small."""
    w, h = 128, 64
    jax_rast, scene, assets = bench.build_map_shadow_scene(w, h)
    jax_rast.set_shadows(True, res=32, sun_res=64)
    jax_rast.use_pallas = True
    packed = PackedScene.from_scene(scene, assets, static_only=True)
    ref = jax_rast.rasterize(scene, w, h, 40, assets, packed=packed)
    port = _port_rast(jax_rast).set_shadows(True, res=32, sun_res=64)
    out = port.rasterize(scene, w, h, 40, assets, packed=packed)
    sun_entry, cubes = port.frame_args["shadow_spec"]
    assert sun_entry is not None and [c[0] for c in cubes] == [3, 4, 5, 6]
    _assert_pinned(ref, out, 0)


def test_point_shadow_darkens_umbra():
    scene, assets = _scene(), Assets.default()
    r = _port_rast(_rast(use_pallas=True))
    off = r.rasterize(scene, W, H, 32, assets)
    on = r.set_shadows(True).rasterize(scene, W, H, 32, assets)
    umbra_off, open_off = _umbra_vs_open(off)
    umbra_on, open_on = _umbra_vs_open(on)
    assert abs(open_on - open_off) < 2.0, (open_on, open_off)
    assert umbra_on < umbra_off - 10.0, (umbra_on, umbra_off)


def test_sun_shadow_and_max_shadow_distance_drive_output():
    """apply_render_settings' sun casts the wall's shadow, and a
    max_shadow_distance below the wall-to-floor distance opens the umbra."""
    scene, assets = _scene(), Assets.default()

    def render(msd):
        r = _port_rast(_rast(use_pallas=True))
        rs = RenderSettings()
        rs.sun_enabled = True
        rs.sun_direction = (0.6, -1.0, 0.0)
        rs.sun_intensity = 1.0
        rs.max_shadow_distance = msd
        r.apply_render_settings(rs)
        return r.set_shadows(True).rasterize(scene, W, H, 32, assets)

    u_base, o_base = _umbra_vs_open(render(50.0))
    u_cap, o_cap = _umbra_vs_open(render(0.05))
    assert u_base < u_cap - 10.0, (u_base, u_cap)
    assert abs(o_base - o_cap) < 2.0


def test_moving_light_rebakes():
    """Moving the casting light invalidates the cached bake (the umbra
    follows); an unmoved light reuses it."""
    from rusterix_tpu_torch.ops import raster

    # the cache is cleared wholesale past 8 entries: start it empty, so
    # that the bakes of tests run earlier in the process cannot evict this
    # test's first bake when its second one is added
    raster._SHADOW_CACHE.clear()
    scene, assets = _scene(), Assets.default()
    r = _port_rast(_rast(use_pallas=True)).set_shadows(True, res=64)
    a = r.rasterize(scene, W, H, 32, assets)
    rows = r.frame_args["shadow_rows"]
    r.rasterize(scene, W, H, 32, assets)
    assert r.frame_args["shadow_rows"] is rows
    scene.lights[0].position = np.array([4.0, 1.2, 0.0], np.float32)
    b = r.rasterize(scene, W, H, 32, assets)
    assert r.frame_args["shadow_rows"] is not rows
    assert np.abs(a.astype(int) - b.astype(int)).max() > 20
    assert len(raster._SHADOW_CACHE) >= 2

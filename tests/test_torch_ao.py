"""rusterix_tpu_torch's ambient occlusion against the JAX package on the
CPU: the tap spiral, `ssao_pass` on synthetic depths (tests/test_ao.py's)
and on the map's visibility pass, B1's plain version with the `ao_img`
input against the JAX kernel in interpret mode, and the AO frame of
tests/test_ao.py's floor-and-wall scene against the JAX Rasterizer's
megakernel path (use_pallas=True). The map's AO frame is held to the
CPU frame on the card (chip_smoke.py, path C).

Tolerances: tap offsets and the AO factor exactly (the port writes out
XLA's fused products and takes a correctly rounded square root, so every
tap decision and the falloff sum agree bit for bit); frames within 1 per
RGBA8 channel with the count of differing pixels pinned (0 on these
scenes).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from rusterix_tpu import Assets, Batch3D, CullMode, PixelSource, Scene  # noqa: E402
from rusterix_tpu.ops import ao as jao  # noqa: E402
from rusterix_tpu.ops.matrices import look_at_rh, perspective_fov_rh_zo  # noqa: E402
from rusterix_tpu.ops.raster import Rasterizer as JaxRasterizer  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu.ops.setup_pass import setup_pass as jax_setup_pass  # noqa: E402
from rusterix_tpu.ops.visibility import visibility_pass as jax_visibility_pass  # noqa: E402
from rusterix_tpu_torch import Rasterizer  # noqa: E402
from rusterix_tpu_torch.ops import ao as tao  # noqa: E402
from rusterix_tpu_torch.ops import megakernel as tm  # noqa: E402
from tests.test_torch_megakernel import (  # noqa: E402
    CASES,
    H,
    W,
    _box_inputs,
    _jax_render,
    _max_channel_diff,
    _torch_args,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("samples,max_px", [(1, 24), (4, 24), (8, 24), (8, 12), (32, 24)])
def test_tap_offsets_match_jax(samples, max_px):
    assert tao.tap_offsets(samples, max_px) == jao.tap_offsets(samples, max_px)


def _ndc_from_depth(d, near=0.1, far=100.0):
    """view depth -> (z_ndc, depth_a, depth_b) for RH-ZO (tests/test_ao.py)."""
    a = far / (near - far)
    b = near * far / (near - far)
    return (b / d - a).astype(np.float32), np.float32(a), np.float32(b)


def _synthetic(name):
    """tests/test_ao.py's step edge and slanted plane, and a bumpy depth
    field with misses -> (depth, hit, radius, px_scale, taps)."""
    h, w = 64, 96
    if name == "step":
        d = np.full((h, w), 10.0, np.float32)
        d[:, 48:] = 9.7
        hit = np.ones((h, w), bool)
        hit[:4, :] = False
        return d, hit, 1.0, 0.002, tao.tap_offsets(8, max_px=12)
    if name == "slope":
        rows = np.arange(h, dtype=np.float32)[:, None]
        d = (6.0 + 0.12 * rows * np.ones((1, w), np.float32)).astype(np.float32)
        return d, np.ones((h, w), bool), 1.0, 0.002, tao.tap_offsets(8, max_px=12)
    rng = np.random.default_rng(0)
    d = 8 + rng.uniform(-0.5, 0.5, (h, w)).cumsum(0) * 0.05 + rng.uniform(0, 0.3, (h, w))
    hit = rng.uniform(size=(h, w)) > 0.1
    return d.astype(np.float32), hit, 0.6, 0.01, tao.tap_offsets(8)


@pytest.mark.parametrize("name", ["step", "slope", "bumpy"])
def test_ssao_matches_jax_on_synthetic_depth(name):
    d, hit, radius, px_scale, taps = _synthetic(name)
    z, a, b = _ndc_from_depth(d)
    ref = np.asarray(jao.ssao_pass(jnp.asarray(z), jnp.asarray(hit), a, b, radius, px_scale, taps))
    out = tao.ssao_pass(torch.from_numpy(z), torch.from_numpy(hit), a, b, radius, px_scale, taps)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref < 0.999).sum() > 100  # the depths occlude
    assert (ref[~hit] == 1.0).all()


def test_ssao_square_root_is_correctly_rounded():
    """The tap distance takes its square root in f64 and rounds once, which
    is the correctly rounded f32 square root (as XLA's and CUDA's sqrtf are;
    torch's vectorised f32 CPU square root can miss the last bit), and the
    distance decides `dist < radius`."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0.0, 1.0, 200000).astype(np.float32)
    exact = np.sqrt(x)  # IEEE, correctly rounded
    via_f64 = torch.sqrt(torch.from_numpy(x).double()).float().numpy()
    np.testing.assert_array_equal(via_f64, exact)


def test_ssao_matches_jax_on_the_map_visibility():
    """The bench map's depth and coverage from the JAX visibility pass at
    192x96, through both AO passes with the bench's AO (8 samples, radius
    0.6) and the frame's own depth constants and pixel scale."""
    w, h = 192, 96
    rast, scene, assets = bench.build_map_scene(w, h)
    packed = PackedScene.from_scene(scene, assets, static_only=True)
    d3 = {k: jnp.asarray(v) for k, v in vars(packed.d3).items()}
    proj = np.asarray(rast.projection_matrix, np.float32)
    vis, _attr, _bbox, alive, _tid = jax_setup_pass(
        d3["pos"], d3["uv"], d3["nrm"], d3["valid"], d3["cull"],
        jnp.asarray(rast.view_matrix, jnp.float32), jnp.asarray(proj), w, h,
    )
    z, _idx, hit = jax_visibility_pass(vis, alive.astype(jnp.float32), w, h)
    px_scale = np.float32(2.0) / (proj[1, 1] * np.float32(h))
    taps = tao.tap_offsets(8)
    ref = np.asarray(jao.ssao_pass(z, hit, proj[2, 2], proj[2, 3], np.float32(0.6), px_scale,
                                   taps))
    out = tao.ssao_pass(torch.from_numpy(np.array(z)), torch.from_numpy(np.array(hit)),
                        proj[2, 2], proj[2, 3], np.float32(0.6), px_scale, taps)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref < 0.99).sum() > 50  # the map's corners occlude


def test_mega_reference_with_ao_matches_jax_interpret():
    """B1's plain version with an (H, W) AO factor drawn from a seed against
    mega_render(ao_img=..., interpret=True), on the box with every light
    type, the sun, bilinear texels and exp^2 fog: z equal, RGBA within 1."""
    args, kwargs = _box_inputs(*CASES[4])
    ao = np.random.default_rng(4).uniform(0.2, 1.0, (H, W)).astype(np.float32)
    rgba_ref, z_ref = _jax_render(args, dict(kwargs, ao_img=jnp.asarray(ao)))
    targs, tkw = _torch_args(args, kwargs)
    rgba, z = tm.mega_render(*targs, W, H, **tkw, ao_img=torch.from_numpy(ao))
    plain, _ = tm.mega_render(*targs, W, H, **tkw)
    assert not torch.equal(rgba, plain), "ao_img changed nothing"
    np.testing.assert_array_equal(z.numpy(), z_ref)
    assert _max_channel_diff(rgba.numpy(), rgba_ref) <= 1


def _floor_and_wall():
    """tests/test_ao.py's floor plane and wall box, its camera and an
    ambient-only light setup (the luminance ratio is the AO factor)."""
    floor = (
        Batch3D.from_box(-5.0, -0.1, -5.0, 10.0, 0.1, 10.0)
        .set_source(PixelSource.pixel((200, 200, 200, 255)))
        .set_cull_mode(CullMode.Off)
        .with_computed_normals()
    )
    wall = (
        Batch3D.from_box(2.0, 0.0, -2.0, 0.2, 2.0, 4.0)
        .set_source(PixelSource.pixel((150, 100, 80, 255)))
        .set_cull_mode(CullMode.Off)
        .with_computed_normals()
    )
    scene = Scene.from_static([], [floor, wall]).set_lights([])
    view = look_at_rh(np.array([0.0, 9.0, 5.0], np.float32), np.array([1.5, 0.0, 0.0], np.float32),
                      np.array([0.0, 1.0, 0.0], np.float32))
    proj = perspective_fov_rh_zo(1.2, 128.0, 96.0, 0.1, 100.0)
    return scene, view, proj


def _ao_frames(samples, radius):
    """The floor-and-wall scene at 128x96 through the JAX megakernel path
    and the port, one shared PackedScene -> (jax, port) int32 frames."""
    scene, view, proj = _floor_and_wall()
    packed = PackedScene.from_scene(scene, Assets.default(), static_only=True)
    frames = []
    for rast in (JaxRasterizer.setup(None, view, proj),
                 Rasterizer.setup(None, view, proj, device="cpu")):
        rast.use_pallas = True
        rast.background((10, 10, 10, 255)).ambient([0.6, 0.6, 0.6, 1.0])
        rast.set_ambient_occlusion(True, samples=samples, radius=radius)
        frames.append(rast.rasterize(scene, 128, 96, 40, Assets.default(),
                                     packed=packed).astype(np.int32))
    return frames


def test_ao_frame_matches_jax_megakernel():
    """tests/test_ao.py's AO scene, samples 8, radius 2.0: pixel for pixel."""
    ref, out = _ao_frames(8, 2.0)
    scene, view, proj = _floor_and_wall()
    off = Rasterizer.setup(None, view, proj, device="cpu").background((10, 10, 10, 255))
    off = off.ambient([0.6, 0.6, 0.6, 1.0]).rasterize(scene, 128, 96, 40, Assets.default())
    assert int((np.abs(out - off.astype(np.int32)).max(-1) > 1).sum()) > 100  # AO darkens
    assert int((np.abs(ref - out).max(-1) > 0).sum()) == 0


def test_ao_with_zero_samples_is_ao_off():
    """samples == 0 is compute_ao's early return: no pre-pass, no AO
    factor, the frame without AO byte for byte (the JAX package's
    _ao_taps returns None alike)."""
    scene, view, proj = _floor_and_wall()
    frames = []
    for samples in (0, None):
        rast = Rasterizer.setup(None, view, proj, device="cpu").background((10, 10, 10, 255))
        rast.ambient([0.6, 0.6, 0.6, 1.0])
        if samples is not None:
            rast.set_ambient_occlusion(True, samples=samples, radius=2.0)
            assert rast._ao_taps() is None
        frames.append(rast.rasterize(scene, 128, 96, 40, Assets.default()))
    np.testing.assert_array_equal(frames[0], frames[1])
    jax_rast = JaxRasterizer.setup(None, view, proj).set_ambient_occlusion(True, samples=0)
    assert jax_rast._ao_taps() is None


def test_render_settings_carry_ao_samples_and_radius():
    """apply_render_settings keeps ao_samples / ao_radius (defaults 4 and
    0.5 before it): set_ambient_occlusion without arguments takes them."""
    from rusterix_tpu_torch.models import RenderSettings

    scene, view, proj = _floor_and_wall()
    rast = Rasterizer.setup(None, view, proj, device="cpu").set_ambient_occlusion(True)
    assert (rast._rs_ao_samples, rast._rs_ao_radius) == (4.0, 0.5)
    assert rast._ao_taps() == tao.tap_offsets(4) and rast._uniforms(scene)["ao_radius"] == 0.5
    rs = RenderSettings()
    rs.ao_samples, rs.ao_radius = 8.0, 1.5
    rast.apply_render_settings(rs)
    assert rast._ao_taps() == tao.tap_offsets(8)
    assert rast._uniforms(scene)["ao_radius"] == np.float32(1.5)
    assert rast.set_ambient_occlusion(True, radius=0.0)._ao_taps() is None

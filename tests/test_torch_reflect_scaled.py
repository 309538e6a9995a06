"""rusterix_tpu_torch's reflections at a reduced scale against the JAX
package on the CPU: the bilinear upsample against `jax.image.resize`, the
strided reflection pass against the full-resolution pass subsampled at the
same pixels, and the bench's map_1920x1080_ggx_refl1_half frame at 256x128
(`reflection_pass_scaled(scale=2)` on the map).

Tolerances: the upsample bit for bit where jnp.einsum contracts the width
first (landscape frames), else allclose(atol=1e-5) with the same mask
decisions (XLA's CPU dot rounds the height-first contraction of a portrait
frame in another order, not reproduced here); the strided pass's mask
exactly and its radiance allclose(atol=1e-5) (the JAX package's own
promise, tests/test_reflect.py); the frame within 1 per RGBA8 channel with the
count of differing pixels pinned (0 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu_torch import (  # noqa: E402
    Assets,
    Batch3D,
    D3OrbitCamera,
    Light,
    LightType,
    PixelSource,
    Rasterizer,
    Scene,
    Texture,
)
from rusterix_tpu_torch.models import Tile  # noqa: E402
from rusterix_tpu_torch.ops import reflect as tr  # noqa: E402
from rusterix_tpu_torch.ops.raster import frame_inputs, visibility_prepass  # noqa: E402


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


@pytest.mark.parametrize("out_h,out_w,exact", [
    (64, 128, True),    # even, landscape: the bench's case
    (59, 130, True),    # odd height, irrational scale
    (41, 40, True),     # odd, nearly square (the width still contracts first)
    (97, 63, False),    # odd portrait: jnp.einsum contracts the height first
])
def test_resize_bilinear_matches_jax(out_h, out_w, exact):
    """The radiance (h, w, 3) and the applied mask (h, w) from half size up,
    with seeded values."""
    rng = np.random.default_rng(out_h * out_w)
    hs, ws = out_h // 2, out_w // 2
    img = rng.uniform(0.0, 1.0, (hs, ws, 3)).astype(np.float32)
    mask = (rng.uniform(size=(hs, ws)) > 0.5).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (out_h, out_w, 3), "bilinear"))
    ref_m = np.asarray(jax.image.resize(jnp.asarray(mask), (out_h, out_w), "bilinear"))
    out = tr._resize_bilinear(torch.from_numpy(img), out_h, out_w).numpy()
    out_m = tr._resize_bilinear(torch.from_numpy(mask), out_h, out_w).numpy()
    np.testing.assert_array_equal(out_m > 0.5, ref_m > 0.5)
    if exact:
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out_m, ref_m)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(out_m, ref_m, rtol=0, atol=1e-5)


def test_strided_pass_equals_full_res_subsampled():
    """reflection_pass with stride 2 equals the full-resolution pass at the
    even pixels, on a checkerboard floor (planes evaluated at the wrong
    screen position would shift texels) with a box, two samples a pixel
    (tests/test_reflect.py:318-380 on the port)."""
    w, h = 160, 120
    floor = (
        Batch3D.from_box(-3, -1.3, -3, 6, 0.2, 6)
        .set_source(PixelSource.static_tile_index(0))
        .with_computed_normals()
    )
    box = (
        Batch3D.from_box(-0.5, -0.5, -0.5, 1.0, 1.0, 1.0)
        .set_source(PixelSource.pixel((250, 40, 40, 255)))
        .with_computed_normals()
    )
    scene = Scene.from_static([], [floor, box]).set_lights(
        [Light(LightType.Point).with_position([2, 2, 2]).with_intensity(1.5).compile()]
    )
    assets = Assets.default().with_textures([Tile.from_texture(Texture.checkerboard(32, 4))])
    cam = D3OrbitCamera()
    cam.azimuth = 0.8
    cam.set_parameter_f32("distance", 4.0)
    rast = Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(w, h), device="cpu")
    rast.ambient((0.25, 0.3, 0.35, 1.0)).background((90, 120, 160, 255)).set_reflections(1)
    rast.rasterize(scene, w, h, 40, assets)
    fa = rast.frame_args
    fi = frame_inputs(**fa)
    z, idx, hit = visibility_prepass(fi, w, h)
    common = (fi["attr"], fi["tri_id"], fa["d3"], fa["atlas"], fa["lights"], fa["uniforms"])
    full, fmask = tr.reflection_pass(z, idx, hit, *common, w, h, 0, 2)
    sl = (slice(0, h, 2), slice(0, w, 2))
    lo, lmask = tr.reflection_pass(z[sl], idx[sl], hit[sl], *common, w // 2, h // 2, 0, 2,
                                   stride=2)
    np.testing.assert_array_equal(lmask.numpy(), fmask.numpy()[sl])
    np.testing.assert_allclose(lo.numpy(), full.numpy()[sl], rtol=0, atol=1e-5)
    assert int(lmask.sum()) > 1000


def test_half_scale_reflection_frame_matches_jax_megakernel():
    """The bench's map_1920x1080_ggx_refl1_half configuration at 256x128:
    pixel for pixel."""
    w, h = 256, 128
    rast, scene, assets = bench.build_map_refl_scene(w, h)
    rast.set_reflections(1, scale=2)
    rast.use_pallas = True
    packed = PackedScene.from_scene(scene, assets, static_only=True)
    ref = rast.rasterize(scene, w, h, 40, assets, packed=packed).astype(np.int32)
    port = Rasterizer.setup(None, rast.view_matrix, rast.projection_matrix, device="cpu")
    port.ambient([0.25, 0.25, 0.3, 1.0]).set_brdf("ggx").set_reflections(1, scale=2)
    port.sun_dir = np.array([0.4, -1.0, 0.25], np.float32)
    port.sun_color = np.array([1.0, 1.0, 0.95], np.float32)
    port.day_factor = 1.0
    out = port.rasterize(scene, w, h, 40, assets, packed=packed).astype(np.int32)
    assert int((np.abs(ref - out).max(-1) > 0).sum()) == 0

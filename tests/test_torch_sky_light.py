"""rusterix_tpu_torch's sky light against the JAX package on the CPU:
`sky_light_pass` (its term and mask) on identical inputs, with B3's plain
version on the port's side and the JAX kernel in interpret mode on the
other, and the sky-light frame of the repo's floor-and-wall scene (with
the bench's AO) against the JAX Rasterizer's megakernel path.

Tolerances: the mask exactly; the term allclose(rtol=1e-6, atol=1e-6)
(XLA's CPU build fuses the sRGB decode of the albedo); frames within 1 per
RGBA8 channel with the count of differing pixels pinned (0 here).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rusterix_tpu import (  # noqa: E402
    Assets,
    Batch3D,
    D3OrbitCamera,
    Light,
    LightType,
    PixelSource,
    Scene,
)
from rusterix_tpu.ops import reflect as jr  # noqa: E402
from rusterix_tpu.ops.raster import Rasterizer as JaxRasterizer  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu.ops.setup_pass import setup_pass as jax_setup_pass  # noqa: E402
from rusterix_tpu.ops.visibility import visibility_pass as jax_visibility_pass  # noqa: E402
from rusterix_tpu_torch.ops import reflect as tr  # noqa: E402
from rusterix_tpu_torch.ops.raster import packed_to_torch  # noqa: E402
from rusterix_tpu_torch.scenes import build_sky_light_scene  # noqa: E402

W, H = 128, 80


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_sky_scene():
    """build_sky_light_scene built with the JAX package's classes ->
    (JAX Rasterizer on its megakernel path, scene)."""
    floor = (
        Batch3D.from_box(-6, -1.2, -4, 12, 0.2, 8)
        .set_source(PixelSource.pixel((120, 120, 120, 255)))
        .with_computed_normals()
    )
    wall = (
        Batch3D.from_box(-6, -1.0, -4, 0.3, 5.0, 8)
        .set_source(PixelSource.pixel((90, 60, 40, 255)))
        .with_computed_normals()
    )
    scene = Scene.from_static([], [floor, wall]).set_lights(
        [Light(LightType.Point).with_position([2, 3, 2]).with_intensity(1.0).compile()]
    )
    cam = D3OrbitCamera()
    cam.azimuth = 0.0
    cam.elevation = 0.35
    cam.set_parameter_f32("distance", 8.0)
    rast = JaxRasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(W, H))
    rast.ambient((0.2, 0.2, 0.2, 1.0)).background((60, 110, 220, 255))
    rast.use_pallas = True
    rast.set_sky_light(True).set_ambient_occlusion(True, samples=8, radius=0.6)
    return rast, scene


def _t(a):
    return torch.from_numpy(np.array(a))


def test_sky_light_pass_matches_jax():
    """The pass on the JAX package's visibility of the scene: the rays that
    reach the sky (the mask) exactly, the term to float rounding."""
    rast, scene = _jax_sky_scene()
    packed = PackedScene.from_scene(scene, Assets.default(), static_only=True)
    uniforms = {k: np.asarray(v) for k, v in rast._uniforms(scene).items()}
    d3 = {k: jnp.asarray(v) for k, v in vars(packed.d3).items()}
    atlas_np = packed.atlas_index.atlas
    atlas = {
        "flat": jnp.asarray(atlas_np.data.reshape(-1, 4)),
        "w": jnp.int32(atlas_np.data.shape[1]),
        **{k: jnp.asarray(getattr(atlas_np, k)) for k in ("rects", "tile_first", "tile_count")},
    }
    vis, attr, _bbox, alive, tri_id = jax_setup_pass(
        d3["pos"], d3["uv"], d3["nrm"], d3["valid"], d3["cull"],
        jnp.asarray(uniforms["view"]), jnp.asarray(uniforms["proj"]), W, H,
    )
    z, idx, hit = jax_visibility_pass(vis, alive.astype(jnp.float32), W, H)
    term_ref, mask_ref = jr.sky_light_pass(z, idx, hit, attr, tri_id, d3, atlas, uniforms,
                                           W, H, 0, rt_pallas=True)
    pt = packed_to_torch(packed, "cpu")
    term, mask = tr.sky_light_pass(_t(z), _t(idx), _t(hit), _t(attr), _t(tri_id), pt["d3"],
                                   pt["atlas"], uniforms, W, H)
    mask_ref = np.asarray(mask_ref)
    np.testing.assert_array_equal(mask.numpy(), mask_ref)
    np.testing.assert_allclose(term.numpy(), np.asarray(term_ref), rtol=1e-6, atol=1e-6)
    assert 1000 < mask_ref.sum() < int(np.asarray(hit).sum())  # some rays escape, some hit


def test_sky_light_frame_matches_jax_megakernel():
    """The port's own scene builder (sky light and the bench's AO) against
    the same scene in the JAX package, each packing its own copy: pixel for
    pixel."""
    rast, scene = _jax_sky_scene()
    ref = rast.rasterize(scene, W, H, 40, Assets.default()).astype(np.int32)
    port, port_scene, assets = build_sky_light_scene(W, H, device="cpu")
    out = port.rasterize(port_scene, W, H, 40, assets).astype(np.int32)
    assert int((np.abs(ref - out).max(-1) > 0).sum()) == 0


def test_sky_light_brightens_open_floor_and_leaves_the_sky():
    """The sky's blue lands on floor whose mirror rays escape (the rows near
    the camera) and hardly on floor right under the wall; background pixels
    keep their bytes (tests/test_reflect.py's sky-light check, on the port)."""
    frames = []
    for on in (False, True):
        port, scene, assets = build_sky_light_scene(W, H, device="cpu")
        port.set_sky_light(on).set_ambient_occlusion(False)
        frames.append(port.rasterize(scene, W, H, 40, assets).astype(np.int32))
    off, on = frames
    assert np.array_equal(on[0, 0], off[0, 0])
    gain_b = on[..., 2] - off[..., 2]
    open_rows = gain_b[int(H * 0.8):]
    blocked_rows = gain_b[int(H * 0.34): int(H * 0.5)]
    assert open_rows.mean() > 30
    assert blocked_rows.mean() < open_rows.mean() / 8

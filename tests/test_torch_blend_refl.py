"""Path L's reflections over vertex-blended floors in rusterix_tpu_torch
against the JAX package on the CPU: the G-buffer's blend branch
(`gbuffer_pass(has_blend=True)` against the jitted JAX pass on the frame's
pre-pass) and the whole frame of path K's map cut to two rooms with a sun,
GGX and one reflection ray a pixel (one JAX frame, a module fixture).

Tolerances: the G-buffer's world position and texel exactly (its blend
weight and mix rounded as XLA's CPU build rounds them, shade.gbuffer_pass),
the other fields allclose(rtol=1e-6, atol=1e-6); the frame within 1 per
RGBA8 channel but for pinned pixels of a named class.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rusterix_tpu.ops import raster as jraster  # noqa: E402
from rusterix_tpu.ops import shade as jshade  # noqa: E402
from rusterix_tpu_torch.ops.raster import frame_inputs, visibility_prepass  # noqa: E402
from rusterix_tpu_torch.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu_torch.ops.shade import gbuffer_pass  # noqa: E402
from rusterix_tpu_torch.scenes import build_map_blend_refl_scene  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(build, width, height, configure):
    """-> (JAX frame, port frame, the port Rasterizer, packed, scene,
    assets) of one shared PackedScene of the two-room map."""
    rast, scene, assets = build(width, height, device="cpu", rooms_x=2, rooms_y=1)
    packed = PackedScene.from_scene(scene, assets, static_only=True)
    out = rast.rasterize(scene, width, height, 40, assets, packed=packed)
    jr = jraster.Rasterizer.setup(None, rast.view_matrix, rast.projection_matrix)
    configure(jr.ambient(rast.ambient_color), rast)
    jr.use_pallas = True  # the megakernel path, in interpret mode here
    ref = jr.rasterize(scene, width, height, 40, assets, packed=packed)
    return ref.astype(np.int32), out.astype(np.int32), rast, packed, scene, assets


def _refl(jr, rast):
    jr.sun_dir, jr.sun_color, jr.day_factor = rast.sun_dir, rast.sun_color, rast.day_factor
    jr.set_brdf("ggx").set_reflections(1)


@pytest.fixture(scope="module")
def blend_refl_frames():
    return _frames(build_map_blend_refl_scene, 256, 128, _refl)


def test_blended_map_reflection_frame_matches_jax(blend_refl_frames):
    """Path L's settings on the two-room map: the G-buffer's blend branch
    under the reflections.

    Pinned: 13 pixels differ, 11 by more than 1, on two columns where a
    wall is seen edge-on (x 97 and 160): the class of
    tests/test_torch_raster.py's reflection map, GGX samples within an ulp
    of the wall's plane whose cast flips on the last bit of XLA's cos/sin.
    The same 13 pixels differ with the blend taken out of the pack."""
    ref, out, _rast, _packed, _scene, _assets = blend_refl_frames
    diff = np.abs(ref - out).max(axis=-1)
    assert int((diff > 0).sum()) == 13
    assert int((diff > 1).sum()) == 11
    assert set(np.nonzero(diff)[1].tolist()) == {97, 160}


def test_gbuffer_blend_matches_jax(blend_refl_frames):
    """The G-buffer on the reflection frame's pre-pass: the winner's
    blended texel (the weight plane and the mix as XLA rounds them)
    exactly, against the jitted JAX pass."""
    _ref, _out, rast, packed, _scene, _assets = blend_refl_frames
    fa = rast.frame_args
    fi = frame_inputs(**fa)
    z, idx, hit = visibility_prepass(fi, 256, 128)
    g = gbuffer_pass(z, idx, hit, fi["attr"], fi["tri_id"], fa["d3"], fa["atlas"],
                     fa["uniforms"], 256, 128, 0, has_blend=True)
    atlas_np = packed.atlas_index.atlas
    jatlas = {"flat": jnp.asarray(atlas_np.data.reshape(-1, 4)),
              "w": jnp.int32(atlas_np.data.shape[1]), "rects": jnp.asarray(atlas_np.rects),
              "tile_first": jnp.asarray(atlas_np.tile_first),
              "tile_count": jnp.asarray(atlas_np.tile_count)}
    meta = {k: jnp.asarray(v) for k, v in vars(packed.d3).items()}
    u = {k: jnp.asarray(fa["uniforms"][k])
         for k in ("inv_proj", "inv_view", "camera_pos", "anim_frame")}
    ref = jax.jit(lambda *a: jshade.gbuffer_pass(*a, 256, 128, 0, has_blend=True))(
        *(jnp.asarray(t.numpy()) for t in (z, idx, hit, fi["attr"], fi["tri_id"])),
        meta, jatlas, u)
    hm = hit.numpy()
    kind2 = packed.d3.kind2[fi["tri_id"].numpy()[np.clip(idx.numpy(), 0, None)]]
    assert int((hm & (kind2 >= 0)).sum()) > 256 * 128 // 10  # blended winners
    for key in ("world", "texel"):
        np.testing.assert_array_equal(g[key].numpy()[hm], np.asarray(ref[key])[hm])
    for key in ("base", "view_dir", "normal", "roughness", "metallic"):
        np.testing.assert_allclose(g[key].numpy()[hm], np.asarray(ref[key])[hm],
                                   rtol=1e-6, atol=1e-6)

"""Path Q's reflections over per-pixel shader materials in
rusterix_tpu_torch against the JAX package on the CPU: the G-buffer's
material and matmap branches (`gbuffer_pass(has_material=True,
has_matmap=True)` against the jitted JAX pass on the frame's pre-pass, at
bump strength 1.0 and 0.5) and the whole frame of path Q's map cut to two
rooms (walls under emissive stripes with varying roughness and metallic,
floors under a written normal; a sun, GGX and one reflection ray a pixel;
one JAX frame, a module fixture).

Tolerances: the G-buffer's roughness, metallic, emissive and texel exactly
(the sidecar texels); world, base, view direction and normal
allclose(rtol=1e-6, atol=1e-6); the frame exactly.
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
from rusterix_tpu_torch.scenes import build_map_material_scene  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


QW, QH = 128, 64
# the JAX G-buffer with both material branches, compiled once for both bump
# strengths (the strength is an input)
_jax_gbuffer = jax.jit(lambda *a: jshade.gbuffer_pass(*a, QW, QH, 0, has_material=True,
                                                       has_matmap=True))


@pytest.fixture(scope="module")
def material_frames():
    """-> (JAX frame, port frame, the port Rasterizer, packed) of one shared
    PackedScene of the two-room material map."""
    rast, scene, assets = build_map_material_scene(QW, QH, device="cpu", rooms_x=2, rooms_y=1)
    packed = PackedScene.from_scene(scene, assets, static_only=True, device="cpu")
    out = rast.rasterize(scene, QW, QH, 40, assets, packed=packed)
    jr = jraster.Rasterizer.setup(None, rast.view_matrix, rast.projection_matrix)
    jr.ambient(rast.ambient_color)
    jr.sun_dir, jr.sun_color, jr.day_factor = rast.sun_dir, rast.sun_color, rast.day_factor
    jr.set_brdf("ggx").set_reflections(1)
    jr.use_pallas = True  # the megakernel path, in interpret mode here
    ref = jr.rasterize(scene, QW, QH, 40, assets, packed=packed)
    return ref.astype(np.int32), out.astype(np.int32), rast, packed


def test_material_map_reflection_frame_matches_jax(material_frames):
    ref, out, rast, packed = material_frames
    fa = rast.frame_args
    assert fa["has_material"] and fa["has_matmap"] and fa["refl_samples"] == 1
    assert packed.runtime_shaders == () and len(packed.atlas_index.shader_mat_slots) == 2
    np.testing.assert_array_equal(out, ref)
    assert int((out[..., 3] > 0).sum()) > QW * QH // 2


@pytest.mark.parametrize("bump", [1.0, 0.5])
def test_gbuffer_material_matches_jax(material_frames, bump):
    """The G-buffer on the frame's pre-pass: the sidecars' roughness,
    metallic and emissive, and the written normal replacing (bump 1) or
    mixed into (bump 0.5) the geometric one, against the jitted JAX pass."""
    _ref, _out, rast, packed = material_frames
    fa = rast.frame_args
    fi = frame_inputs(**fa)
    z, idx, hit = visibility_prepass(fi, QW, QH)
    uniforms = dict(fa["uniforms"], bump_strength=np.float32(bump))
    g = gbuffer_pass(z, idx, hit, fi["attr"], fi["tri_id"], fa["d3"], fa["atlas"], uniforms,
                     QW, QH, 0, has_material=True, has_matmap=True)
    atlas_np = packed.atlas_index.atlas
    jatlas = {"flat": jnp.asarray(atlas_np.data.reshape(-1, 4)),
              "w": jnp.int32(atlas_np.data.shape[1]), "rects": jnp.asarray(atlas_np.rects),
              "tile_first": jnp.asarray(atlas_np.tile_first),
              "tile_count": jnp.asarray(atlas_np.tile_count)}
    meta = {k: jnp.asarray(v) for k, v in vars(packed.d3).items()}
    u = {k: jnp.asarray(uniforms[k])
         for k in ("inv_proj", "inv_view", "camera_pos", "anim_frame", "bump_strength")}
    ref = _jax_gbuffer(
        *(jnp.asarray(t.numpy()) for t in (z, idx, hit, fi["attr"], fi["tri_id"])),
        meta, jatlas, u)
    hm = hit.numpy()
    nmap = packed.d3.nmap[fi["tri_id"].numpy()[np.clip(idx.numpy(), 0, None)]]
    assert int((hm & (nmap > 0.5)).sum()) > QW * QH // 10  # floors: written normals
    assert int((g["emissive"].numpy()[hm] > 0).any(-1).sum()) > 100
    for key in ("roughness", "metallic", "emissive", "texel"):
        np.testing.assert_array_equal(g[key].numpy()[hm], np.asarray(ref[key])[hm], err_msg=key)
    for key in ("world", "base", "view_dir", "normal"):
        np.testing.assert_allclose(g[key].numpy()[hm], np.asarray(ref[key])[hm],
                                   rtol=1e-6, atol=1e-6, err_msg=key)

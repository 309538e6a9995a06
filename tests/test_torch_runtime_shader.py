"""Runtime rusteria shaders in rusterix_tpu_torch against the JAX package on
the CPU: the split path's pieces (`morton_sort`, `shade_pass` with the
fast and the GGX BRDF, shadow maps, AO, fog and a runtime shader in the
G-buffer) at module level, and whole frames through `Rasterizer.rasterize`
that take the split path (a runtime shader forces it, as the JAX
package's `mega = use_pallas and not shaders`): path T's map cut to two
rooms with a runtime floor shader, a glass pane in the opacity pack with a
runtime shader and a 2D rectangle with a runtime 2D shader, and the map
with U's settings (a sun, GGX, one reflection ray a pixel, shadow maps, AO
and the sky light). The JAX frames run its split path with
`use_pallas = True` (B2 in interpret mode); each scene is one JAX frame, a
module fixture, on the port's PackedScene with the JAX package's compiled
programs in place of the port's.

Tolerances: `morton_sort` exactly (ties by slot index included);
`shade_pass` allclose at rtol 1e-6 / atol 1e-6 on the covered pixels'
RGBA (NaN on the same uncovered pixels) and `wrote` exactly; the frames
within 1 per RGBA8 channel, with the pixels that differ pinned by class:
none differ on these scenes (the classes the split path could show, B2's
z ties under XLA's fused 1/z planes and a last bit of the shader's or the
BRDF's transcendentals, do not occur here).
"""

import dataclasses
from importlib import import_module

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rusterix_tpu as jrt  # noqa: E402
import rusterix_tpu_torch as trt  # noqa: E402
from rusterix_tpu.models.light import pack_lights  # noqa: E402
from rusterix_tpu.ops import raster as jraster  # noqa: E402
from rusterix_tpu.ops import shade as jshade  # noqa: E402
from rusterix_tpu.ops.visibility_pallas import morton_sort as jax_morton_sort  # noqa: E402
from rusterix_tpu.shader import Rusteria as JaxRusteria  # noqa: E402
from rusterix_tpu_torch.models.render_settings import RenderSettings  # noqa: E402
from rusterix_tpu_torch.ops import shade as tshade  # noqa: E402
from rusterix_tpu_torch.ops.raster import (  # noqa: E402
    ambient_occlusion,
    frame_inputs,
    packed_to_torch,
    visibility_prepass,
)
from rusterix_tpu_torch.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu_torch.ops.visibility_pallas import morton_sort  # noqa: E402
from rusterix_tpu_torch.scenes import (  # noqa: E402
    FLOOR_CHECKER,
    build_map_runtime_shader_refl_scene,
    build_map_runtime_shader_scene,
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


def _jax_pack(packed, sources):
    """The port's PackedScene with the JAX package's programs, compiled from
    the same sources (scene order), as its runtime shaders."""
    progs = tuple(None if p is None else JaxRusteria.parse_and_compile(src)
                  for p, src in zip(packed.runtime_shaders, sources))
    return dataclasses.replace(packed, runtime_shaders=progs)


def _jax_rasterizer(rast):
    """A JAX Rasterizer with the port Rasterizer's camera and settings, on
    its split path with B2 in interpret mode."""
    jr = jraster.Rasterizer.setup(rast.projection_matrix_2d, rast.view_matrix,
                                  rast.projection_matrix)
    for k in ("ambient_color", "background_color", "sun_dir", "sun_color", "day_factor",
              "brdf", "reflection_samples", "shadow_settings", "ao_settings",
              "sky_light_enabled", "render_mode"):
        setattr(jr, k, getattr(rast, k))
    jr.use_pallas = True
    return jr


def _assert_close(ref, out, pinned_differing=0):
    """Within 1 per channel; the count of differing pixels as pinned."""
    diff = np.abs(ref.astype(np.int32) - out.astype(np.int32)).max(axis=-1)
    assert int(diff.max()) <= 1
    assert int((diff > 0).sum()) == pinned_differing


# ------------------------------------------------------------ morton_sort


@pytest.mark.parametrize("t2", [300, 5000])
def test_morton_sort_matches_jax_exactly(t2):
    """The permuted planes, boxes, alive flags and slots equal the JAX
    package's, on seeded candidates whose box centres repeat (ties broken
    by slot index) with a fifth dead; 5000 slots coarsen the curve (fewer
    than 20 code bits)."""
    rng = np.random.default_rng(t2)
    w, h = 200, 120
    centres = rng.uniform(-20, 220, (t2 // 4, 2)).astype(np.float32)
    c = centres[rng.integers(0, len(centres), t2)]
    half = rng.uniform(0, 15, (t2, 2)).astype(np.float32)
    bbox = np.concatenate([c - half, c + half], axis=1).astype(np.float32)
    alive = (rng.uniform(size=t2) > 0.2).astype(np.float32)
    vis = rng.normal(size=(t2, 12)).astype(np.float32)
    slots = np.arange(t2, dtype=np.int32)
    want = jax_morton_sort(jnp.asarray(vis), jnp.asarray(bbox), jnp.asarray(alive),
                           jnp.asarray(slots), w, h)
    got = morton_sort(_t(vis), _t(bbox), _t(alive), _t(slots), w, h)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert got[3].dtype == torch.int32
    assert not np.array_equal(got[3].numpy(), slots)


# ------------------------------------------------------------- shade_pass

SW, SH = 96, 48


@pytest.fixture(scope="module")
def gbuffer_inputs():
    """Path U's map cut to two rooms at 96x48 (shadow maps of 16 / 32
    texels), with exp^2 fog: the port's PackedScene and bake, and its split
    path's setup pass, B2 winners (plain version) and AO factor, as numpy
    (the setup pass and the AO factor are bit-equal to the JAX package's,
    tests/test_torch_setup_pass.py and test_torch_ao.py; any winners serve
    as the shared input)."""
    rast, scene, assets = build_map_runtime_shader_refl_scene(SW, SH, device="cpu", rooms_x=2,
                                                              rooms_y=1)
    rast.set_shadows(True, res=16, sun_res=32)
    rast.apply_render_settings(RenderSettings(fog_density=0.05, fog_color=(0.8, 0.4, 0.3)))
    rast.ambient([0.25, 0.25, 0.3, 1.0])
    rast.sun_dir = np.array([0.4, -1.0, 0.25], np.float32)
    rast.day_factor = 1.0
    packed = PackedScene.from_scene(scene, assets, static_only=True, device="cpu")
    rast.rasterize(scene, SW, SH, 40, assets, packed=packed)
    fa = rast.frame_args
    uniforms = {k: np.asarray(v) for k, v in fa["uniforms"].items()}
    fi = frame_inputs(**fa)
    z, idx, hit = visibility_prepass(fi, SW, SH)
    ao = ambient_occlusion((z, idx, hit), uniforms, SH, fa["ao_taps"])
    attr, tri_id = fi["attr"], fi["tri_id"]
    d3 = {k: jnp.asarray(v) for k, v in vars(packed.d3).items()}
    atlas_np = packed.atlas_index.atlas
    lights = pack_lights(scene.all_lights(), packed.lights["valid"].shape[0])
    lights["flicker_factor"] = rast._flicker_factors(lights)
    assert fa["has_fog"] and fa["shadow_spec"] is not None and len(fa["shaders"]) == 1
    assert fi["split"] and fa["ao_taps"]
    return {
        "packed": packed, "uniforms": uniforms, "lights": lights, "fa": fa,
        "g": [a.numpy() for a in (z, idx, hit, attr, tri_id)], "ao": ao.numpy(),
        "jax_d3": d3,
        "jax_atlas": {"flat": jnp.asarray(atlas_np.data.reshape(-1, 4)),
                      "w": jnp.int32(atlas_np.data.shape[1]),
                      **{k: jnp.asarray(getattr(atlas_np, k))
                         for k in ("rects", "tile_first", "tile_count")}},
    }


@pytest.mark.parametrize("brdf_ggx", [False, True], ids=["fast", "ggx"])
def test_shade_pass_matches_jax(gbuffer_inputs, brdf_ggx):
    """shade_pass on the same G-buffer inputs as the jitted JAX shade_pass:
    the runtime floor shader in the G-buffer, the sun and the light rows
    through the BRDF, the shadow maps of the sun and the casting lights,
    the AO factor on the ambient terms and the fog."""
    m = gbuffer_inputs
    fa = m["fa"]
    shadow = (fa["shadow_rows"], fa["shadow_params"], fa["shadow_spec"])
    jprog = (JaxRusteria.parse_and_compile(FLOOR_CHECKER),)
    kw = {"has_fog": True, "brdf_ggx": brdf_ggx}
    spec = fa["shadow_spec"]

    def run(z, idx, hit, attr, tri_id, d3, atlas, lights, uniforms, rows, params, ao):
        return jshade.shade_pass(z, idx, hit, attr, tri_id, d3, atlas, lights, uniforms, SW, SH,
                                 0, shaders=jprog, shadow=(rows, params, spec), ao=ao, **kw)

    ref, ref_wrote = jax.jit(run)(
        *(jnp.asarray(a) for a in m["g"]), m["jax_d3"], m["jax_atlas"],
        {k: jnp.asarray(v) for k, v in m["lights"].items()},
        {k: jnp.asarray(v) for k, v in m["uniforms"].items()},
        jnp.asarray(shadow[0].numpy()), jnp.asarray(shadow[1]), jnp.asarray(m["ao"]))
    pt = packed_to_torch(m["packed"], "cpu")
    out, wrote = tshade.shade_pass(
        *(_t(a) for a in m["g"]), pt["d3"], pt["atlas"], m["lights"], m["uniforms"], SW, SH, 0,
        shaders=fa["shaders"], shadow=shadow, ao=_t(m["ao"]), **kw)
    ref, out = np.asarray(ref), out.numpy()
    np.testing.assert_array_equal(wrote.numpy(), np.asarray(ref_wrote))
    hit = m["g"][2]
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    assert not np.isnan(ref[hit]).any()
    np.testing.assert_allclose(out[hit], ref[hit], rtol=1e-6, atol=1e-6)
    assert int(np.asarray(ref_wrote).sum()) > SW * SH // 3


def test_light_rows_sum_in_xla_order():
    """shade_pass (and d2_pass) add the light rows' terms one after another
    from the first row, skipping rows that are not valid: bit for bit the
    jitted `jnp.sum(..., axis=-2)` over the padded light axis of the JAX
    shade_pass, on seeded terms of mixed sign and magnitude with dead rows
    (exact zeros) among them."""
    rng = np.random.default_rng(10)
    terms = (rng.normal(size=(8, 16, 16, 3)) * 10.0 ** rng.integers(-4, 3, (1, 1, 16, 1))
             ).astype(np.float32)
    dead = [3, 9, 10, 11, 12, 13, 14, 15]
    terms[:, :, dead] = 0.0
    want = np.asarray(jax.jit(lambda x: jnp.sum(x, axis=-2))(jnp.asarray(terms)))
    t = torch.from_numpy(terms)
    acc = None
    for i in range(16):
        if i not in dead:
            acc = t[:, :, i] if acc is None else acc + t[:, :, i]
    np.testing.assert_array_equal(acc.numpy(), want)
    pairwise = (t[:, :, :8].sum(-2) + t[:, :, 8:].sum(-2)).numpy()
    assert not np.array_equal(pairwise, want)  # the order matters on these terms


# ------------------------------------------------------------------ frames

FW, FH = 128, 64


def _frames(build, sources, configure=lambda r: None):
    """One scene rendered by the port and by the JAX package's split path
    from the port's pack -> (JAX frame, port frame, port Rasterizer)."""
    rast, scene, assets = build()
    configure(rast)
    packed = PackedScene.from_scene(scene, assets, static_only=True, device="cpu")
    out = rast.rasterize(scene, FW, FH, 40, assets, packed=packed)
    ref = _jax_rasterizer(rast).rasterize(scene, FW, FH, 40, assets,
                                          packed=_jax_pack(packed, sources))
    return ref, out, rast


GLASS = """
fn shade() {
    color = color * vec3(1.0, fract(hitpoint.y * 2.0 + uv.x), 0.8);
    opacity = opacity * 0.7;
}
"""
RECT = "fn shade() { color = color * vec3(0.5 + 0.5 * fract(hitpoint.x * 0.05), 0.6, 1.0); }"
RECT_BOX = (4, 40, 36, 20)  # x, y, width, height of the 2D rectangle, in pixels


def _t_scene(shaders=True):
    """Path T's map cut to two rooms, with a glass pane in the opacity pack
    under GLASS and a 2D rectangle under RECT (runtime shaders both: GLASS
    reads the colour, opacity and hit point; a 2D batch's shader never
    bakes); `shaders` False drops the three programs."""
    rast, scene, assets = build_map_runtime_shader_scene(FW, FH, device="cpu", rooms_x=2,
                                                         rooms_y=1)
    chunk = import_module("rusterix_tpu_torch.builders.chunk").Chunk()
    chunk.batches3d_opacity = [trt.Batch3D.from_box(6.0, 0.0, 9.0, 3.0, 2.0, 0.05)
                               .set_source(trt.PixelSource.pixel((120, 180, 220, 150)))
                               .set_cull_mode(trt.CullMode.Off).with_computed_normals()
                               .set_shader(1)]
    scene.chunks[(9, 9)] = chunk
    x, y, w, h = RECT_BOX
    scene.d2_static.append(trt.Batch2D.from_rectangle(float(x), float(y), float(w), float(h))
                           .set_source(trt.PixelSource.pixel((200, 120, 60, 255)))
                           .set_shader(2))
    scene.add_shader(GLASS)
    scene.add_shader(RECT)
    if not shaders:
        scene.shaders.clear()
        scene.shaders_with_opacity.clear()
    scene.touch()
    return rast, scene, assets


@pytest.fixture(scope="module")
def t_frames():
    return _frames(_t_scene, [FLOOR_CHECKER, GLASS, RECT])


@pytest.fixture(scope="module")
def u_frames():
    return _frames(
        lambda: build_map_runtime_shader_refl_scene(FW, FH, device="cpu", rooms_x=2, rooms_y=1),
        [FLOOR_CHECKER], lambda r: r.set_shadows(True, res=32, sun_res=64))


def test_split_frame_matches_jax(t_frames):
    """Path T cut to two rooms with a pane and a 2D rectangle: B2's plain
    version over the Morton order, shade_pass with the runtime floor
    shader, compose_opaque, the pane's depth-peeled layer shaded by its
    runtime shader (_shade_opacity) and the rectangle's 2D step by its 2D
    shader (d2_pass)."""
    ref, out, rast = t_frames
    fa = rast.frame_args
    assert len(fa["shaders"]) == 3 and fa["has_opacity"] and fa["has_d2"]
    assert not fa["refl_samples"]
    _assert_close(ref, out, 0)
    assert int((out[..., 3] > 0).sum()) > FW * FH // 2


def test_split_frame_with_reflections_and_sky_light_matches_jax(u_frames):
    """Path U cut to two rooms: the shader's registers in the G-buffers of
    the shading, the reflection rays and the sky-light rays, with shadow
    maps and AO."""
    ref, out, rast = u_frames
    fa = rast.frame_args
    assert fa["refl_samples"] == 1 and fa["sky_light"] and fa["ao_taps"]
    assert fa["shadow_spec"] is not None and fa["brdf_ggx"]
    _assert_close(ref, out, 0)


def test_the_runtime_shaders_change_the_frame(t_frames):
    """Without its shaders the same scene renders through B1 (the floors'
    texel lit as is, the pane and the rectangle unshaded): the floors, the
    pane and the whole rectangle differ."""
    _ref, out, _rast = t_frames
    rast, scene, assets = _t_scene(shaders=False)
    plain = rast.rasterize(scene, FW, FH, 40, assets)
    assert rast.frame_args["shaders"] == ()
    moved = np.abs(plain.astype(int) - out.astype(int)).max(-1) > 2
    x, y, w, h = RECT_BOX
    assert moved[y:y + h, x:x + w].all()
    assert moved.sum() > FW * FH // 10 + w * h

"""rusterix_tpu_torch megakernel vs the JAX package's: the preparation
(Morton order, front-to-back super sort, parameter packs) and the plain
torch version of the kernel against `mega_render(interpret=True)` on
identical numpy inputs. The CUDA kernel's own checks are in
test_torch_cuda.py, which runs without jax.

Tolerances: permutations, integer fields and the packed u32 words exactly;
floats allclose(rtol=1e-6, atol=1e-6) (op order of XLA on the CPU and torch
may differ in the last bit); frames within 1 per RGBA8 channel.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rusterix_tpu import (  # noqa: E402
    Assets,
    Batch3D,
    D3OrbitCamera,
    Light,
    LightType,
    PixelSource,
    Scene,
    Texture,
    Tile,
)
from rusterix_tpu.models.light import pack_lights  # noqa: E402
from rusterix_tpu.ops import megakernel as jm  # noqa: E402
from rusterix_tpu.ops import visibility_pallas as jv  # noqa: E402
from rusterix_tpu.ops.raster import Rasterizer as JaxRasterizer  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu.ops.setup_pass import setup_pass as jax_setup_pass  # noqa: E402
from rusterix_tpu_torch.ops import megakernel as tm  # noqa: E402
from rusterix_tpu_torch.ops import visibility_pallas as tv  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 192, 96  # exercises tile padding (not multiples of 64x128)

LIGHT_SETS = {  # tests/test_shade_pallas.py
    "point": [Light(LightType.Point).with_position([2, 2, 2]).with_intensity(1.2)],
    "mixed": [
        Light(LightType.Point).with_position([2, 2, 2]).with_intensity(1.0),
        Light(LightType.Ambient).with_position([0, 2, 0]).with_intensity(0.3),
        Light(LightType.Spot).with_position([0, 3, 0]).with_intensity(1.5),
        Light(LightType.Area).with_position([-2, 2, 0]).with_intensity(0.8),
        Light(LightType.Daylight).with_position([0, 5, 0]).with_intensity(0.5),
    ],
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _box_inputs(lights="mixed", sun=True, sample_mode=0, fog="off", source="pixel"):
    """The test_shade_pallas box, prepared by the JAX package -> numpy
    mega_render inputs (args, kwargs): prepared once a case for the
    module (the tests share them and change only their copy of kwargs)."""
    args, kwargs = _box_inputs_once(lights, sun, sample_mode, fog, source)
    return list(args), dict(kwargs)


@functools.cache
def _box_inputs_once(lights, sun, sample_mode, fog, source):
    batch = Batch3D.from_box(-0.6, -0.6, -0.6, 1.2, 1.2, 1.2).with_computed_normals()
    assets = Assets.default()
    if source == "pixel":
        batch.set_source(PixelSource.pixel((200, 150, 90, 255)))
    else:
        batch.set_source(PixelSource.static_tile_index(0))
        assets = assets.with_textures([Tile.from_texture(Texture.checkerboard(16, 4))])
    scene = Scene.from_static([], [batch]).set_lights(
        [light.compile() for light in LIGHT_SETS[lights]]
    )
    cam = D3OrbitCamera()
    cam.azimuth = 0.8
    cam.set_parameter_f32("distance", 2.5)
    rast = JaxRasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(W, H))
    rast.ambient((0.5, 0.6, 0.7, 1.0))
    if sun:
        rast.sun_dir = np.array([0.4, -1.0, 0.2], np.float32)
        rast.day_factor = 0.8
    packed = PackedScene.from_scene(scene, assets, static_only=True)
    light_soa = pack_lights(scene.all_lights(), packed.lights["valid"].shape[0])
    light_soa["flicker_factor"] = rast._flicker_factors(light_soa)
    uniforms = rast._uniforms(scene)
    has_fog = fog != "off"
    if fog == "linear":
        uniforms.update(fog_color=np.array([0.2, 0.3, 0.4, 1.0], np.float32),
                        fog_end=np.float32(1.5), fog_fade=np.float32(2.0))
    elif fog == "exp2":
        uniforms.update(fog_color=np.array([0.6, 0.5, 0.4, 1.0], np.float32),
                        fog_mode=np.float32(1.0), fog_density=np.float32(0.15))

    d3 = {k: jnp.asarray(v) for k, v in vars(packed.d3).items()}
    atlas_np = packed.atlas_index.atlas
    atlas = {k: jnp.asarray(getattr(atlas_np, k)) for k in ("rects", "tile_first", "tile_count")}
    vis, attr, bbox, alive, tri_id = jax_setup_pass(
        d3["pos"], d3["uv"], d3["nrm"], d3["valid"], d3["cull"],
        jnp.asarray(uniforms["view"]), jnp.asarray(uniforms["proj"]), W, H,
    )
    table = jm.pack_mega_table(attr, tri_id, d3, atlas, uniforms["anim_frame"], False)
    vis_s, bbox_s, alive_s, table_s, s_near = jm.morton_ftb_sort(
        vis, bbox, alive.astype(jnp.float32), table, W, H
    )
    flat = np.ascontiguousarray(atlas_np.data.reshape(-1, 4)).view(np.uint32).reshape(-1)
    bg = np.broadcast_to(np.array([30, 40, 50, 255], np.float32) / 255.0, (H, W, 4))
    args = [
        vis_s, alive_s, bbox_s, table_s, flat.view(np.int32),
        jm.pack_background_u32(jnp.asarray(bg)),
        jm.pack_mega_params(uniforms, W, H, atlas_np.data.shape[1], has_fog),
        jm.pack_light_params(light_soa),
        jm.pack_occ_params(uniforms),
    ]
    kwargs = dict(sample_mode=sample_mode, light_spec=jm.light_spec_from(light_soa),
                  sun_off=not sun, s_near=np.asarray(s_near))
    return [np.asarray(a) for a in args], kwargs


def _jax_render(args, kwargs):
    ins = [jnp.asarray(a) for a in args]
    ins[4] = jm.atlas_rows_i32(jax.lax.bitcast_convert_type(ins[4], jnp.uint32))
    kw = dict(kwargs, s_near=jnp.asarray(kwargs["s_near"]))
    rgba, z = jm.mega_render(*ins, W, H, interpret=True, **kw)
    return np.asarray(rgba), np.asarray(z)


def _torch_args(args, kwargs, device="cpu"):
    targs = [_t(a).to(device) for a in args]
    return targs, dict(kwargs, s_near=_t(kwargs["s_near"]).to(device))


def _max_channel_diff(rgba_a, rgba_b):
    a = np.ascontiguousarray(rgba_a).view(np.uint8).astype(np.int32)
    b = np.ascontiguousarray(rgba_b).view(np.uint8).astype(np.int32)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("t2", [300, 2048, 8192])
def test_morton_perm_matches(t2):
    """Bit-equal Morton order, dead slots last, including the coarsened
    curve of large slot counts (t2 > 4096)."""
    rng = np.random.default_rng(t2)
    lo = rng.uniform(-50, 400, (t2, 2)).astype(np.float32)
    bbox = np.concatenate([lo, lo + rng.uniform(0, 60, (t2, 2)).astype(np.float32)], axis=1)
    alive = (rng.uniform(size=t2) > 0.2).astype(np.float32)
    ref = np.asarray(jv.morton_perm(jnp.asarray(bbox), jnp.asarray(alive), 320, 240))
    out = tv.morton_perm(_t(bbox), _t(alive), 320, 240).numpy()
    np.testing.assert_array_equal(out, ref)


def test_morton_ftb_sort_matches():
    rng = np.random.default_rng(3)
    t2 = 700  # pads to 768: six supers, some all dead
    planes = rng.normal(size=(t2, 12)).astype(np.float32)
    planes[:, 9:] *= np.float32(0.01)
    lo = rng.uniform(-20, 300, (t2, 2)).astype(np.float32)
    bbox = np.concatenate([lo, lo + rng.uniform(0, 40, (t2, 2)).astype(np.float32)], axis=1)
    alive = (rng.uniform(size=t2) > 0.5).astype(np.float32)
    table = rng.normal(size=(t2, 32)).astype(np.float32)
    ref = jm.morton_ftb_sort(*(jnp.asarray(a) for a in (planes, bbox, alive, table)),
                             W, H, return_perm=True)
    out = tm.morton_ftb_sort(*(_t(a) for a in (planes, bbox, alive, table)),
                             W, H, return_perm=True)
    np.testing.assert_array_equal(out[5].numpy(), np.asarray(ref[5]))  # perm
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))  # alive
    for i in (0, 1, 3, 4):  # planes, bbox, table, s_near
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref[i]), rtol=1e-6, atol=1e-6)


def test_pack_helpers_match():
    batch = Batch3D.from_box(-0.6, -0.6, -0.6, 1.2, 1.2, 1.2)
    scene = Scene.from_static([], [batch.set_source(PixelSource.static_tile_index(0))])
    assets = Assets.default().with_textures([Tile.from_texture(Texture.checkerboard(16, 4))])
    packed = PackedScene.from_scene(scene, assets)
    rng = np.random.default_rng(0)
    n_cand = 2 * packed.d3.pos.shape[0]
    attr = rng.normal(size=(n_cand, 21)).astype(np.float32)
    tri_id = np.repeat(np.arange(n_cand // 2, dtype=np.int32), 2)
    atlas_np = packed.atlas_index.atlas
    atlas = {k: getattr(atlas_np, k) for k in ("rects", "tile_first", "tile_count")}
    meta = vars(packed.d3)
    ref = jm.pack_mega_table(jnp.asarray(attr), jnp.asarray(tri_id),
                             {k: jnp.asarray(v) for k, v in meta.items()},
                             {k: jnp.asarray(v) for k, v in atlas.items()}, 3, False)
    out = tm.pack_mega_table(_t(attr), _t(tri_id), {k: _t(v) for k, v in meta.items()},
                             {k: _t(v) for k, v in atlas.items()}, 3, False)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    lights = pack_lights([light.compile() for light in LIGHT_SETS["mixed"]], 8)
    lights["flicker_factor"] = np.linspace(0.5, 1.0, 8).astype(np.float32)
    np.testing.assert_allclose(tm.pack_light_params(lights, "cpu").numpy(),
                               np.asarray(jm.pack_light_params(lights)), rtol=1e-6, atol=1e-6)
    occ = {"occ_box": np.array([[0, 0, 1, 1], [2, 2, 4, 5]], np.float32),
           "occ_val": np.array([0.5, 0.25], np.float32)}
    for uniforms in (occ, {}):
        np.testing.assert_array_equal(tm.pack_occ_params(uniforms, "cpu").numpy(),
                                      np.asarray(jm.pack_occ_params(uniforms)))
    # params: the packed (80,) rows the box inputs were made with
    rast = JaxRasterizer.setup(None, np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32))
    uniforms = rast._uniforms(scene)
    uniforms.update(fog_mode=np.float32(1.0), fog_density=np.float32(0.2))
    np.testing.assert_array_equal(
        tm.pack_mega_params(uniforms, W, H, 64, "cpu", True).numpy(),
        np.asarray(jm.pack_mega_params(uniforms, W, H, 64, True)),
    )
    bg = rng.uniform(-0.1, 1.1, (H, W, 4)).astype(np.float32)
    bg_ref = np.asarray(jm.pack_background_u32(jnp.asarray(bg)))
    bg_out = tm.pack_background_u32(_t(bg))
    np.testing.assert_array_equal(bg_out.numpy(), bg_ref)
    np.testing.assert_array_equal(tm.unpack_frame_u32(bg_out).numpy(),
                                  np.asarray(jm.unpack_frame_u32(jnp.asarray(bg_ref))))


CASES = [
    # (light set, sun, sample mode, fog, surface)
    ("point", True, 0, "off", "pixel"),
    ("mixed", True, 0, "off", "pixel"),
    ("mixed", False, 1, "linear", "texture"),
    ("point", False, 0, "exp2", "texture"),
    ("mixed", True, 1, "exp2", "texture"),
]


@pytest.mark.parametrize("lights,sun,sample_mode,fog,source", CASES)
def test_reference_matches_jax_interpret(lights, sun, sample_mode, fog, source):
    args, kwargs = _box_inputs(lights, sun, sample_mode, fog, source)
    rgba_ref, z_ref = _jax_render(args, kwargs)
    targs, tkw = _torch_args(args, kwargs)
    rgba, z = tm.mega_render_reference(*targs, W, H, **tkw)
    assert (rgba_ref != np.asarray(args[5])).any(), "the box covers no pixel"
    np.testing.assert_allclose(z.numpy(), z_ref, rtol=1e-6, atol=1e-6)
    assert _max_channel_diff(rgba.numpy(), rgba_ref) <= 1


@pytest.mark.parametrize("lights,sun,sample_mode,fog,source", [CASES[1], CASES[4]])
def test_ggx_reference_matches_jax_interpret(lights, sun, sample_mode, fog, source):
    """B1's brdf_ggx variant (Cook-Torrance, roughness 0.5, metallic 0)."""
    args, kwargs = _box_inputs(lights, sun, sample_mode, fog, source)
    kwargs["brdf_ggx"] = True
    rgba_ref, z_ref = _jax_render(args, kwargs)
    targs, tkw = _torch_args(args, kwargs)
    rgba, z = tm.mega_render_reference(*targs, W, H, **tkw)
    fast, _ = tm.mega_render_reference(*targs, W, H, **dict(tkw, brdf_ggx=False))
    assert not torch.equal(rgba, fast), "the GGX variant changed nothing"
    np.testing.assert_allclose(z.numpy(), z_ref, rtol=1e-6, atol=1e-6)
    assert _max_channel_diff(rgba.numpy(), rgba_ref) <= 1


@pytest.mark.parametrize("lights,sun,sample_mode,fog,source", [CASES[1], CASES[2], CASES[4]])
@pytest.mark.parametrize("stage_cut", [1, 2])
def test_stage_cut_reference_matches_jax_interpret(stage_cut, lights, sun, sample_mode, fog,
                                                   source):
    """The profiling cuts: 1 gives the scan's winning slot per pixel (equal
    to the JAX kernel's) and the winning 1/z; 2 the quantized texel (within
    1 per channel) in tiles with a winner and the background elsewhere. No
    pixel of these boxes is a z tie, so none is pinned."""
    args, kwargs = _box_inputs(lights, sun, sample_mode, fog, source)
    kwargs["stage_cut"] = stage_cut
    out_ref, z_ref = _jax_render(args, kwargs)
    targs, tkw = _torch_args(args, kwargs)
    out, z = tm.mega_render_reference(*targs, W, H, **tkw)
    full, _ = tm.mega_render_reference(*targs, W, H, **dict(tkw, stage_cut=0))
    assert not torch.equal(out, full), "the cut changed nothing"
    np.testing.assert_allclose(z.numpy(), z_ref, rtol=1e-6, atol=1e-6)
    if stage_cut == 1:
        assert (out_ref >= 0).any(), "the box covers no pixel"
        np.testing.assert_array_equal(out.numpy(), out_ref)
    else:
        assert _max_channel_diff(out.numpy(), out_ref) <= 1


def test_stage_cut_on_cpu_tensors_takes_the_plain_version():
    args, kwargs = _box_inputs("point")
    targs, tkw = _torch_args(args, kwargs)
    for cut in (1, 2):
        out = tm.mega_render(*targs, W, H, **dict(tkw, stage_cut=cut))
        ref = tm.mega_render_reference(*targs, W, H, **dict(tkw, stage_cut=cut))
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    with pytest.raises(ValueError, match="stage_cut"):
        tm.mega_render(*targs, W, H, **dict(tkw, stage_cut=5))


def test_cpu_tensors_take_the_plain_version():
    args, kwargs = _box_inputs("point")
    targs, tkw = _torch_args(args, kwargs)
    before = tm.launches
    rgba, z = tm.mega_render(*targs, W, H, **tkw)
    ref = tm.mega_render_reference(*targs, W, H, **tkw)
    assert tm.launches == before
    assert torch.equal(rgba, ref[0]) and torch.equal(z, ref[1])


def test_has_blend_on_cpu_tensors_takes_the_plain_version():
    """B1's has_blend variant (ported; held against the JAX kernel in
    tests/test_torch_blend.py) on the box with a blend extension whose
    weight plane is the 1/w plane (weight 1) toward a pixel colour: CPU
    tensors take the plain version, and every covered pixel takes the
    second source's colour before the lighting."""
    args, kwargs = _box_inputs("point")
    targs, tkw = _torch_args(args, kwargs)
    table = targs[3]
    n = table.shape[0]
    ext = torch.cat([table[:, 0:3], torch.full((n, 1), 2.0),  # kind2: a pixel colour
                     torch.tensor([[0.1, 0.8, 0.3, 1.0]]).expand(n, 4),
                     torch.zeros((n, 8))], dim=1)
    targs[3] = torch.cat([table, ext], dim=1)
    before = tm.launches
    rgba, z = tm.mega_render(*targs, W, H, **dict(tkw, has_blend=True))
    ref = tm.mega_render_reference(*targs, W, H, **dict(tkw, has_blend=True))
    plain = tm.mega_render_reference(*targs, W, H, **tkw)
    assert tm.launches == before
    assert torch.equal(rgba, ref[0]) and torch.equal(z, ref[1]) and torch.equal(z, plain[1])
    texel = tm.mega_render_reference(*targs, W, H, **dict(tkw, has_blend=True, stage_cut=2))[0]
    covered = (z < 1.0).numpy()
    px = texel.numpy().view(np.uint8).reshape(H, W, 4)[covered]
    assert covered.sum() > 1000 and (px == np.array([26, 204, 77, 255], np.uint8)).all()
    assert int((rgba != plain[0]).sum()) > 1000


@pytest.mark.parametrize(
    "variant", ["has_matmap", "shadow_rows", "ao_img"],
)
def test_mega_render_refuses_unported_variants(variant):
    """What mega_render refuses of the ported variants: has_matmap without
    has_material (the table's fixed column layout), an `ao_img` that is
    not (H, W) f32 and `shadow_rows` without its spec are ValueErrors.
    Shadow maps with their transmittance layers, the scenevm tonemap
    (tests/test_torch_glass.py), has_blend (tests/test_torch_blend.py) and
    has_material (tests/test_torch_material.py) are ported."""
    args, kwargs = _box_inputs("point")
    targs, tkw = _torch_args(args, kwargs)
    tkw[variant] = torch.ones(1) if variant in ("shadow_rows", "ao_img") else True
    with pytest.raises(ValueError, match=variant):
        tm.mega_render(*targs, W, H, **tkw)


def test_has_material_on_cpu_tensors_takes_the_plain_version():
    """B1's has_material variant (ported; held against the JAX kernel in
    tests/test_torch_material.py) on the box with a material extension of
    roughness 0.2 and metallic 1: CPU tensors take the plain version, and
    the metal's F0 and sharper highlight change the lit pixels."""
    args, kwargs = _box_inputs("point")
    targs, tkw = _torch_args(args, kwargs)
    table = targs[3]
    n = table.shape[0]
    targs[3] = torch.cat([table, torch.tensor([[0.2, 1.0, 0.0, 0.0]]).expand(n, 4)], dim=1)
    before = tm.launches
    rgba, z = tm.mega_render(*targs, W, H, **dict(tkw, has_material=True))
    ref = tm.mega_render_reference(*targs, W, H, **dict(tkw, has_material=True))
    plain = tm.mega_render_reference(*targs, W, H, **tkw)
    assert tm.launches == before
    assert torch.equal(rgba, ref[0]) and torch.equal(z, ref[1]) and torch.equal(z, plain[1])
    covered = int((z < 1.0).sum())
    assert covered > 1000 and int((rgba != plain[0]).sum()) > covered // 2


@pytest.mark.parametrize("stage_cut", [3, 4])
def test_mega_render_refuses_tpu_only_stage_cuts(stage_cut):
    """Cuts 3 and 4 sit inside TPU mechanisms the CUDA kernel lacks."""
    args, kwargs = _box_inputs("point")
    targs, tkw = _torch_args(args, kwargs)
    with pytest.raises(NotImplementedError, match=f"stage_cut={stage_cut}"):
        tm.mega_render(*targs, W, H, **dict(tkw, stage_cut=stage_cut))


def test_nonzero_row_offset_is_refused():
    """A row offset is no longer refused (the row-sharded frame's slabs):
    pack_mega_params(y0=) writes it at params[58] as the JAX package's
    does. B1 at a row offset is held against the JAX kernel in
    tests/test_torch_sharded_kernels.py."""
    rast = JaxRasterizer.setup(None, np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32))
    uniforms = rast._uniforms(Scene.from_static([], []))
    out = tm.pack_mega_params(uniforms, W, H, 64, "cpu", y0=64).numpy()
    ref = np.asarray(jm.pack_mega_params(uniforms, W, H, 64, y0=64))
    assert out[58] == 64.0
    np.testing.assert_array_equal(out, ref)

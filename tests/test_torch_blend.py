"""Vertex-blended floors in rusterix_tpu_torch against the JAX package on
the CPU: B1's `has_blend` variant (the plain version of the kernel) and
the whole frame of path K's map cut to two rooms (the blended floors, the
map's lights). Path L's reflections over them and the G-buffer's blend
branch are in tests/test_torch_blend_refl.py.

- Kernel level: `mega_render_reference(has_blend=True)` against the JAX
  megakernel in interpret mode on identical inputs prepared by the JAX
  package: tests/test_blend_render.py's quad (a red base, a green second
  source, a vertical weight gradient) beside the same quad with a textured
  second source, sampled bilinearly.
- Frame (one JAX frame, a module fixture): the two-room map.

Tolerances: B1's RGBA8 and z_eff exactly (on other inputs the JAX kernel in
interpret mode can differ in the last bit of z_eff where it evaluates the
1/z plane with XLA's CPU FMAs, tests/test_torch_megakernel.py; not on these);
the frame exactly.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rusterix_tpu import (  # noqa: E402
    Assets,
    Batch3D,
    D3OrbitCamera,
    PixelSource,
    Scene,
    Texture,
    Tile,
)
from rusterix_tpu.models.light import pack_lights  # noqa: E402
from rusterix_tpu.ops import megakernel as jm  # noqa: E402
from rusterix_tpu.ops import raster as jraster  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene as JaxPackedScene  # noqa: E402
from rusterix_tpu.ops.setup_pass import setup_pass as jax_setup_pass  # noqa: E402
from rusterix_tpu_torch.models import VertexBlendPreset  # noqa: E402
from rusterix_tpu_torch.ops import megakernel as tm  # noqa: E402
from rusterix_tpu_torch.ops.raster import frame_inputs  # noqa: E402
from rusterix_tpu_torch.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu_torch.scenes import (  # noqa: E402
    _map_assets,
    blend_map,
    build_map_blend_scene,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


QW, QH = 128, 96


def _quad(x0, second):
    """tests/test_blend_render.py's quad, one unit wide from x0, with a weight
    gradient (0 at the bottom edge, 1 at the top) toward `second`."""
    verts = np.array([[x0, -1, 0, 1], [x0 + 1, -1, 0, 1], [x0 + 1, 1, 0, 1], [x0, 1, 0, 1]],
                     np.float32)
    uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    b = Batch3D.new(verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32), uvs)
    b.source = PixelSource.pixel((255, 0, 0, 255))
    b.source2 = second
    b.blend_weights = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    return b


def _quad_inputs():
    """Two blended quads, the second source a green pixel colour and a
    checkerboard tile, prepared by the JAX package -> numpy mega_render
    inputs (args, kwargs) with the blend extension, bilinear sampling."""
    scene = Scene.from_static([], [_quad(-1.1, PixelSource.pixel((0, 255, 0, 255))),
                                   _quad(0.1, PixelSource.static_tile_index(0))])
    assets = Assets.default().with_textures([Tile.from_texture(Texture.checkerboard(16, 4))])
    cam = D3OrbitCamera()
    cam.azimuth = 0.7
    cam.set_parameter_f32("distance", 2.5)
    rast = jraster.Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(QW, QH))
    rast.ambient((1.0, 1.0, 1.0, 1.0))
    packed = JaxPackedScene.from_scene(scene, assets, static_only=True)
    assert (packed.d3.kind2 >= 0).any()
    lights = pack_lights(scene.all_lights(), packed.lights["valid"].shape[0])
    lights["flicker_factor"] = rast._flicker_factors(lights)
    uniforms = rast._uniforms(scene)
    d3 = {k: jnp.asarray(v) for k, v in vars(packed.d3).items()}
    atlas_np = packed.atlas_index.atlas
    atlas = {k: jnp.asarray(getattr(atlas_np, k)) for k in ("rects", "tile_first", "tile_count")}
    vis, attr, bbox, alive, tri_id = jax_setup_pass(
        d3["pos"], d3["uv"], d3["nrm"], d3["valid"], d3["cull"],
        jnp.asarray(uniforms["view"]), jnp.asarray(uniforms["proj"]), QW, QH, bw=d3["bw"])
    table = jm.pack_mega_table(attr, tri_id, d3, atlas, uniforms["anim_frame"], True)
    vis_s, bbox_s, alive_s, table_s, s_near = jm.morton_ftb_sort(
        vis, bbox, alive.astype(jnp.float32), table, QW, QH)
    flat = np.ascontiguousarray(atlas_np.data.reshape(-1, 4)).view(np.uint32).reshape(-1)
    bg = np.broadcast_to(np.array([30, 40, 50, 255], np.float32) / 255.0, (QH, QW, 4))
    args = [vis_s, alive_s, bbox_s, table_s, flat.view(np.int32),
            jm.pack_background_u32(jnp.asarray(bg)),
            jm.pack_mega_params(uniforms, QW, QH, atlas_np.data.shape[1]),
            jm.pack_light_params(lights), jm.pack_occ_params(uniforms)]
    kwargs = dict(sample_mode=1, light_spec=jm.light_spec_from(lights), sun_off=True,
                  s_near=np.asarray(s_near), has_blend=True)
    return [np.array(a) for a in args], kwargs


def test_blend_kernel_plain_version_matches_jax_interpret():
    """B1's blend branch: the second texel (a pixel colour; a texture,
    bilinear), the clipped weight plane over 1/w and the mix; RGBA8 and
    z_eff equal."""
    args, kwargs = _quad_inputs()
    assert args[3].shape[1] == 48
    ins = [jnp.asarray(a) for a in args]
    ins[4] = jm.atlas_rows_i32(jax.lax.bitcast_convert_type(ins[4], jnp.uint32))
    rgba, z = jm.mega_render(*ins, QW, QH, interpret=True,
                             **dict(kwargs, s_near=jnp.asarray(kwargs["s_near"])))
    targs = [torch.from_numpy(a) for a in args]
    tkw = dict(kwargs, s_near=torch.from_numpy(kwargs["s_near"]))
    out, out_z = tm.mega_render_reference(*targs, QW, QH, **tkw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(rgba))
    np.testing.assert_array_equal(out_z.numpy(), np.asarray(z))
    # the branch does something on both quads: without it they keep the
    # base texel
    plain, _ = tm.mega_render_reference(*targs, QW, QH, **dict(tkw, has_blend=False))
    px = out.numpy().view(np.uint8).reshape(QH, QW, 4)[..., :3].astype(int)
    base = plain.numpy().view(np.uint8).reshape(QH, QW, 4)[..., :3].astype(int)
    changed = np.abs(px - base).max(-1) > 30
    covered = out_z.numpy() < 1.0
    for half in (slice(0, QW // 2), slice(QW // 2, QW)):
        assert covered[:, half].sum() > 400
        assert changed[:, half].sum() > 0.9 * covered[:, half].sum()


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


@pytest.fixture(scope="module")
def blend_frames():
    return _frames(build_map_blend_scene, 256, 128, lambda jr, rast: None)


def test_blended_map_is_built_as_path_k_says():
    """Every room's floor is a sector surface of blended cells cycling
    through the 18 non-Solid presets; the sector's own floor is not emitted
    under it (no coplanar duplicate); the closed doorways build no wall."""
    assets = _map_assets(blended=True)
    m = blend_map(assets, 2, 1)
    assert len(m.sectors) == 2 and len(m.surfaces) == 2
    for sector in m.sectors:
        assert sector.properties.get_source("source") is None
        assert sector.properties.get_source("cap_source") is not None
        cells = sector.properties.get("blend_tiles").data
        assert len(cells) == 100
        assert {p for p, _s in cells.values()} == set(VertexBlendPreset) - {
            VertexBlendPreset.Solid}
    zero = [ld for ld in m.linedefs if ld.properties.get_float_default("wall_height", 0) == 0]
    assert len(zero) == 8  # the two rooms' doorways


def test_blended_map_frame_matches_jax(blend_frames):
    """Path K's map at two rooms, 256x128: B1's has_blend variant on the
    blended floors, equal to the JAX megakernel frame pixel for pixel."""
    ref, out, rast, packed, scene, assets = blend_frames
    fa = rast.frame_args
    fi = frame_inputs(**fa)
    assert fa["has_blend"] and fi["mega_kwargs"]["has_blend"]
    assert fi["mega_args"][3].shape[1] == 48
    np.testing.assert_array_equal(out, ref)
    # the blend reaches the floors: without it a fifth of the frame changes
    unblended = copy.deepcopy(packed)
    unblended.d3.kind2[:] = -1
    plain = rast.rasterize(scene, 256, 128, 40, assets, packed=unblended).astype(np.int32)
    assert int((np.abs(plain - out).max(-1) > 8).sum()) > 256 * 128 // 5

"""B1's and B2's new forms in rusterix_tpu_torch on the CPU: the row offset
of a slab of a row-sharded frame (params[58], the near bound clipped to
the slab's rows) and B1's generic light loop (light_spec None).

On a box under five lights of every type and the sun at 192x96, the slab
of rows [40, 77) (not a multiple of the 64-row tile):
- B1's plain version at the row offset against the JAX kernel in
  interpret mode with the same offset and light loop, and against the same
  rows of the whole frame; the generic loop against the specialised loop;
- the scan alone (stage_cut 1) against the whole frame's winners;
- B2 at the row offset against the same rows of the whole frame;
- morton_ftb_sort's near bound clipped to the slab against the JAX
  package's;
- B1 refuses only stage_cut 3 and 4.

Tolerances: against the JAX kernel in interpret mode within 1 per RGBA8
channel and z_eff within 1e-6 (it evaluates the 1/z plane with XLA's CPU
FMAs, tests/test_torch_megakernel.py); against the port's own outputs and
the JAX sort exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rusterix_tpu.ops import megakernel as jm  # noqa: E402
from rusterix_tpu_torch import Rasterizer  # noqa: E402
from rusterix_tpu_torch.models import (  # noqa: E402
    Assets,
    Batch3D,
    CullMode,
    D3OrbitCamera,
    Light,
    LightType,
    PixelSource,
    Scene,
    Texture,
    Tile,
)
from rusterix_tpu_torch.ops import megakernel as tm  # noqa: E402
from rusterix_tpu_torch.ops import visibility_pallas as tv  # noqa: E402
from rusterix_tpu_torch.ops.raster import frame_inputs  # noqa: E402
from rusterix_tpu_torch.ops.scene_pack import PackedScene  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 192, 96
Y0, ROWS = 40, 37  # a slab of rows [40, 77): not a multiple of the 64-row tile


@pytest.fixture(scope="module")
def box():
    """A textured box under five lights of every type and the sun, rendered
    by the port -> its render_frame arguments."""
    scene = Scene.from_static([], [
        Batch3D.from_box(-0.5, -0.5, -0.5, 1.0, 1.0, 1.0).set_cull_mode(CullMode.Off)
        .set_source(PixelSource.static_tile_index(0)).with_computed_normals()])
    assets = Assets.default().with_textures([Tile.from_texture(Texture.checkerboard(32, 8))])
    camera = D3OrbitCamera()
    camera.set_parameter_f32("distance", 1.6)
    rast = Rasterizer.setup(None, camera.view_matrix(), camera.projection_matrix(W, H),
                            device="cpu").ambient([0.15, 0.15, 0.2, 1.0])
    scene.set_lights([
        Light(LightType.Point).with_position([2, 2, 2]).with_intensity(1.0).compile(),
        Light(LightType.Ambient).with_position([0, 2, 0]).with_intensity(0.3).compile(),
        Light(LightType.Spot).with_position([0, 3, 0]).with_intensity(1.5).compile(),
        Light(LightType.Area).with_position([-2, 2, 0]).with_intensity(0.8).compile(),
        Light(LightType.Daylight).with_position([0, 5, 0]).with_intensity(0.5).compile(),
    ])
    rast.sun_dir = np.array([0.4, -1.0, 0.2], np.float32)
    rast.day_factor = 0.8
    rast.background((30, 40, 50, 255))
    rast.rasterize(scene, W, H, 40, assets, packed=PackedScene.from_scene(
        scene, assets, static_only=True))
    return rast.frame_args


def _slab_inputs(fa, y0, rows):
    """B1's inputs for the slab of rows [y0, y0 + rows) of the frame ->
    (the whole frame's frame_inputs, args, kwargs, the slab's sort
    permutation)."""
    fi = frame_inputs(**fa)
    d3, unif = fa["d3"], fa["uniforms"]
    from rusterix_tpu_torch.ops.setup_pass import setup_pass

    vis, attr, bbox, alive, tri_id = setup_pass(
        d3["pos"], d3["uv"], d3["nrm"], d3["valid"], d3["cull"],
        torch.from_numpy(unif["view"]), torch.from_numpy(unif["proj"]), W, H)
    table = tm.pack_mega_table(attr, tri_id, d3, fa["atlas"], int(unif["anim_frame"]), False)
    vis_s, bbox_s, alive_s, table_s, s_near, perm = tm.morton_ftb_sort(
        vis, bbox, alive.float(), table, W, H, y0g=y0, rows_local=rows, return_perm=True)
    args = [vis_s, alive_s, bbox_s, table_s, fa["atlas"]["flat_u32"],
            tm.pack_background_u32(fa["background"][y0:y0 + rows]),
            tm.pack_mega_params(unif, W, H, fa["atlas"]["w"], "cpu", y0=y0),
            fi["mega_args"][7], fi["mega_args"][8]]
    kwargs = dict(fi["mega_kwargs"], s_near=s_near)
    return fi, args, kwargs, perm


def _jax_slab(args, kwargs, rows, light_spec):
    ins = [jnp.asarray(a.numpy()) for a in args]
    ins[4] = jm.atlas_rows_i32(jax.lax.bitcast_convert_type(ins[4], jnp.uint32))
    rgba, z = jm.mega_render(*ins, W, rows, interpret=True, full_height=H,
                             light_spec=light_spec, sun_off=kwargs["sun_off"],
                             s_near=jnp.asarray(kwargs["s_near"].numpy()))
    return np.asarray(rgba), np.asarray(z)


def _channels(rgba):
    return rgba.numpy().view(np.uint8).reshape(*rgba.shape, 4).astype(int)


@pytest.mark.parametrize("light_spec", ["specialised", "generic"])
def test_b1_row_offset_and_generic_loop_match_jax(box, light_spec):
    """B1's plain version on the slab [40, 77): against the JAX kernel in
    interpret mode with the same row offset (params[58]) and light loop;
    against the same rows of the whole frame; generic against specialised
    bit for bit."""
    fi, args, kwargs, _perm = _slab_inputs(box, Y0, ROWS)
    spec = kwargs["light_spec"] if light_spec == "specialised" else None
    rgba, z = tm.mega_render(*args, W, ROWS, **dict(kwargs, light_spec=spec))
    ref_rgba, ref_z = _jax_slab(args, kwargs, ROWS, spec)
    assert np.abs(_channels(rgba) - ref_rgba.view(np.uint8).reshape(ROWS, W, 4)).max() <= 1
    np.testing.assert_allclose(z.numpy(), ref_z, rtol=1e-6, atol=1e-6)
    whole_rgba, whole_z = tm.mega_render(*fi["mega_args"], **fi["mega_kwargs"])
    assert torch.equal(rgba, whole_rgba[Y0:Y0 + ROWS]) and torch.equal(z, whole_z[Y0:Y0 + ROWS])
    covered = int((z < 1.0).sum())
    assert covered > ROWS * W // 8
    if spec is None:
        spec_rgba, spec_z = tm.mega_render(*args, W, ROWS, **kwargs)
        assert torch.equal(rgba, spec_rgba) and torch.equal(z, spec_z)


def test_b1_row_offset_scan_matches_the_whole_frame(box):
    """The scan alone at the row offset (stage_cut 1): each pixel's
    winning candidate (its setup-pass slot through the slab's and the
    frame's own sort permutations) and 1/z are the whole frame's."""
    fi, args, kwargs, perm = _slab_inputs(box, Y0, ROWS)
    slot, best = tm.mega_render(*args, W, ROWS, **dict(kwargs, stage_cut=1))
    w_slot, w_best = tm.mega_render(*fi["mega_args"], **dict(fi["mega_kwargs"], stage_cut=1))
    slab_tri = torch.where(slot >= 0, perm[slot.clamp(min=0).long()], -1)
    whole_tri = torch.where(w_slot >= 0, fi["sort_perm"][w_slot.clamp(min=0).long()], -1)
    assert torch.equal(best, w_best[Y0:Y0 + ROWS])
    assert torch.equal(slab_tri, whole_tri[Y0:Y0 + ROWS])
    assert int((slot >= 0).sum()) > ROWS * W // 8


def test_b2_row_offset_matches_the_whole_frame(box):
    """B2 on the slab: z, idx (mapped to the setup pass's slots) and hit
    equal the whole frame's pre-pass on the same rows."""
    fi = frame_inputs(**box)
    from rusterix_tpu_torch.ops.raster import visibility_prepass

    whole = visibility_prepass(fi, W, H)
    slab = visibility_prepass(fi, W, ROWS, Y0)
    for a, b in zip(slab, whole):
        assert torch.equal(a, b[Y0:Y0 + ROWS])
    assert int(slab[2].sum()) > ROWS * W // 8
    assert tv.scan_work(fi["vis_s"], fi["alive_s"], fi["bbox_s"], W, ROWS, Y0) > 0


def test_near_bound_clips_to_the_slab(box):
    """morton_ftb_sort(y0g, rows_local) orders the supers by the near bound
    over the slab's rows, as the JAX package's does."""
    fa = box
    d3, unif = fa["d3"], fa["uniforms"]
    from rusterix_tpu.ops.setup_pass import setup_pass as jax_setup
    from rusterix_tpu_torch.ops.setup_pass import setup_pass

    tin = [d3[k] for k in ("pos", "uv", "nrm", "valid", "cull")]
    vis, attr, bbox, alive, tri_id = setup_pass(*tin, torch.from_numpy(unif["view"]),
                                                torch.from_numpy(unif["proj"]), W, H)
    jvis, _jattr, jbbox, jalive, _ = jax_setup(*[jnp.asarray(t.numpy()) for t in tin],
                                               jnp.asarray(unif["view"]),
                                               jnp.asarray(unif["proj"]), W, H)
    table = torch.zeros((vis.shape[0], 4))
    out = tm.morton_ftb_sort(vis, bbox, alive.float(), table, W, H, y0g=Y0, rows_local=ROWS)
    ref = jm.morton_ftb_sort(jvis, jbbox, jalive.astype(jnp.float32),
                             jnp.zeros((vis.shape[0], 4)), W, H, y0g=float(Y0),
                             rows_local=ROWS)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))


def test_b1_refuses_only_the_tpu_stage_cuts(box):
    """Every variant of the JAX kernel is ported but stage_cut 3 and 4."""
    _fi, args, kwargs, _perm = _slab_inputs(box, Y0, ROWS)
    for cut in (3, 4):
        with pytest.raises(NotImplementedError, match=f"stage_cut={cut}"):
            tm.mega_render(*args, W, ROWS, **dict(kwargs, light_spec=None, stage_cut=cut))

"""Glass, sky and the SceneVM tonemap in rusterix_tpu_torch against the JAX
package on the CPU: a small glazed room (a floor, a wall and two
translucent panes in the opacity pack; a point light and a spot light
that cast cube maps, the render graph's sky and fog at hour 14 with its
sun map, shadow maps with transmittance layers, two depth-peeled
transparency layers, the scenevm tonemap).

- Module level: the opacity layers' visibility (the plain pass in XLA's
  plane rounding, with the 1/z ceiling) and `_shade_opacity`; B1's plain
  version with the transmittance and tonemap variants against the JAX
  megakernel in interpret mode on the room's own inputs.
- Frame level (two JAX frames, the megakernel path in interpret mode): the
  room, and the room with one GGX reflection sample a pixel (reflections
  on the opaque frame and on both layers).

Tolerances: the layers and their shading exactly; B1's RGBA8 exactly (the
tonemap's exp and log agree on these inputs) and its z_eff within 1e-6
with the pixels that differ pinned (1: the JAX kernel in interpret mode
evaluates the 1/z plane with XLA's CPU FMAs, tests/test_torch_megakernel.py);
the frames within 1 per RGBA8 channel except pinned pixels of two named
classes: sky pixels (z_eff 1) whose colour rounds across a byte on the last
bit of XLA's sky expressions (XLA fuses them into FMAs by context; the port
fuses the ones that decide the cloud texel, tests/test_torch_composite.py),
and with reflections, pixels the reflections change, where a reflection
sample rounds across a decision (the class of tests/test_torch_raster.py's
reflection map: grazing samples whose cast or hit flips on the last bit of
XLA's cos/sin).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rusterix_tpu import (  # noqa: E402
    Assets,
    Batch3D,
    CullMode,
    Light,
    LightType,
    PixelSource,
    Scene,
)
from rusterix_tpu.builders.chunk import Chunk  # noqa: E402
from rusterix_tpu.ops import megakernel as jm  # noqa: E402
from rusterix_tpu.ops import raster as jraster  # noqa: E402
from rusterix_tpu.ops.matrices import look_at_rh, perspective_fov_rh_zo  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu.ops.setup_pass import setup_pass as jax_setup_pass  # noqa: E402
from rusterix_tpu.ops.visibility import visibility_pass as jax_visibility_pass  # noqa: E402
from rusterix_tpu.shapefx.graph import ShapeFXGraph as JaxGraph  # noqa: E402
from rusterix_tpu_torch import Rasterizer  # noqa: E402
from rusterix_tpu_torch.ops import megakernel as tm  # noqa: E402
from rusterix_tpu_torch.ops import raster as traster  # noqa: E402
from rusterix_tpu_torch.ops.raster import frame_inputs, packed_to_torch  # noqa: E402
from rusterix_tpu_torch.ops.setup_pass import setup_pass  # noqa: E402
from rusterix_tpu_torch.ops.visibility import visibility_pass  # noqa: E402
from rusterix_tpu_torch.shapefx.graph import ShapeFXGraph as PortGraph  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 128, 96


def _box(x, y, z, w, h, d, rgba):
    return (Batch3D.from_box(x, y, z, w, h, d).set_source(PixelSource.pixel(rgba))
            .set_cull_mode(CullMode.Off).with_computed_normals())


def _room():
    """-> (scene, assets, packed): the glazed room. The panes stand between
    the casting lights and the floor, one behind the other from the camera
    (two layers)."""
    floor = _box(-5.0, -0.1, -5.0, 10.0, 0.1, 10.0, (200, 200, 200, 255))
    wall = _box(2.0, 0.0, -2.0, 0.2, 2.0, 4.0, (150, 100, 80, 255))
    pane_a = _box(-1.0, 0.0, -1.5, 0.05, 1.6, 3.0, (120, 180, 220, 110))
    pane_b = _box(-2.0, 0.0, -1.0, 0.05, 1.2, 2.0, (220, 120, 120, 150))
    point = (Light(LightType.Point).with_position([0.0, 1.2, 0.0]).with_intensity(1.5)
             .with_color([1.0, 1.0, 1.0]).with_range(0.5, 30.0))
    spot = (Light(LightType.Spot).with_position([-3.5, 1.5, 0.3]).with_intensity(1.8)
            .with_color([1.0, 0.9, 0.8]).with_range(0.5, 20.0))
    spot.direction = np.array([1.0, -0.6, 0.0], np.float32)
    scene = Scene.from_static([], [floor, wall]).set_lights([point.compile(), spot.compile()])
    chunk = Chunk()
    chunk.batches3d_opacity = [pane_a, pane_b]
    scene.chunks[(0, 0)] = chunk
    assets = Assets.default()
    return scene, assets, PackedScene.from_scene(scene, assets, static_only=True)


VIEW = look_at_rh(np.array([-6.0, 3.0, 6.0], np.float32), np.array([0.5, 0.8, 0.0], np.float32),
                  np.array([0.0, 1.0, 0.0], np.float32))
PROJ = perspective_fov_rh_zo(1.1, float(W), float(H), 0.1, 100.0)


def _configure(rast, graph, reflections=False):
    rast.background((10, 10, 10, 255)).ambient([0.12, 0.12, 0.12, 1.0])
    rast.render_graph = graph.default_render_graph(with_sky=True, with_fog=True)
    rast.hour = 14.0
    rast.set_shadows(True)
    rast.transparency_layers = 2
    rast.set_tonemap("scenevm")
    if reflections:
        rast.set_brdf("ggx").set_reflections(1)
    return rast


def _port_rast(reflections=False):
    return _configure(Rasterizer.setup(None, VIEW, PROJ, device="cpu"), PortGraph, reflections)


def _jax_frame(scene, assets, packed, reflections=False):
    rast = _configure(jraster.Rasterizer.setup(None, VIEW, PROJ), JaxGraph, reflections)
    rast.use_pallas = True  # the megakernel path, in interpret mode here
    return rast.rasterize(scene, W, H, 32, assets, packed=packed).astype(np.int32)


@pytest.fixture(scope="module")
def room():
    return _room()


@pytest.fixture(scope="module")
def port_room(room):
    """The port's room frame and its render_frame arguments."""
    scene, assets, packed = room
    rast = _port_rast()
    frame = rast.rasterize(scene, W, H, 32, assets, packed=packed).astype(np.int32)
    return frame, rast.frame_args


def test_room_exercises_every_new_part(room, port_room):
    """The bake has transmittance layers for the sun and both casting lights
    (the spot light among them), the sky paints the background, both
    transparency layers hold glass, and each part changes the frame."""
    scene, assets, packed = room
    frame, fa = port_room
    sun_entry, cubes = fa["shadow_spec"]
    assert sun_entry[2] >= 0 and sun_entry[3] == 4
    assert [c[0] for c in cubes] == [0, 1] and all(c[3] >= 0 and c[4] == 4 for c in cubes)
    assert fa["has_sky"] and fa["tonemap"] and fa["has_opacity"]
    layers = traster.opacity_layers(fa["d3_op"], fa["atlas"], fa["uniforms"], W, H, 0, 2)
    assert all(int((zo < 1.0).sum()) > 50 for _c, zo in layers)

    def changed(mutate):
        rast = mutate(_port_rast())
        other = rast.rasterize(scene, W, H, 32, assets, packed=packed).astype(np.int32)
        return int((np.abs(other - frame).max(-1) > 1).sum())

    def no_trans(r):
        r._rs_shadow_steps = 0.0
        return r

    assert changed(no_trans) > 20
    assert changed(lambda r: r.set_tonemap("srgb")) > W * H // 4
    assert changed(lambda r: setattr(r, "transparency_layers", 1) or r) > 20
    assert changed(lambda r: setattr(r, "render_graph", None) or r) > W * H // 4


def test_layer_visibility_and_opacity_shading_match_jax(room, port_room):
    """Two peeled layers of the opacity pack: the XLA visibility pass with
    its 1/z ceiling and `_shade_opacity`, on the JAX side, against the
    port's plain pass (`plane_fma`) and its `_shade_opacity`."""
    scene, assets, packed = room
    _frame, fa = port_room
    u = fa["uniforms"]
    op = {k: jnp.asarray(v) for k, v in vars(packed.d3_opacity).items()}
    vis, attr, _bb, alive, tri = jax_setup_pass(
        op["pos"], op["uv"], op["nrm"], op["valid"], op["cull"], jnp.asarray(u["view"]),
        jnp.asarray(u["proj"]), W, H)
    atlas_np = packed.atlas_index.atlas
    jatlas = {"flat": jnp.asarray(atlas_np.data.reshape(-1, 4)), "w": jnp.int32(
        atlas_np.data.shape[1]), "rects": jnp.asarray(atlas_np.rects),
        "tile_first": jnp.asarray(atlas_np.tile_first),
        "tile_count": jnp.asarray(atlas_np.tile_count)}
    d3_op = packed_to_torch(packed, "cpu")["d3_op"]
    tvis, tattr, _tbb, talive, ttri = setup_pass(
        d3_op["pos"], d3_op["uv"], d3_op["nrm"], d3_op["valid"], d3_op["cull"],
        torch.from_numpy(u["view"]), torch.from_numpy(u["proj"]), W, H)
    ceil_j = ceil_t = None
    for _layer in range(2):
        z, idx, hit, inv = jax_visibility_pass(vis, alive.astype(jnp.float32), W, H,
                                               z_ceil=ceil_j, return_invz=True)
        tz, tidx, thit, tinv = visibility_pass(tvis, talive.float(), W, H, chunk=64,
                                               z_ceil=ceil_t, return_invz=True,
                                               plane_fma=True)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(tz.numpy(), np.asarray(z))
        np.testing.assert_array_equal(tinv.numpy(), np.asarray(inv))
        jcol, jz, jt = jraster._shade_opacity(
            z, idx, hit, attr, tri, op, jatlas, {k: jnp.asarray(v) for k, v in u.items()},
            W, H, 0)
        tcol, tzeff, tt = traster._shade_opacity(tz, tidx, thit, tattr, ttri, d3_op,
                                                 fa["atlas"], u, W, H, 0)
        np.testing.assert_array_equal(tcol.numpy(), np.asarray(jcol))
        np.testing.assert_array_equal(tzeff.numpy(), np.asarray(jz))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert int(np.asarray(hit).sum()) > 50
        ceil_j, ceil_t = inv, tinv


def test_b1_transmittance_and_tonemap_match_jax_interpret(port_room):
    """B1's plain version with the room's bake (cube maps of the point and
    the spot light and the sun's map, each with 4 transmittance layers) and
    the scenevm tonemap, against the JAX megakernel in interpret mode on the
    same inputs; then the same without the layers and without the tonemap,
    each changing the frame."""
    _frame, fa = port_room
    fi = frame_inputs(**fa)
    args, kw = fi["mega_args"], fi["mega_kwargs"]
    assert kw["tonemap"] and kw["shadow_spec"][0][2] >= 0

    def jax_run(kw_):
        ins = [jnp.asarray(a.numpy()) for a in args[:9]]
        ins[4] = jm.atlas_rows_i32(jax.lax.bitcast_convert_type(ins[4], jnp.uint32))
        rgba, z = jm.mega_render(
            *ins, W, H, args[11], interpret=True, light_spec=kw_["light_spec"],
            sun_off=kw_["sun_off"], s_near=jnp.asarray(kw_["s_near"].numpy()),
            shadow_rows=jnp.asarray(kw_["shadow_rows"].numpy()).reshape(-1, 128),
            shadow_spec=kw_["shadow_spec"], tonemap=kw_["tonemap"])
        return np.asarray(rgba), np.asarray(z)

    rgba, z, work = tm.mega_render_reference(*args, **kw, return_work=True)
    ref_rgba, ref_z = jax_run(kw)
    np.testing.assert_allclose(z.numpy(), ref_z, rtol=1e-6, atol=0)
    assert int((z.numpy() != ref_z).sum()) == 1
    np.testing.assert_array_equal(rgba.numpy(), ref_rgba)
    assert work["trans_steps"] > 0 and work["cube_reads"] > 0 and work["sun_reads"] > 0
    sun, cubes = kw["shadow_spec"]
    opaque_maps = ((sun[0], sun[1], -1, sun[3]), tuple(c[:3] + (-1, c[4]) for c in cubes))
    no_trans = tm.mega_render_reference(*args, **dict(kw, shadow_spec=opaque_maps))[0]
    srgb = tm.mega_render_reference(*args, **dict(kw, tonemap=False))[0]
    assert int((no_trans != rgba).sum()) > 20
    assert int((srgb != rgba).sum()) > 1000


def _sky_px(frame_args):
    """The pixels the sky miss pass paints (B1's z_eff is 1)."""
    fi = frame_inputs(**frame_args)
    return tm.mega_render(*fi["mega_args"], **fi["mega_kwargs"])[1].numpy() >= 1.0


def test_room_frame_matches_jax_megakernel(room, port_room):
    """Pinned: 3 sky pixels, each 1 off in one channel."""
    scene, assets, packed = room
    frame, fa = port_room
    ref = _jax_frame(scene, assets, packed)
    diff = np.abs(ref - frame).max(-1)
    assert int((diff > 1).sum()) == 0
    assert int((diff > 0).sum()) == 3
    assert bool(_sky_px(fa)[diff > 0].all())


def test_room_reflection_frame_matches_jax_megakernel(room):
    """With one GGX reflection sample a pixel on the opaque frame and on
    both layers. Pinned: the sky pixels of the frame above and reflection
    pixels."""
    scene, assets, packed = room
    rast = _port_rast(reflections=True)
    out = rast.rasterize(scene, W, H, 32, assets, packed=packed).astype(np.int32)
    sky = _sky_px(rast.frame_args)
    ref = _jax_frame(scene, assets, packed, reflections=True)
    without = rast.set_reflections(0).rasterize(scene, W, H, 32, assets,
                                                packed=packed).astype(np.int32)
    reflected = np.abs(out - without).max(-1) > 0
    assert int(reflected.sum()) > 500
    diff = np.abs(ref - out).max(-1)
    assert int((diff > 0).sum()) == PINNED_REFLECTION_PX
    assert int((diff > 1).sum()) == PINNED_REFLECTION_PX_BEYOND_ONE
    assert int((diff > 0)[sky].sum()) == 3
    assert not bool((diff > 0)[~(reflected | sky)].any())


#: 3 sky pixels (as in the frame without reflections) and 9 reflection
#: pixels, 2 of them more than 1 off
PINNED_REFLECTION_PX = 12
PINNED_REFLECTION_PX_BEYOND_ONE = 2

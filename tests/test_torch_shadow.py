"""rusterix_tpu_torch's shadow maps against the JAX package on the CPU,
module by module on identical numpy inputs: the cube and sun texel
helpers and `shadow_factor` (against `shadow_factor_xla`), the bake
(`bake_shadow_pack`, `bake_shadow_cams`, `_trans_face`,
`composite_dynamic_depth`) on tests/test_shadow_render.py's room, the
shadowed reflection-hit shading on the GGX-reflection map, and a JAX bake
carried into the port (`shadow_pack_from_numpy`). The JAX functions run
inside jax.jit, as the frames run them.

Tolerances: every comparison is exact (texel indices, depths, factors,
tables, cameras), except the hit shading, allclose(rtol=1e-5, atol=1e-5)
as in tests/test_torch_reflect.py; the port writes out the products XLA
fuses into FMAs where they pick a texel or decide a depth compare.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rusterix_tpu import Assets, Batch3D, CullMode, PixelSource, Scene  # noqa: E402
from rusterix_tpu.models.light import pack_lights  # noqa: E402
from rusterix_tpu.ops import reflect as jr  # noqa: E402
from rusterix_tpu.ops import shadow as jsh  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu_torch.ops import megakernel as tm  # noqa: E402
from rusterix_tpu_torch.ops import reflect as tr  # noqa: E402
from rusterix_tpu_torch.ops import shadow as tsh  # noqa: E402
from rusterix_tpu_torch.ops.raster import frame_inputs, packed_to_torch  # noqa: E402
from tests.test_shadow_render import _scene  # noqa: E402
from tests.test_torch_reflect import (  # noqa: E402
    _jax_gbuffer_and_rays,
    _jax_rt,
    _map_frame,
    _t,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SUN_DIR = np.array([0.6, -1.0, 0.0], np.float32)  # tests/test_shadow_render.py's sun
MAP_SUN_DIR = np.array([0.4, -1.0, 0.25], np.float32)  # the bench's


def _sun_params(sun_dir=MAP_SUN_DIR, center=(25.0, 1.5, 25.0), radius=36.0):
    """(40,) bake params with the sun camera of `sun_dir` around a sphere."""
    _view, _proj, sp = jsh.sun_camera(sun_dir, np.asarray(center, np.float32), radius)
    p = np.zeros(40, np.float32)
    p[0], p[1] = 50.0, 0.05
    p[2:5], p[5:8], p[8:11], p[11:14] = sp["pos"], sp["right"], sp["up"], sp["fwd"]
    p[14], p[15] = sp["f"], sp["near"]
    return p


def _nudge(x, steps):
    """x moved by `steps` f32 ulps (per element, steps may be negative)."""
    out = x.copy()
    for s in range(1, int(np.abs(steps).max()) + 1):
        up = steps >= s
        down = steps <= -s
        out[up] = np.nextafter(out[up], np.float32(np.inf))
        out[down] = np.nextafter(out[down], np.float32(-np.inf))
    return out


def _cube_points(rng, res, n=60000):
    """Seeded directions, plus points whose texel coordinate lies on a
    texel boundary of +X, within two ulps."""
    tp = (rng.standard_normal((3, n)) * 3.0).astype(np.float32)
    k = rng.integers(0, res + 1, n)
    ma = rng.uniform(0.5, 8.0, n).astype(np.float32)
    u = (k / (res * 0.5) - 1.0).astype(np.float32)
    tz = _nudge(-(u * ma).astype(np.float32), rng.integers(-2, 3, n))
    ty = (rng.uniform(-0.95, 0.95, n) * ma).astype(np.float32)
    return np.concatenate([tp, np.stack([ma, ty, tz])], axis=1)


@pytest.mark.parametrize("res", [32, 48, 128])
def test_cube_texel_matches_jax(res):
    rng = np.random.default_rng(res)
    pts = _cube_points(rng, res)
    face_j, u_j, v_j, ma_j = jax.jit(jsh.cube_face_uv)(*pts)
    face, u, v, ma = tsh.cube_face_uv(*(_t(c) for c in pts))
    np.testing.assert_array_equal(face.numpy(), np.asarray(face_j))
    for a, b in ((u, u_j), (v, v_j), (ma, ma_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    flat_j, d_j = jax.jit(partial(jsh.cube_shadow_texel, base=256, res=res))(*pts)
    flat, d = tsh.cube_shadow_texel(*(_t(c) for c in pts), 256, res)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(flat_j))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    assert set(np.unique(face.numpy())) == set(range(6))


def test_sun_texel_matches_jax():
    """Points over the map's bounding box, some off the map (in_range
    false), through the bench sun's camera."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-15.0, 65.0, (3, 200000)).astype(np.float32)
    params = _sun_params()
    flat_j, vz_j, in_j = jax.jit(partial(jsh.sun_shadow_texel, base=512, res=256))(
        *pts, jnp.asarray(params))
    flat, vz, in_range = tsh.sun_shadow_texel(*(_t(c) for c in pts), params, 512, 256)
    np.testing.assert_array_equal(vz.numpy(), np.asarray(vz_j))
    np.testing.assert_array_equal(in_range.numpy(), np.asarray(in_j))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(flat_j))
    assert 0.2 < float(in_range.float().mean()) < 0.99


def _factor_case(kind, rng, n=100000):
    """A table with a cube map (res 32) and a sun map (res 64), each with two
    transmittance layers for the "_trans" kinds, depths drawn around the
    receivers' own; receivers and unit normals around the light, or over
    the map for the sun -> (rows, params, entry, lpos, points, normals)."""
    res, sres, steps = 32, 64, 2
    cube_size, sun_size = 6 * res * res, sres * sres
    trans = kind.endswith("_trans")
    layout = [cube_size, sun_size] + ([2 * steps * cube_size, 2 * steps * sun_size] if trans
                                      else [])
    rows = rng.uniform(0.0, 14.0, sum(layout)).astype(np.float32)
    bases = np.cumsum([0] + layout)
    # the sun camera stands 17.6 units behind the receivers' centre
    rows[bases[1]:bases[2]] = rng.uniform(0.0, 35.0, sun_size)
    if trans:  # alpha planes in [0, 1]
        for b, size in ((bases[2], cube_size), (bases[3], sun_size)):
            for k in range(steps):
                a0 = b + (2 * k + 1) * size
                rows[a0:a0 + size] = rng.uniform(0.0, 1.0, size)
    params = _sun_params(center=(15.0, 2.5, 15.0), radius=8.0)
    nrm = rng.standard_normal((3, n)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0)
    nrm[:, : n // 10] = 0.0  # no normal: no offset
    lpos = np.array([15.0, 2.5, 15.0], np.float32)
    pts = (lpos[:, None] + rng.standard_normal((3, n)) * 3.0).astype(np.float32)
    if kind.startswith("cube"):
        entry = (3, int(bases[0]), res, int(bases[2]) if trans else -1, steps)
    else:
        entry = (int(bases[1]), sres, int(bases[3]) if trans else -1, steps)
        lpos = None
    return rows, params, entry, lpos, pts, nrm


@pytest.mark.parametrize("kind", ["cube", "sun", "cube_trans", "sun_trans"])
def test_shadow_factor_matches_jax(kind):
    rows, params, entry, lpos, pts, nrm = _factor_case(kind, np.random.default_rng(len(kind)))
    if lpos is None:
        ref = jax.jit(lambda r, p, *c: jsh.shadow_factor_xla(r, p, entry, *c))(
            rows, jnp.asarray(params), *pts, *nrm)
    else:
        ref = jax.jit(lambda r, p, lp, *c: jsh.shadow_factor_xla(r, p, entry, *c, lpos=lp))(
            rows, jnp.asarray(params), jnp.asarray(lpos), *pts, *nrm)
    out = tsh.shadow_factor(_t(rows), params, entry, *(_t(c) for c in pts),
                            *(_t(c) for c in nrm), lpos=lpos)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 0.05 < float((ref == 0.0).mean()) < 0.95  # both outcomes occur
    if kind.endswith("_trans"):
        assert ((ref > 0.0) & (ref < 1.0)).mean() > 0.05  # layers attenuate


# ------------------------------------------------------------ the bake


def _room(sun=True):
    """tests/test_shadow_render.py's room, packed by the JAX package ->
    (packed, lights, cast rows, sun direction, numpy d3)."""
    scene = _scene()
    packed = PackedScene.from_scene(scene, Assets.default(), static_only=True)
    lights = pack_lights(scene.all_lights(), packed.lights["valid"].shape[0])
    return packed, lights, [0], SUN_DIR if sun else None, {
        k: np.asarray(v) for k, v in vars(packed.d3).items()}


def _bake_both(d3, lights, cast, sun, **kw):
    jrows, jparams, jspec = jsh.bake_shadow_pack(
        {k: jnp.asarray(v) for k, v in d3.items()}, None, lights, cast, sun, **kw)
    trows, tparams, tspec = tsh.bake_shadow_pack(
        {k: torch.from_numpy(v) for k, v in d3.items()}, None, lights, cast, sun, **kw)
    return (np.asarray(jrows).reshape(-1), jparams, jspec), (trows, tparams, tspec)


@pytest.mark.parametrize("sun", [False, True])
def test_bake_matches_jax_on_the_room(sun):
    """The point light's cube map (and the sun's map): every texel equal,
    params and spec equal; then the dynamic-caster cameras."""
    packed, lights, cast, sun_dir, d3 = _room(sun)
    (jrows, jparams, jspec), (trows, tparams, tspec) = _bake_both(
        d3, lights, cast, sun_dir, res=64, sun_res=128)
    assert tspec == jspec
    np.testing.assert_array_equal(tparams, jparams)
    np.testing.assert_array_equal(trows.numpy(), jrows)
    assert 0.05 < float((jrows < 1e29).mean()) < 0.9  # the maps hold occluders
    bounds = jsh.scene_bounds(packed.d3.pos, packed.d3.valid)
    np.testing.assert_array_equal(tsh.bake_shadow_cams(lights, tspec, sun_dir, bounds),
                                  jsh.bake_shadow_cams(lights, jspec, sun_dir, bounds))


def test_bake_with_no_caster_and_no_sun_is_neutral():
    packed, lights, _cast, _sun, d3 = _room(sun=False)
    rows, params, spec = tsh.bake_shadow_pack({k: torch.from_numpy(v) for k, v in d3.items()},
                                              None, lights, [], None)
    jrows, jparams, jspec = jsh.bake_shadow_pack({k: jnp.asarray(v) for k, v in d3.items()},
                                                 None, lights, [], None)
    assert spec == jspec == (None, ())
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows).reshape(-1))
    np.testing.assert_array_equal(params, jparams)
    assert tsh.bake_shadow_cams(lights, spec) is None


def test_trans_face_matches_jax():
    """Depth-peeled layers of the room through a cube face looking at the
    wall, with an opacity drawn per triangle from a seed."""
    _packed, lights, _cast, _sun, d3 = _room()
    alpha = np.random.default_rng(5).uniform(0.2, 0.9, d3["pos"].shape[0]).astype(np.float32)
    far = float(max(lights["end"][0], jsh.SHADOW_NEAR * 2.0))
    a, b = jsh.depth_const(jsh.SHADOW_NEAR, far)
    proj = jsh.perspective_fov_rh_zo(np.pi / 2.0, 1.0, 1.0, jsh.SHADOW_NEAR, far)
    view = jsh.face_view_matrix(lights["position"][0], 0)  # +X, toward the wall
    keys = ("pos", "uv", "nrm", "valid")
    ref = jsh._trans_face(*(jnp.asarray(d3[k]) for k in keys), jnp.asarray(alpha), view, proj,
                          a, b, 32, 3)
    out = tsh._trans_face(*(torch.from_numpy(d3[k]) for k in keys), torch.from_numpy(alpha),
                          view, proj, a, b, 32, 3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (np.asarray(ref)[1, 0] < 1e29).sum() > 10  # a second layer was peeled


def test_composite_dynamic_depth_matches_jax():
    """A box in front of the wall, packed as a dynamic pack, min-composited
    into the room's cube and sun maps."""
    packed, lights, cast, sun_dir, d3 = _room()
    (jrows, _jp, jspec), (trows, _tp, tspec) = _bake_both(d3, lights, cast, sun_dir, res=32,
                                                          sun_res=64)
    bounds = jsh.scene_bounds(packed.d3.pos, packed.d3.valid)
    cams = jsh.bake_shadow_cams(lights, jspec, sun_dir, bounds)
    box = (Batch3D.from_box(1.0, 0.0, -0.5, 0.3, 1.0, 1.0)
           .set_source(PixelSource.pixel((90, 90, 90, 255))).set_cull_mode(CullMode.Off)
           .with_computed_normals())
    dyn = vars(PackedScene.from_scene(Scene.from_static([], [box]), Assets.default(),
                                      static_only=True).d3)
    keys = ("pos", "uv", "nrm", "valid")
    ref = np.asarray(jsh.composite_dynamic_depth(jnp.asarray(jrows), jspec, cams,
                                                 *(jnp.asarray(dyn[k]) for k in keys)))
    out = tsh.composite_dynamic_depth(trows, tspec, cams,
                                      *(torch.from_numpy(np.asarray(dyn[k])) for k in keys))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref < jrows).sum() > 20  # the box occludes


# ----------------------------------------------- the reflection hits, B1


@pytest.fixture(scope="module")
def map_shadowed():
    """The GGX-reflection map at 128x64 with the JAX package's bake of its
    casting lights (the four brightest point rows) and the bench sun."""
    m = _map_frame(128, 64)
    lights = m["lights"]
    rows_idx = [i for i in range(len(lights["type"]))
                if lights["valid"][i] > 0.5 and int(lights["type"][i]) in (0, 3)]
    cast = sorted(sorted(rows_idx, key=lambda i: -float(lights["intensity"][i]))[:4])
    # trans_steps as the Rasterizer sets it from max_shadow_steps (16 -> 4)
    rows, params, spec = jsh.bake_shadow_pack(m["jax_d3"], None, lights, cast, MAP_SUN_DIR,
                                              res=64, sun_res=128, trans_steps=4)
    return m, (np.asarray(rows).reshape(-1), params, spec)


def test_shadowed_hit_shading_matches_jax(map_shadowed):
    """_shade_reflection_hits with the same maps, rays and hits (the JAX
    walk's): the sun's and each casting light's factor at the hits."""
    m, (rows, params, spec) = map_shadowed
    *_, rays = _jax_gbuffer_and_rays(m)
    names = ("o_x", "o_y", "o_z", "d_x", "d_y", "d_z")
    ray_np = [rays[k].numpy() for k in names]
    t_ref, i_ref = _jax_rt(m["packed"].d3.pos, m["packed"].d3.valid,
                           np.stack(ray_np[:3]), np.stack(ray_np[3:]), 50.0, 64, 128)
    i_ref = np.where(rays["ok"].numpy(), i_ref, -1)
    sky = jnp.asarray(m["uniforms"]["refl_sky"])

    ref = np.asarray(jax.jit(
        lambda *a: jr._shade_reflection_hits(*a[:-2], 0, sky, shadow=(a[-2], a[-1], spec)))(
        jnp.asarray(t_ref), jnp.asarray(i_ref), *(jnp.asarray(r) for r in ray_np),
        m["jax_d3"], m["jax_atlas"], jax.tree_util.tree_map(jnp.asarray, m["lights"]),
        m["uniforms"], jnp.asarray(rows), jnp.asarray(params)))
    pt = packed_to_torch(m["packed"], "cpu")

    def port_hits(shadow):
        return tr._shade_reflection_hits(
            _t(t_ref), _t(i_ref), *(_t(r) for r in ray_np), pt["d3"], pt["atlas"],
            m["lights"], m["uniforms"], 0, _t(m["uniforms"]["refl_sky"]), shadow=shadow).numpy()

    out = port_hits(tsh.shadow_pack_from_numpy(rows, params, spec, "cpu"))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert int((np.abs(out - port_hits(None)).max(-1) > 1e-3).sum()) > 5  # hits in shadow


def test_shadow_pack_from_numpy_gives_the_port_bake_frame(map_shadowed):
    """B1's plain version shades the same frame with the JAX package's bake
    carried over as with the port's own bake of the same lights."""
    m, (rows, params, spec) = map_shadowed
    from rusterix_tpu_torch.scenes import build_map_shadow_refl_scene

    rast, scene, assets = build_map_shadow_refl_scene(128, 64, device="cpu")
    rast.set_shadows(True, res=64, sun_res=128).set_reflections(0)
    frame = rast.rasterize(scene, 128, 64, 40, assets)
    fa = dict(rast.frame_args)
    own_rows, own_params, own_spec = fa["shadow_rows"], fa["shadow_params"], fa["shadow_spec"]
    assert own_spec == spec
    np.testing.assert_array_equal(own_params, params)
    jrows, jparams, jspec = tsh.shadow_pack_from_numpy(rows, params, spec, "cpu")
    np.testing.assert_array_equal(jrows.numpy(), own_rows.numpy())
    fa.update(shadow_rows=jrows, shadow_params=jparams, shadow_spec=jspec)
    fi = frame_inputs(**fa)
    rgba, _z = tm.mega_render(*fi["mega_args"], **fi["mega_kwargs"])
    np.testing.assert_array_equal(tm.unpack_frame_u32(rgba).numpy(), frame)

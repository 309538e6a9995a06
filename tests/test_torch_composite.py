"""rusterix_tpu_torch's composite family against the JAX package, module by
module, on the same seeded numpy inputs: the opacity layers' blend, the
render graph's sky miss pass and its cloud texel, the brush preview, the
distance fog, the pattern bank's sampler, the opacity shading, the
reflection composite under the scenevm tonemap, and the single-rounding
`_fma` that every XLA-fused product of the port goes through.

Tolerances, as each test states: exact where the two sides round alike
(the blend, the sampler, the cloud texel, the opacity shading, `_fma`);
elsewhere allclose at a few f32 ulps with the count of RGBA8 bytes that
differ pinned: XLA's CPU build fuses some products of the sky and brush
expressions into FMAs by context (the same expression fuses differently
in another jitted function), and its pow/exp/log approximations are not
torch's, so a last bit differs; a byte flips only where the value lies
within that bit of a rounding boundary.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rusterix_tpu.models.camera import D3FirstPCamera  # noqa: E402
from rusterix_tpu.ops import composite as jc  # noqa: E402
from rusterix_tpu.ops import reflect as jr  # noqa: E402
from rusterix_tpu.ops.matrices import invert  # noqa: E402
from rusterix_tpu.shader import patterns as jp  # noqa: E402
from rusterix_tpu.shapefx import render as jfx  # noqa: E402
from rusterix_tpu.shapefx.graph import ShapeFXGraph as JaxGraph  # noqa: E402
from rusterix_tpu_torch.ops import composite as tc  # noqa: E402
from rusterix_tpu_torch.ops import reflect as tr  # noqa: E402
from rusterix_tpu_torch.ops import setup_pass as tsp  # noqa: E402
from rusterix_tpu_torch.ops import shade as ts  # noqa: E402
from rusterix_tpu_torch.shader import patterns as tp  # noqa: E402
from rusterix_tpu_torch.shapefx import render as tfx  # noqa: E402
from rusterix_tpu_torch.shapefx.graph import ShapeFXGraph as PortGraph  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 256, 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _u8(x):
    return np.floor(np.clip(np.asarray(x), 0.0, 1.0) * 255.0 + 0.5).astype(np.int32)


def _uniforms():
    """A first-person camera looking slightly up past the horizon (sky and
    y=0 plane both in view) and a brush on the plane."""
    cam = D3FirstPCamera()
    cam.set_parameter_vec3("position", [5.0, 1.6, 5.0])
    cam.set_parameter_vec3("center", [15.0, 1.9, 12.0])
    view = np.asarray(cam.view_matrix(), np.float32)
    proj = np.asarray(cam.projection_matrix(W, H), np.float32)
    inv_view, inv_proj = invert(view), invert(proj)
    return {"inv_proj": inv_proj, "inv_view": inv_view,
            "camera_pos": inv_view[:3, 3].copy(),
            "brush_pos": np.array([9.0, 0.0, 8.0], np.float32),
            "brush_radius": np.float32(2.5), "brush_falloff": np.float32(0.5)}


def _sky_params(hour=14.0):
    """The same Sky node's device parameters on both sides."""
    nodes = []
    for graph in (JaxGraph, PortGraph):
        node = [n for n in graph.default_render_graph(with_sky=True).nodes
                if n.role.name == "Sky"][0]
        node.render_setup(hour)
        nodes.append(node)
    return jfx.sky_device_params(nodes[0]), tfx.sky_device_params(nodes[1], "cpu")


def _frame_and_z(rng):
    frame = rng.uniform(0.0, 1.0, (H, W, 4)).astype(np.float32)
    z = np.where(rng.uniform(size=(H, W)) > 0.4, 1.0,
                 rng.uniform(0.9, 0.999, (H, W))).astype(np.float32)
    return frame, z


def _jax_uniforms(u):
    return {k: jnp.asarray(v) for k, v in u.items()}


# ------------------------------------------------------------------ _fma


C2_INPUT = (np.float32(2.0 ** -18 * (1 + 2.0 ** -15)), np.float32(1 - 2.0 ** -15),
            np.float32(64 + 2.0 ** -17))


def test_fma_rounds_once_on_the_double_rounding_input():
    """a*b + c with a = 2^-18 (1 + 2^-15), b = 1 - 2^-15, c = 64 + 2^-17:
    the f64 sum lands on an f32 tie; rounded once the result is 64.0000076
    (the jitted JAX `a*b + c`), rounded twice 64.0000153. Both names of
    the helper are the one function."""
    a, b, c = C2_INPUT
    ref = np.asarray(jax.jit(lambda a, b, c: a * b + c)(
        jnp.asarray([a]), jnp.asarray([b]), jnp.asarray([c])))
    assert ref[0] == np.float32(64 + 2.0 ** -17)
    out = tsp._fma(_t([a]), _t([b]), _t([c])).numpy()
    np.testing.assert_array_equal(out, ref)
    assert ts._fma is tsp._fma


def _near_ties(rng, n):
    """Seeded inputs whose exact a*b + c lies within 2^-30 relative of an
    f32 rounding tie, on both sides of it and in both signs, plus random
    ones."""
    c = rng.uniform(1.0, 2.0, n).astype(np.float32) * np.float32(2.0) ** rng.integers(
        -20, 20, n).astype(np.float32)
    c = np.where(rng.uniform(size=n) < 0.5, c, -c).astype(np.float32)
    half_ulp = np.spacing(np.abs(c)).astype(np.float64) / 2
    j = rng.integers(15, 22, n)
    a = (half_ulp * (1 + 2.0 ** -j)).astype(np.float32)
    b = (1 - 2.0 ** -j).astype(np.float32)
    sign = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0).astype(np.float32)
    a = a * sign
    ra = rng.normal(size=n).astype(np.float32)
    rb = rng.normal(size=n).astype(np.float32)
    rc = rng.normal(size=n).astype(np.float32)
    return (np.concatenate([a, ra]), np.concatenate([b, rb]), np.concatenate([c, rc]))


def test_fma_matches_jitted_jax_on_near_ties():
    a, b, c = _near_ties(np.random.default_rng(6), 20000)
    ref = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    out = tsp._fma(_t(a), _t(b), _t(c)).numpy()
    np.testing.assert_array_equal(out, ref)
    # the case exists in these inputs: rounding the f64 sum twice misses it
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert int((twice != ref).sum()) > 1000


def test_fma_takes_numbers_as_f32_constants_and_keeps_non_finite():
    x = _t(np.array([1.5, np.inf, -np.inf, np.nan], np.float32))
    out = tsp._fma(x, 0.1, 1.0).numpy()
    ref = np.asarray(jax.jit(lambda x: x * 0.1 + 1.0)(np.asarray(x)))
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------- blend_opacity


@pytest.mark.parametrize("preserve", [False, True])
def test_blend_opacity_matches_jax(preserve):
    rng = np.random.default_rng(1)
    frame, z = _frame_and_z(rng)
    op = rng.uniform(0.0, 1.0, (H, W, 4)).astype(np.float32)
    op_z = np.where(rng.uniform(size=(H, W)) > 0.5, 1.0,
                    rng.uniform(0.85, 1.0, (H, W))).astype(np.float32)
    op_z[::7] = z[::7]  # equal depths do not blend
    ref = np.asarray(jax.jit(lambda *a: jc.blend_opacity(*a, preserve))(frame, z, op, op_z))
    out = tc.blend_opacity(_t(frame), _t(z), _t(op), _t(op_z), preserve).numpy()
    np.testing.assert_array_equal(out, ref)
    assert 0 < int((ref != frame).any(-1).sum()) < H * W


# ------------------------------------------------------------ the sky


def test_sky_miss_pass_matches_jax():
    """Every miss pixel (z_eff 1) takes the sky; RGBA8 bytes pinned."""
    rng = np.random.default_rng(2)
    frame, z = _frame_and_z(rng)
    u = _uniforms()
    jpre, tpre = _sky_params()
    ref = np.asarray(jax.jit(lambda f, z, u: jc.sky_miss_pass(f, z, jpre, u, W, H))(
        frame, z, _jax_uniforms(u)))
    out = tc.sky_miss_pass(_t(frame), _t(z), tpre, u, W, H).numpy()
    np.testing.assert_array_equal(out[z < 1.0], frame[z < 1.0])
    np.testing.assert_allclose(out, ref, rtol=0, atol=6e-7)
    assert int((_u8(out) != _u8(ref)).any(-1).sum()) == 0
    assert float(np.abs(out[z >= 1.0] - frame[z >= 1.0]).max()) > 0.1


def test_sky_miss_on_the_same_rays_and_its_cloud_texel():
    """sky_miss on identical unit rays (upward ones through the cloud
    layer): within 2 ulps of 1; the cloud texel each ray samples (the floors
    of u*SIZE after the division by the ray's dy) equal JAX's."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(96, 128, 3)).astype(np.float32)
    d[..., 1] = np.abs(d[..., 1]) * np.where(rng.uniform(size=(96, 128)) < 0.8, 1.0, -1.0)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cam = np.array([5.0, 1.6, 5.0], np.float32)
    jpre, tpre = _sky_params()
    ref = np.asarray(jax.jit(lambda d: jfx.sky_miss(jpre, d, jnp.asarray(cam)))(d))
    out = tfx.sky_miss(tpre, _t(d), cam).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2.5e-7)

    def jax_texel(d):
        dy = d[..., 1]
        t_hit = jnp.where(dy > 0.0, (1500.0 - cam[1]) / jnp.where(dy > 0, dy, 1.0), -1.0)
        u = (cam[0] + d[..., 0] * t_hit) * 0.0005
        v = (cam[2] + d[..., 2] * t_hit) * 0.0005
        x = jnp.floor((u - jnp.floor(u)) * jp.SIZE).astype(jnp.int32) % jp.SIZE
        y = jnp.floor((v - jnp.floor(v)) * jp.SIZE).astype(jnp.int32) % jp.SIZE
        return y * jp.SIZE + x

    u, v, _t_hit = tfx.cloud_uv(_t(d), _t(cam))
    x = torch.remainder(torch.floor((u - torch.floor(u)) * tp.SIZE).int(), tp.SIZE)
    y = torch.remainder(torch.floor((v - torch.floor(v)) * tp.SIZE).int(), tp.SIZE)
    up = d[..., 1] > 0
    np.testing.assert_array_equal((y * tp.SIZE + x).numpy()[up],
                                  np.asarray(jax.jit(jax_texel)(d))[up])


def test_sample_pattern_matches_jax():
    rng = np.random.default_rng(4)
    u = rng.uniform(-3.0, 3.0, (64, 64)).astype(np.float32)
    v = rng.uniform(-3.0, 3.0, (64, 64)).astype(np.float32)
    np.testing.assert_array_equal(tp.pattern_bank(), jp.pattern_bank())
    for name, idx in tp.PATTERN_NAMES.items():
        ref = np.asarray(jp.sample_pattern_jnp(jnp.asarray(jp.pattern_bank()), idx, u, v))
        out = tp.sample_pattern_jnp(_t(tp.pattern_bank()), idx, _t(u), _t(v)).numpy()
        np.testing.assert_array_equal(out, ref, err_msg=name)


def test_sky_setup_and_ambient_match_jax():
    """The numpy set-up of the Sky and Fog nodes is the JAX package's."""
    for hour in (3.0, 7.0, 14.0, 19.5):
        nodes = []
        for graph in (JaxGraph, PortGraph):
            g = graph.default_render_graph(with_sky=True, with_fog=True)
            sky = [n for n in g.nodes if n.role.name == "Sky"][0]
            fog = [n for n in g.nodes if n.role.name == "Fog"][0]
            nodes.append((sky.render_setup(hour), sky.render_ambient_color(hour), fog,
                          sky.precomputed))
            fog.render_setup(hour)
        (jr_, ja, jf, jpc), (tr_, ta, tf, tpc) = nodes
        np.testing.assert_array_equal(jr_[0], tr_[0])
        assert jr_[1] == tr_[1]
        np.testing.assert_array_equal(ja, ta)
        for a, b in zip(jpc + jf.precomputed, tpc + tf.precomputed):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", [0.0, 1.0])
def test_fog_apply_matches_jax(mode):
    rng = np.random.default_rng(5)
    color = rng.uniform(0.0, 1.0, (64, 64, 3)).astype(np.float32)
    world = rng.uniform(-20.0, 20.0, (64, 64, 3)).astype(np.float32)
    cam = np.array([1.0, 1.6, -2.0], np.float32)
    fog_color = np.array([0.6, 0.5, 0.4, 1.0], np.float32)
    args = (cam, fog_color, np.float32(6.0), np.float32(9.0), np.float32(mode),
            np.float32(0.01))
    ref = np.asarray(jax.jit(jfx.fog_apply)(color, world, *args))
    out = tfx.fog_apply(_t(color), _t(world), *args).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=3e-7)
    assert float(np.abs(out - color).max()) > 0.2


# ---------------------------------------------------------- brush preview


def test_brush_preview_pass_matches_jax():
    """The brush circle on the y=0 plane brightens miss pixels inside its
    radius; RGBA8 bytes pinned."""
    rng = np.random.default_rng(7)
    frame, z = _frame_and_z(rng)
    u = _uniforms()
    ref = np.asarray(jax.jit(lambda f, z, u: jc.brush_preview_pass(f, z, u, W, H))(
        frame, z, _jax_uniforms(u)))
    out = tc.brush_preview_pass(_t(frame), _t(z), u, W, H).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=6e-7)
    assert int((_u8(out) != _u8(ref)).any(-1).sum()) == 0
    changed_ref = (ref != frame).any(-1)
    changed = (out != frame).any(-1)
    np.testing.assert_array_equal(changed, changed_ref)  # dist < radius decided alike
    assert int(changed.sum()) > 200


# ------------------------------------------------- the reflection composite


def test_apply_reflections_with_the_scenevm_tonemap_matches_jax():
    """Decode with the tonemap's inverse, add the linear term, re-encode;
    untouched pixels keep their bytes. RGBA8 bytes pinned."""
    rng = np.random.default_rng(8)
    frame = rng.uniform(0.0, 1.0, (H, W, 4)).astype(np.float32)
    refl = rng.uniform(0.0, 0.5, (H, W, 3)).astype(np.float32)
    mask = rng.uniform(size=(H, W)) > 0.3
    ref = np.asarray(jax.jit(lambda f, r, m: jr.apply_reflections(f, r, m, tonemap=True))(
        frame, refl, mask))
    out = tr.apply_reflections(_t(frame), _t(refl), _t(mask), tonemap=True).numpy()
    np.testing.assert_array_equal(out[~mask], frame[~mask])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert int((_u8(out) != _u8(ref)).any(-1).sum()) == 0

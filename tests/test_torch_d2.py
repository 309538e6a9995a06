"""The 2D pass of rusterix_tpu_torch against the JAX package on the CPU:
`light_radiance` (3D and the 2D lights), the ordered 2D raster
(`composite.d2_pass`) inside whole frames through Rasterizer.rasterize on
the bench's cube (a 3D box through B1's plain version, then the 2D
rectangle) and on a small 2D map view (two rooms of path N's map with a
white rectangle over them, lit by the map's point light and an ambient
light, the map's walls blocking the point light), and the picking methods
`screen_to_world` / `screen_ray`.

Each frame is rendered once by each package (module fixtures) from one
shared PackedScene. The 2D pass rounds its edge functions, barycentrics,
projection and blend as XLA's CPU build does (composite.d2_pass), so the
frames are held pixel for pixel.

Tolerances: light_radiance allclose(rtol=1e-6, atol=1e-6) (it is bit-equal
on these inputs); the frames exactly; the picking results within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from rusterix_tpu.models.blend import RenderMode as JaxRenderMode  # noqa: E402
from rusterix_tpu.ops import raster as jraster  # noqa: E402
from rusterix_tpu.ops.shade import light_radiance as jax_light_radiance  # noqa: E402
from rusterix_tpu_torch.models import Batch2D, PixelSource  # noqa: E402
from rusterix_tpu_torch.ops import composite  # noqa: E402
from rusterix_tpu_torch.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu_torch.ops.shade import light_radiance, lights_to_torch  # noqa: E402
from rusterix_tpu_torch.scenes import build_cube_scene, build_map_2d_scene  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_lights(rng, n=12):
    """Every light type twice, random placements, ranges and shapes."""
    lights = {
        "valid": (rng.random(n) > 0.1).astype(np.float32),
        "type": (np.arange(n) % 6).astype(np.int32),
        "position": (rng.random((n, 3)) * 10).astype(np.float32),
        "color": rng.random((n, 3)).astype(np.float32),
        "intensity": (rng.random(n) * 2).astype(np.float32),
        "start": (rng.random(n) * 2).astype(np.float32),
        "end": (rng.random(n) * 8 + 2).astype(np.float32),
        "flicker": np.zeros(n, np.float32),
        "direction": rng.standard_normal((n, 3)).astype(np.float32),
        "cone_angle": (rng.random(n) * 1.2).astype(np.float32),
        "normal": rng.standard_normal((n, 3)).astype(np.float32),
        "width": (rng.random(n) * 3 + 0.2).astype(np.float32),
        "height": (rng.random(n) * 3 + 0.2).astype(np.float32),
        "from_linedef": (rng.random(n) > 0.5).astype(np.float32),
        "flicker_factor": (rng.random(n) * 0.5 + 0.5).astype(np.float32),
    }
    lights["direction"] /= np.linalg.norm(lights["direction"], axis=1, keepdims=True)
    return lights


@pytest.mark.parametrize("case", ["2d", "3d", "3d_normal"])
def test_light_radiance_matches_jax(case):
    """Every light type at seeded points: the 2D footprint (d2) and the 3D
    radiance without and with the Lambert factor, against the jitted JAX
    function."""
    rng = np.random.default_rng(3)
    lights = _seeded_lights(rng)
    world = (rng.random((48, 40, 3)) * 10).astype(np.float32)
    normal = None
    if case == "3d_normal":
        normal = rng.standard_normal((48, 40, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    d2 = case == "2d"
    ref = np.asarray(jax.jit(lambda lt, w, n: jax_light_radiance(lt, w, n, d2=d2))(
        lights, world, normal))
    out = light_radiance(lights_to_torch(lights, "cpu"), torch.from_numpy(world),
                         None if normal is None else torch.from_numpy(normal), d2=d2).numpy()
    assert out.shape == ref.shape == (48, 40, 12, 3)
    assert np.count_nonzero(ref) > ref.size // 4
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def _jax_rast(port_rast):
    rast = jraster.Rasterizer.setup(port_rast.projection_matrix_2d, port_rast.view_matrix,
                                    port_rast.projection_matrix)
    if port_rast.ambient_color is not None:
        rast.ambient(port_rast.ambient_color)
    rast.set_render_mode(JaxRenderMode(port_rast.render_mode.d2_active,
                                       port_rast.render_mode.d3_active, False))
    rast.use_pallas = True  # the megakernel path, in interpret mode here
    return rast


def _frames(build_scene, width, height):
    """-> (JAX frame, port frame, the port's render_frame arguments, scene)
    of one shared PackedScene."""
    rast, scene, assets = build_scene(width, height)
    packed = PackedScene.from_scene(scene, assets, static_only=True)
    out = rast.rasterize(scene, width, height, 40, assets, packed=packed)
    ref = _jax_rast(rast).rasterize(scene, width, height, 40, assets, packed=packed)
    return ref.astype(np.int32), out.astype(np.int32), rast.frame_args, scene


def _cube(width, height):
    return build_cube_scene(width, height, device="cpu")


def _lit_map(width, height):
    """Two rooms of path N's map, a white rectangle drawn over them."""
    rast, scene, assets = build_map_2d_scene(width, height, device="cpu", rooms_x=2, rooms_y=1)
    scene.d2_static.append(Batch2D.from_rectangle(0.0, 0.0, 20.0, 10.0)
                           .set_source(PixelSource.pixel((255, 255, 255, 255))))
    return rast, scene, assets


@pytest.fixture(scope="module")
def cube_frames():
    return _frames(_cube, 160, 120)


@pytest.fixture(scope="module")
def map_frames():
    return _frames(_lit_map, 256, 128)


def test_cube_frame_matches_jax(cube_frames):
    """Path M at 160x120: the box through B1 and the bench's 200x200
    rectangle (its default source is off: transparent, so the 2D step
    leaves the colour and makes the covered alpha opaque)."""
    ref, out, fa, _scene = cube_frames
    assert fa["has_d2"] and not fa["has_lights"] and not fa["has_ambient"]
    assert int(fa["d2"]["valid"].sum()) == 2
    assert (out[..., 3] == 255).all()  # the gradient background is opaque
    np.testing.assert_array_equal(out, ref)


def test_map_view_frame_matches_jax(map_frames):
    """The 2D map view: wall strips, floors and the white rectangle, lit in
    u8 space by the point light and the ambient, the walls blocking the
    point light (the lit side and the shadow side of a wall differ)."""
    ref, out, fa, scene = map_frames
    assert fa["has_d2"] and fa["has_lights"] and fa["has_ambient"]
    assert "seg_a" in fa["uniforms"] and int(fa["uniforms"]["seg_valid"].sum()) >= 16
    assert int(fa["d3"]["valid"].sum()) == 0  # 3D off
    # the rectangle covers the map; its brightness varies with the lights
    lit = out[..., 0][out[..., 3] == 255]
    assert lit.size > 256 * 128 // 2 and lit.max() > lit.min() + 60
    np.testing.assert_array_equal(out, ref)
    # without the walls' segments the point light reaches more of the map
    fa_free = dict(fa, uniforms={k: v for k, v in fa["uniforms"].items()
                                 if not k.startswith("seg_")})
    bg = torch.zeros((128, 256, 4))
    free = composite.d2_pass(bg, fa["d2"], fa["atlas"], fa["lights"], fa_free["uniforms"],
                             256, 128, 0, False, True, True)
    walled = composite.d2_pass(bg, fa["d2"], fa["atlas"], fa["lights"], fa["uniforms"],
                               256, 128, 0, False, True, True)
    assert float(free.sum()) > float(walled.sum())


def test_d2_step_rounding_matches_xla():
    """The edge functions, the barycentric u and the 3x3 projection of
    seeded triangles, as composite.d2_pass evaluates them, against a jitted
    JAX scan of the JAX package's expressions (bit for bit)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    h, w, t = 40, 56, 24
    pos = (rng.random((t, 3, 2)) * np.array([w, h]) * 1.2 - 5).astype(np.float32)
    uvs = (rng.random((t, 3, 2)) * 4 - 1).astype(np.float32)
    m = np.array([[1.7, 0.0, 3.25], [0.0, 1.7, -2.5], [0.0, 0.0, 1.0]], np.float32)

    def step(c, xs):
        v, uv = xs
        px = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5, (h, w))
        py = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5, (h, w))
        v0, v1, v2 = v[0], v[1], v[2]
        e0 = (v1[1] - v0[1]) * px + (v0[0] - v1[0]) * py + (v1[0] * v0[1] - v1[1] * v0[0])
        ac, ab = v2 - v0, v1 - v0
        area = ac[0] * ab[1] - ac[1] * ab[0]
        inv_area = jnp.where(jnp.abs(area) > 1e-20, 1.0 / area, 0.0)
        alpha = ((v2[0] - px) * (v1[1] - py) - (v2[1] - py) * (v1[0] - px)) * inv_area
        beta = (ac[0] * (py - v0[1]) - ac[1] * (px - v0[0])) * inv_area
        gamma = 1.0 - alpha - beta
        return c, (e0, uv[0, 0] * alpha + uv[1, 0] * beta + uv[2, 0] * gamma)

    @jax.jit
    def run(pos, uvs):
        ph = jnp.concatenate([pos, jnp.ones(pos.shape[:-1] + (1,), pos.dtype)], axis=-1)
        proj = jnp.einsum("ij,tvj->tvi", m, ph, precision=jax.lax.Precision.HIGHEST)[..., :2]
        return proj, jax.lax.scan(step, 0, (proj, uvs))[1]

    proj_j, (e0_j, u_j) = run(pos, uvs)
    proj_j, e0_j, u_j = np.asarray(proj_j), np.asarray(e0_j), np.asarray(u_j)
    proj = composite.project2d(m, torch.from_numpy(pos))
    np.testing.assert_array_equal(proj.numpy(), proj_j)
    k = composite._tri_constants(proj, {"valid": torch.ones(t)})
    px = torch.arange(w, dtype=torch.float32)[None, :] + 0.5
    py = torch.arange(h, dtype=torch.float32)[:, None] + 0.5
    for i in range(t):
        e0 = (k[i, 0] * px + k[i, 1] * py) + k[i, 2]
        np.testing.assert_array_equal(e0.numpy(), e0_j[i])
        u = composite._step_uv(k[i], torch.from_numpy(uvs[i]), px.expand(h, w),
                               py.expand(h, w))[0]
        np.testing.assert_array_equal(u.numpy(), u_j[i])


def test_screen_to_world_and_screen_ray_match_jax():
    """Picking through the last frame's size and the inverse matrices."""
    rast, scene, assets = build_cube_scene(64, 48, device="cpu")
    rast.rasterize(scene, 64, 48, 40, assets)
    jr = jraster.Rasterizer.setup(None, rast.view_matrix, rast.projection_matrix)
    jr._last_size = (64, 48)
    for x, y in ((0.0, 0.0), (31.5, 20.25), (63.0, 47.0)):
        for z in (-1.0, 0.3, 1.0):
            np.testing.assert_allclose(rast.screen_to_world(x, y, z),
                                       jr.screen_to_world(x, y, z), rtol=1e-6, atol=1e-6)
        ray, ref = rast.screen_ray(x, y), jr.screen_ray(x, y)
        np.testing.assert_allclose(ray.origin, ref.origin, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ray.dir, ref.dir, rtol=1e-6, atol=1e-6)
        assert abs(float(np.linalg.norm(ray.dir)) - 1.0) < 1e-6

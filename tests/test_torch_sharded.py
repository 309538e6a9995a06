"""The row-sharded frame of rusterix_tpu_torch (parallel.render_frame_sharded,
Rasterizer.rasterize(mesh=)) on the CPU, and B1's and B2's row offset and
B1's generic light loop.

- The cube with its 2D rectangle and point light (the scene of
  tests/test_multichip.py) at 64x48 in 8 slabs, byte-equal to the JAX
  package's render_frame_sharded on its 8-device virtual CPU mesh (its XLA
  backend, jitted), both with the generic light loop (light_spec None).
- Against the port's own single frame: the early-out scene (a wall filling
  the frame over a floor of 84 quads, more than one super) at 64x128 in
  16-row slabs, heights that 8 does not divide (7 and 5 slabs too),
  light_spec None against the specialised frame, rasterize(mesh=) against
  rasterize(), with SSAA.
- The refusals that remain: dynamic batches and runtime shaders with a
  mesh too, and a mesh that is not a tuple of devices.

The kernels' new forms are held in tests/test_torch_sharded_kernels.py,
the feature scene in tests/test_torch_sharded_features.py.

Tolerances: the frames exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rusterix_tpu.ops import raster as jraster  # noqa: E402
from rusterix_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from rusterix_tpu.parallel.mesh import render_frame_sharded as jax_sharded  # noqa: E402
from rusterix_tpu_torch import Rasterizer  # noqa: E402
from rusterix_tpu_torch.models import (  # noqa: E402
    Assets,
    Batch2D,
    Batch3D,
    CullMode,
    D3FirstPCamera,
    D3OrbitCamera,
    Light,
    LightType,
    PixelSource,
    Scene,
    Texture,
    Tile,
)
from rusterix_tpu_torch.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu_torch.parallel import make_mesh, render_frame_sharded  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESH8 = make_mesh(8, device="cpu")


def _cube(width, height, tris=24):
    """tests/test_multichip.py's cube, built with the port -> (rast, scene,
    assets, packed)."""
    scene = Scene.from_static(
        [Batch2D.from_rectangle(2.0, 2.0, 30.0, 30.0).set_source(
            PixelSource.static_tile_index(0))],
        [Batch3D.from_box(-0.5, -0.5, -0.5, 1.0, 1.0, 1.0).set_cull_mode(CullMode.Off)
         .set_source(PixelSource.static_tile_index(0)).with_computed_normals()],
    ).set_lights([Light(LightType.Point).with_position([2.0, 0.8, 2.0]).with_intensity(1.0)
                   .compile()])
    assets = Assets.default().with_textures([Tile.from_texture(Texture.checkerboard(32, 8))])
    camera = D3OrbitCamera()
    camera.set_parameter_f32("distance", 1.6)
    rast = Rasterizer.setup(None, camera.view_matrix(), camera.projection_matrix(width, height),
                            device="cpu").ambient([0.15, 0.15, 0.2, 1.0])
    packed = PackedScene.from_scene(scene, assets, d3_capacity=tris, static_only=True)
    return rast, scene, assets, packed


def _sharded_args(rast):
    """The port's last frame's render_frame arguments as
    render_frame_sharded takes them (no reflection scale)."""
    return {k: v for k, v in rast.frame_args.items() if k != "refl_scale"}


def test_cube_sharded_matches_jax_sharded():
    """The cube in 8 slabs of 6 rows (its 2D rectangle, its point light,
    the generic light loop) against the JAX package's sharded frame, and
    against the port's single frame."""
    width, height = 64, 48
    rast, scene, assets, packed = _cube(width, height)
    single = rast.rasterize(scene, width, height, 40, assets, packed=packed)
    fa = _sharded_args(rast)
    assert fa["has_d2"] and fa["has_lights"] and fa["has_ambient"]
    out = render_frame_sharded(MESH8, **dict(fa, light_spec=None)).numpy()

    jr = jraster.Rasterizer.setup(None, rast.view_matrix, rast.projection_matrix).ambient(
        [0.15, 0.15, 0.2, 1.0])
    jr.use_pallas = False
    jr.rasterize(scene, width, height, 40, assets, packed=packed)
    cache = jr._scene_cache
    lights = dict(cache["packed"].lights)
    lights["flicker_factor"] = jr._flicker_factors(lights)
    uni = jr._uniforms(scene)
    atlas_w = cache["atlas"]["w"]
    mesh = jax_make_mesh(8)

    @jax.jit
    def jax_frame(d3, d2, lt, atlas, uniforms, background):
        return jax_sharded(mesh, d3, d2, lt, dict(atlas, w=atlas_w), uniforms, background,
                           width, height, sample_mode=0, has_ambient=True, has_lights=True,
                           has_d2=True)

    ref = np.asarray(jax_frame(
        cache["d3"], cache["d2"], {k: jnp.asarray(v) for k, v in lights.items()},
        {k: v for k, v in cache["atlas"].items() if k != "w"}, uni,
        jnp.zeros((height, width, 4), jnp.float32)))
    assert out.shape == ref.shape == (height, width, 4)
    assert (out[..., 3] > 0).sum() > width * height // 4
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, single)


def _early_out_scene(width, height):
    """tests/test_multichip.py's early-out scene, built with the port: one
    frustum-filling wall quad over a floor of 84 separate quads (more than
    one super of candidates), whose near bound grows toward the bottom
    rows: a near bound clipped to the wrong rows lets the early stop drop
    the floor in the lower slabs."""
    wall = Batch3D()
    wall.add_quad([0.0, 1.0, 4.05], [0.0, 0.0, -1.0], 14.0)
    floor = Batch3D()
    for gx in range(12):
        for gz in range(7):
            floor.add_quad([(gx - 5.5) * 0.5, 0.0, 0.5 + gz * 0.5], [0.0, 1.0, 0.0], 0.45)
    for b in (wall, floor):
        b.set_cull_mode(CullMode.Off)
        b.set_source(PixelSource.static_tile_index(0))
        b.with_computed_normals()
    scene = Scene.from_static([], [wall, floor])
    assets = Assets.default().with_textures([Tile.from_texture(Texture.checkerboard(32, 8))])
    camera = D3FirstPCamera()
    camera.set_parameter_vec3("position", [0.0, 1.0, 0.0])
    camera.set_parameter_vec3("center", [0.0, 1.0, 4.0])
    rast = Rasterizer.setup(None, camera.view_matrix(), camera.projection_matrix(width, height),
                            device="cpu").ambient([0.4, 0.4, 0.4, 1.0])
    return rast, scene, assets


def test_early_out_scene_keeps_the_lower_slabs_floor():
    """64x128 in 16-row slabs equals the single frame; the floor shows in
    the lower slabs (the slab's near bound clips to its own rows)."""
    width, height = 64, 128
    rast, scene, assets = _early_out_scene(width, height)
    single = rast.rasterize(scene, width, height, 40, assets)
    assert rast.frame_args["d3"]["valid"].shape[0] > 128
    sharded = rast.rasterize(scene, width, height, 40, assets, mesh=MESH8)
    np.testing.assert_array_equal(sharded, single)
    # the wall alone (no floor) differs in the lower rows
    rast_w, scene_w, assets_w = _early_out_scene(width, height)
    scene_w.d3_static = scene_w.d3_static[:1]
    wall_only = rast_w.rasterize(scene_w, width, height, 40, assets_w)
    assert (np.abs(wall_only[96:].astype(int) - single[96:]).max(-1) > 0).sum() > 100


@pytest.mark.parametrize("height,n", [(44, 8), (45, 7), (48, 5)])
def test_height_the_mesh_does_not_divide(height, n):
    """Each slab owns ceil(height / n) rows; the overhang renders the
    background and is cropped. The cube's 2D rectangle and its lights
    ride along."""
    width = 64
    rast, scene, assets, packed = _cube(width, height, tris=16)
    single = rast.rasterize(scene, width, height, 40, assets, packed=packed)
    out = render_frame_sharded(make_mesh(n, "cpu"), **_sharded_args(rast)).numpy()
    assert (-(-height // n)) * n != height
    np.testing.assert_array_equal(out, single)


def test_render_sharded_jit_closure_renders_the_sharded_frame():
    """render_sharded_jit: a closure over the mesh, the size and the
    settings (the JAX package jit-compiles it) that renders each frame's
    data as render_frame_sharded does."""
    from rusterix_tpu_torch.parallel import render_sharded_jit

    width, height = 64, 48
    rast, scene, assets, packed = _cube(width, height)
    single = rast.rasterize(scene, width, height, 40, assets, packed=packed)
    fa = rast.frame_args
    run = render_sharded_jit(MESH8, width, height, 0, has_ambient=True, has_lights=True,
                             has_d2=True, light_spec=fa["light_spec"])
    out = run(fa["d3"], fa["d2"], fa["lights"], fa["atlas"], fa["uniforms"], fa["background"])
    np.testing.assert_array_equal(out.numpy(), single)


def test_generic_light_loop_matches_the_specialised_frame():
    """light_spec None (B1's generic one-hot loop over every light row,
    dead rows included) gives the specialised frame's bytes, on the cube
    with five lights of every type and the sun."""
    width, height = 64, 48
    rast, scene, assets, _packed = _cube(width, height)
    scene.set_lights([
        Light(LightType.Point).with_position([2.0, 0.8, 2.0]).with_intensity(1.0).compile(),
        Light(LightType.Ambient).with_position([0, 2, 0]).with_intensity(0.3).compile(),
        Light(LightType.Spot).with_position([0, 3, 0]).with_intensity(1.5).compile(),
        Light(LightType.Area).with_position([-2, 2, 0]).with_intensity(0.8).compile(),
        Light(LightType.Daylight).with_position([0, 5, 0]).with_intensity(0.5).compile(),
    ])
    rast.sun_dir = np.array([0.4, -1.0, 0.2], np.float32)
    rast.day_factor = 0.8
    packed = PackedScene.from_scene(scene, assets, d3_capacity=24, static_only=True)
    single = rast.rasterize(scene, width, height, 40, assets, packed=packed)
    fa = _sharded_args(rast)
    assert len(fa["light_spec"]) == 5 and fa["lights"]["valid"].shape[0] > 5
    generic = render_frame_sharded(MESH8, **dict(fa, light_spec=None)).numpy()
    np.testing.assert_array_equal(generic, single)


def test_rasterize_with_a_mesh_matches_rasterize():
    """The public entry point, with 2x2 SSAA around the sharded frame."""
    width, height = 48, 32
    rast, scene, assets, packed = _cube(width, height)
    rast.set_supersample(2)
    single = rast.rasterize(scene, width, height, 40, assets, packed=packed)
    sharded = rast.rasterize(scene, width, height, 40, assets, packed=packed, mesh=MESH8)
    assert sharded.shape == (height, width, 4)
    np.testing.assert_array_equal(sharded, single)
    dev = rast.rasterize(scene, width, height, 40, assets, packed=packed, mesh=MESH8,
                         readback=False)
    assert isinstance(dev, torch.Tensor) and dev.shape == (height, width, 4)


@pytest.mark.parametrize("feature", ["dynamic batches", "runtime shaders"])
def test_mesh_renders_what_it_refused(feature):
    """Dynamic batches and runtime shaders, refused by name with a mesh
    until they were ported, render in 8 slabs as the single frame renders
    them: the dynamic pack concatenated after the static one before the
    slabs, and the split path (B2 over the whole frame's Morton order at
    each slab's row offset, shade_pass on its rows) on every slab. Equal
    byte for byte (the Morton order is the same on every slab, so no tie
    resolves otherwise); the mutation changes the frame where the cube's
    2D rectangle leaves it uncovered."""
    width, height = 64, 48
    rast, scene, assets, packed = _cube(width, height)
    before = rast.rasterize(scene, width, height, 40, assets, packed=packed)
    if feature == "dynamic batches":
        scene.d3_dynamic.append(Batch3D.from_box(-0.3, -0.3, 0.4, 0.6, 0.6, 0.6)
                                .set_source(PixelSource.pixel((40, 200, 90, 255))))
        scene.touch_dynamic()
    else:
        # what PackedScene.from_scene keeps of a shader that reads its
        # inputs (it cannot bake), on the cube's triangles
        from rusterix_tpu_torch.shader import Rusteria

        packed.runtime_shaders = (Rusteria.parse_and_compile(
            "fn shade() { color = color * vec3(0.5, 1.0, fract(hitpoint.y * 4.0)); }"),)
        packed.d3.shader[:] = 0
    single = rast.rasterize(scene, width, height, 40, assets, packed=packed)
    sharded = rast.rasterize(scene, width, height, 40, assets, packed=packed, mesh=MESH8)
    np.testing.assert_array_equal(sharded, single)
    assert int((single != before).any(-1).sum()) > 20


@pytest.mark.parametrize("feature", ["not a mesh"])
def test_what_a_mesh_still_refuses(feature):
    """A mesh that is not a tuple of devices is a TypeError (the one
    refusal left of this test's former cases)."""
    rast, scene, assets, packed = _cube(32, 32)
    with pytest.raises(TypeError, match="mesh="):
        rast.rasterize(scene, 32, 32, 40, assets, packed=packed, mesh=object())

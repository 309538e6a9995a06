"""The row-sharded frame of rusterix_tpu_torch with dynamic batches and
dynamic shadow casters, against the JAX package on the CPU.

V's kind of scene (scenes.build_map_dynamic_scene: an opaque and a
translucent entity billboard and a 2D rectangle, moved every frame by
scenes.move_dynamic, the opaque billboard casting into the cached shadow
maps) on a small floor under a point light and the sun, at 64x48 in 8
slabs through the port's `Rasterizer.rasterize(mesh=make_mesh(8, "cpu"))`,
against the JAX package's sharded frame of the same scene on its 8
virtual CPU devices: the JAX package's Rasterizer's mesh branch (its
ops/raster.py:1536-1591) concatenates the dynamic packs after the static
ones and composites the casters' depth into the static maps
(ops/shadow.composite_dynamic_depth) before it calls
parallel.mesh.render_frame_sharded; the test runs those steps in one
jitted function on the port's host packs (the static packs, the frame's
dynamic packs and the static bake, which equal the JAX package's) with the
JAX package's XLA backend, as tests/test_torch_sharded_features.py runs
it (un-jitted, shard_map dispatches op by op).

Tolerances: the port's sharded frame equals its single frame byte for
byte, at both move times. Against the JAX frame every pixel is within 1,
and the pixels that differ are counted and pinned (133 and 20 of 3,072):
all of them are pixels the 3D pass shades and a later pass (the 2D pass,
the translucent billboard's layer) composites over. The JAX package's XLA
backend composites those passes over its unquantized f32 opaque frame
(shade_pass, its parallel/mesh.py:253-262), its megakernel backend, which
the port follows, over B1's RGBA8 bytes (:250), as the reference's u8
tile buffer does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rusterix_tpu.ops.shadow import NO_OCCLUDER  # noqa: E402
from rusterix_tpu.ops.shadow import composite_dynamic_depth as jax_composite  # noqa: E402
from rusterix_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from rusterix_tpu.parallel.mesh import render_frame_sharded as jax_sharded  # noqa: E402
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
)
from rusterix_tpu_torch.ops.raster import _SCENE_CACHE, _SHADOW_CACHE  # noqa: E402
from rusterix_tpu_torch.ops.raster import (  # noqa: E402
    frame_inputs,
    render_frame,
    visibility_prepass,
)
from rusterix_tpu_torch.parallel import make_mesh  # noqa: E402
from rusterix_tpu_torch.scenes import move_dynamic  # noqa: E402

W, H = 64, 48
MESH8 = make_mesh(8, "cpu")
#: the move times of the two frames (scenes.move_dynamic)
TIMES = (0.5, 1.0)
#: pixels of each frame where the port's frame differs from the JAX
#: package's XLA-backend frame (by 1)
PINNED_XLA = (133, 20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    """A 12 x 10-unit floor around scenes.move_dynamic's billboards and 2D
    rectangle, a point light and the sun, with shadow maps and dynamic
    casters -> (rast, scene, assets)."""
    floor = (Batch3D.from_box(3.0, -0.2, 3.0, 12.0, 0.2, 10.0)
             .set_source(PixelSource.pixel((180, 170, 150, 255))).set_cull_mode(CullMode.Off)
             .with_computed_normals())
    scene = Scene.from_static([], [floor]).set_lights(
        [Light(LightType.Point).with_position([9.0, 3.0, 11.0]).with_intensity(1.6)
         .with_range(0.5, 20.0).compile()])
    move_dynamic(scene, 0.0)
    cam = D3OrbitCamera()
    cam.center = np.array([9.0, 0.5, 8.0], np.float32)
    cam.azimuth = 1.35
    cam.elevation = 0.5
    cam.set_parameter_f32("distance", 8.0)
    rast = Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(W, H), device="cpu")
    rast.ambient((0.15, 0.15, 0.18, 1.0)).background((40, 50, 70, 255))
    rast.sun_dir = np.array([0.4, -1.0, 0.25], np.float32)
    rast.day_factor = 1.0
    rast.set_shadows(True, res=32, sun_res=64)
    return rast, scene, Assets.default()


def _jax_frame_fn(fa):
    """The JAX package's sharded frame of the port's frame arguments `fa`:
    its mesh branch's concatenation and caster composite, then its
    render_frame_sharded, jitted -> f(static packs, dynamic packs, lights,
    atlas, uniforms, background, static shadow rows, shadow params, cams)."""
    mesh = jax_make_mesh(8)
    spec = fa["shadow_spec"]
    atlas_w = int(fa["atlas"]["w"])
    flags = {k: fa[k] for k in (
        "sample_mode", "has_ambient", "has_lights", "has_d2", "has_material", "brdf_ggx",
        "tonemap", "has_opacity", "transparency_layers", "has_fog", "has_sky", "ao_taps",
        "refl_samples", "sky_light", "preserve_transparency")}

    @jax.jit
    def frame(static, dyn, lights, atlas, uniforms, background, rows, params, cams):
        d3, d3_op, d2 = ({k: jnp.concatenate([s[k], d[k]]) for k in s}
                         for s, d in zip(static, dyn))
        dd = dyn[0]
        rows = jax_composite(rows, spec, cams, dd["pos"], dd["uv"], dd["nrm"], dd["valid"])
        return jax_sharded(mesh, d3, d2, lights, dict(atlas, w=atlas_w), uniforms, background,
                           W, H, use_pallas=False, d3_op=d3_op, shadow_rows=rows,
                           shadow_params=params, shadow_spec=spec, **flags)

    return frame


def _jax_inputs(fa, cache, bake):
    """The JAX frame function's inputs from the port's frame arguments, its
    scene cache entry (the static packs) and its static shadow bake."""
    def arrays(tensors):
        return {k: jnp.asarray(v.numpy()) for k, v in tensors.items()}

    static = tuple(cache[p] for p in ("d3", "d3_op", "d2"))
    dyn = tuple({k: v[cache[p]["valid"].shape[0]:] for k, v in fa[p].items()}
                for p in ("d3", "d3_op", "d2"))
    texels = fa["atlas"]["flat_u32"].numpy()
    atlas = {"flat": jnp.asarray(texels.view(np.uint8).reshape(-1, 4)),
             "flat_u32": jnp.asarray(texels.view(np.uint32)),
             **{k: jnp.asarray(fa["atlas"][k].numpy())
                for k in ("rects", "tile_first", "tile_count")}}
    rows = bake[0].numpy()
    rows = np.pad(rows, (0, -rows.size % 128), constant_values=NO_OCCLUDER)
    return (tuple(arrays(s) for s in static), tuple(arrays(d) for d in dyn),
            {k: jnp.asarray(v) for k, v in fa["lights"].items()}, atlas,
            {k: jnp.asarray(v) for k, v in fa["uniforms"].items()},
            jnp.asarray(fa["background"].numpy()), jnp.asarray(rows),
            jnp.asarray(fa["shadow_params"]), jnp.asarray(bake[3]))


@pytest.fixture(scope="module")
def frames():
    """-> [(port single frame, port sharded frame, JAX sharded frame, the
    port's frame arguments)] at the two move times."""
    rast, scene, assets = _scene()
    out, jax_fn = [], None
    for t in TIMES:
        move_dynamic(scene, t)
        single = rast.rasterize(scene, W, H, 40, assets)
        sharded = rast.rasterize(scene, W, H, 40, assets, mesh=MESH8)
        fa = rast.frame_args
        (cache,) = [v for k, v in _SCENE_CACHE.items() if k[0] == scene._cache_uid]
        (bake,) = [v for k, v in _SHADOW_CACHE.items() if k[0][0] == scene._cache_uid]
        jax_fn = jax_fn or _jax_frame_fn(fa)
        ref = np.asarray(jax_fn(*_jax_inputs(fa, cache, bake)))
        out.append((single, sharded, ref, {k: v for k, v in fa.items() if k != "refl_scale"}))
    return out


def test_scene_carries_dynamic_batches_and_casters(frames):
    for _single, _sharded, _ref, fa in frames:
        assert fa["has_opacity"] and fa["has_d2"] and fa["shadow_spec"] is not None
    # the billboards and the rectangle move between the two frames
    assert (frames[0][1] != frames[1][1]).any(-1).sum() > 100


def test_sharded_dynamic_frame_matches_the_single_frame(frames):
    for single, sharded, _ref, _fa in frames:
        np.testing.assert_array_equal(sharded, single)


@pytest.mark.parametrize("k", range(len(TIMES)))
def test_sharded_dynamic_frame_matches_jax_sharded(frames, k):
    _single, sharded, ref, fa = frames[k]
    d = np.abs(sharded.astype(int) - ref).max(-1)
    assert int(d.max()) <= 1 and int((d > 0).sum()) == PINNED_XLA[k]
    # the pinned pixels are pixels the 3D pass shades and a pass after it
    # (the 2D pass, the translucent billboard's layer) composites over
    shaded = visibility_prepass(frame_inputs(**fa), W, H)[2].numpy()
    opaque = render_frame(**dict(fa, has_d2=False, has_opacity=False)).numpy()
    composited = (opaque != sharded).any(-1)
    assert (shaded & composited)[d > 0].all()

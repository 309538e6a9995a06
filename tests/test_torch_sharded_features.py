"""The row-sharded frame of rusterix_tpu_torch with the feature family, on
the CPU.

- The feature scene of tests/test_multichip.py (a floor, a wall and a
  blocker under a point light and the sun; shadow maps with transmittance
  through a pane, AO, GGX, one reflection ray a pixel with shadowed hits,
  sky light, exp^2 fog and depth-peeled layers; the pane as a static
  opacity batch of a chunk, as the port refuses dynamic batches) at 64x48
  in 8 slabs, against the JAX package's render_frame_sharded on its
  8-device virtual CPU mesh, jitted, and against the port's single frame.
- The port's paths that the feature scene leaves out, sharded against the
  port's single frames at small sizes: the glazed map under the render
  graph's sky and fog with the scenevm tonemap (path I), the 2D map view
  (path N), the blended map with reflections (path L) and the material
  map (path Q), each cut to a few rooms.

The JAX frame is its XLA backend (use_pallas=False, jitted), as
tests/test_multichip.py runs it, on the port's own inputs (its packs and
its shadow bake, which equals the JAX package's texel for texel): the
JAX package's megakernel backend in interpret mode takes over a minute to
compile on one core. The port follows the megakernel path, and on this
frame the JAX package's two backends differ on 526 pixels by 1 (its XLA
shading fuses the lighting's products into FMAs by context).
tests/test_torch_sharded_backends.py holds that with the JAX package's
single frames of this scene: its two backends differ on those 526
pixels, and the port's sharded frame equals its megakernel frame but for
5 pixels of the reflection class (tests/test_torch_raster.py). So the
port's frame is not byte-equal to the JAX sharded frame here.

Tolerances: the port's sharded frame equals its single frame exactly;
against the JAX frame every pixel within 1 and the 526 pixels that differ
pinned, all of them pixels the 3D pass shades. The paths the feature
scene leaves out equal their single frames exactly but for the pixels of
one class, counted and pinned: where two candidates tie on 1/z bit for
bit, the slab's scan order (its supers sorted by the near bound over its
own rows, as in the JAX package) can keep another of them than the whole
frame's order does (chip_smoke.tie_pixels finds them).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rusterix_tpu.ops.shadow import NO_OCCLUDER  # noqa: E402
from rusterix_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from rusterix_tpu.parallel.mesh import render_frame_sharded as jax_sharded  # noqa: E402
from rusterix_tpu_torch.models import Assets  # noqa: E402
from rusterix_tpu_torch.ops.raster import frame_inputs, visibility_prepass  # noqa: E402
from rusterix_tpu_torch.ops.scene_pack import PackedScene  # noqa: E402
from chip_smoke import tie_pixels  # noqa: E402
from rusterix_tpu_torch.parallel import make_mesh, render_frame_sharded  # noqa: E402
from rusterix_tpu_torch.scenes import (  # noqa: E402
    build_feature_scene,
    build_map_2d_scene,
    build_map_blend_refl_scene,
    build_map_material_scene,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESH8 = make_mesh(8, device="cpu")
W, H = 64, 48
#: pixels of the feature scene where the port's frame differs from the JAX
#: package's XLA-backend frame (by 1): the JAX package's two backends
#: differ there
PINNED_XLA = 526


def _feature_scene(device="cpu"):
    """tests/test_multichip.py's feature scene with the pane in a chunk's
    opacity batches (scenes.build_feature_scene) -> (rast, scene)."""
    rast, scene, _assets = build_feature_scene(W, H, device=device)
    return rast, scene


def _jax_inputs(fa, packed):
    """The JAX package's render_frame_sharded inputs from the port's frame
    arguments: the same packs, lights, uniforms, background and shadow
    bake (the port's bake equals the JAX package's texel for texel,
    tests/test_torch_shadow.py), in the JAX package's layouts."""
    def arrays(tensors):
        return {k: jnp.asarray(v.numpy()) for k, v in tensors.items()}

    atlas_np = packed.atlas_index.atlas
    texels = np.ascontiguousarray(atlas_np.data.reshape(-1, 4))
    atlas = {"flat": jnp.asarray(texels), "flat_u32": jnp.asarray(texels.view(np.uint32)
                                                                  .reshape(-1)),
             "rects": jnp.asarray(atlas_np.rects), "tile_first": jnp.asarray(atlas_np.tile_first),
             "tile_count": jnp.asarray(atlas_np.tile_count)}
    rows = fa["shadow_rows"].numpy()
    rows = np.pad(rows, (0, -rows.size % 128), constant_values=NO_OCCLUDER).reshape(-1, 128)
    return (arrays(fa["d3"]), arrays(fa["d2"]),
            {k: jnp.asarray(v) for k, v in fa["lights"].items()}, atlas,
            {k: jnp.asarray(v) for k, v in fa["uniforms"].items()},
            jnp.asarray(fa["background"].numpy()), arrays(fa["d3_op"]), jnp.asarray(rows),
            jnp.asarray(fa["shadow_params"]))


@pytest.fixture(scope="module")
def feature():
    """-> (port single frame, port sharded frame, JAX sharded frame, the
    port's frame arguments, scene, assets, packed)."""
    rast, scene = _feature_scene()
    assets = Assets.default()
    packed = PackedScene.from_scene(scene, assets, static_only=True)
    single = rast.rasterize(scene, W, H, 40, assets, packed=packed)
    fa = {k: v for k, v in rast.frame_args.items() if k != "refl_scale"}
    sharded = render_frame_sharded(MESH8, **dict(fa, light_spec=None)).numpy()

    atlas_w = int(fa["atlas"]["w"])
    mesh = jax_make_mesh(8)
    flags = {k: fa[k] for k in (
        "sample_mode", "has_ambient", "has_lights", "has_d2", "has_material", "brdf_ggx",
        "tonemap", "has_opacity", "transparency_layers", "has_fog", "has_sky", "shadow_spec",
        "ao_taps", "refl_samples", "sky_light")}

    @jax.jit
    def jax_frame(d3, d2, lights, atlas, uniforms, background, d3_op, shadow_rows,
                  shadow_params):
        return jax_sharded(mesh, d3, d2, lights, dict(atlas, w=atlas_w), uniforms, background,
                           W, H, use_pallas=False, d3_op=d3_op, shadow_rows=shadow_rows,
                           shadow_params=shadow_params, **flags)

    ref = np.asarray(jax_frame(*_jax_inputs(fa, packed)))
    return single, sharded, ref, fa, scene, assets, packed


def test_feature_scene_exercises_the_family(feature):
    _single, _sharded, _ref, fa, _scene, _assets, _packed = feature
    assert fa["shadow_spec"] is not None and fa["ao_taps"] and fa["sky_light"]
    assert fa["refl_samples"] == 1 and fa["has_opacity"] and fa["has_fog"] and fa["brdf_ggx"]
    sun, cubes = fa["shadow_spec"]
    assert sun is not None and sun[2] >= 0 and cubes and cubes[0][3] >= 0  # transmittance


def test_feature_scene_sharded_matches_the_single_frame(feature):
    single, sharded, _ref, _fa, _scene, _assets, _packed = feature
    np.testing.assert_array_equal(sharded, single)


def test_feature_scene_sharded_matches_jax_sharded(feature):
    single, sharded, ref, fa, scene, assets, packed = feature
    d = np.abs(sharded.astype(int) - ref).max(-1)
    assert int(d.max()) <= 1 and int((d > 0).sum()) == PINNED_XLA
    # the pinned pixels are pixels the 3D pass shades
    shaded = visibility_prepass(frame_inputs(**fa), W, H)[2].numpy()
    assert shaded[d > 0].all()


def _sky(width, height):
    """The feature scene under the render graph's sky and fog at hour 14,
    with the scenevm tonemap, two layers and the editor's brush preview."""
    from rusterix_tpu_torch.ops.raster import BrushPreview
    from rusterix_tpu_torch.shapefx import ShapeFXGraph

    rast, scene = _feature_scene()
    rast.render_graph = ShapeFXGraph.default_render_graph(with_sky=True, with_fog=True)
    rast.hour = 14.0
    rast.transparency_layers = 2
    rast.set_tonemap("scenevm")
    rast.brush_preview = BrushPreview(np.array([0.5, -1.1, 0.5], np.float32), 1.5, 0.5)
    return rast, scene, Assets.default()


def _map_2d(width, height):
    return build_map_2d_scene(width, height, device="cpu", rooms_x=2, rooms_y=1)


def _blend_refl(width, height):
    return build_map_blend_refl_scene(width, height, device="cpu", rooms_x=2, rooms_y=1)


def _material(width, height):
    return build_map_material_scene(width, height, device="cpu", rooms_x=2, rooms_y=1)


#: each path's builder, the frame flag it must set and its pixels of the
#: tie class
PATHS = {"I sky": (_sky, "has_sky", 0), "N 2D view": (_map_2d, "has_d2", 0),
         "L blend reflections": (_blend_refl, "has_blend", 13),
         "Q materials": (_material, "has_matmap", 0)}


@pytest.mark.parametrize("path", list(PATHS))
def test_port_paths_sharded_match_single(path):
    """Each path at 64x48 in 8 slabs of 6 rows equals its single frame
    through rasterize(mesh=), but for the pinned pixels of the tie class."""
    build, flag, pinned = PATHS[path]
    rast, scene, assets = build(W, H)
    single = rast.rasterize(scene, W, H, 40, assets)
    assert rast.frame_args[flag]
    sharded = rast.rasterize(scene, W, H, 40, assets, mesh=MESH8)
    differ = np.abs(sharded.astype(int) - single).max(-1) > 0
    ties = tie_pixels(MESH8, **rast.frame_args).numpy()
    assert int(differ.sum()) == pinned and ties[differ].all()

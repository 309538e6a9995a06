"""Where the JAX package's two backends part on the feature scene of
tests/test_torch_sharded_features.py, on the CPU.

The port follows the JAX package's megakernel path, and its sharded frame
of the feature scene equals its single frame. The JAX package's
render_frame_sharded runs its XLA backend (use_pallas=False), and the
port's frame differs from that one on 526 pixels by 1. This file holds
where they come from, with the JAX package's single frames of the scene
(jitted, on the port's inputs): its megakernel backend (in interpret mode)
and its XLA backend, which equals its sharded XLA frame.

- The JAX package's two backends differ on 526 pixels, by 1 (its XLA
  shading fuses the lighting's products into FMAs by context).
- The port's sharded frame equals the JAX megakernel frame but for 5
  pixels, by 1, all of them pixels the reflections change (the class of
  tests/test_torch_raster.py's reflection map: grazing samples whose cast
  or hit flips on the last bit of XLA's cos/sin).
- Where the port's frame differs from the JAX XLA frame, the JAX package's
  megakernel frame differs from it too, but for pixels of those 5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from rusterix_tpu.ops import raster as jraster  # noqa: E402
from rusterix_tpu_torch.models import Assets  # noqa: E402
from rusterix_tpu_torch.ops.raster import frame_inputs, visibility_prepass  # noqa: E402
from rusterix_tpu_torch.ops.reflect import reflection_pass  # noqa: E402
from rusterix_tpu_torch.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu_torch.parallel import render_frame_sharded  # noqa: E402
from tests.test_torch_sharded_features import MESH8, PINNED_XLA, H, W, _feature_scene, _jax_inputs  # noqa: E402

#: pixels of the reflection class where the port's frame differs from the
#: JAX megakernel frame
PINNED_REFL = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """-> (the port's sharded frame, the JAX megakernel frame, the JAX XLA
    frame, the port's reflection mask)."""
    rast, scene = _feature_scene()
    assets = Assets.default()
    packed = PackedScene.from_scene(scene, assets, static_only=True)
    rast.rasterize(scene, W, H, 40, assets, packed=packed)
    fa = {k: v for k, v in rast.frame_args.items() if k != "refl_scale"}
    sharded = render_frame_sharded(MESH8, **fa).numpy()

    fi = frame_inputs(**fa)
    pre = visibility_prepass(fi, W, H)
    shadow = (fa["shadow_rows"], fa["shadow_params"], fa["shadow_spec"])
    _refl, rmask = reflection_pass(*pre, fi["attr"], fi["tri_id"], fa["d3"], fa["atlas"],
                                   fa["lights"], fa["uniforms"], W, H, fa["sample_mode"],
                                   fa["refl_samples"], shadow=shadow, has_blend=fa["has_blend"],
                                   has_material=fa["has_material"],
                                   has_matmap=fa["has_matmap"])

    d3, d2, lights, atlas, uniforms, background, d3_op, shadow_rows, shadow_params = (
        _jax_inputs(fa, packed))
    atlas_w = int(fa["atlas"]["w"])
    flags = {k: fa[k] for k in (
        "sample_mode", "has_ambient", "has_lights", "has_d2", "has_material", "brdf_ggx",
        "tonemap", "has_opacity", "transparency_layers", "has_fog", "has_sky", "shadow_spec",
        "ao_taps", "refl_samples", "sky_light", "light_spec")}
    out = {}
    for use_pallas in (True, False):
        @jax.jit
        def jax_frame(d3, d3_op, d2, lights, atlas, uniforms, background, shadow_rows,
                      shadow_params, use_pallas=use_pallas):
            return jraster.render_frame(
                d3, d3_op, d2, lights, dict(atlas, w=atlas_w), uniforms, background, W, H,
                use_pallas=use_pallas, shadow_rows=shadow_rows, shadow_params=shadow_params,
                **flags)

        out[use_pallas] = np.asarray(jax_frame(d3, d3_op, d2, lights, atlas, uniforms,
                                               background, shadow_rows, shadow_params))
    return sharded, out[True], out[False], rmask.numpy()


def _differ(a, b):
    d = np.abs(a.astype(int) - b.astype(int)).max(-1)
    assert int(d.max()) <= 1
    return d > 0


def test_jax_backends_differ_on_the_pinned_pixels(frames):
    _sharded, mega, xla, _rmask = frames
    assert int(_differ(mega, xla).sum()) == PINNED_XLA


def test_port_sharded_matches_jax_megakernel_frame(frames):
    sharded, mega, _xla, rmask = frames
    differ = _differ(sharded, mega)
    assert int(differ.sum()) == PINNED_REFL and rmask[differ].all()


def test_port_differs_from_jax_xla_where_jax_backends_differ(frames):
    sharded, mega, xla, _rmask = frames
    apart = _differ(sharded, xla) ^ _differ(mega, xla)
    assert (apart <= _differ(sharded, mega)).all()

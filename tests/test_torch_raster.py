"""The port's slice end to end: rusterix_tpu_torch.Rasterizer on the CPU
against the JAX Rasterizer's megakernel (use_pallas=True, interpret mode on
the CPU), on one shared PackedScene per scene; and every feature outside
the slice raising NotImplementedError.

Tolerance: frames within 1 per RGBA8 channel. Each test pins the count of
pixels that differ at all (measured: none, the two packages round every
visibility decision alike on these scenes).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench  # noqa: E402
from rusterix_tpu import (  # noqa: E402
    Assets,
    Batch3D,
    D3OrbitCamera,
    Light,
    LightType,
    PixelSource,
    Scene,
)
from rusterix_tpu.models.render_settings import RenderSettings  # noqa: E402
from rusterix_tpu.ops.raster import Rasterizer as JaxRasterizer  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu_torch import Rasterizer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LIGHT_SETS = {  # tests/test_shade_pallas.py
    "point": [Light(LightType.Point).with_position([2, 2, 2]).with_intensity(1.2)],
    "mixed": [
        Light(LightType.Point).with_position([2, 2, 2]).with_intensity(1.0),
        Light(LightType.Ambient).with_position([0, 2, 0]).with_intensity(0.3),
        Light(LightType.Spot).with_position([0, 3, 0]).with_intensity(1.5),
        Light(LightType.Area).with_position([-2, 2, 0]).with_intensity(0.8),
        Light(LightType.Daylight).with_position([0, 5, 0]).with_intensity(0.5),
    ],
}


def _both(jax_rast, scene, assets, width, height, configure):
    """Render one shared PackedScene through both packages -> int32 frames."""
    packed = PackedScene.from_scene(scene, assets, static_only=True)
    jax_rast.use_pallas = True
    configure(jax_rast)
    ref = jax_rast.rasterize(scene, width, height, 40, assets, packed=packed)
    port = Rasterizer.setup(None, jax_rast.view_matrix, jax_rast.projection_matrix,
                            device="cpu")
    configure(port)
    out = port.rasterize(scene, width, height, 40, assets, packed=packed)
    assert out.shape == (height, width, 4) and out.dtype == np.uint8
    return ref.astype(np.int32), out.astype(np.int32)


def _assert_close(ref, out, pinned_differing):
    diff = np.abs(ref - out)
    assert diff.max() <= 1
    assert int((diff.max(axis=-1) > 0).sum()) == pinned_differing


def test_map_frame_matches_jax_megakernel():
    w, h = 256, 128
    rast, scene, assets = bench.build_map_scene(w, h)
    ref, out = _both(rast, scene, assets, w, h, lambda r: r.ambient([0.25, 0.25, 0.3, 1.0]))
    assert (out[..., 3] > 0).sum() > w * h // 10  # the map covers the frame
    _assert_close(ref, out, 0)


def _box_scene(lights):
    batch = (
        Batch3D.from_box(-0.6, -0.6, -0.6, 1.2, 1.2, 1.2)
        .set_source(PixelSource.pixel((200, 150, 90, 255)))
        .with_computed_normals()
    )
    scene = Scene.from_static([], [batch]).set_lights([light.compile() for light in lights])
    cam = D3OrbitCamera()
    cam.azimuth = 0.8
    cam.set_parameter_f32("distance", 2.5)
    return scene, cam


@pytest.mark.parametrize("which,fog", [("point", False), ("mixed", False), ("mixed", True)])
def test_box_frame_matches_jax_megakernel(which, fog):
    w, h = 192, 96
    scene, cam = _box_scene(LIGHT_SETS[which])
    rast = JaxRasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(w, h))

    def configure(r):
        r.ambient((0.5, 0.6, 0.7, 1.0))
        r.sun_dir = np.array([0.4, -1.0, 0.2], np.float32)
        r.day_factor = 0.8
        if fog:
            r.apply_render_settings(RenderSettings(fog_density=0.08, fog_color=(0.9, 0.3, 0.2)))

    ref, out = _both(rast, scene, Assets.default(), w, h, configure)
    _assert_close(ref, out, 0)


# -------------------------------------------------- features outside the slice


def _small_scene():
    scene, cam = _box_scene(LIGHT_SETS["point"])
    rast = Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(32, 32),
                            device="cpu")
    return rast, scene


def _set(attr, value):
    def mutate(rast, scene, packed):
        setattr(rast, attr, value)
    return mutate


def _packed_field(part, field, value):
    def mutate(rast, scene, packed):
        getattr(getattr(packed, part), field)[0] = value
    return mutate


def _dynamic(rast, scene, packed):
    scene.d3_dynamic.append(Batch3D.from_box(0, 0, 0, 0.1, 0.1, 0.1))


def _shader(rast, scene, packed):
    scene.shaders.append(object())


UNPORTED = {
    "opacity batches": _packed_field("d3_opacity", "valid", 1.0),
    "2D batches": _packed_field("d2", "valid", 1.0),
    "dynamic batches": _dynamic,
    "shaders": _shader,
    "render-graph": _set("render_graph", object()),
    "brush preview": _set("brush_preview", object()),
    "shadows": _set("shadow_settings", {"res": 128}),
    "ambient occlusion": _set("ao_settings", {"samples": 4, "radius": 0.5}),
    "reflections": _set("reflection_samples", 1),
    "sky light": _set("sky_light_enabled", True),
    "GGX": _set("brdf", "ggx"),
    "scenevm tonemap": _set("tonemap", "scenevm"),
    "vertex blend": _packed_field("d3", "kind2", 1),
    "material": _packed_field("d3", "rough", 0.3),
    "matmap": _packed_field("d3", "m1_slot", 0),
    "SSAA": _set("supersample", 2),
}


@pytest.mark.parametrize("feature", list(UNPORTED))
def test_unported_feature_raises(feature):
    rast, scene = _small_scene()
    packed = PackedScene.from_scene(scene, Assets.default(), static_only=True)
    UNPORTED[feature](rast, scene, packed)
    with pytest.raises(NotImplementedError, match=feature):
        rast.rasterize(scene, 32, 32, 32, Assets.default(), packed=packed)


def test_mesh_argument_raises():
    rast, scene = _small_scene()
    with pytest.raises(NotImplementedError, match="mesh="):
        rast.rasterize(scene, 32, 32, 32, Assets.default(), mesh=object())


def test_cuda_is_never_replaced_by_the_cpu():
    """Asking for CUDA where there is none raises; nothing picks the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    scene, cam = _box_scene(LIGHT_SETS["point"])
    with pytest.raises(RuntimeError, match="cuda"):
        Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(32, 32))
    with pytest.raises(RuntimeError, match="cuda"):
        Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(32, 32), device="cuda")

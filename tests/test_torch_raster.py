"""The port's slice end to end: rusterix_tpu_torch.Rasterizer on the CPU
against the JAX Rasterizer's megakernel (use_pallas=True, interpret mode on
the CPU), on one shared PackedScene per scene; and every feature outside
the slice raising NotImplementedError.

Tolerance: frames within 1 per RGBA8 channel, except a pinned count of
pixels each test names and explains. Each test pins the count of pixels
that differ at all (the opaque frames: none, the two packages round every
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


def _both(jax_rast, scene, assets, width, height, configure=lambda r: None):
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


def _assert_close(ref, out, pinned_differing, pinned_beyond_one=0):
    diff = np.abs(ref - out).max(axis=-1)
    assert int((diff > 1).sum()) == pinned_beyond_one
    assert int((diff > 0).sum()) == pinned_differing


def test_map_frame_matches_jax_megakernel():
    w, h = 256, 128
    rast, scene, assets = bench.build_map_scene(w, h)
    ref, out = _both(rast, scene, assets, w, h, lambda r: r.ambient([0.25, 0.25, 0.3, 1.0]))
    assert (out[..., 3] > 0).sum() > w * h // 10  # the map covers the frame
    _assert_close(ref, out, 0)


def test_map_reflection_frame_matches_jax_megakernel():
    """The bench's map_1920x1080_ggx_refl1 configuration at 256x128: the
    sun, the GGX BRDF and one GGX reflection ray per pixel, through B1, the
    visibility pre-pass (B2) and the ray-intersect walk (B3).

    Pinned: 5 pixels differ, 4 of them by more than 1, all on one column
    where a wall is seen edge-on. There the GGX-sampled reflection
    direction lies within an ulp of the wall's plane (N.L ~ 0): XLA's CPU
    build and torch evaluate the sample's cos/sin (and a fused quotient) a
    last bit apart, so the ray is cast in one frame and not in the other,
    and the pixel takes the sky's reflection or keeps its opaque color. The
    opaque frame under the reflections, the pre-pass winners and the hits
    of identical rays are equal (test_torch_reflect.py)."""
    w, h = 256, 128
    rast, scene, assets = bench.build_map_refl_scene(w, h)

    def configure(r):
        r.ambient([0.25, 0.25, 0.3, 1.0])
        r.sun_dir = np.array([0.4, -1.0, 0.25], np.float32)
        r.sun_color = np.array([1.0, 1.0, 0.95], np.float32)
        r.day_factor = 1.0
        r.set_brdf("ggx").set_reflections(1)

    ref, out = _both(rast, scene, assets, w, h, configure)
    port = Rasterizer.setup(None, rast.view_matrix, rast.projection_matrix, device="cpu")
    configure(port)
    opaque = port.set_reflections(0).rasterize(scene, w, h, 40, assets).astype(np.int32)
    assert int((np.abs(out - opaque).max(axis=-1) > 1).sum()) > 2000  # walls reflect
    _assert_close(ref, out, 5, pinned_beyond_one=4)


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


def _shadows(rast, scene, packed):
    rast.set_shadows(True, res=16, sun_res=16)


def _shader(rast, scene, packed):
    scene.shaders.append(object())


def _reflect(*mutations):
    def mutate(rast, scene, packed):
        rast.set_reflections(1)
        for m in mutations:
            m(rast, scene, packed)
    return mutate


UNPORTED = {
    "2D batches": _packed_field("d2", "valid", 1.0),
    "dynamic batches": _dynamic,
    "shaders": _shader,
    "reflections with shadows": _reflect(_shadows, _dynamic),
    "vertex blend": _packed_field("d3", "kind2", 1),
    "material": _packed_field("d3", "rough", 0.3),
    "matmap": _packed_field("d3", "m1_slot", 0),
}


# shadows with reflections are ported; what of them is not (dynamic
# casters, which need dynamic batches) raises by its own name. Opacity
# batches, transparency layers, shadow transmittance, the render graph's
# sky and fog, the brush preview and the scenevm tonemap are ported (held
# against the JAX package in tests/test_torch_glass.py)
REFUSED_AS = {
    "reflections with shadows": "dynamic shadow casters",
}


@pytest.mark.parametrize("feature", list(UNPORTED))
def test_unported_feature_raises(feature):
    rast, scene = _small_scene()
    packed = PackedScene.from_scene(scene, Assets.default(), static_only=True)
    UNPORTED[feature](rast, scene, packed)
    with pytest.raises(NotImplementedError, match=REFUSED_AS.get(feature, feature)):
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

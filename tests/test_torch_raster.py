"""The port's slice end to end: rusterix_tpu_torch.Rasterizer on the CPU
against the JAX Rasterizer's megakernel (use_pallas=True, interpret mode on
the CPU), on one shared PackedScene per scene; and the features earlier
slices refused, each rendering.

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


# ------------------------------------------- features refused in earlier slices


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
    # what PackedScene.from_scene keeps of a shader that reads its inputs
    # (it cannot bake): a runtime shader
    from rusterix_tpu_torch.shader import Rusteria

    packed.runtime_shaders = (Rusteria.parse_and_compile("fn shade() { color = color * 0.5; }"),)


def _padding_field(part, field, value):
    def mutate(rast, scene, packed):
        getattr(getattr(packed, part), field)[-1] = value
    return mutate


def _reflect(*mutations):
    def mutate(rast, scene, packed):
        rast.set_reflections(1)
        for m in mutations:
            m(rast, scene, packed)
    return mutate


# refused until 2D batches, vertex blend and baked shaders' materials were
# ported: each mutation now renders, and is inert on the box (a zero-area
# padding triangle drawn in 2D; a second source mixed in with weight 0; a
# material or a matmap slot on a padding triangle, which turns B1's material
# variant on for triangles of the default material), so the frame equals the
# unmutated one (the 2D pass runs over the frame in f32 and re-quantizes
# it exactly; B1's blend branch mixes 0 of the second texel; the material
# math on roughness 0.5 and metallic 0 gives the default's albedo scales and
# Fresnel, and a specular power within the bytes). The passes themselves are
# held against the JAX package in tests/test_torch_d2.py,
# tests/test_torch_blend.py and tests/test_torch_material.py.
#
# refused until dynamic batches, dynamic shadow casters and runtime shaders
# were ported (they raised NotImplementedError by name): each now renders
# and is inert on the box as well. The dynamic box lies inside the box (its
# frame and, with shadows and reflections set up before both frames, its
# depth in the maps hide behind the box's own faces); the runtime shader
# is one that no triangle carries, so the frame takes the split path (B2
# over the Morton order, shade_pass, compose_opaque) and gives B1's bytes.
# Those paths are held against the JAX package in
# tests/test_torch_runtime_shader.py and tests/test_torch_dynamic.py.
FORMERLY_REFUSED = {
    "2D batches": (_packed_field("d2", "valid", 1.0), "has_d2"),
    "vertex blend": (_packed_field("d3", "kind2", 1), "has_blend"),
    "material": (_padding_field("d3", "rough", 0.3), "has_material"),
    "matmap": (_padding_field("d3", "m1_slot", 0), "has_matmap"),
    "dynamic batches": (_dynamic, lambda fa: int(fa["d3"]["valid"][-16:].sum()) == 12),
    "shaders": (_shader, "shaders"),
    "reflections with shadows": (_dynamic, lambda fa: fa["refl_samples"] == 1
                                 and fa["shadow_spec"] is not None, _reflect(_shadows)),
}


@pytest.mark.parametrize("feature", list(FORMERLY_REFUSED))
def test_formerly_refused_feature_renders(feature):
    rast, scene = _small_scene()
    packed = PackedScene.from_scene(scene, Assets.default(), static_only=True)
    mutate, flag, *setup = FORMERLY_REFUSED[feature]
    for m in setup:
        m(rast, scene, packed)
    before = rast.rasterize(scene, 32, 32, 32, Assets.default(), packed=packed)
    mutate(rast, scene, packed)
    after = rast.rasterize(scene, 32, 32, 32, Assets.default(), packed=packed)
    assert flag(rast.frame_args) if callable(flag) else rast.frame_args[flag]
    assert (before[..., 3] > 0).sum() > 100
    np.testing.assert_array_equal(after, before)


def test_mesh_argument_raises():
    """mesh= takes a tuple of torch devices (parallel.make_mesh); the
    row-sharded frame it selects is held in tests/test_torch_sharded*.py."""
    rast, scene = _small_scene()
    with pytest.raises(TypeError, match="mesh="):
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

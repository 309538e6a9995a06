"""B1's material variants in rusterix_tpu_torch against the JAX package on
the CPU: `has_material` (baked shaders' constant roughness and metallic) and
`has_matmap` (their per-pixel M1 / M2 sidecar tiles: emissive, roughness,
metallic, a written normal), and the constant-material cube's frame.

- Kernel level: `mega_render_reference` (the plain version of the kernel)
  against the JAX megakernel in interpret mode, on identical inputs: the
  port's own preparation of a frame (its setup pass, table, sort and
  parameter packs, `frame_inputs`) over the JAX package's pack with its
  bakes. Scenes: path O's wood cube under its point light and the sun with
  the fast BRDF (nearest texels) and with GGX (bilinear); two boxes under
  tests/test_matmap.py's per-pixel material shaders (emissive stripes, a
  written normal) at bump strength 1.0 and 0.5 (one compiled JAX kernel:
  the strength is a parameter); and two vertex-blended quads under a
  matmap shader, whose blend extension then starts at column 45. The
  port's pack_mega_table gives the JAX table column for column.
- Frame (one JAX frame): path O's cube at 96x64, rendered by the port from
  the JAX package's PackedScene (the one the kernel-level wood cases use).

Tolerances: RGBA8 exactly; z_eff exactly but on a pinned count of pixels
of the wood cube, where the JAX kernel in interpret mode evaluates the 1/z
plane with XLA's CPU FMAs and lands within 2 ulps (the class of
tests/test_torch_megakernel.py); the frame exactly. The specular power
exp2(shininess * log2(n.h)) goes through XLA's CPU exp2 and log2 in the
JAX kernel and torch's in the plain version; on these inputs no pixel
differs in RGBA8.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from rusterix_tpu import (  # noqa: E402
    Assets,
    Batch3D,
    CullMode,
    D3OrbitCamera,
    Light,
    LightType,
    PixelSource,
    Scene,
)
from rusterix_tpu.ops import megakernel as jm  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene as JaxPackedScene  # noqa: E402
from rusterix_tpu_torch import SampleMode  # noqa: E402
from rusterix_tpu_torch.ops import megakernel as tm  # noqa: E402
from rusterix_tpu_torch.ops.raster import Rasterizer, frame_inputs  # noqa: E402
from rusterix_tpu_torch.scenes import (  # noqa: E402
    EMISSIVE_VARYING,
    NORMAL_WRITER,
    build_cube_shaded_scene,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


QW, QH = 96, 64


POINT_LIGHT = Light(LightType.Point).with_position([2.0, 0.8, 1.0]).with_intensity(1.4)


def _wood_cube():
    """Path O's scene (bench.py's cube_shaded), built by the JAX package."""
    return bench.build_cube_shaded_scene(QW, QH)[1], 1.5


def _matmap_boxes():
    """Two boxes: emissive stripes with roughness and metallic varying over
    uv (shader 0), and a written normal (shader 1)."""
    boxes = [Batch3D.from_box(x, -0.4, -0.4, 0.8, 0.8, 0.8).set_cull_mode(CullMode.Off)
             .with_computed_normals().set_shader(i) for i, x in enumerate((-0.9, 0.1))]
    scene = Scene.from_static([], boxes).set_lights([POINT_LIGHT.compile()])
    scene.add_shader(EMISSIVE_VARYING)
    scene.add_shader(NORMAL_WRITER)
    return scene, 2.4


def _blended_quads():
    """tests/test_blend_render.py's quads (a weight gradient toward a green
    second source) under the matmap shaders."""
    quads = []
    for i, x0 in enumerate((-1.1, 0.1)):
        verts = np.array([[x0, -1, 0, 1], [x0 + 1, -1, 0, 1], [x0 + 1, 1, 0, 1], [x0, 1, 0, 1]],
                         np.float32)
        uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
        b = Batch3D.new(verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32), uvs)
        b.source2 = PixelSource.pixel((0, 255, 0, 255))
        b.blend_weights = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
        quads.append(b.set_cull_mode(CullMode.Off).with_computed_normals().set_shader(i))
    scene = Scene.from_static([], quads).set_lights([POINT_LIGHT.compile()])
    scene.add_shader(EMISSIVE_VARYING)
    scene.add_shader(NORMAL_WRITER)
    return scene, 2.5


#: pixels whose z_eff is within 2 ulps, not equal, of the JAX kernel's in
#: interpret mode
Z_ULP_PINNED = {"material_fast": 10, "material_ggx": 10, "matmap_bump_1": 0,
                "matmap_bump_0.5": 0, "matmap_blend": 0}
# scene, BRDF, bump strength, sample mode
CASES = {
    "material_fast": (_wood_cube, False, 1.0, 0),
    "material_ggx": (_wood_cube, True, 1.0, 1),
    "matmap_bump_1": (_matmap_boxes, False, 1.0, 0),
    "matmap_bump_0.5": (_matmap_boxes, False, 0.5, 0),
    "matmap_blend": (_blended_quads, False, 1.0, 0),
}


@functools.lru_cache(maxsize=None)
def _packed(make):
    """-> (scene, assets, camera distance, the JAX package's PackedScene),
    packed (and baked) once a module."""
    scene, distance = make()
    assets = Assets.default()
    return scene, assets, distance, JaxPackedScene.from_scene(scene, assets, static_only=True)


def _inputs(case):
    """The case's scene over the JAX package's pack, prepared by the port
    -> torch mega_render inputs (args, kwargs) and the port's frame_args."""
    make, ggx, bump, sample_mode = CASES[case]
    scene, assets, distance, packed = _packed(make)
    cam = D3OrbitCamera()
    cam.azimuth = 0.6
    cam.set_parameter_f32("distance", distance)
    rast = Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(QW, QH), device="cpu")
    rast.ambient((0.3, 0.3, 0.35, 1.0))
    rast.sun_dir, rast.day_factor = np.array([0.4, -1.0, 0.25], np.float32), 0.8
    rast._rs_bump_strength = bump
    rast.sample_mode = (SampleMode.Nearest, SampleMode.Linear)[sample_mode]
    if ggx:
        rast.set_brdf("ggx")
    rast.rasterize(scene, QW, QH, 32, assets, packed=packed)
    fa = rast.frame_args
    fi = frame_inputs(**fa)
    args, kwargs = list(fi["mega_args"][:9]), dict(fi["mega_kwargs"], sample_mode=sample_mode)
    assert fi["mega_args"][11] == sample_mode and kwargs["brdf_ggx"] == ggx
    return args, kwargs, (fi, fa)


@pytest.mark.parametrize("case", list(CASES))
def test_material_kernel_plain_version_matches_jax_interpret(case):
    args, kwargs, (fi, fa) = _inputs(case)
    flags = {k: kwargs[k] for k in ("has_blend", "has_material", "has_matmap")}
    assert flags["has_material"]
    assert flags["has_matmap"] == case.startswith("matmap")
    assert flags["has_blend"] == (case == "matmap_blend")
    # the table's layout: material 32-33, matmap 34-44, the blend from 45
    anim = int(fa["uniforms"]["anim_frame"])
    port_table = tm.pack_mega_table(fi["attr"], fi["tri_id"], fa["d3"], fa["atlas"], anim,
                                    **flags)
    want_cols = 32 + 2 + (11 if flags["has_matmap"] else 0) + (16 if flags["has_blend"] else 0)
    assert port_table.shape[1] == want_cols
    jd3 = {k: jnp.asarray(v.numpy()) for k, v in fa["d3"].items()}
    jatlas = {k: jnp.asarray(fa["atlas"][k].numpy()) for k in ("rects", "tile_first",
                                                                "tile_count")}
    table = jm.pack_mega_table(jnp.asarray(fi["attr"].numpy()), jnp.asarray(fi["tri_id"].numpy()),
                               jd3, jatlas, anim, **flags)
    np.testing.assert_array_equal(port_table.numpy(), np.asarray(table))

    ins = [jnp.asarray(a.numpy()) for a in args]
    ins[4] = jm.atlas_rows_i32(jax.lax.bitcast_convert_type(ins[4], jnp.uint32))
    jkw = {k: kwargs[k] for k in ("sample_mode", "light_spec", "sun_off", "brdf_ggx")}
    rgba, z = jm.mega_render(*ins, QW, QH, interpret=True, s_near=jnp.asarray(
        kwargs["s_near"].numpy()), **jkw, **flags)
    out, out_z = tm.mega_render_reference(*args, QW, QH, **kwargs)
    np.testing.assert_array_equal(out.numpy(), np.asarray(rgba))
    # z_eff: equal but where the interpret-mode kernel's 1/z plane takes
    # XLA's CPU FMAs (the class of tests/test_torch_megakernel.py)
    zd = out_z.numpy().view(np.int32).astype(np.int64) - np.asarray(z).view(np.int32)
    assert np.abs(zd).max() <= 2
    assert int((zd != 0).sum()) == Z_ULP_PINNED[case]
    # the variant does something: without it the frame differs
    plain, _ = tm.mega_render_reference(*args, QW, QH, **dict(kwargs, has_material=False,
                                                               has_matmap=False))
    covered = int((out_z.numpy() < 1.0).sum())
    assert covered > 500
    assert int((plain.numpy() != out.numpy()).sum()) > covered // 4


def test_matmap_needs_the_material_columns():
    args, kwargs, _f = _inputs("material_fast")
    with pytest.raises(ValueError, match="has_matmap implies has_material"):
        tm.mega_render(*args, QW, QH, **dict(kwargs, has_material=False, has_matmap=True))


def test_shaded_cube_frame_matches_jax():
    """Path O's cube at 96x64 from the JAX package's pack: the port's frame
    (its has_material B1 on the CPU) equals the JAX megakernel frame."""
    jr = bench.build_cube_shaded_scene(QW, QH)[0]
    jr.use_pallas = True  # the megakernel path, in interpret mode here
    jscene, jassets, _d, packed = _packed(_wood_cube)
    want = jr.rasterize(jscene, QW, QH, 32, jassets, packed=packed)
    rast, scene, assets = build_cube_shaded_scene(QW, QH, device="cpu")
    got = rast.rasterize(scene, QW, QH, 32, assets, packed=packed)
    assert rast.frame_args["has_material"] and not rast.frame_args["has_matmap"]
    np.testing.assert_array_equal(got, want)
    assert int((got[..., :3] != np.asarray(want)[0, 0, :3]).any(-1).sum()) > 1000

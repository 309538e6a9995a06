"""Pack-time shader bakes of rusterix_tpu_torch against the JAX package's on
the CPU (`ops/scene_pack.py`'s AtlasIndex.build through each package's
compiler), and the animated cube's frames.

- Bakes: path O's wood cube (one frame, the constant material), path P's
  time-shader cube (16 animation frames), the two per-pixel material
  shaders of tests/test_matmap.py (M1 / M2 sidecar tiles) and a shader
  that reads its input (it stays a runtime shader). The shader slots, the
  material slots, each bake's frame count and the runtime shaders are
  equal; the atlas bytes differ by at most 1, on a pinned count of bytes
  (the bakes' colours differ in the last bits where XLA fuses the shaders'
  `a*b + c` and its CPU sin and pow are not torch's, and a byte flips where
  a value lies at a rounding boundary of the u8 quantization).
- The input-reading shader (it cannot bake) renders as a runtime shader,
  equal to the JAX package's frame.
- Frames (one JAX scene): path P's cube at 96x64 at two animation frames,
  rendered by the port from the JAX package's PackedScene (so the bake's
  rounding stays out), equal to the JAX megakernel frames; the two frames
  differ.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench  # noqa: E402
import rusterix_tpu as jrt  # noqa: E402
import rusterix_tpu_torch as trt  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene as JaxPackedScene  # noqa: E402
from rusterix_tpu_torch.ops.scene_pack import SHADER_ANIM_FRAMES, PackedScene  # noqa: E402
from rusterix_tpu_torch.scenes import (  # noqa: E402
    EMISSIVE_VARYING,
    NORMAL_WRITER,
    build_cube_shaded_scene,
    build_cube_timeshader_scene,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HITPOINT_READER = """
fn shade() {
    color = vec3(fract(hitpoint.y), 0.3, 0.3);
}
"""


def _box_scene(pkg, shader_src):
    """tests/test_matmap.py's box under a shader, built by package `pkg`."""
    b = (pkg.Batch3D.from_box(-0.6, -0.6, -0.6, 1.2, 1.2, 1.2)
         .set_cull_mode(pkg.CullMode.Off).with_computed_normals().set_shader(0))
    scene = pkg.Scene.from_static([], [b])
    scene.add_shader(shader_src)
    return scene, pkg.Assets.default()


def _cube(jax_build, port_build):
    def build(pkg):
        if pkg is jrt:
            _r, scene, assets = jax_build(96, 64)
        else:
            _r, scene, assets = port_build(96, 64, device="cpu")
        return scene, assets
    return build


SCENES = {
    "wood": _cube(bench.build_cube_shaded_scene, build_cube_shaded_scene),
    "time_shader": _cube(bench.build_cube_timeshader_scene, build_cube_timeshader_scene),
    "emissive_varying": lambda pkg: _box_scene(pkg, EMISSIVE_VARYING),
    "normal_writer": lambda pkg: _box_scene(pkg, NORMAL_WRITER),
    "hitpoint_reader": lambda pkg: _box_scene(pkg, HITPOINT_READER),
}
# (bake frames, atlas bytes that differ by 1) per scene; None: no bake
EXPECTED = {
    "wood": (1, 0),
    "time_shader": (SHADER_ANIM_FRAMES, 1),
    "emissive_varying": (1, 0),
    "normal_writer": (1, 0),
    "hitpoint_reader": (None, 0),
}


@functools.lru_cache(maxsize=None)
def _jax_pack(name):
    """-> (JAX scene, its assets, its PackedScene), packed once a module."""
    jscene, jassets = SCENES[name](jrt)
    return jscene, jassets, JaxPackedScene.from_scene(jscene, jassets, static_only=True)


@pytest.mark.parametrize("name", list(SCENES))
def test_bake_matches_jax_pack(name):
    _jscene, _jassets, want = _jax_pack(name)
    tscene, tassets = SCENES[name](trt)
    got = PackedScene.from_scene(tscene, tassets, static_only=True, device="cpu")
    wi, gi = want.atlas_index, got.atlas_index
    assert gi.shader_slots == wi.shader_slots
    assert gi.shader_mat_slots.keys() == wi.shader_mat_slots.keys()
    for k, want_mat in wi.shader_mat_slots.items():
        np.testing.assert_allclose(gi.shader_mat_slots[k], want_mat, rtol=1e-6)
    assert len(got.runtime_shaders) == len(want.runtime_shaders)
    frames, n_diff = EXPECTED[name]
    if frames is None:
        assert gi.shader_slots == {} and len(got.runtime_shaders) == 1
    else:
        slot = gi.shader_slots[0][0]
        for tab in ("tile_first", "tile_count", "rects", "opaque"):
            np.testing.assert_array_equal(getattr(gi.atlas, tab), getattr(wi.atlas, tab))
        assert int(gi.atlas.tile_count[slot]) == frames
        assert got.runtime_shaders == ()
    d = np.abs(gi.atlas.data.astype(int) - wi.atlas.data.astype(int))
    assert d.max() <= 1
    assert int((d > 0).sum()) == n_diff
    for part in ("d3", "d3_opacity"):
        for field, arr in vars(getattr(want, part)).items():
            np.testing.assert_array_equal(getattr(getattr(got, part), field), arr,
                                          err_msg=f"{part}.{field}")


def test_input_reading_shader_renders_as_jax():
    """A shader that reads its inputs (the hit point) cannot bake, and was
    refused by name until runtime shaders were ported: it now runs at
    every frame (the split path) and the frame equals the JAX package's,
    each package on its own scene and compiler."""
    frames = []
    for pkg in (jrt, trt):
        scene, assets = _box_scene(pkg, HITPOINT_READER)
        cam = pkg.D3OrbitCamera()
        cam.set_parameter_f32("distance", 2.5)
        kw = {"device": "cpu"} if pkg is trt else {}
        rast = pkg.Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(32, 32), **kw)
        if pkg is jrt:
            rast.use_pallas = True  # its split path, B2 in interpret mode
        frames.append(rast.rasterize(scene, 32, 32, 32, assets))
    assert len(rast.frame_args["shaders"]) == 1
    np.testing.assert_array_equal(frames[1], frames[0])
    assert (frames[1][..., 3] > 0).sum() > 100


def test_animated_cube_frames_match_jax():
    """Path P's cube at two animation frames: the port's frames from the
    JAX package's pack equal the JAX megakernel frames, and differ from
    each other."""
    jr = bench.build_cube_timeshader_scene(96, 64)[0]
    jr.use_pallas = True  # the megakernel path, in interpret mode here
    jscene, jassets, packed = _jax_pack("time_shader")
    rast, scene, assets = build_cube_timeshader_scene(96, 64, device="cpu")
    frames = []
    for f in (2, 9):
        jscene.animation_frame = scene.animation_frame = f
        want = jr.rasterize(jscene, 96, 64, 32, jassets, packed=packed)
        got = rast.rasterize(scene, 96, 64, 32, assets, packed=packed)
        assert rast.frame_args["has_material"] and not rast.frame_args["has_matmap"]
        np.testing.assert_array_equal(got, want)
        frames.append(got.astype(int))
    assert int((np.abs(frames[0] - frames[1]).max(-1) > 0).sum()) > 500


GLASS_SHADER = "fn shade() { color = vec3(uv.x, 0.4, 0.8); opacity = 0.3 + 0.5 * uv.y; }"


def _glazed(pkg):
    """A floor, and a pane in the opacity pack (a chunk's opacity batch)
    under a baked shader that writes opacity, built by package `pkg`."""
    from importlib import import_module

    chunk = import_module(pkg.__name__ + ".builders.chunk").Chunk()
    floor = (pkg.Batch3D.from_box(-3.0, -0.1, -3.0, 6.0, 0.1, 6.0)
             .set_source(pkg.PixelSource.pixel((200, 200, 200, 255)))
             .set_cull_mode(pkg.CullMode.Off).with_computed_normals())
    chunk.batches3d_opacity = [pkg.Batch3D.from_box(-1.0, 0.0, -1.5, 0.05, 1.6, 3.0)
                               .set_cull_mode(pkg.CullMode.Off).with_computed_normals()
                               .set_shader(0)]
    scene = pkg.Scene.from_static([], [floor])
    scene.chunks[(0, 0)] = chunk
    scene.add_shader(GLASS_SHADER)
    return scene, pkg.Assets.default()


def test_opacity_batch_under_a_baked_shader_matches_jax():
    """An opacity batch under a baked shader (its alpha from the shader's
    opacity) is no runtime shader: both packages bake it, and the port's
    opacity layer (the plain visibility pass and `_shade_opacity`) on the
    JAX package's pack equals the JAX package's (its `_shade_opacity` with
    no runtime shaders), exactly; the port's frame renders it."""
    import jax.numpy as jnp

    from rusterix_tpu.ops import raster as jraster
    from rusterix_tpu.ops.setup_pass import setup_pass as jax_setup_pass
    from rusterix_tpu.ops.visibility import visibility_pass as jax_visibility_pass
    from rusterix_tpu_torch.ops import raster as traster
    from rusterix_tpu_torch.ops.raster import packed_to_torch
    from rusterix_tpu_torch.ops.setup_pass import setup_pass
    from rusterix_tpu_torch.ops.visibility import visibility_pass

    w, h = 64, 48
    jscene, jassets = _glazed(jrt)
    tscene, tassets = _glazed(trt)
    packed = JaxPackedScene.from_scene(jscene, jassets, static_only=True)
    got = PackedScene.from_scene(tscene, tassets, static_only=True, device="cpu")
    assert packed.runtime_shaders == () == got.runtime_shaders
    assert got.atlas_index.shader_slots == packed.atlas_index.shader_slots
    op_valid = packed.d3_opacity.valid > 0.5
    assert op_valid.any() and (packed.d3_opacity.tex_slot[op_valid] == 0).all()
    cam = trt.D3OrbitCamera()
    cam.set_parameter_f32("distance", 4.0)
    rast = trt.Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(w, h),
                                device="cpu")
    frame = rast.rasterize(tscene, w, h, 32, tassets, packed=packed)
    assert rast.frame_args["has_opacity"] and frame.shape == (h, w, 4)
    u = rast.frame_args["uniforms"]
    op = {k: jnp.asarray(v) for k, v in vars(packed.d3_opacity).items()}
    vis, attr, _bb, alive, tri = jax_setup_pass(
        op["pos"], op["uv"], op["nrm"], op["valid"], op["cull"], jnp.asarray(u["view"]),
        jnp.asarray(u["proj"]), w, h)
    z, idx, hit = jax_visibility_pass(vis, alive.astype(jnp.float32), w, h)
    atlas_np = packed.atlas_index.atlas
    jatlas = {"flat": jnp.asarray(atlas_np.data.reshape(-1, 4)),
              "w": jnp.int32(atlas_np.data.shape[1]), "rects": jnp.asarray(atlas_np.rects),
              "tile_first": jnp.asarray(atlas_np.tile_first),
              "tile_count": jnp.asarray(atlas_np.tile_count)}
    # op by op, as tests/test_torch_glass.py holds it (under jit XLA fuses the
    # sRGB round trip and a colour's last bit moves)
    jcol, _jz, _jt = jraster._shade_opacity(z, idx, hit, attr, tri, op, jatlas,
                                            {k: jnp.asarray(v) for k, v in u.items()}, w, h, 0)
    tp = packed_to_torch(packed, "cpu")
    d3_op = tp["d3_op"]
    tvis, tattr, _tbb, talive, ttri = setup_pass(
        d3_op["pos"], d3_op["uv"], d3_op["nrm"], d3_op["valid"], d3_op["cull"],
        torch.from_numpy(u["view"]), torch.from_numpy(u["proj"]), w, h)
    tz, tidx, thit = visibility_pass(tvis, talive.float(), w, h, chunk=64, plane_fma=True)
    tcol, _tz, _tt = traster._shade_opacity(tz, tidx, thit, tattr, ttri, d3_op, tp["atlas"],
                                            u, w, h, 0)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tcol.numpy(), np.asarray(jcol))
    alpha = tcol.numpy()[..., 3][thit.numpy()]
    assert thit.numpy().sum() > 50 and 0.2 < alpha.min() < alpha.max() < 0.9

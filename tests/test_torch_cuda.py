"""The CUDA kernels on the card: the megakernel (B1, both BRDFs, the
ambient-occlusion input, the profiling cuts), the visibility pre-pass
(B2), the ray intersect (B3) and its preparation kernel against their
plain torch versions on the same inputs (B1 also with shadow maps, their
transmittance layers, the scenevm tonemap and the has_blend variant, alone
and with the others), the whole CUDA frames (opaque, with GGX reflections
at full and half scale, with AO, with sky light, with SSAA, with shadows,
with shadowed reflections, the glazed map under the sky without and with
reflections, the blended map without and with reflections, the cube and
the 2D map views, the baked-shader paths O, P and Q) against the CPU
frames, B1's has_material and has_matmap variants, the shader bakes on the
card against the CPU's, B2 on the split path's Morton order (runtime
shaders), the split-path frames (T, U, W) and the dynamic-batch frame (V)
against the CPU frames, the port's map, cube and shaded-cube
examples, B3's preparation routes above the rank sort (the cluster route
and the global route) against rt_prepare and in path B's frame, the minigame frame and
the path tracer's buffer against the CPU's, the frame through the per-frame
arena against the per-leaf frame, the one host-to-device copy of path A's
steady frame, frame_breakdown on the card, and the huge scene's reflection
frame through B3's cluster preparation route; with two cards or more, each
kernel on the last card while cuda:0 is current against the same launch on
cuda:0, the frames of the sharded paths (R, S, the feature scene JA, I,
T8, V, M) over `card_mesh(2)` against the same slabs on one card and
`trace_sharded` over the cards against sequential traces; on one card, a
steady sharded frame of R, S, JA, I and T8 without a host synchronisation.

These tests need a GPU and skip with a reason elsewhere. They import no
jax, so they also run on a machine without it:

    RUSTERIX_TPU_TEST_PLATFORM=cuda python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: z_eff, the stage_cut outputs, the pre-pass's z and idx, the
preparation's boxes, tnear and slist and the ray intersect's t and idx
equal; RGBA8 within 1 per channel (the kernels and the plain versions
round alike, -fmad=false; only expf may differ in an ulp).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rusterix_tpu_torch import (  # noqa: E402
    Assets,
    Batch3D,
    D3OrbitCamera,
    Light,
    LightType,
    PixelSource,
    Rasterizer,
    SampleMode,
    Scene,
    Texture,
)
from rusterix_tpu_torch import _cuda  # noqa: E402
from rusterix_tpu_torch.models import CullMode, RenderSettings, Tile  # noqa: E402
from rusterix_tpu_torch.ops import megakernel, rt_kernel, visibility_pallas  # noqa: E402
from rusterix_tpu_torch.ops.matrices import look_at_rh, perspective_fov_rh_zo  # noqa: E402
from rusterix_tpu_torch.profiling import counters  # noqa: E402
from rusterix_tpu_torch.ops.raster import (  # noqa: E402
    ambient_occlusion,
    frame_inputs,
    visibility_prepass,
)
from rusterix_tpu_torch.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu_torch.ops.setup_pass import setup_pass  # noqa: E402
from rusterix_tpu_torch.scenes import (  # noqa: E402
    EMISSIVE_VARYING,
    build_cube_scene,
    build_cube_shaded_scene,
    build_cube_timeshader_scene,
    build_map_2d_scene,
    build_map_ao_scene,
    build_map_blend_refl_scene,
    build_map_blend_scene,
    build_map_glass_refl_scene,
    build_map_glass_scene,
    build_map_material_scene,
    build_map_refl_half_scene,
    build_map_refl_scene,
    build_map_scene,
    build_map_shadow_refl_scene,
    build_map_shadow_scene,
    build_map_ssaa2_scene,
    build_sky_light_scene,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 192, 96

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

CASES = [
    # (light set, sun, sample mode, fog, surface)
    ("point", True, 0, "off", "pixel"),
    ("mixed", True, 0, "off", "pixel"),
    ("mixed", False, 1, "linear", "texture"),
    ("point", False, 0, "exp2", "texture"),
    ("mixed", True, 1, "exp2", "texture"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _box_frame_args(lights, sun, sample_mode, fog, source):
    """The box scene's frame, rendered by the port on the CPU -> its
    render_frame arguments."""
    batch = Batch3D.from_box(-0.6, -0.6, -0.6, 1.2, 1.2, 1.2).with_computed_normals()
    assets = Assets.default()
    if source == "pixel":
        batch.set_source(PixelSource.pixel((200, 150, 90, 255)))
    else:
        tile = Tile.from_texture(Texture.checkerboard(16, 4))
        batch.set_source(PixelSource.static_tile_index(0))
        assets = assets.with_textures([tile])
    scene = Scene.from_static([], [batch]).set_lights(
        [light.compile() for light in LIGHT_SETS[lights]]
    )
    cam = D3OrbitCamera()
    cam.azimuth = 0.8
    cam.set_parameter_f32("distance", 2.5)
    rast = Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(W, H), device="cpu")
    rast.ambient((0.5, 0.6, 0.7, 1.0)).background((30, 40, 50, 255))
    rast.set_sample_mode(SampleMode(sample_mode))
    if sun:
        rast.sun_dir = np.array([0.4, -1.0, 0.2], np.float32)
        rast.day_factor = 0.8
    if fog == "exp2":
        rast.apply_render_settings(RenderSettings(fog_density=0.15, fog_color=(0.6, 0.5, 0.4)))
    elif fog == "linear":  # the ShapeFX Fog node's fade
        rast._rs_has_fog = True
        rast._fog_color = np.array([0.2, 0.3, 0.4, 1.0], np.float32)
        rast._fog_end, rast._fog_fade = 1.5, 2.0
    rast.rasterize(scene, W, H, 32, assets)
    return rast.frame_args


def _box_frame_inputs(lights, sun, sample_mode, fog, source):
    """The box scene's mega_render inputs, prepared by the port on the CPU."""
    fi = frame_inputs(**_box_frame_args(lights, sun, sample_mode, fog, source))
    return fi["mega_args"], fi["mega_kwargs"]


def _to(args, kwargs, device):
    def move(a):
        return a.to(device) if isinstance(a, torch.Tensor) else a

    return [move(a) for a in args], {k: move(v) for k, v in kwargs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("lights,sun,sample_mode,fog,source", CASES)
def test_kernel_matches_plain_version(cuda, lights, sun, sample_mode, fog, source):
    args, kwargs = _to(*_box_frame_inputs(lights, sun, sample_mode, fog, source), cuda)
    before = counters["b1.launch"]
    rgba, z = megakernel.mega_render(*args, **kwargs)
    ref_rgba, ref_z = megakernel.mega_render_reference(*args, **kwargs)
    torch.cuda.synchronize()
    assert counters["b1.launch"] == before + 1
    assert torch.equal(z, ref_z)
    diff = (megakernel.unpack_frame_u32(rgba).int() - megakernel.unpack_frame_u32(ref_rgba).int())
    assert int(diff.abs().max()) <= 1
    assert bool((z < 1.0).any()), "the box covers no pixel"


@pytest.mark.cuda
def test_cuda_frame_matches_cpu_frame(cuda):
    """The map through Rasterizer on the card and on the CPU."""
    frames = []
    for device in (cuda, "cpu"):
        rast, scene, assets = build_map_scene(256, 128, device=device)
        frames.append(rast.rasterize(scene, 256, 128, 40, assets).astype(np.int32))
    assert np.abs(frames[0] - frames[1]).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("lights,sun,sample_mode,fog,source", CASES[:2] + CASES[3:4])
def test_ggx_kernel_matches_plain_version(cuda, lights, sun, sample_mode, fog, source):
    """B1's brdf_ggx variant (Cook-Torrance, roughness 0.5, metallic 0)."""
    args, kwargs = _to(*_box_frame_inputs(lights, sun, sample_mode, fog, source), cuda)
    kwargs["brdf_ggx"] = True
    rgba, z = megakernel.mega_render(*args, **kwargs)
    ref_rgba, ref_z = megakernel.mega_render_reference(*args, **kwargs)
    fast_rgba, _ = megakernel.mega_render(*args, **dict(kwargs, brdf_ggx=False))
    torch.cuda.synchronize()
    assert torch.equal(z, ref_z)
    diff = (megakernel.unpack_frame_u32(rgba).int() - megakernel.unpack_frame_u32(ref_rgba).int())
    assert int(diff.abs().max()) <= 1
    assert not torch.equal(rgba, fast_rgba), "brdf_ggx changed nothing"


def _map_frame_inputs(width, height):
    """The procedural map's mega_render inputs at a size off the tile grid."""
    rast, scene, assets = build_map_scene(width, height, device="cpu")
    rast.rasterize(scene, width, height, 40, assets)
    fi = frame_inputs(**rast.frame_args)
    return fi["mega_args"], fi["mega_kwargs"]


@pytest.mark.cuda
@pytest.mark.parametrize("stage_cut", [1, 2])
@pytest.mark.parametrize("scene", ["box_192x96", "map_333x77"])
def test_stage_cut_kernel_matches_plain_version(cuda, scene, stage_cut):
    """The profiling cuts (the scan's winners; the quantized texel), both
    outputs equal, at a small size and at one off the 64x128 tile grid."""
    if scene == "box_192x96":
        inputs = _box_frame_inputs("mixed", True, 1, "off", "texture")
    else:
        inputs = _map_frame_inputs(333, 77)
    args, kwargs = _to(*inputs, cuda)
    out = megakernel.mega_render(*args, **kwargs, stage_cut=stage_cut)
    ref = megakernel.mega_render_reference(*args, **kwargs, stage_cut=stage_cut)
    full = megakernel.mega_render(*args, **kwargs)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert not torch.equal(out[0], full[0]), "the cut changed nothing"
    if stage_cut == 1:
        assert bool((out[0] >= 0).any()), "no pixel has a winner"


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_map_off_the_tile_grid(cuda):
    """A 64x128 tile shared by the blocks of a cluster: the same frame, bit
    for bit in z_eff, on the map at a size off the tile grid (early stops
    and tiles cut by the frame's edge included)."""
    args, kwargs = _to(*_map_frame_inputs(333, 77), cuda)
    rgba, z = megakernel.mega_render(*args, **kwargs)
    ref_rgba, ref_z = megakernel.mega_render_reference(*args, **kwargs)
    torch.cuda.synchronize()
    assert torch.equal(z, ref_z)
    diff = (megakernel.unpack_frame_u32(rgba).int() - megakernel.unpack_frame_u32(ref_rgba).int())
    assert int(diff.abs().max()) <= 1
    assert bool((z < 1.0).any())


def _random_candidates(seed, n, width, height):
    """n random world triangles in front of an orbit camera through the
    port's setup pass -> (vis_planes, alive, bbox) on the CPU."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    pos = np.stack([a, a + rng.uniform(-0.4, 0.4, (n, 3)), a + rng.uniform(-0.4, 0.4, (n, 3))], 1)
    pos = np.concatenate([pos, np.ones((n, 3, 1))], axis=2).astype(np.float32)
    cam = D3OrbitCamera()
    cam.azimuth = 0.6
    cam.set_parameter_f32("distance", 4.0)
    vis, _attr, bbox, alive, _tid = setup_pass(
        torch.from_numpy(pos), torch.zeros((n, 3, 2)), torch.zeros((n, 3, 3)),
        torch.ones(n), torch.zeros(n, dtype=torch.int32),
        torch.from_numpy(np.asarray(cam.view_matrix(), np.float32)),
        torch.from_numpy(np.asarray(cam.projection_matrix(width, height), np.float32)),
        width, height,
    )
    return vis, alive.float(), bbox


@pytest.mark.cuda
@pytest.mark.parametrize("width,height", [(192, 96), (333, 77)])
def test_visibility_kernel_matches_plain_version(cuda, width, height):
    """B2 on random triangles, at sizes off the 64x128 tile grid."""
    vis, alive, bbox = (t.to(cuda) for t in _random_candidates(3, 700, width, height))
    before = counters["b2.launch"]
    z, idx, hit = visibility_pallas.visibility_pass_pallas(vis, alive, bbox, width, height)
    z_p, idx_p, hit_p = visibility_pallas.visibility_pass_pallas_reference(
        vis, alive, bbox, width, height)
    torch.cuda.synchronize()
    assert counters["b2.launch"] == before + 1
    assert torch.equal(idx, idx_p) and torch.equal(hit, hit_p)
    assert torch.equal(z, z_p)
    assert int(hit.sum()) > width * height // 20


#: the most cells rt_prepare_kernel takes (RT_MAX_CELLS in csrc/rt_kernel.cu)
RANK_MAX_CELLS = 28672


def _random_rays(seed, tcount, height, width, parked=0.0):
    """Random triangles (T, 3, 4) and unit rays (o, d each (3, H, W)), a
    `parked` share of them parked at 1e8 with direction (0, -1, 0)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-10, 10, (tcount, 3)).astype(np.float32)
    pos = np.stack([a, a + rng.uniform(-1.5, 1.5, (tcount, 3)),
                    a + rng.uniform(-1.5, 1.5, (tcount, 3))], axis=1)
    pos = np.concatenate([pos, np.ones((tcount, 3, 1))], axis=2).astype(np.float32)
    valid = (rng.uniform(size=tcount) > 0.2).astype(np.float32)
    o = rng.uniform(-8, 8, (3, height, width)).astype(np.float32)
    d = rng.normal(size=(3, height, width)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    dead = rng.uniform(size=(height, width)) < parked
    o[:, dead] = 1e8
    d[:, dead] = np.array([0.0, -1.0, 0.0], np.float32)[:, None]
    return pos, valid, o, d


@pytest.mark.cuda
@pytest.mark.parametrize("tcount,height,width,parked", [
    (300, 24, 40, 0.0),     # 5 cells with a dead tail, one partial block
    (2048, 67, 300, 0.5),   # 32 cells, ragged blocks, half the rays parked
])
def test_ray_intersect_kernel_matches_plain_version(cuda, tcount, height, width, parked):
    """B3 on random scenes: the same walk, the same hits, bit for bit."""
    pos, valid, o, d = _random_rays(11, tcount, height, width, parked)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (pos, valid, *o, *d)]
    before = (counters["b3.walk_launch"], counters["b3.prepare.rank"])
    t, idx = rt_kernel.intersect_rays_pallas(*args, 25.0, height, width)
    t_p, idx_p = rt_kernel.intersect_rays_pallas_reference(*args, 25.0, height, width)
    torch.cuda.synchronize()
    assert (counters["b3.walk_launch"], counters["b3.prepare.rank"]) == (before[0] + 1,
                                                                         before[1] + 1)
    assert torch.equal(idx, idx_p)
    assert torch.equal(t, t_p)
    assert int((idx >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tcount,height,width,parked", [
    (300, 24, 40, 0.0),     # 5 cells with a dead tail, one partial block
    (2048, 67, 300, 0.5),   # 32 cells, ragged blocks, half the rays parked
    (40000, 19, 150, 0.2),  # 625 cells: the rank sort past one warp of keys
])
def test_preparation_kernel_matches_rt_prepare(cuda, monkeypatch, tcount, height, width, parked):
    """The blocks' boxes, the keys and their stable sort, bit for bit, with
    NaN values among the rays (skipped by the boxes); rt_prepare_kernel at
    every size here, whatever the routing limit."""
    monkeypatch.setattr(rt_kernel, "PREPARE_MAX_CELLS", RANK_MAX_CELLS)
    pos, valid, o, d = _random_rays(13, tcount, height, width, parked)
    o[1, 3, 7] = np.nan
    d[2, height - 1, width - 1] = np.nan
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (pos, valid, *o, *d)]
    before = counters["b3.prepare.rank"]
    prep = rt_kernel.rt_prepare_cuda(*args, 25.0, height, width)
    ref = rt_kernel.rt_prepare(*args, 25.0, height, width)
    torch.cuda.synchronize()
    assert counters["b3.prepare.rank"] == before + 1
    for key in ("boxes", "tnear", "slist", "tab", "cbox", "tcap"):
        assert torch.equal(prep[key], ref[key]), key
    assert bool((prep["tnear"] < 3e37).any())


@pytest.mark.cuda
@pytest.mark.parametrize("ncells", [2048, 6200])
def test_large_scene_prepares_through_the_kernel(cuda, monkeypatch, ncells):
    """Scenes of thousands of cells (16 KB of keys, and 48 KB and more, which
    a block has to opt in to) through rt_prepare_kernel, with the routing
    limit at the kernel's own: the same shortlist and the same hits."""
    monkeypatch.setattr(rt_kernel, "PREPARE_MAX_CELLS", RANK_MAX_CELLS)
    tcount, height, width = 64 * ncells, 8, 128
    pos, valid, o, d = _random_rays(17, tcount, height, width)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (pos, valid, *o, *d)]
    before = (counters["b3.walk_launch"], counters["b3.prepare.rank"])
    prep = rt_kernel.rt_prepare_cuda(*args, 25.0, height, width)
    ref = rt_kernel.rt_prepare(*args, 25.0, height, width)
    t, idx = rt_kernel.intersect_rays_pallas(*args, 25.0, height, width)
    t_p, idx_p = rt_kernel.intersect_rays_pallas_reference(*args, 25.0, height, width)
    torch.cuda.synchronize()
    assert (counters["b3.walk_launch"], counters["b3.prepare.rank"]) == (before[0] + 1,
                                                                         before[1] + 2)
    for key in ("boxes", "tnear", "slist"):
        assert torch.equal(prep[key], ref[key]), key
    assert torch.equal(idx, idx_p) and torch.equal(t, t_p)
    assert int((idx >= 0).sum()) > 0


def _sparse_scene(seed, height, width):
    """512 compact cells, 64 small triangles around each node of an 8x8x8
    grid, and per 8x128 ray block a narrow cone of rays from outside the
    grid: most cells a block visits lie beside its cone, so no ray enters
    them and they are not tested."""
    rng = np.random.default_rng(seed)
    node = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
    centre = (node * 2.5 - 8.75).astype(np.float32)
    a = (np.repeat(centre, 64, axis=0) + rng.uniform(-0.5, 0.5, (512 * 64, 3))).astype(np.float32)
    pos = np.stack([a, a + rng.uniform(-0.3, 0.3, a.shape), a + rng.uniform(-0.3, 0.3, a.shape)], 1)
    pos = np.concatenate([pos, np.ones((len(a), 3, 1))], axis=2).astype(np.float32)
    nby, nbx = -(-height // 8), -(-width // 128)
    axis = rng.normal(size=(nby, nbx, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    axis = np.repeat(np.repeat(axis, 8, 0), 128, 1)[:height, :width]
    d = axis + rng.uniform(-0.05, 0.05, axis.shape)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -14.0 * axis + rng.uniform(-0.2, 0.2, axis.shape)
    def to32(x):
        return np.ascontiguousarray(np.moveaxis(x, -1, 0), np.float32)

    return pos, np.ones(len(a), np.float32), to32(o), to32(d)


@pytest.mark.cuda
def test_ray_intersect_kernel_on_visited_cells_it_does_not_test(cuda):
    """A sparse scene with coherent rays: the walk visits many cells whose
    box no ray enters, so their prefetched triangles are never read, and the
    cells it does test still give the plain version's hits bit for bit."""
    height, width = 40, 300
    pos, valid, o, d = _sparse_scene(19, height, width)
    args = [torch.from_numpy(a).to(cuda) for a in (pos, valid, *o, *d)]
    t, idx = rt_kernel.intersect_rays_pallas(*args, 60.0, height, width)
    t_p, idx_p, work = rt_kernel.intersect_rays_pallas_reference(
        *args, 60.0, height, width, return_work=True)
    torch.cuda.synchronize()
    visited = work["ray_box"] // (rt_kernel.RT_BH * rt_kernel.RT_BW)
    tested = work["ray_triangle"] // (rt_kernel.RT_BH * rt_kernel.RT_BW * rt_kernel.RT_CELL)
    assert visited > 4 * tested > 0, (visited, tested)
    assert torch.equal(idx, idx_p) and torch.equal(t, t_p)
    assert int((idx >= 0).sum()) > 0


@pytest.mark.cuda
def test_cuda_reflection_frame_matches_cpu_frame(cuda):
    """The map with the sun, GGX and one reflection ray per pixel, through
    Rasterizer on the card (B1, B2, B3) and on the CPU (plain versions)."""
    frames = []
    counts = (counters["b1.launch"], counters["b2.launch"], counters["b3.walk_launch"])
    for device in (cuda, "cpu"):
        rast, scene, assets = build_map_refl_scene(192, 96, device=device)
        frames.append(rast.rasterize(scene, 192, 96, 40, assets).astype(np.int32))
    after = (counters["b1.launch"], counters["b2.launch"], counters["b3.walk_launch"])
    assert all(b > a for a, b in zip(counts, after))
    assert np.abs(frames[0] - frames[1]).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", [f"box{i}" for i in range(len(CASES))] + ["map_333x77"])
def test_ao_kernel_matches_plain_version(cuda, case):
    """B1's ao_img variant (an (H, W) factor on the two ambient terms) on
    the box cases and on the map at a size off the 64x128 tile grid, with a
    factor drawn from a seed."""
    if case == "map_333x77":
        (args, kwargs), (width, height) = _map_frame_inputs(333, 77), (333, 77)
    else:
        (args, kwargs), (width, height) = _box_frame_inputs(*CASES[int(case[3:])]), (W, H)
    rng = np.random.default_rng(len(case) + width)
    ao = torch.from_numpy(rng.uniform(0.2, 1.0, (height, width)).astype(np.float32))
    args, kwargs = _to(args, dict(kwargs, ao_img=ao), cuda)
    before = counters["b1.launch"]
    rgba, z = megakernel.mega_render(*args, **kwargs)
    ref_rgba, ref_z = megakernel.mega_render_reference(*args, **kwargs)
    plain, _ = megakernel.mega_render(*args, **dict(kwargs, ao_img=None))
    torch.cuda.synchronize()
    assert counters["b1.launch"] == before + 2
    assert torch.equal(z, ref_z)
    diff = (megakernel.unpack_frame_u32(rgba).int() - megakernel.unpack_frame_u32(ref_rgba).int())
    assert int(diff.abs().max()) <= 1
    assert not torch.equal(rgba, plain), "ao_img changed nothing"


@pytest.mark.cuda
@pytest.mark.parametrize("build,width,height", [
    (build_map_ao_scene, 256, 128),
    (build_sky_light_scene, 256, 128),
    (build_map_refl_half_scene, 256, 128),
    (build_map_ssaa2_scene, 128, 64),
    (build_map_shadow_scene, 256, 128),
    (build_map_shadow_refl_scene, 256, 128),
    (build_map_blend_scene, 256, 128),
    (build_map_blend_refl_scene, 256, 128),
    (build_cube_scene, 160, 120),
    (build_map_2d_scene, 256, 128),
], ids=["ao", "sky_light", "refl_half", "ssaa2", "shadow", "shadow_refl", "blend",
        "blend_refl", "cube", "map_2d"])
def test_cuda_frame_of_a_later_path_matches_cpu_frame(cuda, build, width, height):
    """The AO map, the sky-light scene, the half-scale reflection map, the
    SSAA2 map, the shadowed maps (without and with GGX reflections), the
    blended map (without and with GGX reflections), the cube and the 2D map
    view through Rasterizer on the card and on the CPU."""
    frames = []
    for device in (cuda, "cpu"):
        rast, scene, assets = build(width, height, device=device)
        frames.append(rast.rasterize(scene, width, height, 40, assets).astype(np.int32))
    assert frames[0].shape == (height, width, 4)
    assert np.abs(frames[0] - frames[1]).max() <= 1


def _room_shadow_inputs():
    """tests/test_shadow_render.py's room (a floor, a wall, a point light)
    with the bench sun and shadow maps at set_shadows' defaults, rendered on
    the CPU -> B1's inputs, the bake among them."""
    floor = (Batch3D.from_box(-5.0, -0.1, -5.0, 10.0, 0.1, 10.0)
             .set_source(PixelSource.pixel((200, 200, 200, 255)))
             .set_cull_mode(CullMode.Off).with_computed_normals())
    wall = (Batch3D.from_box(2.0, 0.0, -2.0, 0.2, 2.0, 4.0)
            .set_source(PixelSource.pixel((150, 100, 80, 255)))
            .set_cull_mode(CullMode.Off).with_computed_normals())
    light = (Light(LightType.Point).with_position([0.0, 1.2, 0.0]).with_intensity(1.5)
             .with_color([1.0, 1.0, 1.0]).with_range(0.5, 30.0))
    scene = Scene.from_static([], [floor, wall]).set_lights([light.compile()])
    view = look_at_rh(np.array([0.0, 9.0, 5.0], np.float32), np.array([1.5, 0.0, 0.0], np.float32),
                      np.array([0.0, 1.0, 0.0], np.float32))
    rast = Rasterizer.setup(None, view, perspective_fov_rh_zo(1.2, 128.0, 96.0, 0.1, 100.0),
                            device="cpu")
    rast.background((10, 10, 10, 255)).ambient([0.12, 0.12, 0.12, 1.0])
    rast.sun_dir, rast.day_factor = np.array([0.6, -1.0, 0.0], np.float32), 1.0
    rast.set_shadows(True).rasterize(scene, 128, 96, 32, Assets.default())
    fi = frame_inputs(**rast.frame_args)
    return fi["mega_args"], fi["mega_kwargs"]


def _map_shadow_inputs(width, height):
    """The shadowed map's (path G's scene) B1 inputs at a small size."""
    rast, scene, assets = build_map_shadow_scene(width, height, device="cpu")
    rast.rasterize(scene, width, height, 40, assets)
    fi = frame_inputs(**rast.frame_args)
    return fi["mega_args"], fi["mega_kwargs"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["room", "map_256x128"])
def test_shadow_kernel_matches_plain_version(cuda, case):
    """B1's shadow variant (the point light's cube map and the sun's map on
    the room; four cube maps and the sun's on the map), z_eff and RGBA8 bit
    for bit against the plain version on the same inputs."""
    inputs = _room_shadow_inputs() if case == "room" else _map_shadow_inputs(256, 128)
    args, kwargs = _to(*inputs, cuda)
    assert kwargs["shadow_rows"].is_cuda and kwargs["shadow_spec"][0] is not None
    rgba, z = megakernel.mega_render(*args, **kwargs)
    ref_rgba, ref_z = megakernel.mega_render_reference(*args, **kwargs)
    plain, _ = megakernel.mega_render(*args, **dict(kwargs, shadow_rows=None, shadow_spec=None))
    torch.cuda.synchronize()
    assert torch.equal(z, ref_z)
    assert torch.equal(rgba, ref_rgba)
    if case == "room":
        assert int((rgba != plain).sum()) > 300, "the maps shadowed nothing"


def _glass_inputs(width, height, device):
    """Path I's B1 inputs (the glazed map under the sky: shadow maps with
    transmittance layers, the scenevm tonemap) at width x height, rendered
    on `device`."""
    rast, scene, assets = build_map_glass_scene(width, height, device=device)
    rast.rasterize(scene, width, height, 40, assets)
    fi = frame_inputs(**rast.frame_args)
    return fi["mega_args"], fi["mega_kwargs"]


@pytest.mark.cuda
@pytest.mark.parametrize("width,height", [(256, 128), (1920, 1080)])
def test_glass_kernel_matches_plain_version(cuda, width, height):
    """B1's transmittance and tonemap variants on path I's inputs, z_eff and
    RGBA8 bit for bit against the plain version; each variant changes the
    frame."""
    args, kwargs = _glass_inputs(width, height, cuda)
    sun_entry, cubes = kwargs["shadow_spec"]
    assert kwargs["tonemap"] and sun_entry[2] >= 0 and all(c[3] >= 0 for c in cubes)
    rgba, z = megakernel.mega_render(*args, **kwargs)
    ref_rgba, ref_z = megakernel.mega_render_reference(*args, **kwargs)
    opaque_maps = ((sun_entry[0], sun_entry[1], -1, sun_entry[3]),
                   tuple(c[:3] + (-1, c[4]) for c in cubes))
    no_trans, _ = megakernel.mega_render(*args, **dict(kwargs, shadow_spec=opaque_maps))
    srgb, _ = megakernel.mega_render(*args, **dict(kwargs, tonemap=False))
    torch.cuda.synchronize()
    assert torch.equal(z, ref_z)
    assert torch.equal(rgba, ref_rgba)
    assert int((rgba != no_trans).sum()) > 0, "the transmittance layers changed nothing"
    assert int((rgba != srgb).sum()) > width * height // 20, "the tonemap changed nothing"


@pytest.mark.cuda
@pytest.mark.parametrize("build", [build_map_glass_scene, build_map_glass_refl_scene],
                         ids=["glass", "glass_refl"])
def test_cuda_glass_frame_matches_cpu_frame(cuda, build):
    """Paths I and J (the glazed map under the sky, without and with GGX
    reflections) at 256x128 through Rasterizer on the card and on the CPU:
    equal bytes."""
    frames = []
    for device in (cuda, "cpu"):
        rast, scene, assets = build(256, 128, device=device)
        frames.append(rast.rasterize(scene, 256, 128, 40, assets).astype(np.int32))
    assert int((frames[0] != frames[1]).any(-1).sum()) == 0


@pytest.mark.cuda
def test_map_example_runs_on_the_card(cuda, tmp_path):
    """examples/map_torch.py renders its 800x600 frame through B1 and saves
    it."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    out = tmp_path / "map_torch.png"
    run = subprocess.run([sys.executable, str(root / "examples" / "map_torch.py"),
                          "--out", str(out)], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    assert out.exists() and "launches" in run.stdout


def _near_fma_ties(rng, n):
    """Seeded a, b, c whose exact a*b + c lies within 2^-30 relative of an
    f32 rounding tie (both sides, both signs), plus random ones
    (tests/test_torch_composite.py's set)."""
    c = (rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    c = np.where(rng.uniform(size=n) < 0.5, c, -c).astype(np.float32)
    j = rng.integers(15, 22, n)
    a = (np.spacing(np.abs(c)).astype(np.float64) / 2 * (1 + 2.0 ** -j)).astype(np.float32)
    a = a * np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0).astype(np.float32)
    b = (1 - 2.0 ** -j).astype(np.float32)
    r = rng.normal(size=(3, n)).astype(np.float32)
    return (np.concatenate([a, r[0]]), np.concatenate([b, r[1]]), np.concatenate([c, r[2]]))


@pytest.mark.cuda
def test_fma_equals_b1_lookup_fma_on_the_card(cuda):
    """The port's `_fma` (one rounding) on the card and on the CPU equals
    B1's lookup FMA (__fmaf_rn): on the double-rounding input
    (64.0000076, not 64.0000153) and on seeded near-ties."""
    from rusterix_tpu_torch.ops.setup_pass import _fma

    a, b, c = _near_fma_ties(np.random.default_rng(6), 20000)
    a = np.concatenate([[np.float32(2.0 ** -18 * (1 + 2.0 ** -15))], a]).astype(np.float32)
    b = np.concatenate([[np.float32(1 - 2.0 ** -15)], b]).astype(np.float32)
    c = np.concatenate([[np.float32(64 + 2.0 ** -17)], c]).astype(np.float32)
    ta, tb, tc = (torch.from_numpy(x).to(cuda) for x in (a, b, c))
    kernel = megakernel.lookup_fma_cuda(ta, tb, tc).cpu()
    on_card = _fma(ta, tb, tc).cpu()
    on_cpu = _fma(*(torch.from_numpy(x) for x in (a, b, c)))
    assert float(kernel[0]) == float(np.float32(64 + 2.0 ** -17))
    assert torch.equal(on_card, kernel) and torch.equal(on_cpu, kernel)
    twice = torch.from_numpy((a.astype(np.float64) * b + c).astype(np.float32))
    assert int((twice != kernel).sum()) > 1000


def _blend_inputs(device, extras: bool):
    """Path K's B1 inputs (the blended map) at 256x128, rendered on
    `device`; with `extras`, the map also has a sun, shadow maps (small:
    cube maps of 16^2, the sun's of 32^2), AO and the scenevm tonemap, so
    that one launch runs has_blend with the shadow, transmittance-free
    lookup, ao_img and tonemap variants."""
    rast, scene, assets = build_map_blend_scene(256, 128, device=device)
    if extras:
        rast.sun_dir, rast.day_factor = np.array([0.4, -1.0, 0.25], np.float32), 1.0
        rast.set_shadows(True, res=16, sun_res=32).set_tonemap("scenevm")
        rast.set_ambient_occlusion(True, samples=4, radius=0.6)
    rast.rasterize(scene, 256, 128, 40, assets)
    fa = rast.frame_args
    fi = frame_inputs(**fa)
    kwargs = dict(fi["mega_kwargs"])
    if extras:
        pre = visibility_prepass(fi, 256, 128)
        kwargs["ao_img"] = ambient_occlusion(pre, fa["uniforms"], 128, fa["ao_taps"])
    return fi["mega_args"], kwargs


@pytest.mark.cuda
@pytest.mark.parametrize("extras", [False, True], ids=["alone", "shadows_ao_tonemap"])
def test_blend_kernel_matches_plain_version(cuda, extras):
    """B1's has_blend variant on path K's inputs, alone and with shadow
    maps, ambient occlusion and the tonemap: z_eff and RGBA8 bit for bit
    against the plain version at stage_cut 0, 1 and 2; the blend changes
    the frame."""
    args, kwargs = _blend_inputs(cuda, extras)
    assert kwargs["has_blend"] and args[3].shape[1] == 48
    if extras:
        assert kwargs["shadow_spec"] is not None and kwargs["tonemap"]
        assert kwargs["ao_img"] is not None
    for cut in (0, 1, 2):
        rgba, z = megakernel.mega_render(*args, **kwargs, stage_cut=cut)
        ref_rgba, ref_z = megakernel.mega_render_reference(*args, **kwargs, stage_cut=cut)
        torch.cuda.synchronize()
        assert torch.equal(z, ref_z) and torch.equal(rgba, ref_rgba), f"stage_cut {cut}"
    rgba, _z = megakernel.mega_render(*args, **kwargs)
    plain, _ = megakernel.mega_render(*args, **dict(kwargs, has_blend=False))
    torch.cuda.synchronize()
    assert int((rgba != plain).sum()) > 256 * 128 // 20, "the blend changed nothing"


@pytest.mark.cuda
def test_d2_pass_on_the_card_matches_the_cpu(cuda):
    """The 2D pass alone on path N's inputs at 256x128 with a white
    rectangle over two rooms (tests/test_torch_d2.py's lit map): the same
    f32 frame on the card and on the CPU."""
    from rusterix_tpu_torch.models import Batch2D
    from rusterix_tpu_torch.ops.composite import d2_pass

    out = []
    for device in (cuda, "cpu"):
        rast, scene, assets = build_map_2d_scene(256, 128, device=device, rooms_x=2, rooms_y=1)
        scene.d2_static.append(Batch2D.from_rectangle(0.0, 0.0, 20.0, 10.0)
                               .set_source(PixelSource.pixel((255, 255, 255, 255))))
        rast.rasterize(scene, 256, 128, 40, assets)
        fa = rast.frame_args
        frame = torch.full((128, 256, 4), 0.25, device=device)
        out.append(d2_pass(frame, fa["d2"], fa["atlas"], fa["lights"], fa["uniforms"], 256,
                           128, 0, False, fa["has_lights"], fa["has_ambient"]).cpu())
    assert torch.equal(out[0], out[1])
    assert float(out[1][..., 0].amax()) - float(out[1][..., 0].amin()) > 0.3


@pytest.mark.cuda
def test_cube_example_runs_on_the_card(cuda, tmp_path):
    """examples/cube_torch.py renders its frames through B1 and the 2D pass
    and saves the last one."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    out = tmp_path / "cube_torch.png"
    run = subprocess.run([sys.executable, str(root / "examples" / "cube_torch.py"),
                          "--out", str(out)], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    assert out.exists() and "launches" in run.stdout


def _shaded_inputs(device, case):
    """B1's inputs of a baked-shader scene at 256x128, rendered on `device`
    (the bakes run there too): path O's cube with the fast BRDF or GGX
    (has_material), path Q's map cut to two rooms at bump strength 1 or 0.5
    (has_material + has_matmap, GGX), and path K's blended map cut to two
    rooms under the emissive matmap shader with a sun, shadow maps, AO and
    the scenevm tonemap (has_matmap with has_blend and the other variants in
    one launch)."""
    if case.startswith("cube"):
        rast, scene, assets = build_cube_shaded_scene(256, 128, device=device)
        if case == "cube_ggx":
            rast.set_brdf("ggx")
    elif case.startswith("material_map"):
        rast, scene, assets = build_map_material_scene(256, 128, device=device, rooms_x=2,
                                                       rooms_y=1)
        rast.set_reflections(0)
        rast._rs_bump_strength = 0.5 if case == "material_map_bump_0.5" else 1.0
    else:
        rast, scene, assets = build_map_blend_scene(256, 128, device=device, rooms_x=2,
                                                    rooms_y=1)
        for b in scene.all_d3_batches(include_dynamic=False):
            b.set_shader(0)
        scene.add_shader(EMISSIVE_VARYING)
        scene.touch()
        rast.sun_dir, rast.day_factor = np.array([0.4, -1.0, 0.25], np.float32), 1.0
        rast.set_shadows(True, res=16, sun_res=32).set_tonemap("scenevm")
        rast.set_ambient_occlusion(True, samples=4, radius=0.6)
    rast.rasterize(scene, 256, 128, 40, assets)
    fa = rast.frame_args
    fi = frame_inputs(**fa)
    kwargs = dict(fi["mega_kwargs"])
    if fa["ao_taps"]:
        pre = visibility_prepass(fi, 256, 128)
        kwargs["ao_img"] = ambient_occlusion(pre, fa["uniforms"], 128, fa["ao_taps"])
    return fi["mega_args"], kwargs


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cube_fast", "cube_ggx", "material_map_bump_1",
                                  "material_map_bump_0.5", "blend_matmap_extras"])
def test_material_kernel_matches_plain_version(cuda, case):
    """B1's has_material and has_matmap variants (with the fast BRDF and
    GGX, at bump strength 1 and 0.5, and with has_blend, shadow maps, AO
    and the tonemap): z_eff and RGBA8 bit for bit against the plain version
    at stage_cut 0, 1 and 2; the material changes the frame."""
    args, kwargs = _shaded_inputs(cuda, case)
    assert kwargs["has_material"]
    assert kwargs["has_matmap"] == (not case.startswith("cube"))
    assert kwargs["has_blend"] == (case == "blend_matmap_extras")
    for cut in (0, 1, 2):
        rgba, z = megakernel.mega_render(*args, **kwargs, stage_cut=cut)
        ref_rgba, ref_z = megakernel.mega_render_reference(*args, **kwargs, stage_cut=cut)
        torch.cuda.synchronize()
        assert torch.equal(z, ref_z) and torch.equal(rgba, ref_rgba), f"stage_cut {cut}"
    rgba, _z = megakernel.mega_render(*args, **kwargs)
    plain, _ = megakernel.mega_render(*args, **dict(kwargs, has_material=False, has_matmap=False))
    torch.cuda.synchronize()
    assert int((rgba != plain).sum()) > 100, "the material changed nothing"


SHADED_BUILDS = {"O": build_cube_shaded_scene, "P": build_cube_timeshader_scene,
                 "Q": build_map_material_scene}


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(SHADED_BUILDS))
def test_cuda_bake_matches_cpu_bake(cuda, path):
    """The shader bakes of paths O, P and Q on the card and on the CPU: the
    same slots, texel bytes at most 1 apart."""
    packs = []
    for device in (cuda, "cpu"):
        _rast, scene, assets = SHADED_BUILDS[path](64, 32, device=device)
        packs.append(PackedScene.from_scene(scene, assets, static_only=True, device=device))
    a, b = (p.atlas_index for p in packs)
    assert a.shader_slots == b.shader_slots and a.shader_mat_slots == b.shader_mat_slots
    assert packs[0].runtime_shaders == () == packs[1].runtime_shaders
    assert np.abs(a.atlas.data.astype(int) - b.atlas.data.astype(int)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(SHADED_BUILDS))
def test_cuda_shaded_frame_matches_cpu_frame(cuda, path):
    """Paths O, P (at animation frame 3) and Q (two rooms, with its
    reflections) at 256x128 through Rasterizer on the card and on the CPU,
    from one PackedScene."""
    frames, packed = [], None
    for device in (cuda, "cpu"):
        kw = dict(rooms_x=2, rooms_y=1) if path == "Q" else {}
        rast, scene, assets = SHADED_BUILDS[path](256, 128, device=device, **kw)
        scene.animation_frame = 3
        packed = packed or PackedScene.from_scene(scene, assets, static_only=True, device="cpu")
        frames.append(rast.rasterize(scene, 256, 128, 40, assets, packed=packed).astype(np.int32))
    assert np.abs(frames[0] - frames[1]).max() == 0


@pytest.mark.cuda
def test_cube_shaded_example_runs_on_the_card(cuda, tmp_path):
    """examples/cube_shaded_torch.py bakes its shader and renders through
    B1's has_material variant, and saves the last frame."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    out = tmp_path / "cube_shaded_torch.png"
    run = subprocess.run([sys.executable, str(root / "examples" / "cube_shaded_torch.py"),
                          "--out", str(out)], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    assert out.exists() and "has_material True" in run.stdout


# ------------------------------------------- the row-sharded frame's kernels

def _slab_mega_inputs(fa, y0, rows, device):
    """B1's inputs for the slab of rows [y0, y0 + rows) of the frame whose
    render_frame arguments are `fa` (prepared by the port on the CPU, the
    near bound clipped to the slab's rows) -> (args, kwargs) on `device`."""
    from rusterix_tpu_torch.ops.setup_pass import setup_pass as port_setup

    fi = frame_inputs(**fa)
    d3, unif, width, height = fa["d3"], fa["uniforms"], fa["width"], fa["height"]
    vis, attr, bbox, alive, tri_id = port_setup(
        d3["pos"], d3["uv"], d3["nrm"], d3["valid"], d3["cull"],
        torch.from_numpy(unif["view"]), torch.from_numpy(unif["proj"]), width, height,
        bw=d3["bw"] if fa["has_blend"] else None)
    table = megakernel.pack_mega_table(attr, tri_id, d3, fa["atlas"], int(unif["anim_frame"]),
                                       fa["has_blend"], fa["has_material"], fa["has_matmap"])
    vis_s, bbox_s, alive_s, table_s, s_near = megakernel.morton_ftb_sort(
        vis, bbox, alive.float(), table, width, height, y0g=y0, rows_local=rows)
    args = [vis_s, alive_s, bbox_s, table_s, fa["atlas"]["flat_u32"],
            megakernel.pack_background_u32(fa["background"][y0:y0 + rows]),
            megakernel.pack_mega_params(unif, width, height, fa["atlas"]["w"], "cpu",
                                        fa["has_fog"], y0=y0, shadow_params=fa["shadow_params"]),
            fi["mega_args"][7], fi["mega_args"][8], width, rows, fa["sample_mode"]]
    kwargs = dict(fi["mega_kwargs"], s_near=s_near)
    return _to(args, kwargs, device)


def _map_args(width, height):
    rast, scene, assets = build_map_scene(width, height, device="cpu")
    rast.rasterize(scene, width, height, 40, assets)
    return rast.frame_args


@pytest.mark.cuda
@pytest.mark.parametrize("stage_cut", [0, 1, 2])
@pytest.mark.parametrize("case", ["map_333x200", "box_mixed"])
def test_row_offset_kernel_matches_plain_version(cuda, case, stage_cut):
    """B1 at a row offset (params[58]) on a slab of 75 rows from row 70, not
    a multiple of the 64-row tile: both outputs of the cuts equal, z_eff
    equal and RGBA8 within 1 at stage_cut 0."""
    if case == "box_mixed":
        rast_args = _box_frame_args("mixed", True, 1, "exp2", "texture")
        y0, rows = 13, 75
    else:
        rast_args = _map_args(333, 200)
        y0, rows = 70, 75
    args, kwargs = _slab_mega_inputs(rast_args, y0, rows, cuda)
    out = megakernel.mega_render(*args, **kwargs, stage_cut=stage_cut)
    ref = megakernel.mega_render_reference(*args, **kwargs, stage_cut=stage_cut)
    torch.cuda.synchronize()
    assert torch.equal(out[1], ref[1])
    if stage_cut:
        assert torch.equal(out[0], ref[0])
    else:
        diff = megakernel.unpack_frame_u32(out[0]).int() - megakernel.unpack_frame_u32(ref[0]).int()
        assert int(diff.abs().max()) <= 1
        assert bool((out[1] < 1.0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["box_mixed", "map_333x200_slab"])
def test_generic_light_loop_kernel_matches_specialised_launch(cuda, case):
    """light_spec None (the generic loop: every light row, the types read
    from the one-hot columns on the card) against the specialised launch bit
    for bit, and against its plain version (the JAX kernel's blend)."""
    if case == "box_mixed":
        args, kwargs = _to(*_box_frame_inputs("mixed", True, 0, "off", "pixel"), cuda)
    else:
        args, kwargs = _slab_mega_inputs(_map_args(333, 200), 70, 75, cuda)
    rgba, z = megakernel.mega_render(*args, **dict(kwargs, light_spec=None))
    spec_rgba, spec_z = megakernel.mega_render(*args, **kwargs)
    ref_rgba, ref_z = megakernel.mega_render_reference(*args, **dict(kwargs, light_spec=None))
    torch.cuda.synchronize()
    assert torch.equal(rgba, spec_rgba) and torch.equal(z, spec_z)
    assert torch.equal(z, ref_z)
    diff = megakernel.unpack_frame_u32(rgba).int() - megakernel.unpack_frame_u32(ref_rgba).int()
    assert int(diff.abs().max()) <= 1
    assert args[7].shape[0] > len(kwargs["light_spec"])  # dead rows visited


@pytest.mark.cuda
@pytest.mark.parametrize("y0,rows", [(70, 75), (128, 64)])
def test_visibility_kernel_at_a_row_offset_matches_plain_version(cuda, y0, rows):
    """B2 at a row offset against visibility_pass(..., y0=) (its plain
    version) on the map's sorted candidates: z and idx equal."""
    fa = _map_args(333, 200)
    fi = frame_inputs(**fa)
    ins = [t.to(cuda) for t in (fi["vis_s"], fi["alive_s"], fi["bbox_s"])]
    z, idx, hit = visibility_pallas.visibility_pass_pallas(*ins, 333, rows, y0)
    zp, idxp, _hp = visibility_pallas.visibility_pass_pallas_reference(*ins, 333, rows, y0)
    whole = visibility_pallas.visibility_pass_pallas(*ins, 333, 200)
    torch.cuda.synchronize()
    assert torch.equal(z, zp) and torch.equal(idx, idxp)
    n = min(rows, 200 - y0)
    assert torch.equal(idx[:n], whole[1][y0:y0 + n]) and bool(hit.any())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 7])
def test_sharded_cube_matches_single_cube_on_the_card(cuda, n):
    """The bench's cube (its 2D rectangle) at 800x600 through
    rasterize(mesh=make_mesh(n, "cuda")) against rasterize() on the card,
    byte for byte; every slab launches B1 once."""
    from rusterix_tpu_torch.parallel import make_mesh

    rast, scene, assets = build_cube_scene(800, 600, device=cuda)
    single = rast.rasterize(scene, 800, 600, 40, assets)
    before = counters["b1.launch"]
    sharded = rast.rasterize(scene, 800, 600, 40, assets, mesh=make_mesh(n, cuda))
    torch.cuda.synchronize()
    assert counters["b1.launch"] == before + n
    np.testing.assert_array_equal(sharded, single)


@pytest.mark.cuda
@pytest.mark.parametrize("width,height", [(333, 200), (1920, 1080)])
def test_visibility_kernel_on_the_morton_order_matches_plain_version(cuda, width, height):
    """B2 on the split path's candidates (runtime shaders: morton_sort of
    the setup pass's slots, no front-to-back super order) of path T's map
    cut to two rooms: z and idx equal to its plain version, one launch."""
    from rusterix_tpu_torch.scenes import build_map_runtime_shader_scene

    rast, scene, assets = build_map_runtime_shader_scene(width, height, device=cuda,
                                                         rooms_x=2, rooms_y=1)
    rast.rasterize(scene, width, height, 40, assets)
    fi = frame_inputs(**rast.frame_args)
    assert fi["split"] and fi["mega_args"] is None
    before = counters["b2.launch"]
    z, idx, hit = visibility_pallas.visibility_pass_pallas(
        fi["vis_s"], fi["alive_s"], fi["bbox_s"], width, height)
    zp, idxp, _hp = visibility_pallas.visibility_pass_pallas_reference(
        fi["vis_s"], fi["alive_s"], fi["bbox_s"], width, height)
    torch.cuda.synchronize()
    assert counters["b2.launch"] == before + 1
    assert torch.equal(z, zp) and torch.equal(idx, idxp)
    assert int(hit.sum()) > width * height // 10


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["runtime_shader", "runtime_shader_refl", "dynamic",
                                  "cube_2d_shader"])
def test_cuda_split_and_dynamic_frames_match_cpu_frames(cuda, path):
    """Paths T, U (shadow maps at 32 / 64 texels), V and W at 256x128 on the
    card against the CPU: RGBA8 within 1. T, U and W take the split path
    (B2 and no B1), V B1 over the concatenated dynamic pack."""
    from rusterix_tpu_torch import scenes

    build = getattr(scenes, f"build_map_{path}_scene" if path != "cube_2d_shader"
                    else "build_cube_2d_shader_scene")
    frames = []
    for dev in (cuda, "cpu"):
        rast, scene, assets = build(256, 128, device=dev)
        if rast.shadow_settings is not None:
            rast.set_shadows(True, res=32, sun_res=64)
        b1 = counters["b1.launch"]
        frames.append(rast.rasterize(scene, 256, 128, 40, assets).astype(np.int32))
        if dev is cuda:
            assert (counters["b1.launch"] > b1) == (path == "dynamic")
    assert np.abs(frames[0] - frames[1]).max() <= 1
    assert (frames[0][..., 3] > 0).sum() > 256 * 128 // 10


def _spread_rays(seed, ncells, height, width, parked=0.0):
    """Compact cells (64 triangles within 0.6 of a random centre in
    [-10, 10]^3) and rays whose origins follow the pixel (a plane across
    [-8, 8]^2, z within 0.05), so that a ray block's keys spread over many
    distinct gaps; a `parked` share of the rays parked at 1e8."""
    rng = np.random.default_rng(seed)
    tcount = 64 * ncells
    centre = np.repeat(rng.uniform(-10, 10, (ncells, 3)), 64, axis=0)
    a = centre + rng.uniform(-0.3, 0.3, (tcount, 3))
    pos = np.stack([a, a + rng.uniform(-0.3, 0.3, (tcount, 3)),
                    a + rng.uniform(-0.3, 0.3, (tcount, 3))], axis=1)
    pos = np.concatenate([pos, np.ones((tcount, 3, 1))], axis=2).astype(np.float32)
    valid = (rng.uniform(size=tcount) > 0.2).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    o = np.stack([xs / width * 16.0 - 8.0, ys / height * 16.0 - 8.0,
                  rng.uniform(-0.05, 0.05, (height, width))]).astype(np.float32)
    d = rng.normal(size=(3, height, width)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    dead = rng.uniform(size=(height, width)) < parked
    o[:, dead] = 1e8
    d[:, dead] = np.array([0.0, -1.0, 0.0], np.float32)[:, None]
    return pos, valid, o, d


def _step_rays(seed, gaps, ncells, height, width):
    """Cells that lie at exact gaps from every ray block: cell c spans x in
    [g, g + 0.5] for g = gaps[c % len(gaps)] and y, z in [-2, 2], and every
    origin lies at x = 0 with y, z in [-1, 1], so that each key is its gap's
    f32 bits and the row's keys differ only in the bytes where the gaps'
    bits do."""
    rng = np.random.default_rng(seed)
    g = np.repeat(np.resize(np.asarray(gaps, np.float32), ncells), 64)
    tri = np.zeros((64 * ncells, 3, 4), np.float32)
    tri[:, 0, :3] = np.stack([g, np.full_like(g, -2), np.full_like(g, -2)], 1)
    tri[:, 1, :3] = np.stack([g + 0.5, np.full_like(g, 2), np.full_like(g, -2)], 1)
    tri[:, 2, :3] = np.stack([g, np.full_like(g, 2), np.full_like(g, 2)], 1)
    tri[:, :, 3] = 1.0
    o = rng.uniform(-1, 1, (3, height, width)).astype(np.float32)
    o[0] = 0.0
    d = rng.normal(size=(3, height, width)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return tri, np.ones(64 * ncells, np.float32), o, d


#: gaps whose f32 bits differ in byte 3 only, in bytes 2 and 3, in bytes 1
#: to 3: rows the global route sorts in one, two and three passes
STEP_GAPS = {"steps1": (0.0, 2.0, 8.0), "steps2": (2.0, 3.0, 8.0),
             "steps3": (2.0, 2.0001220703125, 3.0, 8.0)}
#: the limits that send any scene to the global route, and those that send
#: any scene the cluster kernel holds to the cluster route
GLOBAL = {"PREPARE_MAX_CELLS": 0, "CLUSTER_MAX_CELLS": 0}
CLUSTER = {"CLUSTER_MAX_CELLS": 106496}

# (keys, cells, ray rows, ray columns, limits lowered) -> the route the
# limits give; "ties": random rays over random cells (every live key at gap
# 0, 100 dead cells at _BIG), "zero": the same without dead cells (every key
# 0), "spread": _spread_rays, "dead": no live slot, "parked": every ray
# parked, "halfparked": spread keys under the lower half of the frame, the
# upper half's ray blocks parked, "steps1" to "steps3": _step_rays
PREPARATION_ROUTE_CASES = [
    ("ties", 28700, 16, 128, CLUSTER),         # just above the rank route's old limit
    ("spread", 28700, 16, 128, CLUSTER),
    ("spread", 100003, 8, 128, CLUSTER),       # an odd size in the largest cluster
    ("spread", 700, 19, 150, {"PREPARE_MAX_CELLS": 4}),                       # 1 block
    ("spread", 5000, 24, 300, {"PREPARE_MAX_CELLS": 4}),                      # 2 blocks
    ("spread", 700, 8, 128, {"PREPARE_MAX_CELLS": 4, "CLUSTER_SPAN": 100}),   # 8 small
    ("dead", 6200, 8, 128, {"PREPARE_MAX_CELLS": 4}),
    ("parked", 6200, 8, 128, {"PREPARE_MAX_CELLS": 4}),
    ("spread", 9000, 16, 128, {"PREPARE_MAX_CELLS": 4, "CLUSTER_MAX_CELLS": 4}),  # global
    ("ties", 3000, 8, 128, {"PREPARE_MAX_CELLS": 4, "CLUSTER_MAX_CELLS": 4}),
    # the global route at the sizes of its tiles (rt_kernel.GLOBAL_TILE
    # pairs): a row of one cell, of 32, shorter than a tile, one tile, a tile
    # and a cell; every key _BIG, every key 0, parked ray blocks beside
    # sorted ones, rows of one to three passes, and with the limits as they
    # stand the first size above the cluster route and the first size the
    # cluster kernel cannot hold
    ("zero", 1, 8, 128, GLOBAL),
    ("spread", 32, 8, 128, GLOBAL),
    ("spread", 1000, 19, 150, GLOBAL),
    ("spread", 4096, 16, 128, GLOBAL),
    ("spread", 4097, 16, 128, GLOBAL),
    ("dead", 5000, 8, 128, GLOBAL),
    ("zero", 9000, 16, 128, GLOBAL),
    ("halfparked", 9000, 16, 256, GLOBAL),
    ("steps1", 5000, 8, 128, GLOBAL),
    ("steps2", 5000, 8, 128, GLOBAL),
    ("steps3", 9000, 16, 128, GLOBAL),
    ("spread", 28673, 8, 128, {}),
    ("spread", 106497, 8, 128, {}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("keys,ncells,height,width,limits", PREPARATION_ROUTE_CASES)
def test_large_preparation_route_matches_rt_prepare(cuda, monkeypatch, keys, ncells, height,
                                                    width, limits):
    """The preparation routes above the rank sort, each as `prepare_route`
    picks it from the limits: rt_prepare_cluster_kernel (a thread block
    cluster of 1 to 8 blocks) and the global route (rt_prepare_large_boxes,
    _count and four passes of rt_prepare_large_kernel). Boxes, tnear and
    slist bit for bit against rt_prepare on the card, the route's own
    counter up by one, and B3's walk over its shortlist equal to the walk
    over rt_prepare's."""
    for name, value in limits.items():
        monkeypatch.setattr(rt_kernel, name, value)
    route = rt_kernel.prepare_route(ncells)
    assert route["route"] == ("global" if ncells > rt_kernel.CLUSTER_MAX_CELLS else "cluster")
    if keys in ("ties", "zero", "dead"):
        pos, valid, o, d = _random_rays(19, 64 * ncells, height, width, 0.1)
    elif keys in STEP_GAPS:
        pos, valid, o, d = _step_rays(19, STEP_GAPS[keys], ncells, height, width)
    else:
        pos, valid, o, d = _spread_rays(19, ncells, height, width,
                                        1.0 if keys == "parked" else 0.1)
    if keys == "halfparked":  # whole ray blocks parked above the middle row
        o[:, : height // 2] = 1e8
        d[:, : height // 2] = np.array([0.0, -1.0, 0.0], np.float32)[:, None, None]
    n_dead = 0 if keys in ("zero", *STEP_GAPS) else min(100, ncells // 4)
    if n_dead:  # 100 dead cells (a quarter of a small scene): keys at _BIG among the live ones
        valid[-64 * n_dead:] = 0.0
    if keys == "dead":
        valid[:] = 0.0
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (pos, valid, *o, *d)]
    routes = ("b3.prepare.rank", "b3.prepare.cluster", "b3.prepare.global")
    before = [counters[c] for c in routes]
    prep = rt_kernel.rt_prepare_cuda(*args, 25.0, height, width)
    ref = rt_kernel.rt_prepare(*args, 25.0, height, width)
    torch.cuda.synchronize()
    after = [counters[c] for c in routes]
    k = 1 if route["route"] == "cluster" else 2
    assert [a - b for a, b in zip(after, before)] == [int(i == k) for i in range(3)]
    nb = -(-height // 8) * -(-width // 128)
    assert prep["ncells"] == ncells and prep["tnear"].shape == (nb, ncells)
    for key in ("boxes", "tnear", "slist", "tab", "cbox", "tcap"):
        assert torch.equal(prep[key], ref[key]), key
    tn = prep["tnear"]
    if keys in ("dead", "parked"):
        assert bool((tn >= 3e37).all())
    elif keys == "zero":
        assert bool((tn == 0).all())
    elif keys in STEP_GAPS:  # every row holds each gap, in the bytes that differ
        assert torch.equal(torch.unique(tn), torch.tensor(STEP_GAPS[keys], device=cuda))
    else:
        assert bool((tn < 3e37).any()) and bool((tn >= 3e37).any())
    if keys in ("spread", "halfparked"):  # the radix passes have distinct keys to order
        assert int(torch.unique(tn[-1 if keys == "halfparked" else 0]).numel()) > ncells // 10
    if keys == "halfparked":
        assert bool((tn[: tn.shape[0] // 2] >= 3e37).all())
    fields = rt_kernel._ray_fields(*args[2:])
    t, idx = rt_kernel._launch(prep, fields)
    t_r, idx_r = rt_kernel._launch(ref, fields)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_r) and torch.equal(t, t_r)
    if keys not in ("dead", "parked") and ncells >= 32:
        assert int((idx >= 0).sum()) > 0


@pytest.mark.cuda
def test_reflection_frame_through_the_large_preparation_route(cuda, monkeypatch):
    """Path B's map at 256x128 through each preparation route in turn: the
    routing limits as they stand (the rank sort), PREPARE_MAX_CELLS lowered
    below its cell count (rt_prepare_cluster_kernel) and CLUSTER_MAX_CELLS
    lowered too (rt_prepare_large_kernel). Every frame byte-equal to the
    first."""
    frames = []
    routes = ("b3.prepare.rank", "b3.prepare.cluster", "b3.prepare.global")
    for k, limits in enumerate(({}, {"PREPARE_MAX_CELLS": 4},
                                {"PREPARE_MAX_CELLS": 4, "CLUSTER_MAX_CELLS": 4})):
        for name, value in limits.items():
            monkeypatch.setattr(rt_kernel, name, value)
        rast, scene, assets = build_map_refl_scene(256, 128, device=cuda)
        before = [counters[c] for c in routes]
        frames.append(rast.rasterize(scene, 256, 128, 40, assets))
        ran = [counters[c] > b for c, b in zip(routes, before)]
        assert ran == [i == k for i in range(3)]
    assert np.array_equal(frames[0], frames[1]) and np.array_equal(frames[0], frames[2])
    assert (frames[0][..., 3] > 0).sum() > 256 * 128 // 10


@pytest.mark.cuda
def test_minigame_frame_on_cuda_matches_cpu(cuda):
    """The minigame world after the same seeded ticks (the monster walks by
    Python's random), drawn by the client at 160x120 on the card (B1 over
    the static pack and the monster's billboard) and on the CPU: byte-equal."""
    import random

    from rusterix_tpu_torch.scenes import build_minigame, minigame_tick

    frames = []
    for dev in (cuda, "cpu"):
        random.seed(7)
        rx = build_minigame(dev)
        rx.local_player_event("key_down", "w")
        for _ in range(4):
            minigame_tick(rx)
        b1 = counters["b1.launch"]
        frames.append(rx.draw_scene(rx.assets.maps["world"], 160, 120,
                                    ambient=[0.4, 0.4, 0.4, 1.0]))
        rx.server.stop()
        if dev is cuda:
            assert counters["b1.launch"] == b1 + 1
    assert np.array_equal(frames[0], frames[1])
    assert (frames[0][..., 3] == 255).sum() > 5000


#: pixels of the 64x48 tracer buffer whose path may take another branch on
#: the card than on the CPU (sin and cos, the only functions whose last bit
#: differs between the two, steer the diffuse bounces)
TRACER_BRANCH_PIXELS = 16


@pytest.mark.cuda
def test_tracer_on_cuda_matches_cpu(cuda):
    """The bench's tracer scene at 64x48 after 2 samples on the card and on
    the CPU: the buffers within 1e-5 but for at most TRACER_BRANCH_PIXELS
    pixels."""
    from rusterix_tpu_torch.scenes import build_tracer_scene
    from rusterix_tpu_torch.tracer import AccumBuffer, Tracer

    bufs = []
    for dev in (cuda, "cpu"):
        scene, cam, assets = build_tracer_scene()
        buf, tracer = AccumBuffer(64, 48, device=dev), Tracer(device=dev)
        for _ in range(2):
            tracer.trace(cam, scene, buf, 64, assets)
        bufs.append(buf.pixels)
    far = (np.abs(bufs[0] - bufs[1]) > 1e-5).any(-1)
    print(f"tracer CUDA vs CPU: {int(far.sum())} pixels past 1e-5")
    assert int(far.sum()) <= TRACER_BRANCH_PIXELS
    assert np.isfinite(bufs[0]).all() and bufs[0][..., :3].max() > 1.0


def _h2d_copies(fn) -> int:
    """Host-to-device copies one call of `fn` makes (the profiler's Memcpy
    HtoD records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert events, "the profiler recorded no device activity"
    return sum("HtoD" in e.name for e in events)


@pytest.mark.cuda
@pytest.mark.parametrize("build", [build_map_scene, build_map_ao_scene],
                         ids=["map", "map_ao"])
def test_arena_frame_equals_the_per_leaf_frame_on_the_card(cuda, build):
    """rasterize's frame through the arena (one pinned, non-blocking copy of
    the per-frame leaves, viewed back out on the card) against render_frame
    over the stashed arguments with every leaf uploaded on its own: equal."""
    from rusterix_tpu_torch.ops.raster import render_frame

    rast, scene, assets = build(640, 360, device=cuda)
    before = counters["arena.upload"]
    frames = [rast.rasterize(scene, 640, 360, 40, assets) for _ in range(3)]
    assert counters["arena.upload"] == before + 3 and rast.frame_arena is not None
    fa = rast.frame_args
    per_leaf = render_frame(**dict(fa, lights=dict(fa["lights"]),
                                   uniforms=dict(fa["uniforms"]))).cpu().numpy()
    for f in frames:
        assert np.array_equal(f, per_leaf)


@pytest.mark.cuda
def test_steady_frame_of_the_map_makes_one_host_to_device_copy(cuda):
    """Path A at 1920x1080: after the first frame (the scene upload), a frame
    makes one host-to-device copy, the arena's."""
    rast, scene, assets = build_map_scene(1920, 1080, device=cuda)
    rast.rasterize(scene, 1920, 1080, 40, assets, readback=False)
    assert _h2d_copies(lambda: rast.rasterize(scene, 1920, 1080, 40, assets)) == 1


@pytest.mark.cuda
def test_frame_breakdown_on_the_card(cuda):
    """frame_breakdown of path A on the card: the megakernel key set, every
    value finite and >= 0, by CUDA events."""
    import math

    from rusterix_tpu_torch.profiling import frame_breakdown

    rast, scene, assets = build_map_scene(1920, 1080, device=cuda)
    out = frame_breakdown(rast, scene, assets, 1920, 1080, reps=5)
    assert set(out) == {"setup_ms", "pack_morton_ms", "megakernel_ms", "frame_ms", "fps",
                        "full_frame_ms"}
    assert all(math.isfinite(v) and v >= 0 for v in out.values())


@pytest.mark.cuda
def test_huge_reflection_frame_takes_the_cluster_route(cuda):
    """HGR at 640x360: the huge scene's 131,072 slots are 2,048 B3 cells,
    which the cluster preparation route takes (one launch, no other route),
    and the frame equals its render over the per-leaf route."""
    from rusterix_tpu_torch.ops.raster import render_frame
    from rusterix_tpu_torch.scenes import build_huge_scene, huge_rasterizer

    scene, cam, assets = build_huge_scene()
    rast = huge_rasterizer(cam, 640, 360, cuda).set_brdf("ggx").set_reflections(1)
    rast.rasterize(scene, 640, 360, 40, assets, readback=False)
    for c in ("b3.walk_launch", "b3.prepare.rank", "b3.prepare.cluster", "b3.prepare.global"):
        counters[c] = 0
    frame = rast.rasterize(scene, 640, 360, 40, assets)
    assert rast.frame_args["d3"]["pos"].shape[0] // rt_kernel.RT_CELL == 2048
    assert (counters["b3.walk_launch"], counters["b3.prepare.rank"],
            counters["b3.prepare.cluster"], counters["b3.prepare.global"]) == (1, 0, 1, 0)
    fa = rast.frame_args
    per_leaf = render_frame(**dict(fa, lights=dict(fa["lights"]), uniforms=dict(fa["uniforms"])))
    assert np.array_equal(frame, per_leaf.cpu().numpy())


# ------------------------------------------------- the mesh over the cards


def _last_card():
    """The machine's last CUDA card; skips where it has fewer than two."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two CUDA cards or more; the machine has {n}")
    return torch.device("cuda", n - 1)


def _prep_inputs(ncells, height, width, device):
    """_spread_rays' scene and rays on `device` -> (pos, valid, ox..dz)."""
    pos, valid, o, d = _spread_rays(19, ncells, height, width, 0.1)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (pos, valid, *o, *d)]


# B3's preparation routes by cell count, with the limits they are sent by
CARD_ROUTES = {"B3_rank": (300, {}), "B3_cluster": (5000, {"PREPARE_MAX_CELLS": 4}),
               "B3_global": (5000, GLOBAL)}


def _launch_on(kernel, device, monkeypatch):
    """One launch of `kernel` on inputs on `device`, with cuda:0 the current
    device -> its outputs on the CPU."""
    torch.manual_seed(3)
    with torch.cuda.device(0):
        if kernel == "B1":
            args, kwargs = _slab_mega_inputs(_map_args(333, 200), 70, 75, device)
            out = megakernel.mega_render(*args, **kwargs)
        elif kernel == "xla_fma":
            a, b, c = (torch.randn(1 << 16).to(device) for _ in range(3))
            out = (megakernel.lookup_fma_cuda(a, b, c),)
        elif kernel == "B2":
            fi = frame_inputs(**_map_args(333, 200))
            ins = [t.to(device) for t in (fi["vis_s"], fi["alive_s"], fi["bbox_s"])]
            out = visibility_pallas.visibility_pass_pallas(*ins, 333, 75, 70)
        elif kernel == "B3_walk":
            args = _prep_inputs(300, 16, 128, device)
            out = rt_kernel.intersect_rays_pallas(*args, 25.0, 16, 128)
        else:
            ncells, limits = CARD_ROUTES[kernel]
            for name, value in limits.items():
                monkeypatch.setattr(rt_kernel, name, value)
            route = rt_kernel.prepare_route(ncells)["route"]
            assert route == kernel.split("_")[1]
            prep = rt_kernel.rt_prepare_cuda(*_prep_inputs(ncells, 16, 128, device), 25.0, 16, 128)
            assert prep["slist"].device == device
            out = tuple(prep[k] for k in ("boxes", "tnear", "slist"))
        assert torch.cuda.current_device() == 0
        assert all(t.device == device for t in out)
        torch.cuda.synchronize(device)
    return [t.cpu() for t in out]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B1", "xla_fma", "B2", *CARD_ROUTES, "B3_walk"])
def test_kernel_on_the_last_card_equals_the_first(cuda, monkeypatch, kernel):
    """Each kernel launched on tensors on the machine's last card while
    cuda:0 is the current device (the launch makes the tensors' card
    current) gives the same bits as the same launch on cuda:0; the resource
    queries answer alike on both cards."""
    last = _last_card()
    first = _launch_on(kernel, torch.device("cuda", 0), monkeypatch)
    other = _launch_on(kernel, last, monkeypatch)
    for a, b in zip(first, other):
        assert torch.equal(a, b)
    assert (_cuda.resources("rt_walk", device=last)
            == _cuda.resources("rt_walk", device=torch.device("cuda", 0)))


#: the sharded paths at 256x128: the scene (scenes.py), and the launches of
#: B1, B2 and B3's walk a slab. R the map, S the shadowed GGX map with AO and
#: sky light, JA the feature scene (shadows with transmittance, AO, GGX,
#: reflections on the opaque frame and each of its 4 layers, sky light,
#: fog), I the glazed map under the sky, T8 the split path, V the dynamic
#: batches with casters, M the cube with its 2D rectangle
SHARDED_PATHS = {
    "R": ("build_map_scene", (1, 0, 0)),
    "S": ("build_map_shadow_refl_scene", (1, 1, 2)),
    "JA": ("build_feature_scene", (1, 1, 6)),
    "I": ("build_map_glass_scene", (1, 0, 0)),
    "T8": ("build_map_runtime_shader_scene", (0, 1, 0)),
    "V": ("build_map_dynamic_scene", (1, 0, 0)),
    "M": ("build_cube_scene", (1, 0, 0)),
}


def _sharded_path(key, device):
    """SHARDED_PATHS' scene `key` at 256x128 on `device` -> (rast, scene,
    assets, move): move(t) places V's dynamic batches for time t."""
    from rusterix_tpu_torch import scenes

    rast, scene, assets = getattr(scenes, SHARDED_PATHS[key][0])(256, 128, device=device)
    if key == "S":
        rast.set_ambient_occlusion(True).set_sky_light(True)

    def move(t):
        if key == "V":
            scenes.move_dynamic(scene, t)

    move(0.0)
    return rast, scene, assets, move


def _launches():
    return (counters["b1.launch"], counters["b2.launch"], counters["b3.walk_launch"])


@pytest.mark.cuda
@pytest.mark.parametrize("key", list(SHARDED_PATHS))
def test_frame_over_two_cards_equals_two_slabs_on_one(cuda, key):
    """Each sharded path at 256x128 through rasterize(mesh=card_mesh(2)):
    byte-equal to the same two slabs on one card, twice (the second frame on
    the placed static state; V's two frames at two move times, each against
    the slabs on one card at the same time), the frame on the first card,
    its kernels launched once a slab (B3's walk once a slab and ray set)."""
    from rusterix_tpu_torch.parallel import card_mesh, make_mesh

    _last_card()
    rast, scene, assets, move = _sharded_path(key, torch.device("cuda", 0))
    mesh = card_mesh(2)
    for t in (0.5, 1.0):
        move(t)
        one = rast.rasterize(scene, 256, 128, 40, assets, mesh=make_mesh(2, "cuda:0"))
        torch.cuda.synchronize()
        before = _launches()
        frame = rast.rasterize(scene, 256, 128, 40, assets, mesh=mesh, readback=False)
        torch.cuda.synchronize()
        after = _launches()
        assert tuple(a - b for a, b in zip(after, before)) == tuple(
            2 * c for c in SHARDED_PATHS[key][1])
        assert frame.device == mesh[0]
        np.testing.assert_array_equal(frame.cpu().numpy(), one)


@pytest.mark.cuda
def test_trace_sharded_over_the_cards_equals_sequential_traces(cuda):
    """trace_sharded over every card (one sample a card) leaves the buffer
    that as many trace() calls leave, bit for bit, twice in a row."""
    from rusterix_tpu_torch.parallel import card_mesh
    from rusterix_tpu_torch.scenes import build_tracer_scene
    from rusterix_tpu_torch.tracer import AccumBuffer, Tracer

    _last_card()
    mesh = card_mesh()
    scene, cam, assets = build_tracer_scene()
    tracer = Tracer(device=mesh[0])
    one, seq = AccumBuffer(64, 48, device=mesh[0]), AccumBuffer(64, 48, device=mesh[0])
    for _ in range(2):
        tracer.trace_sharded(cam, scene, one, 64, assets, mesh)
        for _ in mesh:
            tracer.trace(cam, scene, seq, 64, assets)
        assert np.array_equal(one.pixels, seq.pixels)
    assert set(tracer._placed) == set(mesh[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["R", "S", "JA", "I", "T8"])
def test_steady_sharded_frame_makes_no_host_synchronisation(cuda, key):
    """A steady frame of each sharded path but V and M in 8 slabs on one
    card at 256x128 runs under torch.cuda.set_sync_debug_mode("error")
    without a host synchronisation. V and M wait once a frame, as their
    single frames do: the 2D pass reads its pack's lists of live triangles,
    their light flags and shaders (composite.d2_lists; PERF.md)."""
    from rusterix_tpu_torch.parallel import make_mesh

    rast, scene, assets, _move = _sharded_path(key, cuda)
    mesh = make_mesh(8, cuda)
    for _ in range(2):
        rast.rasterize(scene, 256, 128, 40, assets, mesh=mesh, readback=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frame = rast.rasterize(scene, 256, 128, 40, assets, mesh=mesh, readback=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert frame.shape == (128, 256, 4)

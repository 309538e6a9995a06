"""The CUDA kernels on the card: the megakernel (B1, both BRDFs, the
ambient-occlusion input, the profiling cuts), the visibility pre-pass
(B2), the ray intersect (B3) and its preparation kernel against their
plain torch versions on the same inputs (B1 also with shadow maps, their
transmittance layers and the scenevm tonemap), the whole CUDA frames
(opaque, with GGX reflections at full and half scale, with AO, with sky
light, with SSAA, with shadows, with shadowed reflections, the glazed map
under the sky without and with reflections) against the CPU frames, and
the port's map example.

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
from rusterix_tpu_torch.models import CullMode, RenderSettings, Tile  # noqa: E402
from rusterix_tpu_torch.ops import megakernel, rt_kernel, visibility_pallas  # noqa: E402
from rusterix_tpu_torch.ops.matrices import look_at_rh, perspective_fov_rh_zo  # noqa: E402
from rusterix_tpu_torch.ops.raster import frame_inputs  # noqa: E402
from rusterix_tpu_torch.ops.setup_pass import setup_pass  # noqa: E402
from rusterix_tpu_torch.scenes import (  # noqa: E402
    build_map_ao_scene,
    build_map_glass_refl_scene,
    build_map_glass_scene,
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


def _box_frame_inputs(lights, sun, sample_mode, fog, source):
    """The box scene's mega_render inputs, prepared by the port on the CPU."""
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
    fi = frame_inputs(**rast.frame_args)
    return fi["mega_args"], fi["mega_kwargs"]


def _to(args, kwargs, device):
    def move(a):
        return a.to(device) if isinstance(a, torch.Tensor) else a

    return [move(a) for a in args], {k: move(v) for k, v in kwargs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("lights,sun,sample_mode,fog,source", CASES)
def test_kernel_matches_plain_version(cuda, lights, sun, sample_mode, fog, source):
    args, kwargs = _to(*_box_frame_inputs(lights, sun, sample_mode, fog, source), cuda)
    before = megakernel.launches
    rgba, z = megakernel.mega_render(*args, **kwargs)
    ref_rgba, ref_z = megakernel.mega_render_reference(*args, **kwargs)
    torch.cuda.synchronize()
    assert megakernel.launches == before + 1
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
    before = visibility_pallas.launches
    z, idx, hit = visibility_pallas.visibility_pass_pallas(vis, alive, bbox, width, height)
    z_p, idx_p, hit_p = visibility_pallas.visibility_pass_pallas_reference(
        vis, alive, bbox, width, height)
    torch.cuda.synchronize()
    assert visibility_pallas.launches == before + 1
    assert torch.equal(idx, idx_p) and torch.equal(hit, hit_p)
    assert torch.equal(z, z_p)
    assert int(hit.sum()) > width * height // 20


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
    before = (rt_kernel.launches, rt_kernel.prepare_launches)
    t, idx = rt_kernel.intersect_rays_pallas(*args, 25.0, height, width)
    t_p, idx_p = rt_kernel.intersect_rays_pallas_reference(*args, 25.0, height, width)
    torch.cuda.synchronize()
    assert (rt_kernel.launches, rt_kernel.prepare_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(idx, idx_p)
    assert torch.equal(t, t_p)
    assert int((idx >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tcount,height,width,parked", [
    (300, 24, 40, 0.0),     # 5 cells with a dead tail, one partial block
    (2048, 67, 300, 0.5),   # 32 cells, ragged blocks, half the rays parked
    (40000, 19, 150, 0.2),  # 625 cells: the rank sort past one warp of keys
])
def test_preparation_kernel_matches_rt_prepare(cuda, tcount, height, width, parked):
    """The blocks' boxes, the keys and their stable sort, bit for bit, with
    NaN values among the rays (skipped by the boxes)."""
    pos, valid, o, d = _random_rays(13, tcount, height, width, parked)
    o[1, 3, 7] = np.nan
    d[2, height - 1, width - 1] = np.nan
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (pos, valid, *o, *d)]
    before = rt_kernel.prepare_launches
    prep = rt_kernel.rt_prepare_cuda(*args, 25.0, height, width)
    ref = rt_kernel.rt_prepare(*args, 25.0, height, width)
    torch.cuda.synchronize()
    assert rt_kernel.prepare_launches == before + 1
    for key in ("boxes", "tnear", "slist", "tab", "cbox", "tcap"):
        assert torch.equal(prep[key], ref[key]), key
    assert bool((prep["tnear"] < 3e37).any())


@pytest.mark.cuda
@pytest.mark.parametrize("ncells", [2048, 6200])
def test_large_scene_prepares_through_the_kernel(cuda, ncells):
    """Scenes of thousands of cells (16 KB of keys, and 48 KB and more, which
    a block has to opt in to): still the preparation kernel, the same
    shortlist and the same hits."""
    tcount, height, width = 64 * ncells, 8, 128
    pos, valid, o, d = _random_rays(17, tcount, height, width)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (pos, valid, *o, *d)]
    before = (rt_kernel.launches, rt_kernel.prepare_launches)
    prep = rt_kernel.rt_prepare_cuda(*args, 25.0, height, width)
    ref = rt_kernel.rt_prepare(*args, 25.0, height, width)
    t, idx = rt_kernel.intersect_rays_pallas(*args, 25.0, height, width)
    t_p, idx_p = rt_kernel.intersect_rays_pallas_reference(*args, 25.0, height, width)
    torch.cuda.synchronize()
    assert (rt_kernel.launches, rt_kernel.prepare_launches) == (before[0] + 1, before[1] + 2)
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
    counts = (megakernel.launches, visibility_pallas.launches, rt_kernel.launches)
    for device in (cuda, "cpu"):
        rast, scene, assets = build_map_refl_scene(192, 96, device=device)
        frames.append(rast.rasterize(scene, 192, 96, 40, assets).astype(np.int32))
    after = (megakernel.launches, visibility_pallas.launches, rt_kernel.launches)
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
    before = megakernel.launches
    rgba, z = megakernel.mega_render(*args, **kwargs)
    ref_rgba, ref_z = megakernel.mega_render_reference(*args, **kwargs)
    plain, _ = megakernel.mega_render(*args, **dict(kwargs, ao_img=None))
    torch.cuda.synchronize()
    assert megakernel.launches == before + 2
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
], ids=["ao", "sky_light", "refl_half", "ssaa2", "shadow", "shadow_refl"])
def test_cuda_frame_of_a_later_path_matches_cpu_frame(cuda, build, width, height):
    """The AO map, the sky-light scene, the half-scale reflection map, the
    SSAA2 map and the shadowed maps (without and with GGX reflections)
    through Rasterizer on the card and on the CPU."""
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

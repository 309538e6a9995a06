"""The CUDA kernels on the card: the megakernel (B1, both BRDFs), the
visibility pre-pass (B2) and the ray intersect (B3) against their plain
torch versions on the same inputs, and the whole CUDA frames (opaque and
with GGX reflections) against the CPU frames.

These tests need a GPU and skip with a reason elsewhere. They import no
jax, so they also run on a machine without it:

    RUSTERIX_TPU_TEST_PLATFORM=cuda python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: z_eff, the pre-pass's z and idx and the ray intersect's t and
idx equal; RGBA8 within 1 per channel (the kernels and the plain versions
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
from rusterix_tpu_torch.models import RenderSettings, Tile  # noqa: E402
from rusterix_tpu_torch.ops import megakernel, rt_kernel, visibility_pallas  # noqa: E402
from rusterix_tpu_torch.ops.raster import frame_inputs  # noqa: E402
from rusterix_tpu_torch.ops.setup_pass import setup_pass  # noqa: E402
from rusterix_tpu_torch.scenes import build_map_refl_scene, build_map_scene  # noqa: E402


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
    before = rt_kernel.launches
    t, idx = rt_kernel.intersect_rays_pallas(*args, 25.0, height, width)
    t_p, idx_p = rt_kernel.intersect_rays_pallas_reference(*args, 25.0, height, width)
    torch.cuda.synchronize()
    assert rt_kernel.launches == before + 1
    assert torch.equal(idx, idx_p)
    assert torch.equal(t, t_p)
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

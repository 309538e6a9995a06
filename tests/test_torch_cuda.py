"""The CUDA megakernel (B1) on the card: against its plain torch version
on the same inputs, and the whole CUDA frame against the CPU frame.

These tests need a GPU and skip with a reason elsewhere. They import no
jax, so they also run on a machine without it:

    RUSTERIX_TPU_TEST_PLATFORM=cuda python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: z_eff equal; RGBA8 within 1 per channel (the kernel and the
plain version round alike, -fmad=false; only expf may differ in an ulp).
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
from rusterix_tpu_torch._host import ref_module  # noqa: E402
from rusterix_tpu_torch.ops import megakernel  # noqa: E402
from rusterix_tpu_torch.ops.raster import mega_inputs  # noqa: E402
from rusterix_tpu_torch.scenes import build_map_scene  # noqa: E402


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
        tile = ref_module("models").Tile.from_texture(Texture.checkerboard(16, 4))
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
        rs = ref_module("models.render_settings").RenderSettings
        rast.apply_render_settings(rs(fog_density=0.15, fog_color=(0.6, 0.5, 0.4)))
    elif fog == "linear":  # the ShapeFX Fog node's fade
        rast._rs_has_fog = True
        rast._fog_color = np.array([0.2, 0.3, 0.4, 1.0], np.float32)
        rast._fog_end, rast._fog_fade = 1.5, 2.0
    rast.rasterize(scene, W, H, 32, assets)
    return mega_inputs(**rast.frame_args)


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

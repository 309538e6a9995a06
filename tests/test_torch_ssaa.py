"""rusterix_tpu_torch's supersampled antialiasing against the JAX package on
the CPU: the box filter (`ssaa_downsample` against `_ssaa_downsample`) on
seeded frames, and the bench's map_1920x1080_ssaa2 configuration at
128x64 (rendered at 256x128 inside) against the JAX Rasterizer's megakernel
path.

Tolerances: the box filter exactly (a sum of integers, one division, a
round half up); the frame within 1 per RGBA8 channel with the count of
differing pixels pinned (0 here).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench  # noqa: E402
from rusterix_tpu.ops.raster import _ssaa_downsample  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu_torch import Rasterizer  # noqa: E402
from rusterix_tpu_torch.ops.raster import ssaa_downsample  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ss", [2, 3])
def test_ssaa_downsample_matches_jax(ss):
    """Seeded u8 frames, every block mean including the .5 ties."""
    rng = np.random.default_rng(ss)
    frame = rng.integers(0, 256, (24 * ss, 40 * ss, 4), dtype=np.uint8)
    frame[:ss, :ss] = 0
    frame[0, :2] = 1  # ss 2: a block mean of exactly 0.5
    ref = np.asarray(_ssaa_downsample(jnp.asarray(frame), ss))
    out = ssaa_downsample(torch.from_numpy(frame), ss)
    assert out.dtype == torch.uint8 and out.shape == (24, 40, 4)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_ssaa2_map_frame_matches_jax_megakernel():
    w, h = 128, 64
    rast, scene, assets = bench.build_map_scene(w, h)
    rast.use_pallas = True
    rast.set_supersample(2)
    packed = PackedScene.from_scene(scene, assets, static_only=True)
    ref = rast.rasterize(scene, w, h, 40, assets, packed=packed).astype(np.int32)
    port = Rasterizer.setup(None, rast.view_matrix, rast.projection_matrix, device="cpu")
    port.ambient([0.25, 0.25, 0.3, 1.0]).set_supersample(2)
    out = port.rasterize(scene, w, h, 40, assets, packed=packed)
    assert out.shape == (h, w, 4) and port.frame_args["width"] == 2 * w
    assert int((np.abs(ref - out.astype(np.int32)).max(-1) > 0).sum()) == 0

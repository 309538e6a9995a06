"""rusterix_tpu_torch setup pass vs the JAX package's on the bench map and
box packs and on the near-plane clip cases of tests/test_clip_property.py.

Tolerances: `alive` and `tri_id` exactly; planes and bboxes
allclose(rtol=1e-6, atol=1e-6) (XLA on the CPU and torch may order or fuse
the arithmetic differently in the last bit). Dead slots may carry NaN
attribute planes in both packages; NaN compares equal to NaN here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from rusterix_tpu import Assets, Batch3D, CullMode, D3OrbitCamera, PixelSource, Scene  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu.ops.setup_pass import setup_pass as jax_setup_pass  # noqa: E402
from rusterix_tpu_torch.ops.setup_pass import setup_pass  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compare(packed, view, proj, width, height):
    d3 = vars(packed.d3)
    keys = ("pos", "uv", "nrm", "valid", "cull")
    ref = jax_setup_pass(*(jnp.asarray(d3[k]) for k in keys),
                         jnp.asarray(view), jnp.asarray(proj), width, height)
    out = setup_pass(*(torch.from_numpy(np.asarray(d3[k])) for k in keys),
                     torch.from_numpy(np.asarray(view, np.float32)),
                     torch.from_numpy(np.asarray(proj, np.float32)), width, height)
    vis, attr, bbox, alive, tri_id = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(out[3].numpy(), alive)
    np.testing.assert_array_equal(out[4].numpy(), tri_id)
    for got, want in zip(out[:3], (vis, attr, bbox)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6, equal_nan=True)
    return int(alive.sum())


def test_map_pack_matches():
    rast, scene, assets = bench.build_map_scene(320, 200)
    packed = PackedScene.from_scene(scene, assets, static_only=True)
    n = _compare(packed, rast.view_matrix, rast.projection_matrix, 320, 200)
    assert n > 100


def _box_pack_and_cam(cull=CullMode.Off):
    batch = Batch3D.from_box(-0.6, -0.6, -0.6, 1.2, 1.2, 1.2).with_computed_normals()
    batch.set_cull_mode(cull)
    batch.set_source(PixelSource.pixel((200, 150, 90, 255)))
    packed = PackedScene.from_scene(Scene.from_static([], [batch]), Assets.default())
    cam = D3OrbitCamera()
    cam.azimuth = 0.8
    cam.set_parameter_f32("distance", 2.5)
    return packed, cam


@pytest.mark.parametrize("cull", [CullMode.Off, CullMode.Back, CullMode.Front])
def test_box_pack_matches(cull):
    packed, cam = _box_pack_and_cam(cull)
    n = _compare(packed, cam.view_matrix(), cam.projection_matrix(192, 96), 192, 96)
    assert n > 0


def _random_pack(verts, cull=CullMode.Off):
    tris = np.arange(len(verts)).reshape(-1, 3)
    batch = Batch3D.new(verts, tris, np.zeros((len(verts), 2), np.float32))
    batch.set_cull_mode(cull)
    batch.set_source(PixelSource.pixel((255, 255, 255, 255)))
    return PackedScene.from_scene(Scene.from_static([], [batch]), Assets.default())


def _orbit(distance=2.0):
    cam = D3OrbitCamera()
    cam.azimuth = 0.7
    cam.set_parameter_f32("distance", distance)
    return cam


@pytest.mark.parametrize("seed", [3, 11])
def test_near_plane_straddlers_match(seed):
    """Triangles crossing the z = -0.1 view plane: the fixed-slot clip
    emission (one input triangle -> up to two candidates)."""
    rng = np.random.default_rng(seed)
    cam = _orbit()
    eye = cam.eye_position()
    fwd = -eye / np.linalg.norm(eye)
    n = 10
    centers = eye[None, :] + fwd[None, :] * rng.uniform(0.0, 0.3, (n, 1))
    verts = (centers[:, None, :] + rng.uniform(-0.6, 0.6, (n, 3, 3))).reshape(-1, 3)
    verts = np.concatenate([verts, np.ones((n * 3, 1))], axis=1).astype(np.float32)
    packed = _random_pack(verts)
    _compare(packed, cam.view_matrix(), cam.projection_matrix(128, 96), 128, 96)
    assert (packed.d3.valid > 0.5).sum() == n


@pytest.mark.parametrize("seed,cull", [(1, CullMode.Off), (7, CullMode.Back), (42, CullMode.Front)])
def test_random_triangles_match(seed, cull):
    rng = np.random.default_rng(seed)
    n = 12
    verts = rng.uniform(-1.5, 1.5, (n * 3, 3))
    verts = np.concatenate([verts, np.ones((n * 3, 1))], axis=1).astype(np.float32)
    cam = _orbit()
    _compare(_random_pack(verts, cull), cam.view_matrix(), cam.projection_matrix(128, 96), 128, 96)

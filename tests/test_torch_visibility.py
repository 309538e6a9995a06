"""rusterix_tpu_torch visibility_pass (the plain XLA-formulation scan the
megakernel's plain version shares its step with) vs the JAX package's, on
the bench map's candidates at 128x64.

Tolerances: winner indices exactly (the strict `>` keeps the first slot on
ties in both); z allclose(rtol=1e-6, atol=1e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu.ops.setup_pass import setup_pass as jax_setup_pass  # noqa: E402
from rusterix_tpu.ops.visibility import visibility_pass as jax_visibility_pass  # noqa: E402
from rusterix_tpu_torch.ops.visibility import visibility_pass  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 128, 64


@pytest.fixture(scope="module")
def map_planes():
    rast, scene, assets = bench.build_map_scene(W, H)
    d3 = vars(PackedScene.from_scene(scene, assets, static_only=True).d3)
    vis, _attr, _bbox, alive, _tid = jax_setup_pass(
        *(jnp.asarray(d3[k]) for k in ("pos", "uv", "nrm", "valid", "cull")),
        jnp.asarray(rast.view_matrix), jnp.asarray(rast.projection_matrix), W, H,
    )
    return np.array(vis), np.array(alive, np.float32)


@pytest.mark.parametrize("peel", [False, True])
def test_visibility_pass_matches(map_planes, peel):
    """Nearest layer, and with `peel` the second layer under a z_ceil."""
    vis, alive = map_planes
    z_ref, idx_ref, hit_ref, inv_ref = jax_visibility_pass(
        jnp.asarray(vis), jnp.asarray(alive), W, H, return_invz=True
    )
    z, idx, hit, inv = visibility_pass(torch.from_numpy(vis), torch.from_numpy(alive), W, H,
                                       return_invz=True)
    if peel:
        z_ref, idx_ref, hit_ref = jax_visibility_pass(
            jnp.asarray(vis), jnp.asarray(alive), W, H, z_ceil=inv_ref
        )
        z, idx, hit = visibility_pass(torch.from_numpy(vis), torch.from_numpy(alive), W, H,
                                      z_ceil=torch.from_numpy(np.array(inv_ref)))
    assert 0 < int(hit.sum()) < W * H
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=1e-6, atol=1e-6)

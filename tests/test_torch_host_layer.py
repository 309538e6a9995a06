"""The port's jax-free host layer: rusterix_tpu_torch imports, builds,
packs and renders with every jax import blocked, and the JAX package's
numpy modules it mounts pack the bench map exactly as the JAX package does.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench  # noqa: E402
from rusterix_tpu.ops.scene_pack import PackedScene  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_JAX_SCRIPT = textwrap.dedent(
    """
    import sys

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError("jax is blocked: " + name)
            return None

    sys.meta_path.insert(0, BlockJax())
    import rusterix_tpu_torch
    from rusterix_tpu_torch.scenes import build_map_scene

    rast, scene, assets = build_map_scene(64, 32, device="cpu")
    packed = rusterix_tpu_torch.PackedScene.from_scene(scene, assets, static_only=True)
    frame = rast.rasterize(scene, 64, 32, 40, assets)
    assert frame.shape == (32, 64, 4) and frame.dtype.name == "uint8", frame.shape
    assert int(packed.d3.valid.sum()) > 100
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    assert not loaded, loaded
    print("no-jax ok", int((frame[..., 3] > 0).sum()))
    """
)


def test_port_runs_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", NO_JAX_SCRIPT],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-jax ok" in proc.stdout


def test_mounted_packer_matches_jax_package():
    """The map PackedScene built through the mount equals the JAX package's,
    array for array, byte for byte."""
    from rusterix_tpu_torch import PackedScene as MountedPackedScene
    from rusterix_tpu_torch.scenes import build_map_scene

    assert MountedPackedScene is not PackedScene  # same file, other module
    _rast, scene, assets = bench.build_map_scene(128, 64)
    ref = PackedScene.from_scene(scene, assets, static_only=True)
    _port_rast, pscene, passets = build_map_scene(128, 64, device="cpu")
    got = MountedPackedScene.from_scene(pscene, passets, static_only=True)
    for part in ("d3", "d3_opacity", "d2", "d2_lines"):
        for name, want in vars(getattr(ref, part)).items():
            have = getattr(getattr(got, part), name)
            assert np.asarray(have).tobytes() == np.asarray(want).tobytes(), (part, name)
    for name, want in ref.lights.items():
        assert np.asarray(got.lights[name]).tobytes() == np.asarray(want).tobytes(), name
    atlas, want_atlas = got.atlas_index.atlas, ref.atlas_index.atlas
    for name in ("data", "rects", "opaque", "tile_first", "tile_count"):
        assert getattr(atlas, name).tobytes() == getattr(want_atlas, name).tobytes(), name
    for name, want in ref.occlusion.items():
        assert np.asarray(got.occlusion[name]).tobytes() == np.asarray(want).tobytes(), name


@pytest.mark.parametrize("module", ["shader", "shader.jaxc"])
def test_shader_compiler_fails_loudly_under_the_mount(module):
    """The rusteria compiler is jax code; through the mount both lazy
    import sites (`..shader` and the packer's `..shader.jaxc`) raise
    instead of importing jax."""
    from rusterix_tpu_torch._host import ref_module

    with pytest.raises(NotImplementedError, match="shader compiler"):
        ref_module(module).Rusteria  # noqa: B018

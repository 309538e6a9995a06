"""The port's own host layer: rusterix_tpu_torch imports, builds, packs
and renders with every jax import blocked and without loading any file of
the JAX package; its copies of the JAX package's numpy modules pack the
bench map exactly as the JAX package does.
"""

import ast
import glob
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


NO_JAX_PACKAGE_SCRIPT = textwrap.dedent(
    """
    import os
    import sys

    import rusterix_tpu_torch
    from rusterix_tpu_torch.scenes import build_map_refl_scene, build_map_shadow_refl_scene

    rast, scene, assets = build_map_refl_scene(64, 32, device="cpu")
    frame = rast.rasterize(scene, 64, 32, 40, assets)
    assert frame.shape == (32, 64, 4) and frame.dtype.name == "uint8", frame.shape
    rast, scene, assets = build_map_shadow_refl_scene(64, 32, device="cpu")
    frame = rast.set_shadows(True, res=16, sun_res=32).rasterize(scene, 64, 32, 40, assets)
    assert frame.shape == (32, 64, 4) and rast.frame_args["shadow_spec"][0] is not None
    assert "rusterix_tpu_torch.ops.shadow" in sys.modules
    jax_pkg = os.path.join(os.getcwd(), "rusterix_tpu") + os.sep
    files = [getattr(m, "__file__", None) or "" for m in list(sys.modules.values())]
    from_jax_pkg = sorted(f for f in files if os.path.abspath(f).startswith(jax_pkg))
    assert not from_jax_pkg, from_jax_pkg
    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    assert not jax_mods, jax_mods
    print("own host layer ok", len(files))
    """
)


def test_port_loads_no_file_of_the_jax_package():
    """The reflection frame and the shadowed reflection frame (every module
    of the slice, the shadow maps among them) render without loading any
    file of rusterix_tpu/ and without importing jax."""
    proc = subprocess.run(
        [sys.executable, "-c", NO_JAX_PACKAGE_SCRIPT],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "own host layer ok" in proc.stdout


def _names_jax_package(path):
    """(line, what) of every import of rusterix_tpu and every string
    constant equal to "rusterix_tpu" (a path built at run time) in a file."""
    tree = ast.parse(open(path).read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Constant) and node.value == "rusterix_tpu":
            found.append((node.lineno, "string 'rusterix_tpu'"))
            continue
        else:
            continue
        found += [(node.lineno, n) for n in names if n.split(".")[0] == "rusterix_tpu"]
    return found


def test_port_sources_name_no_jax_package():
    files = sorted(glob.glob(os.path.join(ROOT, "rusterix_tpu_torch", "**", "*.py"),
                             recursive=True))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 40
    hits = {os.path.relpath(f, ROOT): _names_jax_package(f) for f in files}
    assert not {f: h for f, h in hits.items() if h}


def test_mounted_packer_matches_jax_package():
    """The map PackedScene built by the port's copied host layer equals the
    JAX package's, array for array, byte for byte."""
    from rusterix_tpu_torch import PackedScene as MountedPackedScene
    from rusterix_tpu_torch.scenes import build_map_scene

    assert MountedPackedScene is not PackedScene
    assert MountedPackedScene.__module__ == "rusterix_tpu_torch.ops.scene_pack"
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
    """The rusteria compiler is jax code the port has not ported; both lazy
    import sites of the copied host layer (`..shader` and the packer's
    `..shader.jaxc`) land on the port's stub and raise."""
    import importlib

    stub = importlib.import_module(f"rusterix_tpu_torch.{module}")
    with pytest.raises(NotImplementedError, match="shader compiler"):
        stub.Rusteria  # noqa: B018

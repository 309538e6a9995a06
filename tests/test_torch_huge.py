"""The huge scene of rusterix_tpu_torch (`scenes.build_huge_scene`, the
JAX package's tools/bench_huge.py scene) and B3's tuning knobs
(tools/bench_rt_sweep_torch.py) on the CPU: the packed scene byte-equal to
the JAX package's pack of tools/bench_huge.build_huge_scene at 300 boxes,
the port's frame of it at 64x36 against the JAX megakernel frame (B1 in
interpret mode; the one JAX frame of this file), and the knobs' refusals
and build directories, without a build.

Tolerance: the packs are byte-equal; the frames are equal but for
PINNED_TIES pixels (the coplanar z-tie class: the boxes' random sizes give
no coplanar faces here, so none).
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rusterix_tpu.ops.scene_pack import PackedScene as JaxPackedScene  # noqa: E402
from rusterix_tpu_torch.ops import rt_kernel  # noqa: E402
from rusterix_tpu_torch.ops.scene_pack import PackedScene  # noqa: E402
from rusterix_tpu_torch.scenes import build_huge_scene, huge_rasterizer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BOXES = 300
W, H = 64, 36
PINNED_TIES = 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool():
    """tools/bench_huge.py as a module (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location("bench_huge", os.path.join(ROOT, "tools",
                                                                             "bench_huge.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scenes():
    return _jax_tool().build_huge_scene(N_BOXES), build_huge_scene(N_BOXES)


def test_huge_pack_equals_the_jax_package_pack(scenes):
    (jscene, _jcam, jassets), (scene, _cam, assets) = scenes
    want = JaxPackedScene.from_scene(jscene, jassets, static_only=True)
    got = PackedScene.from_scene(scene, assets, static_only=True, device="cpu")
    assert got.d3.pos.shape[0] == 4096 and int((got.d3.valid > 0.5).sum()) == 12 * N_BOXES
    for part in ("d3", "d3_opacity", "d2"):
        for name, w in vars(getattr(want, part)).items():
            assert np.asarray(getattr(getattr(got, part), name)).tobytes() == \
                np.asarray(w).tobytes(), (part, name)
    for name, w in want.lights.items():
        assert np.asarray(got.lights[name]).tobytes() == np.asarray(w).tobytes(), name


def test_huge_frame_equals_the_jax_frame(scenes):
    (jscene, jcam, jassets), (scene, cam, assets) = scenes
    from rusterix_tpu.ops.raster import Rasterizer as JaxRasterizer

    jr = JaxRasterizer.setup(None, jcam.view_matrix(), jcam.projection_matrix(W, H)).ambient(
        [0.3, 0.3, 0.35, 1.0])
    jr.sun_dir = np.array([0.4, -1.0, 0.25], np.float32)
    jr.day_factor = 1.0
    jr.use_pallas = True  # the megakernel path, in interpret mode here
    want = jr.rasterize(jscene, W, H, 40, jassets)
    got = huge_rasterizer(cam, W, H, "cpu").rasterize(scene, W, H, 40, assets)
    diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert int((diff > 0).sum()) == PINNED_TIES
    assert int((got[..., :3] != want[0, 0, :3]).any(-1).sum()) > 50  # boxes were drawn


@pytest.mark.parametrize("env, want", [
    ({"RUSTERIX_TPU_RT_BH": "16", "RUSTERIX_TPU_RT_BW": "128"}, "at most 1024 threads"),
    ({"RUSTERIX_TPU_RT_BH": "2", "RUSTERIX_TPU_RT_BW": "128"}, "whole rounds"),
    ({"RUSTERIX_TPU_RT_CELL": "512"}, "a multiple of 8 from 8 to 256"),
], ids=["tile_over_1024", "tile_under_512", "cell_too_large"])
def test_rt_knobs_refuse_what_the_kernels_cannot_take(env, want):
    with pytest.raises(ValueError, match=want):
        rt_kernel.rt_knobs(env)


def test_rt_knobs_defaults():
    assert rt_kernel.rt_knobs({}) == rt_kernel.DEFAULT_KNOBS == (64, 8, 128)
    assert rt_kernel.rt_knobs({"RUSTERIX_TPU_RT_CELL": "32", "RUSTERIX_TPU_RT_BH": "4"}) == \
        (32, 4, 128)


def _run_with(env: dict, code: str):
    clean = {k: v for k, v in os.environ.items() if not k.startswith("RUSTERIX_TPU_RT_")}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=dict(clean, **env),
                          capture_output=True, text=True, timeout=120)


def test_sweep_tool_refuses_a_tile_over_1024_before_any_build():
    out = _run_with({"RUSTERIX_TPU_RT_BH": "16"},
                    "import sys; sys.argv = ['x']; sys.path.insert(0, 'tools'); "
                    "import bench_rt_sweep_torch as t; t.main([])")
    assert out.returncode != 0 and "at most 1024 threads a block" in out.stderr


def test_knobs_pick_the_build_directory_and_flags():
    code = ("from rusterix_tpu_torch import _cuda; import os; "
            "print(os.path.relpath(_cuda.BUILD_DIR, _cuda._PKG), _cuda.KNOB_DEFINES)")
    default = _run_with({}, code)
    assert default.returncode == 0 and default.stdout.split()[0] == "_build"
    assert default.stdout.strip().endswith("[]")
    other = _run_with({"RUSTERIX_TPU_RT_CELL": "32"}, code)
    assert other.returncode == 0
    assert other.stdout.split()[0] == os.path.join("_build", "rt_cell32_bh8_bw128")
    assert "'-DRT_CELL=32', '-DRT_BH=8', '-DRT_BW=128'" in other.stdout

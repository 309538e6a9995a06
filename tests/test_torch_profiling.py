"""`rusterix_tpu_torch.profiling.frame_breakdown` on the CPU (64x48, one
timed call a phase): the JAX function's key set (rusterix_tpu/profiling.py:
84-202) on the megakernel scene (the map), the split-path scene (the map
under a runtime floor shader) and a scene with the render graph's sky,
opacity batches, 2D batches, dynamic batches and the brush preview (the
map with dynamic billboards, a translucent one, a 2D rectangle); every
value finite and >= 0, and no ablation key for a phase the scene lacks.
CPU times are wall times: nothing here is a device number.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rusterix_tpu_torch.ops.raster import BrushPreview  # noqa: E402
from rusterix_tpu_torch.profiling import frame_breakdown  # noqa: E402
from rusterix_tpu_torch.scenes import (  # noqa: E402
    build_map_dynamic_scene,
    build_map_runtime_shader_scene,
    build_map_scene,
)
from rusterix_tpu_torch.shapefx import ShapeFXGraph  # noqa: E402

W, H = 64, 48
WHOLE = {"frame_ms", "fps", "full_frame_ms"}
MEGAKERNEL = {"setup_ms", "pack_morton_ms", "megakernel_ms"} | WHOLE
SPLIT = {"setup_ms", "visibility_ms", "shade_ms"} | WHOLE
ABLATIONS = {"sky_ms", "opacity_ms", "d2_ms", "dyn_concat_ms", "brush_ms"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features():
    """The map with dynamic batches (an opaque and a translucent billboard,
    a 2D rectangle), the render graph's sky at hour 14 and the brush."""
    rast, scene, assets = build_map_dynamic_scene(W, H, device="cpu")
    rast.set_shadows(False)
    rast.render_graph = ShapeFXGraph.default_render_graph(with_sky=True)
    rast.hour = 14.0
    rast.brush_preview = BrushPreview(position=np.array([8.0, 0.0, 9.0], np.float32),
                                      radius=2.0)
    return rast, scene, assets


@pytest.mark.parametrize("build, keys", [
    (lambda: build_map_scene(W, H, device="cpu"), MEGAKERNEL),
    (lambda: build_map_runtime_shader_scene(W, H, device="cpu", rooms_x=2), SPLIT),
    (_features, MEGAKERNEL | ABLATIONS),
], ids=["megakernel", "split", "sky_opacity_d2_dyn_brush"])
def test_frame_breakdown_keys_and_values(build, keys):
    rast, scene, assets = build()
    out = frame_breakdown(rast, scene, assets, W, H, reps=1)
    assert set(out) == keys
    for k, v in out.items():
        assert math.isfinite(v) and v >= 0.0, (k, v)
    assert out["fps"] == pytest.approx(1e3 / out["frame_ms"])

"""The traffic follows from the seed and the frame's index alone, and the
benchmark's camera matrices are those of the port's camera."""

import numpy as np
import pytest

from rxbench.lib import manifest as mf
from rxbench.lib.traffic import Traffic, camera

MAN = mf.load()
CFG = mf.config(mf.cell(MAN, MAN["workloads"][0]["name"])["config_entry"])
BIG_SEED = 2 ** 31 + 12345


def _frames(mix, seed, idx=(0, 1, 57, 333, 2999)):
    w = Traffic(mf.traffic(mix), CFG, seed)
    return [w.frame(i) for i in idx]


def _same(a, b):
    return all(np.array_equal(x["eye"], y["eye"]) and np.array_equal(x["target"], y["target"])
               and x["dynamic"] == y["dynamic"] for x, y in zip(a, b))


@pytest.mark.parametrize("mix", ["walk", "entities"])
def test_same_seed_same_frames_other_seed_other_frames(mix):
    assert _same(_frames(mix, BIG_SEED), _frames(mix, BIG_SEED))
    assert not _same(_frames(mix, BIG_SEED), _frames(mix, BIG_SEED + 1))


@pytest.mark.parametrize("mix", ["walk", "entities"])
def test_the_walk_stays_inside_the_map_at_eye_height(mix):
    w = Traffic(mf.traffic(mix), CFG, 7)
    side = CFG["rooms_x"] * CFG["room_size"]
    for i in range(0, 4000, 37):
        f = w.frame(i)
        assert 0 < f["eye"][0] < side and 0 < f["eye"][2] < side
        assert f["eye"][1] == pytest.approx(1.6)
        for d in f["dynamic"]:
            if d["kind"] == "billboard":
                assert 0 < d["x"] < side and 0 < d["z"] < side


def test_camera_matrices_equal_the_ports():
    from rusterix_tpu_torch.ops.matrices import look_at_rh, perspective_fov_rh_zo

    f = Traffic(mf.traffic("walk"), CFG, 3).frame(41)
    view, proj = camera(f, dict(CFG, width=1920, height=1080))
    np.testing.assert_allclose(view, look_at_rh(f["eye"], f["target"], [0, 1, 0]), atol=1e-6)
    np.testing.assert_allclose(
        proj, perspective_fov_rh_zo(np.radians(75.0), 1920, 1080, 0.01, 100.0), rtol=1e-6)

"""The per-frame arena of rusterix_tpu_torch (ops/arena.py,
raster.render_frame_arena) against the JAX package on the CPU: the round
trip of a tree through one buffer, the refusals, the arena's words against
the JAX package's `pack_arena` on the map scene's per-frame tree, the
rasterize frame through the arena against `render_frame` over the stashed
arguments with every leaf uploaded on its own (tests/test_arena.py's
dynamic box scene, and the map with lights and AO), and one JAX frame of
the dynamic box scene (its megakernel path, B1 in interpret mode).

Tolerance: the round trip is bit-equal in shape, dtype and value; the
words are equal; the frames are byte-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rusterix_tpu as jrt  # noqa: E402
import rusterix_tpu_torch as trt  # noqa: E402
from rusterix_tpu.ops.arena import pack_arena as jax_pack_arena  # noqa: E402
from rusterix_tpu_torch.ops import arena  # noqa: E402
from rusterix_tpu_torch.ops.raster import render_frame  # noqa: E402
from rusterix_tpu_torch.profiling import counters  # noqa: E402
from rusterix_tpu_torch.scenes import build_map_ao_scene, build_map_scene  # noqa: E402

W, H = 96, 72


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {
        "a": np.arange(12, dtype=np.float32).reshape(3, 4),
        "nested": {
            "i": np.array([-5, 7], np.int32),
            "u": np.array([1, 0xFFFFFFFF], np.uint32),
            "scalar": np.float32(3.25),
            "empty": np.zeros((0, 4), np.float32),
        },
        "none": None,
        "seq": (np.float32(-0.0), [np.array([[1.5]], np.float32)]),
    }


def test_pack_unpack_round_trip_is_bit_equal():
    tree = _tree()
    words, layout = arena.pack_arena(tree)
    assert words.dtype == np.uint32 and words.size == 12 + 2 + 2 + 1 + 0 + 1 + 1
    dev = arena.upload(words, torch.device("cpu"))
    out = arena.unpack_arena(dev, layout)
    flat_in, def_in = arena.tree_flatten(tree)
    flat_out, def_out = arena.tree_flatten(out)
    assert def_in == def_out and out["none"] is None and isinstance(out["seq"][1], list)
    for x, y in zip(flat_in, flat_out):
        x, y = np.asarray(x), y.numpy()
        assert y.shape == x.shape and y.dtype == x.dtype
        assert y.tobytes() == x.tobytes()
    # the layout is cached by the tree's structure: the same structure
    # packs into the same layout object, with the new values
    tree["a"] = tree["a"] + 1
    words2, layout2 = arena.pack_arena(tree)
    assert layout2 is layout and words2[1] == np.float32(2.0).view(np.uint32)


@pytest.mark.parametrize("leaf", [np.zeros(3, np.bool_), np.zeros(3, np.float64),
                                  torch.zeros(3)], ids=["bool", "f64", "tensor"])
def test_pack_refuses_leaves_that_are_not_host_words(leaf):
    before = counters["arena.refusal"]
    assert arena.pack_arena({"x": np.zeros(2, np.float32), "y": leaf}) == (None, None)
    assert counters["arena.refusal"] == before + 1


def _per_frame(rast):
    """The JAX package's per-frame tree of the port's last frame: (d3_dyn,
    d3_op_dyn, d2_dyn, lights, uniforms), the dicts as the host built them."""
    fa = rast.frame_args
    return (None, None, None, dict(fa["lights"]), dict(fa["uniforms"]))


def test_arena_words_equal_the_jax_package_words():
    rast, scene, assets = build_map_scene(64, 48, device="cpu")
    rast.rasterize(scene, 64, 48, 40, assets)
    tree = _per_frame(rast)
    words, layout = arena.pack_arena(tree)
    jwords, jlayout = jax_pack_arena(tree)
    assert words is not None and jwords is not None
    np.testing.assert_array_equal(words, jwords)
    assert layout[0] == jlayout[0]


def _dyn_scene(pkg):
    """tests/test_arena.py's scene: a static box, a dynamic box, a light."""
    scene = pkg.Scene()
    scene.d3_static = [pkg.Batch3D.from_box(-1.0, -1.0, -1.0, 2.0, 2.0, 2.0)]
    scene.d3_dynamic = [pkg.Batch3D.from_box(1.5, 0.0, 0.0, 0.5, 0.5, 0.5)]
    scene.lights = [pkg.Light(pkg.LightType.Point).with_position([0.0, 2.0, 3.0])]
    scene.touch()
    scene.touch_dynamic()
    return scene


def _dyn_rasterizer(pkg, **kw):
    cam = pkg.D3OrbitCamera()
    rast = pkg.Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(W, H), **kw)
    return rast.ambient([0.3, 0.3, 0.3, 1.0])


def _per_leaf(rast):
    """render_frame over the rasterizer's stashed arguments with plain host
    dicts for the lights and uniforms: every consumer uploads its leaves."""
    fa = rast.frame_args
    return render_frame(**dict(fa, lights=dict(fa["lights"]), uniforms=dict(fa["uniforms"])))


@pytest.fixture(scope="module")
def dyn_frames():
    """-> (the JAX frame, the port frame, the port Rasterizer) of the
    dynamic box scene."""
    jr = _dyn_rasterizer(jrt)
    jr.use_pallas = True  # the megakernel path, in interpret mode here
    want = jr.rasterize(_dyn_scene(jrt), W, H, 32, jrt.Assets.default())
    tr = _dyn_rasterizer(trt, device="cpu")
    uploads = counters["arena.upload"]
    got = tr.rasterize(_dyn_scene(trt), W, H, 32, trt.Assets.default())
    assert counters["arena.upload"] == uploads + 1
    return want, got, tr


def test_dynamic_box_frame_through_the_arena_equals_per_leaf(dyn_frames):
    _want, got, tr = dyn_frames
    assert tr.frame_arena is not None
    fa = tr.frame_args
    assert isinstance(fa["uniforms"], arena.Staged) and isinstance(fa["lights"], arena.Staged)
    # the dynamic box's 12 triangles follow the static pack on the device
    assert int(fa["d3"]["valid"][-16:].sum()) == 12
    np.testing.assert_array_equal(got, _per_leaf(tr).numpy())


def test_dynamic_box_frame_equals_jax(dyn_frames):
    want, got, _tr = dyn_frames
    np.testing.assert_array_equal(got, want)


def test_lit_ao_map_frame_through_the_arena_equals_per_leaf():
    rast, scene, assets = build_map_ao_scene(64, 48, device="cpu")
    frame = rast.rasterize(scene, 64, 48, 40, assets)
    assert rast.frame_args["ao_taps"] and rast.frame_arena is not None
    assert len(rast.frame_args["lights"].dev["valid"]) > 1
    np.testing.assert_array_equal(frame, _per_leaf(rast).numpy())

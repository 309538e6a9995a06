"""The port's mesh over several CUDA cards, as far as the CPU can hold it:

- `card_mesh(n)` gives the first n cards of the machine or raises (CUDA's
  count monkeypatched), and `check_mesh` refuses a card past the count;
- each device's static state (the padded pack and its shards, the atlas,
  the 2D pack, the shadow rows, the background's rows; with glass the
  opacity pack, under the render graph's sky its parameters) is placed
  once per scene: two frames over `make_mesh(4, "cpu")` share the same
  tensors, a new scene revision or a moved shadow caster replaces them,
  and the frames stay byte-equal to the single frame and to a frame
  placed anew; the packs a frame's dynamic batches are concatenated into,
  and the shadow rows its casters are composited into, are placed anew
  every frame;
- the frame's per-frame leaves reach each device in one arena upload, and a
  slab's B1 parameter pack is the frame's with its row offset written on
  the device, bit for bit;
- the tracer places its scene once per device (the "meta" device stands in
  for another card);
- every launch and resource query of a CUDA kernel in the port goes through
  `_cuda.on_device`, which makes the tensors' device current (a source
  rule, like test_torch_host_layer.py's import scan).

The kernels on cards other than the first, and the frames over several
cards, are held on the card in tests/test_torch_cuda.py (marker cuda).
No JAX frame is rendered here. Tolerances: the frames exactly.
"""

import ast
import glob
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rusterix_tpu_torch import _cuda  # noqa: E402
from rusterix_tpu_torch.ops import arena, raster  # noqa: E402
from rusterix_tpu_torch.ops.megakernel import mega_param_row, pack_mega_params  # noqa: E402
from rusterix_tpu_torch.profiling import counters  # noqa: E402
from rusterix_tpu_torch.parallel import (  # noqa: E402
    card_mesh,
    check_mesh,
    make_mesh,
    sharded_inputs,
)
from rusterix_tpu_torch.scenes import (  # noqa: E402
    build_map_scene,
    build_map_shadow_scene,
    build_tracer_scene,
)
from rusterix_tpu_torch.tracer import AccumBuffer, Tracer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "rusterix_tpu_torch")
W, H = 64, 32
MESH4 = make_mesh(4, "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps the parallel
    test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def four_cards(monkeypatch):
    """A machine with four CUDA cards, as torch.cuda reports it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


def test_card_mesh_gives_the_first_cards(four_cards):
    assert card_mesh() == tuple(torch.device("cuda", i) for i in range(4))
    assert card_mesh(2) == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match="5 cards asked for, the machine has 4"):
        card_mesh(5)
    with pytest.raises(ValueError):
        card_mesh(0)


def test_card_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        card_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        card_mesh(1)


def test_check_mesh_refuses_a_card_past_the_count(four_cards):
    assert check_mesh(("cuda:0", "cuda:3")) == (torch.device("cuda", 0),
                                                torch.device("cuda", 3))
    with pytest.raises(RuntimeError, match="cuda:4 was asked for, but the machine has 4"):
        check_mesh(("cuda:0", "cuda:4"))
    with pytest.raises(RuntimeError, match="cuda:7"):
        check_mesh([torch.device("cuda", 7)])


def _placed(rast):
    """The rasterizer's scene cache entry's store of placed static state."""
    (entry,) = raster._SCENE_CACHE.values()
    return entry["placed"]


def _static_tensors(store) -> dict:
    """key -> the placed tensor(s) of a store, for identity checks."""
    return {k: v[1] for k, v in store.items()}


def test_static_state_is_placed_once_per_scene():
    """Two sharded frames of the map in 4 slabs place the padded pack, the
    atlas, the 2D pack and the background's rows once, and equal the single
    frame; the slabs' inputs read them; a new revision of the scene starts
    a new store."""
    rast, scene, assets = build_map_scene(W, H, device="cpu")
    single = rast.rasterize(scene, W, H, 40, assets)
    uploads, leaf_frames = counters["arena.upload"], counters["arena.leaf_frame"]
    first = rast.rasterize(scene, W, H, 40, assets, mesh=MESH4)
    # the per-frame leaves: one arena upload a device (one device here)
    assert (counters["arena.upload"] - uploads,
            counters["arena.leaf_frame"] - leaf_frames) == (1, 0)
    store = _placed(rast)
    kept = _static_tensors(store)
    assert {k[0] if isinstance(k[0], str) else k[0][0] for k in kept} == {
        "d3", "atlas", "d2", "background"}
    second = rast.rasterize(scene, W, H, 40, assets, mesh=MESH4)
    assert _placed(rast) is store and _static_tensors(store).keys() == kept.keys()
    assert all(_static_tensors(store)[k] is v for k, v in kept.items())
    np.testing.assert_array_equal(first, single)
    np.testing.assert_array_equal(second, single)

    # the slabs' inputs read the placed tensors
    fa = {k: v for k, v in rast.frame_args.items() if k != "refl_scale"}
    slabs = sharded_inputs(MESH4, placed=store, **fa)
    local = slabs[0]["local"]
    assert local["d3"]["pos"] is kept[(("d3", 4), "pos", torch.device("cpu"))]
    assert local["atlas"]["flat_u32"] is kept[("atlas", "flat_u32", torch.device("cpu"))]
    assert all(fi["local"]["d3"]["pos"] is local["d3"]["pos"] for fi in slabs)
    assert slabs[1]["shard"]["pos"].data_ptr() == (
        local["d3"]["pos"][slabs[1]["shard"]["pos"].shape[0]:].data_ptr())

    scene.revision += 1
    rast.rasterize(scene, W, H, 40, assets, mesh=MESH4)
    renewed = _placed(rast)
    assert renewed is not store
    assert all(v is not kept[k] for k, v in _static_tensors(renewed).items() if k in kept)


def test_moved_caster_replaces_the_placed_shadow_rows():
    """With shadow maps the rows are placed once: the store keeps the
    frame's bake while the shadow cache gives the same tensor, and takes the
    new one when a caster moves (the cache then gives another tensor, here a
    copy of the bake standing in for it)."""
    rast, scene, assets = build_map_shadow_scene(W // 2, H // 2, device="cpu")
    rast.set_shadows(True, res=4, sun_res=8)
    mesh = make_mesh(2, "cpu")
    rast.rasterize(scene, W // 2, H // 2, 40, assets, mesh=mesh)
    store = _placed(rast)
    key = ("shadow_rows", torch.device("cpu"))
    rows = store[key][1]
    assert rows is rast.frame_args["shadow_rows"]
    fa = {k: v for k, v in rast.frame_args.items() if k != "refl_scale"}
    assert sharded_inputs(mesh, placed=store, **fa)[1]["local"]["shadow_rows"] is rows
    rebaked = rows.clone()
    slabs = sharded_inputs(mesh, placed=store, **dict(fa, shadow_rows=rebaked))
    assert store[key][1] is rebaked and slabs[1]["local"]["shadow_rows"] is rebaked


def _role(key) -> str:
    """A placed store key's role: "d3", "atlas", "d2", "d3_op", "sky_pre",
    "shadow_rows" or "background"."""
    return key[0][0] if isinstance(key[0], tuple) else key[0]


def test_glass_and_sky_state_is_placed_once_per_scene():
    """The feature scene under the render graph's sky (opacity batches, sky
    parameters, shadow maps) in 4 slabs: the opacity pack, the sky's
    parameters and the 2D pack are placed on the first frame and the second
    frame reads the same tensors; both frames equal the single frame."""
    from rusterix_tpu_torch.scenes import build_feature_scene
    from rusterix_tpu_torch.shapefx import ShapeFXGraph

    rast, scene, assets = build_feature_scene(W, H, device="cpu")
    rast.render_graph = ShapeFXGraph.default_render_graph(with_sky=True, with_fog=True)
    rast.set_shadows(True, res=8, sun_res=16)
    single = rast.rasterize(scene, W, H, 40, assets)
    fa = rast.frame_args
    assert fa["has_opacity"] and fa["has_sky"] and fa["shadow_spec"] is not None
    first = rast.rasterize(scene, W, H, 40, assets, mesh=MESH4)
    kept = _static_tensors(_placed(rast))
    roles = {_role(k) for k in kept}
    assert {"d3_op", "sky_pre", "d2", "shadow_rows"} <= roles
    second = rast.rasterize(scene, W, H, 40, assets, mesh=MESH4)
    now = _static_tensors(_placed(rast))
    assert now.keys() == kept.keys() and all(now[k] is v for k, v in kept.items())
    np.testing.assert_array_equal(first, single)
    np.testing.assert_array_equal(second, single)


def test_dynamic_packs_are_placed_anew_every_frame():
    """V's scene (the shadowed map with dynamic billboards, casters and a
    2D rectangle) in 4 slabs over two frames at two move times: the packs
    concatenated with the frame's dynamic batches and the shadow rows the
    casters are composited into are placed anew every frame (new tensors
    every frame, as the JAX package moves them every frame); the atlas and
    the background's rows are kept. The frame equals the single frame."""
    from rusterix_tpu_torch.scenes import build_map_dynamic_scene, move_dynamic

    rast, scene, assets = build_map_dynamic_scene(W, H, device="cpu")
    rast.set_shadows(True, res=4, sun_res=8)
    stores = []
    for t in (0.5, 1.0):
        move_dynamic(scene, t)
        frame = rast.rasterize(scene, W, H, 40, assets, mesh=MESH4)
        stores.append(_static_tensors(_placed(rast)))
    single = rast.rasterize(scene, W, H, 40, assets)
    np.testing.assert_array_equal(frame, single)
    first, second = stores
    assert first.keys() == second.keys()
    for key, value in second.items():
        anew = _role(key) in ("d3", "d3_op", "d2", "shadow_rows")
        assert (value is not first[key]) == anew, key
    assert {_role(k) for k in second} == {"d3", "d3_op", "d2", "shadow_rows", "atlas",
                                           "background"}


@pytest.fixture(scope="module")
def map_frame_args():
    """The map's single frame's render_frame arguments (the arena route)."""
    rast, scene, assets = build_map_scene(W, H, device="cpu")
    rast.rasterize(scene, W, H, 40, assets)
    return rast.frame_args


@pytest.mark.parametrize("y0", [0, 8, 135, 945])
def test_slab_parameter_pack_is_written_on_the_device(map_frame_args, y0):
    """A slab's B1 parameter pack: the frame's pack from the arena with its
    row offset set on the device, bit for bit mega_param_row(y0)."""
    fa = map_frame_args
    uni = fa["uniforms"]
    assert isinstance(uni, arena.Staged)
    got = pack_mega_params(uni, W, H, fa["atlas"]["w"], torch.device("cpu"), y0=y0,
                           shadow_params=fa["shadow_params"])
    want = mega_param_row(uni, W, H, fa["atlas"]["w"], y0=y0, shadow_params=fa["shadow_params"])
    assert got.numpy().tobytes() == want.tobytes()


def test_tracer_places_its_scene_once_per_device():
    """trace_sharded's devices other than the tracer's get the packed scene
    once per scene: the same tensors on the second call, new ones after a
    new revision (the meta device stands in for another card)."""
    scene, cam, assets = build_tracer_scene()
    tracer = Tracer(device="cpu")
    cache = tracer._ensure_cache(scene, assets)
    meta = torch.device("meta")
    placed = tracer._cache_on(cache, meta)
    assert placed["d3"]["pos"].device == meta and placed["atlas"]["flat"].device == meta
    assert placed["atlas"]["w"] == cache["atlas"]["w"]
    assert tracer._cache_on(cache, meta)["d3"]["pos"] is placed["d3"]["pos"]
    assert tracer._cache_on(cache, torch.device("cpu")) is cache
    scene.revision += 1
    cache = tracer._ensure_cache(scene, assets)
    assert tracer._cache_on(cache, meta)["d3"]["pos"] is not placed["d3"]["pos"]

    # two samples over a mesh of one device equal two trace() calls
    one, two = AccumBuffer(16, 12, device="cpu"), AccumBuffer(16, 12, device="cpu")
    tracer.trace_sharded(cam, scene, one, 16, assets, make_mesh(2, "cpu"))
    for _ in range(2):
        tracer.trace(cam, scene, two, 16, assets)
    assert torch.equal(one._dev, two._dev)


def _cuda_entries() -> set:
    """The rx_* entries of the port's CUDA library (csrc/*.cu)."""
    found = set()
    for path in glob.glob(os.path.join(PORT, "csrc", "*.cu")):
        found |= set(re.findall(r'extern "C"[^(]*?\b(rx_\w+)\s*\(', open(path).read()))
    return found


def test_every_kernel_call_goes_through_the_device_guard():
    """An entry of the CUDA library is reached only through
    `_cuda.on_device(device, entry, ...)`: in the port no attribute names a
    device entry but to declare its types (`lib.rx_*.argtypes`/`.restype`
    in _cuda.library), `getattr` takes one only inside on_device, every
    on_device call names a device, and every device entry is named in a
    file that calls on_device. The entries that touch no device
    (_cuda.HOST_ENTRIES) are called directly."""
    entries = _cuda_entries()
    assert {"rx_mega_render", "rx_xla_fma", "rx_visibility", "rx_rt_prepare",
            "rx_rt_prepare_cluster", "rx_rt_prepare_large", "rx_rt_intersect",
            "rx_mega_resources", "rx_visibility_resources", "rx_rt_resources",
            "rx_rt_cluster_resources"} <= entries
    device_entries = entries - set(_cuda.HOST_ENTRIES)
    named, bad = set(), []
    for path in sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)):
        if os.path.basename(path) == "native.py":  # the host C library, no CUDA
            continue
        rel = os.path.relpath(path, ROOT)
        in_cuda = rel == os.path.join("rusterix_tpu_torch", "_cuda.py")
        tree = ast.parse(open(path).read(), filename=path)
        parent = {id(c): n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}

        def function_of(node):
            while node is not None and not isinstance(node, ast.FunctionDef):
                node = parent.get(id(node))
            return None if node is None else node.name

        guarded = False
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr in device_entries:
                # only _cuda.library() declares the entries' types
                if not (in_cuda and function_of(node) == "library"):
                    bad.append(f"{rel}:{node.lineno} reaches {node.attr} as an attribute")
            if isinstance(node, ast.Call):
                name = getattr(node.func, "attr", getattr(node.func, "id", ""))
                up = parent.get(id(node))
                if name == "library" and not in_cuda and not (
                        isinstance(up, ast.Attribute) and up.attr in _cuda.HOST_ENTRIES):
                    bad.append(f"{rel}:{node.lineno} takes the library outside _cuda")
                if name == "getattr" and in_cuda and function_of(node) != "on_device":
                    bad.append(f"{rel}:{node.lineno} getattr outside _cuda.on_device")
                if name == "on_device":
                    guarded = True
                    if not node.args or (isinstance(node.args[0], ast.Constant)
                                         and node.args[0].value is None):
                        bad.append(f"{rel}:{node.lineno} on_device names no device")
            if isinstance(node, ast.Constant) and node.value in device_entries:
                named.add((rel, node.value))
        named_here = {e for r, e in named if r == rel}
        if named_here and not guarded:
            bad.append(f"{rel} names {sorted(named_here)} but calls no on_device")
    assert not bad, bad
    assert device_entries <= {e for _r, e in named}, device_entries - {e for _r, e in named}

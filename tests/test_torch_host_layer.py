"""The port's own host layer: rusterix_tpu_torch imports, builds, packs
and renders with every jax import blocked and without loading any file of
the JAX package; its copies of the JAX package's numpy modules pack the
bench map exactly as the JAX package does.
"""

import ast
import functools
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
    from rusterix_tpu_torch.scenes import build_map_glass_refl_scene

    rast, scene, assets = build_map_glass_refl_scene(64, 32, device="cpu")
    frame = rast.set_shadows(True, res=16, sun_res=32).rasterize(scene, 64, 32, 40, assets)
    assert frame.shape == (32, 64, 4) and rast.frame_args["has_sky"]
    from rusterix_tpu_torch.scenes import build_cube_shaded_scene

    rast, scene, assets = build_cube_shaded_scene(64, 48, device="cpu")
    frame = rast.rasterize(scene, 64, 48, 40, assets)
    assert frame.shape == (48, 64, 4) and rast.frame_args["has_material"]
    import random

    from rusterix_tpu_torch.scenes import build_minigame, minigame_tick
    from rusterix_tpu_torch.tracer import AccumBuffer

    random.seed(7)
    rx = build_minigame("cpu")
    minigame_tick(rx)
    frame = rx.draw_scene(rx.assets.maps["world"], 64, 48, ambient=[0.4, 0.4, 0.4, 1.0])
    assert frame.shape == (48, 64, 4) and (frame[..., 3] == 255).sum() > 1000
    buf = AccumBuffer(16, 12, device="cpu")
    rx.trace_scene(rx.client.camera_d3, buf)
    rx.server.stop()
    assert buf.frame == 1 and buf.pixels[..., :3].max() > 0
    for mod in ("shapefx.render", "ops.composite", "shader.patterns", "server.entity",
                "shader.jaxc", "lang.parser", "client.client", "rusterix", "tracer.tracer",
                "tracer.rng"):
        assert "rusterix_tpu_torch." + mod in sys.modules, mod
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
    """The reflection frame, the shadowed reflection frame, the glazed map
    under the sky with reflections and the shaded cube (every module of the
    port's paths: the shadow maps, the sky, the opacity layers, the host
    copy of the map script's entities, the rusteria compiler and its bake),
    and the minigame world through the Rusterix facade (a tick, a frame and
    one trace of the path tracer) render without loading any file of
    rusterix_tpu/ and without importing jax."""
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
    files += sorted(glob.glob(os.path.join(ROOT, "examples", "*_torch.py")))
    assert len(files) > 40
    for part in (("shader", "jaxc.py"), ("parallel", "mesh.py"), ("client", "client.py"),
                 ("client", "widgets.py"), ("rusterix.py",), ("tracer", "tracer.py"),
                 ("tracer", "rng.py")):
        assert os.path.join(ROOT, "rusterix_tpu_torch", *part) in files, part
    for name in ("minigame_torch.py", "tracer_torch.py"):
        assert os.path.join(ROOT, "examples", name) in files, name
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


NORMAL_SHADER = "fn shade() { color = normal * 0.5; }"


def _normal_shaded_box(pkg, **device):
    """A box under NORMAL_SHADER (it reads the normal: a runtime shader)
    rendered by package `pkg` at 32x32 (the JAX package on its split path,
    B2 in interpret mode) -> (frame, rasterizer)."""
    scene = pkg.Scene.from_static([], [pkg.Batch3D.from_box(-0.5, -0.5, -0.5, 1, 1, 1)
                                       .with_computed_normals().set_shader(0)])
    assert scene.add_shader(NORMAL_SHADER) == 0
    cam = pkg.D3OrbitCamera()
    cam.set_parameter_f32("distance", 2.5)
    rast = pkg.Rasterizer.setup(None, cam.view_matrix(), cam.projection_matrix(32, 32), **device)
    if not device:
        rast.use_pallas = True
    return rast.rasterize(scene, 32, 32, 32), rast


@functools.lru_cache(maxsize=None)
def _jax_normal_shaded_box():
    import rusterix_tpu

    return _normal_shaded_box(rusterix_tpu)[0]


@pytest.mark.parametrize("module", ["shader", "shader.jaxc"])
def test_shader_compiler_under_the_mount_is_the_ports(module):
    """Both lazy import sites of the copied host layer (`..shader` and the
    packer's `..shader.jaxc`) land on the port's own torch compiler, and a
    runtime shader (one that reads its inputs, so it cannot bake), which
    the port refused by name until it was ported, renders through it as
    the JAX package renders it."""
    import importlib

    import rusterix_tpu_torch
    from rusterix_tpu_torch.shader import jaxc

    site = importlib.import_module(f"rusterix_tpu_torch.{module}")
    assert site.Rusteria is jaxc.Rusteria
    assert "jax" not in site.Rusteria.__module__.split(".")[0]
    frame, rast = _normal_shaded_box(rusterix_tpu_torch, device="cpu")
    (prog,) = rast.frame_args["shaders"]
    assert isinstance(prog, jaxc.Program)
    np.testing.assert_array_equal(frame, _jax_normal_shaded_box())
    assert (frame[..., 3] > 0).sum() > 100


# ------------------------------------------------ the rest of the host copy


def _relative_imports(path):
    """(line, module the import names, names it takes) of every relative
    import in a file, nested ones included."""
    tree = ast.parse(open(path).read(), filename=path)
    return [(n.lineno, n.level, n.module, [a.name for a in n.names])
            for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level > 0]


def test_every_relative_import_of_the_port_resolves_to_a_port_file():
    """Each `from .x import y` (at module level or inside a function) names
    a module file or a package of rusterix_tpu_torch, or a name its
    package's __init__ defines."""
    root = os.path.join(ROOT, "rusterix_tpu_torch")
    files = sorted(glob.glob(os.path.join(root, "**", "*.py"), recursive=True))
    missing = []
    checked = 0
    for f in files:
        pkg_dir = os.path.dirname(f)
        for line, level, module, names in _relative_imports(f):
            base = pkg_dir
            for _ in range(level - 1):
                base = os.path.dirname(base)
            target = os.path.join(base, *(module.split(".") if module else []))
            checked += 1
            if module and not (os.path.isfile(target + ".py")
                               or os.path.isfile(os.path.join(target, "__init__.py"))):
                missing.append((os.path.relpath(f, ROOT), line, module))
                continue
            if not module:  # from . import name: a submodule or a name of the package
                init = os.path.join(target, "__init__.py")
                for name in names:
                    if not (os.path.isfile(os.path.join(target, name + ".py"))
                            or os.path.isdir(os.path.join(target, name))
                            or (os.path.isfile(init) and name in open(init).read())):
                        missing.append((os.path.relpath(f, ROOT), line, name))
            assert os.path.abspath(target).startswith(root)
    assert checked > 250
    assert not missing, missing


def _both(fn):
    """fn(package) for the JAX package and the port -> the two results."""
    import importlib

    return [fn(importlib.import_module(p)) for p in ("rusterix_tpu", "rusterix_tpu_torch")]


_UUID = __import__("re").compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")


def _json_without_uuids(obj):
    """The JSON text of obj with every uuid (made anew per run) replaced."""
    import json

    return _UUID.sub("<uuid>", json.dumps(obj, sort_keys=True, default=str))


ENTITY_WORLD = """
set_default("wall_height", 2.0)
wall(15)
turn_right()
wall(15)
turn_right()
wall(15)
turn_right()
wall(15)
move_to(10, 10)
add_entity("Orc", "Monster", "wall")
move_to(4, 4)
add_entity("Hero", "Player", "wall")
"""


def test_map_script_with_entities_and_its_json_match_jax():
    """A map script's add_entity (which imports the server's Entity) and
    MapMeta.to_json (map/persist.py) give the JAX package's map."""
    import importlib

    def build(pkg):
        m = pkg.compile_source_map(ENTITY_WORLD)
        meta = importlib.import_module(pkg.__name__ + ".map.meta")
        return ([e.get_attr_string("class_name") for e in m.entities],
                _json_without_uuids(meta.MapMeta(m).to_json()))

    (jax_names, jax_json), (port_names, port_json) = _both(build)
    assert port_names == jax_names == ["Monster", "Player"]
    assert port_json == jax_json


def test_empty_map_meta_json_matches_jax():
    import importlib

    def meta_json(pkg):
        meta = importlib.import_module(pkg.__name__ + ".map.meta")
        return _json_without_uuids(meta.MapMeta(pkg.Map()).to_json())

    jax_json, port_json = _both(meta_json)
    assert port_json == jax_json


def _square_map(pkg, x0=2, y0=2, size=4, floor_height=1.0):
    """tests/test_shapefx_geometry.py's square sector, in `pkg`."""
    import importlib

    el = importlib.import_module(pkg.__name__ + ".map.elements")
    m = pkg.Map()
    pts = [(x0, y0), (x0 + size, y0), (x0 + size, y0 + size), (x0, y0 + size)]
    for i, (x, y) in enumerate(pts):
        m.vertices.append(el.Vertex(id=i, x=float(x), y=float(y)))
    for i in range(4):
        m.linedefs.append(el.Linedef(id=i, start_vertex=i, end_vertex=(i + 1) % 4,
                                     sector_ids=[0]))
    s = el.Sector(id=0, linedefs=[0, 1, 2, 3])
    s.properties.set("floor_height", floor_height)
    m.sectors.append(s)
    return m


def _attach_graph(pkg, m, element, key, *roles, values=None):
    """A graph of the given roles, each linked to the previous one's
    terminal 0 and with a Color node (palette slot 1) on its terminal 1,
    set as `key` of the element (tests/test_shapefx_geometry.py)."""
    fx = pkg.shapefx
    g = fx.ShapeFXGraph(nodes=[fx.ShapeFX(roles[0])])
    prev = 0
    for role in roles[1:]:
        node = fx.ShapeFX(role)
        for k, v in (values or {}).items():
            node.values.set(k, v)
        g.nodes.append(node)
        idx = len(g.nodes) - 1
        g.connections.append((prev, 0, idx, 0))
        color = fx.ShapeFX(fx.ShapeFXRole.Color)
        color.values.set("color", 1)
        g.nodes.append(color)
        g.connections.append((idx, 1, len(g.nodes) - 1, 0))
        prev = idx
    m.shapefx_graphs[g.id] = g
    element.properties.set(key, pkg.PixelSource.shapefx_graph(g.id))
    return g


def test_material_builder_texture_matches_jax():
    """D2MaterialBuilder.build_texture (the shape stack) bakes a sector's
    material graph into the same texture."""
    import importlib

    def bake(pkg):
        importlib.import_module(pkg.__name__ + ".shapefx")
        m = _square_map(pkg, x0=-3, y0=-3, size=6)
        _attach_graph(pkg, m, m.sectors[0], "source", pkg.shapefx.ShapeFXRole.MaterialGroup,
                      pkg.shapefx.ShapeFXRole.Gradient)
        tex = np.zeros((48, 48, 4), np.uint8)
        d2b = importlib.import_module(pkg.__name__ + ".builders.d2builder")
        d2b.D2MaterialBuilder().build_texture(m, pkg.Assets.default(), tex)
        return tex

    jax_tex, port_tex = _both(bake)
    np.testing.assert_array_equal(port_tex, jax_tex)
    assert int((port_tex[..., :3] > 0).any(-1).sum()) > 100


def test_terrain_chunks_with_a_shape_graph_match_jax():
    """D3Builder's terrain with a sector's Flatten graph (shapefx/geometry.py
    from map/terrain.py): the same terrain meshes and baked textures."""
    import importlib

    def build(pkg):
        importlib.import_module(pkg.__name__ + ".shapefx")
        m = _square_map(pkg, floor_height=0.5)
        for ty in range(12):
            for tx in range(12):
                m.terrain.set_height(tx, ty, 3.0)
        _attach_graph(pkg, m, m.sectors[0], "region_graph",
                      pkg.shapefx.ShapeFXRole.SectorGeometry, pkg.shapefx.ShapeFXRole.Flatten,
                      values={"bevel": 1.0})
        scene = pkg.Scene.empty()
        pkg.D3Builder().build(m, pkg.Assets.default(), scene)
        batches = sorted(((k, c.terrain_batch3d) for k, c in scene.chunks.items()
                          if c.terrain_batch3d is not None), key=lambda kv: kv[0])
        return ([(k, np.asarray(b.vertices), np.asarray(b.indices)) for k, b in batches],
                [np.asarray(t.textures[0].data) for t in scene.dynamic_textures])

    (jax_b, jax_t), (port_b, port_t) = _both(build)
    assert port_b and len(port_b) == len(jax_b) and len(port_t) == len(jax_t) >= 1
    for (k1, v1, i1), (k2, v2, i2) in zip(jax_b, port_b):
        assert k1 == k2
        np.testing.assert_array_equal(v2, v1)
        np.testing.assert_array_equal(i2, i1)
    for a, b in zip(jax_t, port_t):
        np.testing.assert_array_equal(b, a)


REGION_PLAYER = """
fn event(name, value) {
    if name == "startup" {
        set_attr("health", 10);
    }
}

fn user_event(name, value) {
    match name {
        "key_down" {
            if value == "w" { action("forward"); }
        }
        _ { }
    }
}
"""


def test_region_instance_ticks_like_jax():
    """A Server with one region (the map script's entities, a scripted
    player through the port's lang/ and vm/): the player registers, walks
    forward for 8 ticks (server/region.py, client/command.py), and ends
    where the JAX package's does, with the same attributes."""
    def run(pkg):
        import importlib

        srv = importlib.import_module(pkg.__name__ + ".server.server")
        m = pkg.compile_source_map(ENTITY_WORLD)
        m.name = "world"
        server = srv.Server()
        server.create_region_instance("world", m, entities={
            "Player": (REGION_PLAYER, "[attributes]\nplayer = true\n"),
            "Monster": ("", "")})
        server.start()
        pid = server.register_player("world", "Player", [4.0, 1.0, 4.0])
        inst = server.instances[0]
        server.local_player_event(pid, "key_down", "w")
        for _ in range(8):
            inst.redraw_tick()
        server.update()
        player = inst.find_entity(pid)
        return (np.asarray(player.position, np.float64).tolist(),
                player.attributes.get_float_default("health", 0.0),
                sorted(e.get_attr_string("class_name") for e in inst.ctx.entities))

    jax_run, port_run = _both(run)
    assert port_run == jax_run
    assert port_run[1] == 10.0 and port_run[0] != [4.0, 1.0, 4.0]

"""The benchmark's frozen copies agree with the port's code as it stands:
the configuration's scene, the host-copy counter and the roofline
constants; and the reference's own map (reference/map_grid.py), built
from the configuration's sizes alone, is the scene the port's builders
make."""

import numpy as np
import pytest

from rxbench.lib import manifest as mf
from rxbench.lib import roofline
from rxbench.lib.trace import HostCopies, port_kernels

MAN = mf.load()
CONFIG = next(c for c in MAN["configs"] if c["name"] == "map_refl_1080p")
W, H = 96, 54


def _packed(scene, assets):
    from rusterix_tpu_torch.ops.scene_pack import PackedScene

    return PackedScene.from_scene(scene, assets, static_only=True, device="cpu")


def test_the_configurations_scene_packs_as_the_ports_builder_does():
    from rusterix_tpu_torch.scenes import build_map_refl_scene

    cfg = mf.config(CONFIG)
    conf = mf.module("configs", "map_refl_1080p")
    scene, assets = conf.build_scene(cfg)
    rast_p, scene_p, assets_p = build_map_refl_scene(W, H, device="cpu")
    a, b = _packed(scene, assets), _packed(scene_p, assets_p)
    for field in ("pos", "uv", "nrm", "valid", "kind", "tex_slot", "repeat", "cull"):
        np.testing.assert_array_equal(getattr(a.d3, field), getattr(b.d3, field), err_msg=field)
    for x, y in zip(scene.all_lights(), scene_p.all_lights()):
        assert repr(x) == repr(y)
    rast = conf.make_rasterizer(cfg, rast_p.view_matrix, rast_p.projection_matrix, "cpu")
    for attr in ("sun_dir", "sun_color", "day_factor", "brdf", "reflection_samples",
                 "ambient_color"):
        assert np.array_equal(np.asarray(getattr(rast, attr)), np.asarray(getattr(rast_p, attr)))
    f1 = rast.rasterize(scene, W, H, assets=assets)
    f2 = rast_p.rasterize(scene_p, W, H, assets=assets_p)
    np.testing.assert_array_equal(f1, f2)


def test_host_copies_count_as_chip_smokes_on_a_cpu_frame():
    import chip_smoke

    conf = mf.module("configs", "map_refl_1080p")
    cfg = mf.config(CONFIG)
    scene, assets = conf.build_scene(cfg)
    from rxbench.lib.traffic import Traffic, camera

    cfg = dict(cfg, width=W, height=H)
    view, proj = camera(Traffic(mf.traffic("walk"), cfg, 5).frame(3), cfg)
    counts = []
    for counter in (HostCopies(), chip_smoke.HostCopies()):
        with counter:
            conf.make_rasterizer(cfg, view, proj, "cpu").rasterize(scene, W, H, assets=assets)
        counts.append(sum(counter.ops.values()))
    assert counts[0] == counts[1]


def test_roofline_constants_are_chip_smokes():
    import chip_smoke

    for name in ("HBM_BYTES_PER_S", "F32_OPS_PER_S", "OPS_INTERP", "OPS_TEXEL_NEAREST",
                 "OPS_SHADE_FIXED", "OPS_SUN_EXTRA", "OPS_MT_TEST"):
        ours = getattr(roofline, name)
        theirs = getattr(chip_smoke, "OPS_PER_MT_TEST" if name == "OPS_MT_TEST" else name)
        assert ours == theirs, name
    assert roofline.OPS_VIS_TEST == chip_smoke.OPS_PER_VIS_TEST
    assert roofline.OPS_BRDF_GGX == chip_smoke.OPS_BRDF[True]
    for t, ops in roofline.OPS_PER_LIGHT.items():
        assert chip_smoke.OPS_PER_LIGHT[t] == ops


def test_the_ports_kernels_are_found_in_its_sources():
    names = port_kernels(mf.ROOT)
    assert {"mega_kernel", "visibility_kernel", "rt_kernel", "rt_prepare_kernel"} <= names


def test_bounds_grow_with_the_work():
    work = {"pixels": 100, "covered": 80, "triangles": 10, "lights": 2, "texels": 50,
            "rays": 60, "ray_boxes": 3_000_000}
    base = roofline.b1_bound_ms(work, [0, 3], True)
    assert base > 0
    assert roofline.b1_bound_ms(dict(work, covered=160), [0, 3], True) > base
    w = roofline.walk_bound_ms(work)
    assert roofline.walk_bound_ms(dict(work, ray_boxes=6_000_000)) > w > 0


@pytest.mark.parametrize("rgba", [(210, 90, 60, 255), (90, 170, 230, 150)])
def test_the_reference_billboard_is_the_ports(rgba):
    from rxbench.lib.traffic import dynamic_parts

    spec = {"kind": "billboard", "x": 3.0, "z": 4.0, "right": [0.6, 0.8], "width": 0.8,
            "height": 2.0, "rgba": list(rgba), "opacity": rgba[3] < 255}
    where = "opacity" if spec["opacity"] else "opaque"
    port = dynamic_parts([spec], "port")[where][0]
    ref = dynamic_parts([spec], "reference")[where][0]
    np.testing.assert_allclose(port.vertices, ref.vertices, atol=1e-6)
    np.testing.assert_array_equal(port.indices, ref.indices)
    np.testing.assert_allclose(port.uvs, ref.uvs)
    np.testing.assert_allclose(np.abs(port.normals), np.abs(ref.normals), atol=1e-6)
    assert tuple(port.source.pixel) == tuple(rgba) == ref.pixel


def _map():
    cfg = mf.config(CONFIG)
    scene, assets = mf.module("configs", "map_refl_1080p").build_scene(cfg)
    return cfg, scene, assets


def test_the_reference_map_is_the_ports_walls():
    """Every triangle of the port's map lies on one of the reference's
    walls facing its way, with the same texture coordinates modulo the
    repeat, the same texture and the same area in all."""
    from rxbench.reference import map_grid

    cfg, scene, assets = _map()
    walls = map_grid.wall_records(cfg)
    a = np.array([w.vertices[0, [0, 2]] for w in walls], np.float64)
    b = np.array([w.vertices[1, [0, 2]] for w in walls], np.float64)
    n = np.array([w.normals[0] for w in walls], np.float64)
    h = cfg["wall_height"]
    area = 0.0
    for batch in scene.all_d3_batches(include_dynamic=False):
        v = np.asarray(batch.vertices, np.float64)[:, :3]
        uv = np.asarray(batch.uvs, np.float64)
        bn = np.asarray(batch.normals, np.float64)[0]
        d = (b - a) / np.linalg.norm(b - a, axis=1)[:, None]
        rel = v[:, None, [0, 2]] - a[None]
        along = (rel * d[None]).sum(-1)
        off = np.abs(rel[..., 0] * d[None, :, 1] - rel[..., 1] * d[None, :, 0])
        length = np.linalg.norm(b - a, axis=1)
        on = ((off < 1e-5) & (along > -1e-5) & (along < length + 1e-5)).all(0)
        on &= (v[:, 1].min() > -1e-5) & (v[:, 1].max() < h + 1e-5)
        on &= np.abs(n @ bn - 1.0) < 1e-6
        (k,) = np.nonzero(on)
        assert len(k) == 1, (v, k)
        w = walls[k[0]]
        ref_uv = np.stack([along[:, k[0]], h - v[:, 1]], 1)
        np.testing.assert_allclose(np.mod(uv, 1.0), np.mod(ref_uv, 1.0), atol=1e-5)
        np.testing.assert_array_equal(
            assets.tile_list[batch.source.index].textures[0].data, w.texture)
        assert batch.repeat_mode == w.repeat_mode and batch.receives_light
        for t in np.asarray(batch.indices):
            area += np.linalg.norm(np.cross(v[t[1]] - v[t[0]], v[t[2]] - v[t[0]])) / 2
    assert area == pytest.approx(sum(float(np.linalg.norm(b_ - a_)) * h
                                     for a_, b_ in zip(a, b)), rel=1e-9)


def test_the_reference_lights_and_2d_walls_are_the_ports():
    from rxbench.reference import map_grid

    cfg, scene, _assets = _map()

    def rows(rs):
        return sorted((r["type"], *r["pos"], *r["color"], r["intensity"], r["start"],
                       r["end"], *r["dir"], r["cone"]) for r in rs)

    port = [{"type": int(l.light_type), "pos": np.asarray(l.position, np.float32).tolist(),
             "color": np.asarray(l.color, np.float32).tolist(),
             "intensity": float(np.float32(l.intensity)),
             "start": float(np.float32(l.start_distance)),
             "end": float(np.float32(l.end_distance)),
             "dir": np.asarray(l.direction, np.float32).tolist(),
             "cone": float(np.float32(l.cone_angle))}
            for l in scene.all_lights() if l.emitting and float(l.flicker) == 0.0]
    assert len(port) == len(scene.all_lights())
    assert rows(port) == rows(map_grid.light_rows(cfg))
    segs = sorted(tuple(np.asarray([*ld.start, *ld.end], np.float32).tolist())
                  for ld in scene.mapmini.all_linedefs() if ld.wall_height > 0.0)
    assert segs == sorted(tuple(s) for s in map_grid.segments(cfg).tolist())

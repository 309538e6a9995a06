"""The port's game client and engine facade (`rusterix_tpu_torch.client`,
`rusterix_tpu_torch.rusterix`) against the JAX package's, on the CPU.

The client modules are copies of the JAX package's (import lines and a
device branch apart), so their plain-Python results are held equal on the
inputs of tests/test_minigame.py, tests/test_screens.py and
tests/test_billboard_anim.py: the message parser, the daylight cycle, the
2D drawing primitives and text, the config, the screen widgets and their
touch dispatch, the door billboards' animation.

The engine loop: the minigame world is built on both packages; after
`random.seed(7)` (the monster walks by Python's global `random`) and the
same 4 ticks with `key_down w`, the player and the monster stand at the
same positions, and the port's `draw_d3` frame at 160x120 equals the JAX
package's megakernel frame (B1 in interpret mode) byte for byte but for
MINIGAME_TEXEL_PINNED pixels of the texel-boundary class: the floor's
interpolated u or v lands on a rounding boundary of the nearest-texel
index, which XLA's CPU build, fusing the interpret-mode kernel's plane
evaluation into FMAs, rounds to the other side (the port's plain version,
like B1 and the TPU kernel, rounds each operation); on the minigame's
2-texel checkerboard a flipped texel is the other check's colour.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rusterix_tpu as jx  # noqa: E402
import rusterix_tpu_torch as tx  # noqa: E402
from rusterix_tpu import client as jc  # noqa: E402
from rusterix_tpu_torch import client as tc  # noqa: E402
from rusterix_tpu_torch.scenes import build_minigame, minigame_tick  # noqa: E402
from tests import test_billboard_anim, test_minigame, test_screens  # noqa: E402

#: pixels of the 160x120 minigame frame of the texel-boundary class (see the
#: module docstring)
MINIGAME_TEXEL_PINNED = 11


def test_exports_follow_the_jax_package():
    assert tc.__all__ == jc.__all__
    for name in ("Client", "Daylight", "Draw2D", "MsgParser", "DrawMode", "Rusterix"):
        assert getattr(tx, name).__name__ == getattr(jx, name).__name__
    from rusterix_tpu_torch.tracer import AccumBuffer, Tracer

    assert (AccumBuffer.__name__, Tracer.__name__) == ("AccumBuffer", "Tracer")
    assert not hasattr(tx, "Tracer") and not hasattr(jx, "Tracer")


TEMPLATES = [
    "You see {E:20.name,article=def} with {N:50,unit=hp}.",
    "You see {E:20.name,article=def}!",
    "{F:3.14159,precision=2}",
    "{E:20.name,article=indef}",
    "{E:20.name,article=definite}",
    "{E:20.name,article=none}",
    "{hello world,case=title}",
    "{hello world,case=ucfirst}",
    "{hello world,case=uppercase}",
    '{N:3,unit="hp"}',
    "{F:2.5,precision=1,unit=kg}",
    "{you,case=ucfirst}{win}!",
    "{N:abc}",
    "{F:xyz}",
    "{E:notanid.name}",
]


@pytest.mark.parametrize("name", ["orc", "sword", "hourglass", "unicorn", "boots", "armor"])
def test_msg_parser_matches_jax(name):
    class E:
        id = 20

        class attributes:
            @staticmethod
            def get_str_default(k, d):
                return name

    loc = {"hello world": "hello world"}
    for template in TEMPLATES:
        got = tc.MsgParser().render(template, entities=[E()], locale=loc)
        assert got == jc.MsgParser().render(template, entities=[E()], locale=loc), template
    toks = tc.MsgParser().parse(TEMPLATES[0])
    ref = jc.MsgParser().parse(TEMPLATES[0])
    assert [(t.kind, t.text) for t in toks] == [(t.kind, t.text) for t in ref]


def test_daylight_matches_jax():
    d, r = tc.Daylight(), jc.Daylight()
    for minutes in range(0, 24 * 60, 37):
        assert d.daylight_intensity(minutes) == r.daylight_intensity(minutes)
        np.testing.assert_array_equal(d.daylight(minutes, 0.1, 0.9), r.daylight(minutes, 0.1, 0.9))
        np.testing.assert_array_equal(d.calculate_light_direction(minutes),
                                      r.calculate_light_direction(minutes))


def _draw2d_buffer(pkg):
    d = pkg.Draw2D()
    buf = np.zeros((64, 64, 4), np.uint8)
    d.rect(buf, 4, 4, 10, 10, (255, 0, 0, 255))
    d.rect_outline(buf, 20, 20, 10, 10, (0, 255, 0, 255))
    d.line(buf, 0, 40, 63, 40, (0, 0, 255, 255))
    d.line(buf, 3, 60, 50, 44, (0, 200, 255, 255))
    d.disc(buf, 50, 50, 5, (255, 255, 0, 255))
    d.blit(buf, np.full((8, 8, 4), 77, np.uint8), 0, 0)
    d.text(buf, 2, 54, "hi", (255, 255, 255, 255), 10)
    out = np.zeros((96, 96, 4), np.uint8)
    d.blit_scaled(out, buf, 0, 0, 96, 96)
    return buf, out


def test_draw2d_primitives_and_text_match_jax():
    for got, want in zip(_draw2d_buffer(tc), _draw2d_buffer(jc)):
        np.testing.assert_array_equal(got, want)
    assert _draw2d_buffer(tc)[0][54:64, 0:16].any()  # the text drew


def test_client_config_matches_jax():
    for text in (test_minigame.CONFIG_TOML, "", "[viewport]\nwidth = 320\n[game]\n"
                 'start_screen = "hud"\nauto_create_player = false\n'):
        assert vars(tc.ClientConfig.parse(text)) == vars(jc.ClientConfig.parse(text))


def _screen_state(pkg_name):
    """test_screens' HUD set up through one package, and its touch dispatch."""
    import importlib

    pkg = importlib.import_module(pkg_name)
    orig = (test_screens.Map, test_screens.Assets)
    test_screens.Map = pkg.map.Map
    test_screens.Assets = pkg.models.Assets
    try:
        assets, attack_id, talk_id = test_screens.screen_assets()
    finally:
        test_screens.Map, test_screens.Assets = orig
    client = pkg.client.Client(device="cpu") if pkg_name.endswith("_torch") else pkg.client.Client()
    client.setup(assets)
    rects = {k: (w.rect.x, w.rect.y, w.rect.width, w.rect.height)
             for k, w in sorted(client.button_widgets.items())}
    state = [client.current_screen, len(client.game_widgets), rects,
             len(client.text_widgets), client.widgets_to_hide, list(client.activated_widgets)]
    btn = client.button_widgets[attack_id]
    state.append(client.touch_screen(btn.rect.x + 5, btn.rect.y + 5))
    state += [client.intent, list(client.activated_widgets),
              list(client.permanently_activated_widgets), client.touch_screen(0, 0)]
    state.append(pkg.client.align_screen_to_grid(320, 200, 32.0))
    return state


def test_screens_match_jax():
    assert _screen_state("rusterix_tpu_torch") == _screen_state("rusterix_tpu")


def _door_poses(pkg_name):
    """test_billboard_anim's door opened and closed through one package:
    the quads' vertices and opacities frame by frame."""
    import importlib

    pkg = importlib.import_module(pkg_name)
    names = ("D3Builder", "Map", "Surface", "ProfileLoop", "LoopOp", "LoopOpKind",
             "BillboardAnimation", "Assets", "PixelSource", "Scene", "Item")
    sources = (pkg.builders, pkg.map, pkg.map, pkg.map, pkg.map, pkg.map, pkg.map,
               pkg.models, pkg.models, pkg.models, pkg.server.item)
    orig = {n: getattr(test_billboard_anim, n) for n in names}
    for n, src in zip(names, sources):
        setattr(test_billboard_anim, n, getattr(src, n))
    try:
        m, scene, item, sid = test_billboard_anim.door_world(pkg.map.BillboardAnimation.Fade)
    finally:
        for n, v in orig.items():
            setattr(test_billboard_anim, n, v)
    states, poses = {}, []
    for frame in range(1, 30):
        if frame == 2:
            item.attributes.set("visible", False)
        if frame == 20:
            item.attributes.set("visible", True)
        opaque, transparent = pkg.client.animate_billboards(
            scene, m, pkg.models.Assets.default(), states, frame, 0, 30.0, 30.0)
        poses.append([(b.vertices.tolist(), float(b.opacity)) for b in opaque + transparent])
    return poses


def test_billboard_animation_matches_jax():
    poses = _door_poses("rusterix_tpu_torch")
    assert poses == _door_poses("rusterix_tpu")
    assert any(len(p) == 0 for p in poses) and any(len(p) == 1 for p in poses)


def _jax_engine():
    rx = jx.Rusterix()
    rx.assets.textures["brickwall"] = jx.Texture.checkerboard(16, 4)
    rx.assets.textures["brickfloor"] = jx.Texture.checkerboard(16, 8)
    rx.assets.textures["sky"] = jx.Texture.from_color((60, 60, 120, 255))
    rx.assets.map_sources["world"] = test_minigame.WORLD_RXM
    rx.assets.entities = {
        "Player": (test_minigame.PLAYER_RXE, test_minigame.PLAYER_TOML),
        "Monster": (test_minigame.MONSTER_RXE, ""),
    }
    rx.assets.config = test_minigame.CONFIG_TOML
    rx.create_regions()
    rx.setup_client()
    return rx


def _ticks_and_frame(rx, tick):
    random.seed(7)
    rx.local_player_event("key_down", "w")
    for _ in range(4):
        tick(rx)
    world = rx.assets.maps["world"]
    frame = np.asarray(rx.draw_scene(world, 160, 120, ambient=[0.4, 0.4, 0.4, 1.0]))
    positions = {e.get_attr_string("class_name"): e.position.copy()
                 for e in rx.server.instances[0].ctx.entities}
    rx.server.stop()
    return positions, frame, len(rx.client.scene.d3_dynamic)


def test_minigame_ticks_and_frame_match_jax(monkeypatch):
    """The engine loop on both packages: the same positions after the same
    seeded ticks; the frame byte-equal to the JAX megakernel frame but for
    the pinned texel-boundary pixels."""
    import rusterix_tpu.ops.visibility_pallas as jvp

    random.seed(7)  # the JAX package's world is built after the same seed
    pos_t, frame_t, n_dyn = _ticks_and_frame(build_minigame("cpu"), minigame_tick)
    assert n_dyn == 1  # the monster's billboard
    monkeypatch.setattr(jvp, "pallas_supported", lambda: True)  # B1, interpret mode
    random.seed(7)

    def jax_tick(rx):
        world = rx.assets.maps["world"]
        rx.update_server()
        rx.apply_entities_items(world)
        rx.build_entities_items_d3(world)

    pos_j, frame_j, _ = _ticks_and_frame(_jax_engine(), jax_tick)
    assert pos_t.keys() == pos_j.keys() == {"Player", "Monster"}
    for k in pos_t:
        np.testing.assert_array_equal(pos_t[k], pos_j[k])
    assert frame_t.shape == frame_j.shape == (120, 160, 4)
    diff = (frame_t != frame_j).any(-1)
    assert int(diff.sum()) == MINIGAME_TEXEL_PINNED
    # the class: a whole texel of the floor's other check colour, opaque
    assert (frame_t[diff][:, 3] == 255).all() and (frame_j[diff][:, 3] == 255).all()
    assert (frame_t[..., 3] == 255).sum() > 5000


def test_rusterix_draw_scene_d2_and_d3_on_cpu():
    rx = build_minigame("cpu")
    world = rx.assets.maps["world"]
    minigame_tick(rx)
    d3 = rx.draw_scene(world, 160, 120, ambient=[0.4, 0.4, 0.4, 1.0])
    rx.set_d2()
    rx.build_scene(world)
    d2 = rx.draw_scene(world, 160, 120)
    rx.server.stop()
    assert rx.draw_mode == tx.DrawMode.D2
    assert d3.shape == d2.shape == (120, 160, 4) and d3.dtype == d2.dtype == np.uint8
    assert (d3[..., 3] == 255).sum() > 5000
    # the 2D view draws D2Builder's wall strips around the room (no floors,
    # ROADMAP C8), unlit: 556 opaque black pixels, as the JAX package's
    # draw_d2 gives them
    assert int((d2[..., 3] == 255).sum()) == 556 and not d2[..., :3].any()


def test_draw_game_text_overlay_on_cpu():
    """draw_game composes the 3D view and the server's messages drawn as
    text (Pillow, on the host)."""
    rx = build_minigame("cpu")
    minigame_tick(rx)
    plain = rx.client.draw_game(160, 120, rx.assets, [0.4, 0.4, 0.4, 1.0])
    rx.server.messages.append((None, None, "You see {E:1.name,article=def}.", ""))
    framed = rx.draw_game(160, 120, [0.4, 0.4, 0.4, 1.0])
    rx.server.stop()
    assert rx.client.messages and rx.client.messages[-1][1].startswith("You see")
    assert framed.shape == (120, 160, 4)
    assert (framed[8:24] != plain[8:24]).any()
    assert np.array_equal(framed[40:], plain[40:])

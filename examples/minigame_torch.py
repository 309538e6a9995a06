#!/usr/bin/env python
"""Minigame example on the PyTorch / CUDA port (the counterpart of
examples/minigame.py, reference examples/minigame.rs + minigame/): the full
engine loop through rusterix_tpu_torch's Rusterix facade — a MapScript
world, Player and Monster entity scripts, server ticks, input, billboards,
and the frame rendered by the port's Rasterizer (B1 on the GPU). Headless:
simulates a short session at 640x400 and saves the last frame.

    python examples/minigame_torch.py                 # on the GPU
    python examples/minigame_torch.py --device cpu    # the plain torch versions
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from rusterix_tpu_torch import Rusterix, Texture  # noqa: E402
from rusterix_tpu_torch.profiling import counters  # noqa: E402

WORLD_RXM = """
set("sky_tex", "sky")
set_default("wall_tex", "brickwall")
set_default("floor_tex", "brickfloor")
set_default("wall_height", 2.0)

box_size = 15

wall(box_size)
turn_right()
wall(box_size)
turn_right()
wall(5)
wall(1)
set("wall_tex", "lightpanel")
add_point_light("#ffffbb", 2.0, 2.0, 13.0)
wall(9)
turn_right()
wall(box_size)

move_to(10, 10.5)
add_entity("Orc", "Monster", "brickwall")

move_to(6, 4.5)
add_entity("Shabby", "Player", "brickwall")
"""

PLAYER_RXE = """
fn event(name, value) {
    if name == "startup" {
        set_attr("health", 10);
        set_attr("mode", "active");
    }
    if name == "bumped_into_wall" {
        message("Ouch!");
    }
}

fn user_event(name, value) {
    match name {
        "key_down" {
            if value == "w" { action("forward"); }
            if value == "a" { action("left"); }
            if value == "d" { action("right"); }
            if value == "s" { action("backward"); }
        }
        "key_up" { action("none"); }
        _ { }
    }
}
"""

PLAYER_TOML = "[attributes]\nplayer = true\n"

MONSTER_RXE = """
fn event(name, value) {
    if name == "startup" {
        set_attr("health", 5);
        set_proximity_tracking(3.0);
        random_walk(2.0, 1.0, 1.5);
    }
    if name == "proximity" {
        message("The orc growls...");
    }
}
"""

CONFIG_TOML = """
[viewport]
width = 640
height = 400

[game]
target_fps = 30
game_tick_ms = 250
start_region = "world"
auto_create_player = true
player_class = "Player"
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="minigame_torch.png", help="the PNG to write")
    opts = ap.parse_args()

    rx = Rusterix(device=opts.device)
    rx.assets.textures["brickwall"] = Texture.checkerboard(32, 8)
    rx.assets.textures["brickfloor"] = Texture.checkerboard(32, 4)
    rx.assets.textures["lightpanel"] = Texture.from_color((255, 255, 200, 255))
    rx.assets.textures["sky"] = Texture.from_color((60, 60, 120, 255))
    rx.assets.map_sources["world"] = WORLD_RXM
    rx.assets.entities = {
        "Player": (PLAYER_RXE, PLAYER_TOML),
        "Monster": (MONSTER_RXE, ""),
    }
    rx.assets.config = CONFIG_TOML

    rx.create_regions()
    rx.setup_client()
    world = rx.assets.maps["world"]

    # walk forward for a second, then stop
    rx.local_player_event("key_down", "w")
    frame = None
    before = counters["b1.launch"]
    t0 = time.time()
    frames = 30
    for i in range(frames):
        if i == 20:
            rx.local_player_event("key_up", "w")
        if i % 8 == 0:
            rx.system_tick()
        rx.update_server()
        rx.apply_entities_items(world)
        rx.build_entities_items_d3(world)
        frame = rx.draw_game(640, 400, ambient=[0.35, 0.35, 0.4, 1.0])
    dt = (time.time() - t0) / frames
    print(f"minigame: {dt * 1000:.1f} ms/frame ({1 / dt:.1f} fps incl. host loop and "
          f"readback) on {opts.device}, megakernel launches {counters["b1.launch"] - before}")

    inst = rx.server.instances[0]
    player = inst.find_entity(rx.client.player_id)
    print(f"player at {np.round(player.position, 2)}, log: {rx.server.get_log()!r}")
    rx.server.stop()

    from PIL import Image

    Image.fromarray(frame, "RGBA").save(opts.out)
    print(f"saved {opts.out}")


if __name__ == "__main__":
    main()

"""Top-level engine facade (reference src/rusterix.rs:16-327).

`Rusterix { assets, server, client }`: create regions from maps, pump the
server, build dynamic geometry, draw the scene.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional

import numpy as np

from .builders import compile_source_map
from .client import Client
from .models.assets import Assets
from .server.message import PlayerCamera
from .server.server import Server


class DrawMode(enum.IntEnum):
    D2 = 0
    D3 = 1


class Rusterix:
    def __init__(self, device=None):
        #: the device the client's frames and the tracer render on (None is
        #: CUDA)
        self.device = device
        self.assets = Assets.default()
        self.server = Server()
        self.client = Client(device=device)
        self.player_camera = PlayerCamera.D3FirstP
        self.draw_mode = DrawMode.D3

    # ---- setup ----

    def set_tiles(self, tiles: Dict[str, object]) -> None:
        """reference rusterix.rs:323-326 — tiles + atlas rebuild."""
        self.assets.set_tiles(tiles)

    def create_regions(self) -> None:
        """One region per map source (reference rusterix.rs:89-95).

        Precompiled maps already in `assets.maps` (e.g. loaded from a
        save-game via map.persist.load_map) get regions too."""
        for name, source in self.assets.map_sources.items():
            if name in self.assets.maps:
                # a precompiled (e.g. save-game-loaded) map wins over its
                # source; delete assets.maps[name] to force a recompile
                continue
            map_ = compile_source_map(source, self.assets)
            map_.name = name
            self.assets.maps[name] = map_
        for name, map_ in self.assets.maps.items():
            self.server.create_region_instance(
                name,
                map_,
                entities=self.assets.entities,
                items=self.assets.items,
                config=self.assets.config,
            )
        self.server.start()

    def setup_client(self) -> None:
        """reference rusterix.rs:286 + client setup commands."""
        commands = self.client.setup(self.assets)
        for cmd in commands:
            if cmd[0] == "create_player":
                _, region, class_name = cmd
                pid = self.server.register_player(region, class_name)
                self.client.player_id = pid
        start = self.client.config.start_region
        if start and start in self.assets.maps:
            self.client.set_map(self.assets.maps[start], self.assets)

    # ---- frame loop ----

    def update_server(self) -> None:
        """reference rusterix.rs:318 — tick + drain. Pending MultipleChoice
        requests are mirrored into the client's messages widget so the menu
        is answerable on the next input (client/mod.rs:909-930)."""
        self.server.redraw_tick()
        self.server.update()
        self.client.process_choices(self.server.get_choices())

    def system_tick(self) -> None:
        self.server.system_tick()

    def apply_entities_items(self, map_) -> None:
        """Mirror entities/items into the map + drive the player camera
        (reference rusterix.rs:146-181)."""
        self.server.apply_entities_items(map_)
        if self.client.player_id is not None:
            for e in map_.entities:
                if e.id == self.client.player_id:
                    cam_attr = e.attributes.get_str_default("player_camera", "")
                    if cam_attr == "iso":
                        self.player_camera = PlayerCamera.D3Iso
                        self.client.set_player_camera(PlayerCamera.D3Iso)
                    elif cam_attr == "firstp":
                        self.player_camera = PlayerCamera.D3FirstP
                        self.client.set_player_camera(PlayerCamera.D3FirstP)
                    self.client.apply_entity_to_camera(e)
                    break

    def build_entities_items_d3(self, map_) -> None:
        self.client.build_entities_items_d3(map_, self.assets)

    def draw_scene(self, map_, width: int, height: int, ambient=None) -> np.ndarray:
        """reference rusterix.rs:256-279 (d2/d3 dispatch)."""
        if self.draw_mode == DrawMode.D2:
            return self.client.draw_d2(width, height, self.assets)
        return self.client.draw_d3(width, height, self.assets, ambient)

    def draw_game(self, width: int, height: int, ambient=None) -> np.ndarray:
        """reference rusterix.rs:291."""
        self.client.process_messages(self.server.messages)
        return self.client.draw_game(width, height, self.assets, ambient)

    def trace_scene(self, camera, buffer, tile_size: int = 64) -> None:
        """Progressive path tracing of the client scene
        (reference rusterix.rs:281 trace_scene)."""
        from .tracer import Tracer

        if not hasattr(self, "_tracer"):
            self._tracer = Tracer(device=self.device)
        self._tracer.trace(camera, self.client.scene, buffer, tile_size, self.assets)

    # ---- reference facade surface (rusterix.rs:97-316) ----

    def set_assets(self, assets: Assets) -> None:
        """rusterix.rs:97-100."""
        self.assets = assets

    def set_d2(self) -> None:
        """rusterix.rs draw-mode switches."""
        self.draw_mode = DrawMode.D2

    def set_d3(self) -> None:
        self.draw_mode = DrawMode.D3

    def set_dirty(self) -> None:
        """Force a scene repack on the next draw (rusterix.rs set_dirty) —
        our equivalent is bumping the scene revision."""
        self.client.scene.touch()
        self.client.scene_d2.touch()

    def build_scene(self, map_, width: int = None, height: int = None) -> None:
        """Build the client scene for the current draw mode
        (rusterix.rs:183-254 build_scene)."""
        self.client.set_map(map_, self.assets)

    def draw_d2(self, width: int, height: int) -> np.ndarray:
        return self.client.draw_d2(width, height, self.assets)

    def draw_d3(self, width: int, height: int, ambient=None) -> np.ndarray:
        return self.client.draw_d3(width, height, self.assets, ambient)

    def draw_custom_d2(self, map_, width: int, height: int) -> np.ndarray:
        """Standalone 2D render of an arbitrary map (rusterix.rs:
        draw_custom_d2 -> client custom scene path)."""
        saved = self.client.current_map
        self.client.set_map(map_, self.assets)
        frame = self.client.draw_d2(width, height, self.assets)
        if saved is not None:
            self.client.set_map(saved, self.assets)
        return frame

    build_custom_scene_d2 = build_scene
    build_custom_scene_d3 = build_scene

    def process_messages(self) -> None:
        """Drain server messages into the client overlay
        (rusterix.rs:291-316)."""
        self.client.process_messages(self.server.get_messages())

    def client_touch_dragged(self, coord, map_=None) -> None:
        self.client.touch_dragged(coord, map_)

    def client_touch_hover(self, coord, map_=None) -> None:
        self.client.touch_hover(coord, map_)

    # ---- input (mirrors examples/minigame.rs:97-123) ----

    def local_player_event(self, event: str, value=None) -> None:
        """Key/touch input for the local player. An armed multiple-choice
        menu intercepts the key first (client/mod.rs:1463-1477) and the
        selected Choice routes to the owning region as a UserAction; other
        events go to the region scripts as plain user events."""
        from .server.message import EntityActionKind

        if self.client.player_id is None:
            return
        if self.client.choice_map and event == "key_down":
            action = self.client.user_event(event, value)
            if action is not None and action.kind == EntityActionKind.Choice:
                self.server.local_player_action(self.client.player_id, action)
                return
        self.server.local_player_event(self.client.player_id, event, value)

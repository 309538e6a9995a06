"""Client — presentation layer (reference src/client/mod.rs).

Owns scenes/cameras/builders, parses the game config, builds per-frame
dynamic geometry (entity/item billboards + lights), renders through the
device Rasterizer, and routes input to the server.
"""

from __future__ import annotations

import math
import tomllib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..builders import D2Builder, D3Builder
from ..models.assets import Assets
from ..models.batch import Batch3D, PixelSource
from ..models.camera import D3FirstPCamera, D3IsoCamera, D3OrbitCamera
from ..models.light import CompiledLight, LightType
from ..models.scene import Scene
from ..ops.matrices import mat3_translation_scale
from ..ops.raster import Rasterizer
from ..server.message import PlayerCamera
from .daylight import Daylight
from .draw2d import Draw2D
from .parser import MsgParser


@dataclass
class ClientConfig:
    """[viewport]/[game] config tables (reference client/mod.rs:739-806)."""

    width: int = 640
    height: int = 400
    grid_size: float = 32.0
    upscale: float = 1.0
    cursor_id: Optional[str] = None
    target_fps: int = 30
    game_tick_ms: int = 250
    start_region: str = ""
    start_screen: str = ""
    auto_create_player: bool = True
    player_class: str = "Player"

    @staticmethod
    def parse(toml_text: str) -> "ClientConfig":
        cfg = ClientConfig()
        if not toml_text:
            return cfg
        try:
            data = tomllib.loads(toml_text)
        except Exception:
            return cfg
        vp = data.get("viewport", {})
        cfg.width = int(vp.get("width", cfg.width))
        cfg.height = int(vp.get("height", cfg.height))
        cfg.grid_size = float(vp.get("grid_size", cfg.grid_size))
        cfg.upscale = float(vp.get("upscale", cfg.upscale))
        cfg.cursor_id = vp.get("cursor_id")
        game = data.get("game", {})
        cfg.target_fps = int(game.get("target_fps", cfg.target_fps))
        cfg.game_tick_ms = int(game.get("game_tick_ms", cfg.game_tick_ms))
        cfg.start_region = str(game.get("start_region", cfg.start_region))
        cfg.start_screen = str(game.get("start_screen", cfg.start_screen))
        cfg.auto_create_player = bool(
            game.get("auto_create_player", cfg.auto_create_player)
        )
        cfg.player_class = str(game.get("player_class", cfg.player_class))
        return cfg


class Client:
    def __init__(self, device=None):
        #: the device every Rasterizer of this client renders on (None is
        #: CUDA, as Rasterizer.setup resolves it)
        self.device = device
        self.config = ClientConfig()
        self.scene = Scene.empty()
        self.scene_d2 = Scene.empty()
        self.camera_d3 = D3FirstPCamera()
        self.draw2d = Draw2D()
        self.daylight = Daylight()
        #: optional RenderSettings applied to every 3D draw
        #: (reference SceneHandler.settings, scene_handler.rs:70)
        self.render_settings = None
        #: supersampled antialiasing factor for 3D draws
        #: (Rasterizer.set_supersample; 1 = off)
        self.supersample = 1
        self.hour = 12.0
        self.msg_parser = MsgParser()
        self.messages: List[Tuple[float, str]] = []
        self.player_id: Optional[int] = None
        self.intent: str = ""  # armed intent for entity taps
        self.current_map = None
        self.viewport: Tuple[int, int] = (640, 400)
        self.offset_d2 = np.zeros(2, np.float32)
        self.client_action = None  # per-player input script (action.rs)
        # screen-map UI registries (client/mod.rs:1498+)
        self.current_screen: str = ""
        self.game_widgets: dict = {}
        self.button_widgets: dict = {}
        self.text_widgets: dict = {}
        self.deco_widgets: dict = {}
        self.messages_widget = None
        #: armed key->Choice map from the last MultipleChoice mirror
        #: (client/mod.rs:102, set at mod.rs:920-930)
        self.choice_map = None
        self.screen_widget = None
        self.activated_widgets: list = []
        self.permanently_activated_widgets: list = []
        self.widgets_to_hide: list = []
        # door/gate billboard animation (scene_handler.rs:580-731)
        self.billboard_anim_states: dict = {}
        self.frame_counter: int = 0
        self.game_tick: int = 0
        self.render_fps: float = 30.0
        self.game_tick_fps: float = 30.0

    # ---- small reference surface (client/mod.rs:231-252, 479-486,
    # 1006-1043, 1180-1199, 1427-1440) ----

    def inc_animation_frame(self) -> None:
        """client/mod.rs:231-237."""
        self.scene.animation_frame += 1
        self.scene_d2.animation_frame += 1
        for widget in self.game_widgets.values():
            if getattr(widget, "scene", None) is not None:
                widget.scene.animation_frame += 1

    def set_server_time(self, minutes: float) -> None:
        """client/mod.rs:240-242 — server game time in minutes of day."""
        self.server_time = float(minutes)
        self.hour = float(minutes) / 60.0

    def set_curr_map_id(self, map_id) -> None:
        """client/mod.rs:245-247."""
        self.curr_map_id = map_id

    def set_camera_d3(self, camera) -> None:
        """client/mod.rs:250-252."""
        self.camera_d3 = camera

    @staticmethod
    def map_grid_to_local(screen_size, grid_pos, map_) -> np.ndarray:
        """Grid coords -> screen-local pixels (client/mod.rs:479-486)."""
        gx = grid_pos[0] * map_.grid_size + map_.offset[0] + screen_size[0] / 2.0
        gy = grid_pos[1] * map_.grid_size - map_.offset[1] + screen_size[1] / 2.0
        return np.array([gx, gy], np.float32)

    def is_inside_game(self, coord) -> bool:
        """client/mod.rs:1180-1183."""
        x, y = int(coord[0]), int(coord[1])
        return 0 <= x < self.viewport[0] and 0 <= y < self.viewport[1]

    def touch_dragged(self, coord, map_=None) -> None:
        """client/mod.rs:1186-1194 — track the cursor position."""
        self.cursor_pos = (int(coord[0]), int(coord[1]))

    def touch_hover(self, coord, map_=None) -> None:
        """client/mod.rs:1197-1205 — cursor tracking + hover reset; entity
        hover picking runs in touch_down's ray path."""
        self.cursor_pos = (int(coord[0]), int(coord[1]))
        self.hovered_entity_id = None
        self.hovered_item_id = None

    def touch_up(self, coord=None, map_=None) -> None:
        """client/mod.rs:1427-1440 — release transient widget activation
        and clear message-widget clicks."""
        self.activated_widgets = list(self.permanently_activated_widgets)
        if self.messages_widget is not None:
            self.messages_widget.touch_up()

    def apply_entities_items_d3(self, map_) -> None:
        """client/mod.rs:312-322: drive the player camera from its entity,
        then rebuild dynamic billboards."""
        for entity in map_.entities:
            if entity.is_player():
                self.apply_entity_to_camera(entity)
        self.current_map = map_

    def insert_game_buffer(self, target: np.ndarray, frame: np.ndarray) -> None:
        """Upscale the game frame into `target` honoring the config's
        upscale mode (client/mod.rs:1006-1043): 'aspect' letterboxes on a
        30,30,30 background, anything else stretches."""
        th, tw = target.shape[:2]
        fh, fw = frame.shape[:2]
        if getattr(self.config, "upscale", "") == "aspect":
            target[..., :3] = 30
            target[..., 3] = 255
            scale = min(tw / fw, th / fh)
            nw, nh = max(int(fw * scale), 1), max(int(fh * scale), 1)
            ox, oy = (tw - nw) // 2, (th - nh) // 2
            sub = np.zeros((nh, nw, 4), np.uint8)
            self.draw2d.blit_scaled(sub, frame, 0, 0, nw, nh)
            target[oy : oy + nh, ox : ox + nw] = sub
        else:
            self.draw2d.blit_scaled(target, frame, 0, 0, tw, th)

    # ---- setup (client/mod.rs:730-837) ----

    def setup(self, assets: Assets) -> List[tuple]:
        """Parse config; return startup commands (player creation)."""
        self.config = ClientConfig.parse(assets.config)
        self.viewport = (self.config.width, self.config.height)
        commands = []
        if self.config.auto_create_player and self.config.start_region:
            commands.append(
                ("create_player", self.config.start_region, self.config.player_class)
            )
            # client-side input scripting for the player class
            # (client/mod.rs:812-816 + src/client/action.rs)
            from .action import ClientAction

            self.client_action = ClientAction()
            self.client_action.init(self.config.player_class, assets)
        # start screen (client/mod.rs:804-830)
        if self.config.start_screen and self.config.start_screen in assets.screens:
            self.init_screen(self.config.start_screen, assets)
        return commands

    def init_screen(self, screen_name: str, assets: Assets) -> None:
        """Build widget registries from a screen map (client/mod.rs:1498)."""
        from .screens import init_screen

        init_screen(self, screen_name, assets)

    def touch_screen(self, x: float, y: float, map_=None):
        """Dispatch a tap against screen-map buttons (client/mod.rs:1300)."""
        from .screens import touch_screen

        return touch_screen(self, x, y, map_)

    def set_map(self, map_, assets: Assets) -> None:
        """Build the static scene from the map."""
        self.current_map = map_
        self.scene = Scene.empty()
        D3Builder().build(map_, assets, self.scene)
        D2Builder().build(map_, assets, self.scene)
        self.scene.touch()

    # ---- dynamic geometry (scenebuilder/d3builder.rs:367-632) ----

    def build_entities_items_d3(self, map_, assets: Assets) -> None:
        """Camera-facing billboards + lights for entities/items."""
        # bake missing character/item tiles for `_source_seq` sequences
        # (reference runs tile_builder before building dynamics,
        # shapestack/tilebuilder.rs:9)
        from ..shapestack import tile_builder

        tile_builder(map_, assets)
        _, right, up = self.camera_d3.basis_vectors()
        batches: List[Batch3D] = []
        lights: List[CompiledLight] = []

        for entity in map_.entities:
            if not entity.attributes.get_bool_default("visible", True):
                continue
            if self.player_id is not None and entity.id == self.player_id:
                continue  # don't draw the local player in first person
            src = self._entity_source(entity, assets)
            if src is not None:
                size = entity.attributes.get_float_default("source_size", 1.0)
                batch = Batch3D()
                batch.add_vertex_billboard(entity.position, right, up, size)
                batch.set_source(src)
                batches.append(batch)
            emit = entity.attributes.get_float_default("emit_light", 0.0)
            if emit > 0.0:
                lights.append(
                    CompiledLight(
                        light_type=LightType.Point,
                        position=np.asarray(entity.position, np.float32),
                        intensity=emit,
                        start_distance=1.0,
                        end_distance=emit * 4.0,
                    )
                )

        for item in map_.items:
            if not item.attributes.get_bool_default("visible", True):
                continue
            src = self._entity_source(item, assets)
            if src is not None:
                batch = Batch3D()
                batch.add_vertex_billboard(item.position, right, up, 0.5)
                batch.set_source(src)
                batches.append(batch)
            if item.light is not None:
                compiled = (
                    item.light.compile() if hasattr(item.light, "compile") else item.light
                )
                lights.append(compiled)

        # animated door/gate billboards from surface profiles
        from .billboard import animate_billboards

        self.frame_counter += 1
        bb_opaque, bb_transparent = animate_billboards(
            self.scene, map_, assets, self.billboard_anim_states,
            self.frame_counter, self.game_tick,
            self.render_fps, self.game_tick_fps,
        )
        batches.extend(bb_opaque)

        self.scene.d3_dynamic = batches
        self.scene.d3_dynamic_opacity = bb_transparent
        self.scene.dynamic_lights = lights
        # dynamic-only edit: the static device cache stays valid (per-frame
        # repack of these lists happens in Rasterizer.rasterize)
        self.scene.touch_dynamic()

    def _entity_source(self, entity, assets: Assets) -> Optional[PixelSource]:
        # baked character-map sequence tiles (pixelsource.rs:140)
        seq = entity.attributes.get_source("_source_seq")
        name = getattr(seq, "name", None)
        if name is not None:
            for table, ctor in (
                (assets.entity_tiles, PixelSource.entity_tile),
                (assets.item_tiles, PixelSource.item_tile),
            ):
                seqs = table.get(entity.id)
                if seqs and name in seqs:
                    return ctor(entity.id, list(seqs).index(name))
        tid = entity.attributes.get_str_default("tile_id", "")
        if tid:
            idx = assets.tile_index(tid)
            if idx is not None:
                return PixelSource.static_tile_index(idx)
        v = entity.attributes.get("tile_id")
        if v is not None and isinstance(v.data, str):
            idx = assets.tile_index(v.data)
            if idx is not None:
                return PixelSource.static_tile_index(idx)
        return None

    # ---- camera driving (rusterix.rs:146-181) ----

    def apply_entity_to_camera(self, entity) -> None:
        entity.apply_to_camera(self.camera_d3)

    def set_player_camera(self, mode: PlayerCamera) -> None:
        if mode == PlayerCamera.D3FirstP:
            self.camera_d3 = D3FirstPCamera()
        elif mode == PlayerCamera.D3Iso:
            self.camera_d3 = D3IsoCamera()

    # ---- drawing ----

    def draw_d3(self, width: int, height: int, assets: Assets, ambient=None,
                readback: bool = True) -> np.ndarray:
        view = self.camera_d3.view_matrix()
        proj = self.camera_d3.projection_matrix(width, height)
        rast = Rasterizer.setup(None, view, proj, device=self.device)
        if self.render_settings is not None:
            rast.apply_render_settings(self.render_settings, hour=self.hour)
        if ambient is not None:
            rast.ambient(ambient)
        if self.supersample > 1:
            rast.set_supersample(self.supersample)
        return rast.rasterize(
            self.scene, width, height, 128, assets, readback=readback
        )

    def draw_d2(self, width: int, height: int, assets: Assets, grid_size: Optional[float] = None) -> np.ndarray:
        gs = grid_size if grid_size is not None else self.config.grid_size
        tx = width / 2.0 - self.offset_d2[0] * gs
        ty = height / 2.0 - self.offset_d2[1] * gs
        proj2d = mat3_translation_scale(tx, ty, gs)
        rast = Rasterizer.setup(proj2d, np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32),
                                device=self.device)
        return rast.rasterize(self.scene, width, height, 128, assets)

    def draw_game(self, width: int, height: int, assets: Assets, ambient=None) -> np.ndarray:
        """Game viewport + message overlay composite (client/mod.rs:837-1171)."""
        if self.screen_widget is not None or self.game_widgets:
            # screen-map UI composition (client/mod.rs:858-906)
            from .screens import draw_screen

            frame = np.zeros(
                (self.config.height, self.config.width, 4), np.uint8
            )
            frame[..., 3] = 255
            draw_screen(self, frame, assets)
        else:
            frame = np.array(
                self.draw_d3(self.config.width, self.config.height, assets, ambient)
            )
        # messages overlay
        y = 8
        for _, text in self.messages[-4:]:
            self.draw2d.text(frame, 8, y, text, (255, 255, 255, 255), 12)
            y += 16
        if (width, height) != (self.config.width, self.config.height):
            out = np.zeros((height, width, 4), np.uint8)
            self.draw2d.blit_scaled(out, frame, 0, 0, width, height)
            return out
        return frame

    # ---- input (client/mod.rs:1282 touch_down -> ray pick) ----

    def touch_down(self, x: float, y: float, server, width: int, height: int):
        """Ray-pick the scene at screen (x, y): an entity hit raises the
        current intent as a user event; a ground hit walks the player there
        (reference client/mod.rs:1282+). Returns ('entity', id) /
        ('ground', (wx, wz)) / None."""
        from ..ops.raster import Rasterizer
        from ..server.message import EntityAction, EntityActionKind

        # interactive message entries (multiple choice) claim the tap first
        # (client/mod.rs:1359-1366)
        if self.messages_widget is not None:
            action = self.messages_widget.touch_down(x, y)
            if action is not None:
                if action.choice is not None and action.choice.kind == "cancel":
                    self.choice_map = None
                if server is not None and self.player_id is not None:
                    server.local_player_action(self.player_id, action)
                return ("choice", action.choice)

        view = self.camera_d3.view_matrix()
        proj = self.camera_d3.projection_matrix(width, height)
        rast = Rasterizer.setup(None, view, proj, device=self.device)
        rast._last_size = (width, height)
        ray = rast.screen_ray(x, y)

        # entity billboards first (distance to entity position vs ray)
        if self.current_map is not None:
            best = None
            for entity in self.current_map.entities:
                if self.player_id is not None and entity.id == self.player_id:
                    continue
                to_e = np.asarray(entity.position, np.float32) - ray.origin
                t = float(np.dot(to_e, ray.dir))
                if t <= 0:
                    continue
                closest = ray.origin + ray.dir * t
                size = entity.attributes.get_float_default("source_size", 1.0)
                if float(np.linalg.norm(closest - entity.position)) < size * 0.5:
                    if best is None or t < best[0]:
                        best = (t, entity.id)
            if best is not None:
                if self.intent and self.player_id is not None:
                    server.local_player_event(
                        self.player_id, "intent", f"{self.intent}:{best[1]}"
                    )
                return ("entity", best[1])

        # ground plane (y == 0) hit -> Goto
        if abs(float(ray.dir[1])) > 1e-5:
            t = -float(ray.origin[1]) / float(ray.dir[1])
            if t > 0:
                world = ray.origin + ray.dir * t
                if self.player_id is not None:
                    server.local_player_action(
                        self.player_id,
                        EntityAction(
                            EntityActionKind.Goto,
                            target=(float(world[0]), float(world[2])),
                        ),
                    )
                return ("ground", (float(world[0]), float(world[2])))
        return None

    def user_event(self, event: str, value):
        """Route input through the player's client-side script
        (client/mod.rs:1442). Returns the resulting EntityAction or None.

        An armed choice_map intercepts key_down first (mod.rs:1463-1477):
        the matching Choice becomes an EntityAction the caller routes to the
        owning region; Cancel also disarms the menu."""
        from ..server.message import EntityAction, EntityActionKind

        if self.choice_map and event == "key_down":
            c = str(value)[:1] if value is not None else ""
            choice = self.choice_map.get(c)
            if choice is not None:
                if choice.kind == "cancel":
                    self.choice_map = None
                return EntityAction(EntityActionKind.Choice, choice=choice)

        if self.client_action is None:
            return None
        action = self.client_action.user_event(event, value)
        return None if action.kind == EntityActionKind.Off else action

    def set_intent(self, intent: str) -> None:
        """Arm a named intent for the next entity/item tap."""
        self.intent = intent

    # ---- messages (client/mod.rs:333) ----

    def process_messages(self, server_messages, now: float = 0.0) -> None:
        m = self.current_map
        for msg in server_messages:
            sender, receiver, text, category = msg
            # entity/item tokens ({E:..}, {I:..}) resolve against the
            # mirrored map state (resolver.rs:125-190)
            rendered = self.msg_parser.render(
                text,
                entities=getattr(m, "entities", None),
                items=getattr(m, "items", None),
            )
            self.messages.append((now, rendered))
            if self.messages_widget is not None:
                self.messages_widget.add(rendered)
        server_messages.clear()

    def process_choices(self, choices, map_=None) -> None:
        """Mirror pending MultipleChoice requests into the messages widget
        and arm the key->Choice answer map (client/mod.rs:909-930). A widget
        is created on demand — choices must be answerable even on screens
        that didn't lay one out."""
        if not choices:
            return
        if self.messages_widget is None:
            from .widgets import MessagesWidget

            self.messages_widget = MessagesWidget()
        cmap = self.messages_widget.process_choices(
            choices, map_ or self.current_map, resolve=self.msg_parser.render
        )
        if cmap:
            self.choice_map = cmap

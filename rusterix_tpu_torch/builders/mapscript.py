"""MapScript — the turtle-style Python DSL for procedural maps.

The reference embeds RustPython to run .rxm scripts
(src/script/mapscript.rs:126-596; e.g. minigame/world.rxm). Since the host
is Python, the DSL is executed natively: the script runs via `exec` with the
DSL functions in scope (set/set_default, wall, move_to, move_forward,
rotate, turn_left/right, add_entity, add_point_light).
"""

from __future__ import annotations

import math
import uuid as uuid_mod
from typing import Dict, Optional

import numpy as np

from ..map import Map
from ..map.value import Value
from ..models.batch import PixelSource
from ..models.light import Light, LightType


def _hex_to_rgb_f32(s: str):
    s = s.lstrip("#")
    return [int(s[i : i + 2], 16) / 255.0 for i in (0, 2, 4)]


class MapScript:
    """One compilation context (reference keeps globals; we keep state here)."""

    def __init__(self, assets=None):
        self.map = Map()
        self.assets = assets
        self.position = np.zeros(2, np.float32)
        self.orientation = np.array([1.0, 0.0], np.float32)
        self.last_wall: Optional[int] = None
        self.last_sector: Optional[int] = None
        self._saved_state = None
        self.defaults: Dict[str, object] = {
            "wall_tex": None,
            "wall_tex_row2": None,
            "wall_tex_row3": None,
            "floor_tex": None,
            "ceiling_tex": None,
            "wall_height": 0.0,
            "wall_width": 0.0,
        }

    # -- texture name -> tile uuid (reference get_texture: find-or-register) --

    def _get_texture(self, name: str) -> Optional[str]:
        if self.assets is None:
            return name  # symbolic id
        for uuid, tile in self.assets.tiles.items():
            if tile.tags == name:
                return uuid
        tex = self.assets.textures.get(name)
        if tex is not None:
            from ..models.texture import Tile

            uuid = str(uuid_mod.uuid4())
            tile = Tile.from_texture(tex)
            tile.id = uuid
            tile.tags = name
            tiles = dict(self.assets.tiles)
            tiles[uuid] = tile
            self.assets.set_tiles(tiles)
            return uuid
        return None

    def _source_for(self, key: str) -> PixelSource:
        tex = self.defaults.get(key)
        if tex is None:
            return PixelSource.off()
        return PixelSource.tile_id(tex)

    # -- DSL commands (mapscript.rs) --

    def set_default(self, key: str, value) -> None:
        if key.endswith("_tex"):
            self.defaults[key] = self._get_texture(str(value))
        else:
            self.defaults[key] = float(value)

    def set(self, key: str, value) -> None:
        if key == "sky_tex":
            self.map.sky_texture = self._get_texture(str(value))
        elif key == "floor_tex" and self.last_sector is not None:
            s = self.map.find_sector(self.last_sector)
            if s is not None:
                s.properties.set(
                    "source", PixelSource.tile_id(self._get_texture(str(value)))
                )
        elif key in ("wall_tex", "wall_tex_row2", "wall_tex_row3") and self.last_wall is not None:
            l = self.map.find_linedef(self.last_wall)
            if l is not None:
                row = {"wall_tex": "row1_source", "wall_tex_row2": "row2_source", "wall_tex_row3": "row3_source"}[key]
                l.properties.set(row, PixelSource.tile_id(self._get_texture(str(value))))
        elif key == "wall_height" and self.last_wall is not None:
            l = self.map.find_linedef(self.last_wall)
            if l is not None:
                l.properties.set("wall_height", float(value))

    def wall(self, length) -> None:
        """Extrude a wall from the cursor (mapscript.rs:386-470)."""
        to = self.position + self.orientation * float(length)
        from_idx = self.map.add_vertex_at(float(self.position[0]), float(self.position[1]))
        to_idx = self.map.add_vertex_at(float(to[0]), float(to[1]))
        linedef_id, sector_id = self.map.create_linedef(from_idx, to_idx)
        ld = self.map.find_linedef(linedef_id)
        if ld is not None:
            ld.properties.set("row1_source", self._source_for("wall_tex"))
            ld.properties.set("row2_source", self._source_for("wall_tex_row2"))
            ld.properties.set("row3_source", self._source_for("wall_tex_row3"))
            ld.properties.set("wall_height", float(self.defaults["wall_height"]))
            ld.properties.set("wall_width", float(self.defaults["wall_width"]))
            self.last_wall = linedef_id
        if sector_id is not None:
            s = self.map.find_sector(sector_id)
            if s is not None:
                s.properties.set("source", self._source_for("floor_tex"))
                s.properties.set("ceiling_source", self._source_for("ceiling_tex"))
            self.last_sector = sector_id
        self.position = to

    def move_to(self, x, y) -> None:
        self.position = np.array([float(x), float(y)], np.float32)

    def move_forward(self, length) -> None:
        self.position = self.position + self.orientation * float(length)

    def rotate(self, angle_degrees) -> None:
        a = math.radians(float(angle_degrees))
        c, s = math.cos(a), math.sin(a)
        x, y = self.orientation
        self.orientation = np.array([x * c - y * s, x * s + y * c], np.float32)
        # snap tiny fp noise so axis-aligned turns stay exact
        self.orientation = np.round(self.orientation * 1e6) / 1e6

    def push(self) -> None:
        """Save the cursor state (mapscript.rs:60-62)."""
        self._saved_state = (
            self.position.copy(),
            self.orientation.copy(),
            self.last_wall,
            self.last_sector,
        )

    def pop(self) -> None:
        """Restore the saved cursor state (mapscript.rs:64-67)."""
        if self._saved_state is not None:
            pos, ori, lw, ls = self._saved_state
            self.position = pos.copy()
            self.orientation = ori.copy()
            self.last_wall = lw
            self.last_sector = ls

    def turn_left(self) -> None:
        self.rotate(-90.0)

    def turn_right(self) -> None:
        self.rotate(90.0)

    def add_entity(self, name: str, class_name: str, texture: str) -> None:
        """mapscript.rs add_entity: entity at cursor, y=1."""
        from ..server.entity import Entity

        entity = Entity()
        entity.set_position([float(self.position[0]), 1.0, float(self.position[1])])
        entity.set_attribute("name", name)
        entity.set_attribute("class_name", class_name)
        tid = self._get_texture(texture)
        if tid is not None:
            entity.set_attribute("tile_id", tid)
        self.map.entities.append(entity)

    def add_point_light(self, color: str, intensity, start_distance, end_distance) -> None:
        light = Light(LightType.Point)
        light.position = np.array(
            [self.position[0], 0.5, self.position[1]], np.float32
        )
        light.color = np.asarray(_hex_to_rgb_f32(color), np.float32)
        light.intensity = float(intensity)
        light.start_distance = float(start_distance)
        light.end_distance = float(end_distance)
        self.map.lights.append(light)

    # -- compile entry (reference mapscript.rs:614 compile) --

    def compile(self, source: str) -> Map:
        env = {
            "set": self.set,
            "set_default": self.set_default,
            "wall": self.wall,
            "move_to": self.move_to,
            "move_forward": self.move_forward,
            "rotate": self.rotate,
            "turn_left": self.turn_left,
            "turn_right": self.turn_right,
            "push": self.push,
            "pop": self.pop,
            "add_entity": self.add_entity,
            "add_point_light": self.add_point_light,
            "__builtins__": {"range": range, "len": len, "float": float, "int": int},
        }
        exec(compile(source, "<mapscript>", "exec"), env)
        return self.map


def compile_source_map(source: str, assets=None) -> Map:
    """reference Assets::compile_source_map (src/server/assets.rs:250-275)."""
    return MapScript(assets).compile(source)

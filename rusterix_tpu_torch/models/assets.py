"""Central asset database (reference src/server/assets.rs:8-292).

Holds map sources, entity/item scripts, tiles, textures, screens, fonts,
config TOML and the palette. `set_tiles`/`set_tile_list` also (re)build the
device texture atlas used by the renderer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .texture import Texture, TextureAtlas, Tile


def default_palette() -> np.ndarray:
    """The lospec 'duel' palette default used by rusteria
    (reference rusteria/src/lib.rs:77-86). First entries; full palette is
    loaded from assets when available."""
    hex_colors = [
        "000000", "222323", "434549", "626871", "828b98", "a6aeba", "cdd2da", "f5f7fa",
        "625d54", "857565", "9e8c79", "aea189", "bbafa4", "ccc3b1", "eadbc9", "fff3d6",
        "583126", "733d3b", "885041", "9a624c", "ad6e51", "d58d6b", "fbaa84", "ffce7f",
        "002735", "003850", "004d5e", "0b667f", "006f89", "328ca7", "24aed6", "88d6ff",
        "662b29", "94363a", "b64d46", "cd5e46", "e37840", "f99b4e", "ffbc4e", "ffe949",
        "282b4a", "3a4568", "615f84", "7a7799", "8690b2", "96b2d9", "c7d6ff", "c6ecff",
        "002219", "003221", "174a1b", "225918", "2f690c", "518822", "7da42d", "a6cc34",
        "181f2f", "23324d", "25466b", "366b8a", "318eb8", "41b2e3", "52d2ff", "74f5fd",
        "1a332c", "2f3f38", "385140", "325c40", "417455", "498960", "55b67d", "91daa1",
        "5e0711", "82211d", "b63c35", "e45c5f", "ff7676", "ff9ba8", "ffbbc7", "ffdbff",
        "2d3136", "48474d", "5b5c69", "73737f", "848795", "abaebe", "bac7db", "ebf0f6",
        "3b303c", "5a3c45", "8a5258", "ae6b60", "c7826c", "d89f75", "ecc581", "fffaab",
        "31222a", "4a353c", "5e4646", "725a51", "7e6c54", "9e8a6e", "c0a588", "ddbf9a",
        "2e1026", "49283d", "663659", "975475", "b96d91", "c178aa", "db99bf", "f8c6da",
        "002e49", "004051", "005162", "006b6d", "008279", "00a087", "00bfa3", "00deda",
        "453125", "614a3c", "7e6144", "997951", "b29062", "cca96e", "e8cb82", "fbeaa3",
        "5f0926", "6e2434", "904647", "a76057", "bd7d64", "ce9770", "edb67c", "edd493",
        "323558", "4a5280", "64659d", "7877c1", "8e8ce2", "9c9bef", "b8aeff", "dcd4ff",
        "431729", "712b3b", "9f3b52", "d94a69", "f85d80", "ff7daf", "ffa6c5", "ffcdff",
        "49251c", "633432", "7c4b47", "98595a", "ac6f6e", "c17e7a", "d28d7a", "e59a7c",
        "202900", "2f4f08", "495d00", "617308", "7c831e", "969a26", "b4aa33", "d0cc32",
        "622a00", "753b09", "854f12", "9e6520", "ba882e", "d1aa39", "e8d24b", "fff64f",
        "26233d", "3b3855", "56506f", "75686e", "917a7b", "b39783", "cbb550", "dcd8af",
        "1d2c43", "2e3d47", "394d3c", "4c5f33", "58712c", "6b842d", "789e24", "7fbd39",
        "372423", "53393a", "784c49", "945d4f", "a96d58", "bf7e63", "d79374", "e4a57a",
        "2d4b47", "47655a", "5b7b69", "71957d", "87ae8e", "8ac196", "a9d1c1", "e0faeb",
        "001b40", "03315f", "07487c", "105da2", "1476c0", "4097ea", "55b1f1", "6dccff",
        "554769", "765d73", "977488", "b98c93", "d5a39a", "ebbd9d", "ffd59b", "fdf786",
        "1d1d21", "3c3151", "584a7f", "7964ba", "9585f1", "a996ec", "baabf7", "d1bdfe",
    ]
    out = np.zeros((len(hex_colors), 3), np.float32)
    for i, h in enumerate(hex_colors):
        out[i] = [int(h[0:2], 16) / 255.0, int(h[2:4], 16) / 255.0, int(h[4:6], 16) / 255.0]
    return out


@dataclass
class Assets:
    map_sources: Dict[str, str] = field(default_factory=dict)
    maps: Dict[str, object] = field(default_factory=dict)
    entities: Dict[str, tuple] = field(default_factory=dict)  # name -> (source, data)
    items: Dict[str, tuple] = field(default_factory=dict)
    tiles: Dict[str, Tile] = field(default_factory=dict)  # uuid -> Tile
    materials: Dict[str, Tile] = field(default_factory=dict)
    textures: Dict[str, Texture] = field(default_factory=dict)
    tile_list: List[Tile] = field(default_factory=list)
    tile_indices: Dict[str, int] = field(default_factory=dict)
    screens: Dict[str, object] = field(default_factory=dict)
    character_maps: Dict[str, object] = field(default_factory=dict)
    entity_tiles: Dict[int, Dict[str, Tile]] = field(default_factory=dict)
    item_maps: Dict[str, object] = field(default_factory=dict)
    item_tiles: Dict[int, Dict[str, Tile]] = field(default_factory=dict)
    config: str = ""
    fonts: Dict[str, object] = field(default_factory=dict)
    palette: np.ndarray = field(default_factory=default_palette)
    global_graph: object = None
    locales: Dict[str, Dict[str, str]] = field(default_factory=dict)

    _atlas: Optional[TextureAtlas] = None

    @staticmethod
    def default() -> "Assets":
        return Assets()

    # -- builders --

    def with_textures(self, tiles: List[Tile]) -> "Assets":
        """Set tile_list directly (reference bench usage
        benches/rasterize_cube.rs:20-22)."""
        self.tile_list = list(tiles)
        self._atlas = None
        return self

    def set_tiles(self, tiles: Dict[str, Tile]) -> None:
        """reference assets.rs:114-140: rebuild tile_list + indices."""
        self.tiles = dict(tiles)
        self.tile_list = []
        self.tile_indices = {}
        for i, (uuid, tile) in enumerate(self.tiles.items()):
            self.tile_indices[uuid] = i
            self.tile_list.append(tile)
        self._atlas = None

    def tile_index(self, uuid: str) -> Optional[int]:
        return self.tile_indices.get(uuid)

    # NOTE: the reference's `textures(...)` builder (assets.rs:288-291) is
    # named with_textures here — the `textures` FIELD (named texture dict)
    # occupies the method name.

    def add_entity(self, name: str, code: str, data: str = "") -> None:
        """Register an entity class (source, TOML data) (assets.rs:283-285)."""
        self.entities[name] = (code, data)

    def add_item(self, name: str, code: str, data: str = "") -> None:
        """Item-class analogue of add_entity."""
        self.items[name] = (code, data)

    def blocking_tiles(self) -> set:
        """Ids of blocking tiles/materials (assets.rs:177-190) — feeds
        Map.as_mini's blocked-tile set."""
        out = set()
        for tile in self.tiles.values():
            if tile.blocking:
                out.add(tile.id)
        for mat in self.materials.values():
            if mat.blocking:
                out.add(mat.id)
        return out

    def compile_source_map(self, name: str) -> bool:
        """Compile one map source to assets.maps (assets.rs:261-281 —
        commented out there mid-refactor; rusterix.rs create_regions carries
        the live equivalent)."""
        source = self.map_sources.get(name)
        if source is None:
            return False
        from ..builders import compile_source_map as _compile

        map_ = _compile(source, self)
        map_.name = name
        self.maps[name] = map_
        return True

    def compile_source_maps(self) -> None:
        """assets.rs:252-257."""
        for name in list(self.map_sources.keys()):
            self.compile_source_map(name)

    def clean_tile_list(self) -> None:
        self.tile_list = []
        self.tile_indices = {}
        self._atlas = None

    def atlas(self) -> TextureAtlas:
        if self._atlas is None:
            self._atlas = TextureAtlas.build(self.tile_list)
        return self._atlas

    # -- directory ingest (reference assets.rs:193-248) --

    def collect_from_directory(self, path: str) -> None:
        for root, _dirs, files in os.walk(path):
            for fname in sorted(files):
                full = os.path.join(root, fname)
                stem, ext = os.path.splitext(fname)
                ext = ext.lower()
                if ext == ".png":
                    tex = Texture.from_image_safe(full)
                    if tex is not None:
                        self.textures[stem] = tex
                elif ext == ".rxe":
                    with open(full, "r") as f:
                        self.entities[stem] = (f.read(), self._sibling_toml(root, stem))
                elif ext == ".rxi":
                    with open(full, "r") as f:
                        self.items[stem] = (f.read(), self._sibling_toml(root, stem))
                elif ext == ".rxm":
                    with open(full, "r") as f:
                        self.map_sources[stem] = f.read()
                elif ext == ".toml" and stem == "config":
                    with open(full, "r") as f:
                        self.config = f.read()
                elif ext in (".ttf", ".otf"):
                    # game-supplied fonts by stem name; Draw2D text fns take
                    # the resolved path (reference assets.rs:8-47 `fonts:
                    # FxHashMap<String, Font>` via fontdue, consumed by
                    # draw2d.rs:617+ `&Font` params)
                    self.fonts[stem] = full

    def get_map(self, name: str):
        """Compiled map by name, compiling its MapScript source on first use
        (reference src/server/assets.rs get_map + compile_source_map)."""
        if name not in self.maps and name in self.map_sources:
            from ..builders import compile_source_map

            self.maps[name] = compile_source_map(self.map_sources[name], self)
        return self.maps.get(name)

    @staticmethod
    def _sibling_toml(root: str, stem: str) -> str:
        p = os.path.join(root, stem + ".toml")
        if os.path.exists(p):
            with open(p, "r") as f:
                return f.read()
        return ""

    def read_locales(self) -> None:
        """Parse locale_* tables from config TOML (reference assets.rs:82-101)."""
        import tomllib

        self.locales = {}
        try:
            table = tomllib.loads(self.config)
        except Exception:
            return
        for key, value in table.items():
            if key.startswith("locale_") and isinstance(value, dict):
                self.locales[key[len("locale_"):]] = {
                    k: v for k, v in value.items() if isinstance(v, str)
                }

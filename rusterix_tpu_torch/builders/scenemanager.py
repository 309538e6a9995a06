"""Incremental chunk scheduler (reference src/scenemanager.rs).

Command queue + dirty chunk set over the map bbox; `tick()` builds one chunk
per call and emits progress results — the host->device streaming pipeline
(the reference feeds a GPU VM; we feed the packer/scene cache).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .chunk import CHUNK_SIZE, Chunk
from .d2builder import D2Builder
from .d3builder import D3Builder


class SceneManagerCmdKind(enum.IntEnum):
    """reference scenemanager.rs:9-18"""

    SetMap = 0
    SetTileList = 1
    SetPalette = 2
    AddDirty = 3
    SetDirtyTerrainChunks = 4
    ClearAll = 5


@dataclass
class SceneManagerCmd:
    kind: SceneManagerCmdKind
    data: object = None


@dataclass
class SceneManagerResult:
    """reference scenemanager.rs:22-29"""

    kind: str  # 'chunk' | 'terrain' | 'cleared'
    chunk: Optional[Chunk] = None
    coord: Optional[Tuple[int, int]] = None
    remaining: int = 0
    total: int = 0


class SceneManager:
    def __init__(self):
        self.map = None
        self.assets = None
        self.dirty: List[Tuple[int, int]] = []
        self.total = 0
        self.commands: List[SceneManagerCmd] = []
        self.d2 = D2Builder()
        self.d3 = D3Builder()
        self._built: Dict[Tuple[int, int], Chunk] = {}

    def send(self, cmd: SceneManagerCmd) -> None:
        self.commands.append(cmd)

    def set_map(self, map_, assets=None) -> None:
        """Mark every chunk over the map bbox dirty (scenemanager.rs:112-128,
        272-285)."""
        self.map = map_
        if assets is not None:
            self.assets = assets
        self.dirty = []
        bbox = map_.bounding_box()
        if bbox is not None:
            x0 = int(math.floor(bbox.x / CHUNK_SIZE))
            y0 = int(math.floor(bbox.y / CHUNK_SIZE))
            x1 = int(math.floor(bbox.max_x / CHUNK_SIZE))
            y1 = int(math.floor(bbox.max_y / CHUNK_SIZE))
            for cy in range(y0, y1 + 1):
                for cx in range(x0, x1 + 1):
                    self.dirty.append((cx, cy))
        tb = map_.terrain.bounds() if map_.terrain is not None else None
        if tb is not None:
            x0, y0, x1, y1 = (v // CHUNK_SIZE for v in tb)
            for cy in range(y0, y1 + 1):
                for cx in range(x0, x1 + 1):
                    if (cx, cy) not in self.dirty:
                        self.dirty.append((cx, cy))
        self.total = len(self.dirty)
        self._built = {}

    def add_dirty(self, coord: Tuple[int, int]) -> None:
        if coord not in self.dirty:
            self.dirty.append(coord)
            self.total += 1

    def tick(self) -> Optional[SceneManagerResult]:
        """Process queued commands; build ONE dirty chunk
        (scenemanager.rs:198-256)."""
        while self.commands:
            cmd = self.commands.pop(0)
            if cmd.kind == SceneManagerCmdKind.SetMap:
                self.set_map(*cmd.data if isinstance(cmd.data, tuple) else (cmd.data,))
            elif cmd.kind == SceneManagerCmdKind.AddDirty:
                self.add_dirty(cmd.data)
            elif cmd.kind == SceneManagerCmdKind.ClearAll:
                self.dirty = []
                self._built = {}
                return SceneManagerResult(kind="cleared")

        if not self.dirty or self.map is None:
            return None
        coord = self.dirty.pop(0)

        # full-map single-chunk rebuild: build everything once, then serve
        # per-chunk slices (the builders chunk internally)
        if not self._built:
            from ..models.scene import Scene

            tmp = Scene.empty()
            self.d3.build(self.map, self.assets, tmp)
            self.d2.build(self.map, self.assets, tmp)
            self._built = tmp.chunks

        chunk = self._built.get(coord) or Chunk(
            origin=(coord[0] * CHUNK_SIZE, coord[1] * CHUNK_SIZE)
        )
        return SceneManagerResult(
            kind="chunk",
            chunk=chunk,
            coord=coord,
            remaining=len(self.dirty),
            total=self.total,
        )

    # -- reference API surface (scenemanager.rs:85-295) --

    def receive(self) -> Optional[SceneManagerResult]:
        """Pop the oldest queued result (scenemanager.rs:85-91).

        `tick_batch` fills the queue; `tick()` also returns its result
        directly for callers that drive one chunk at a time."""
        results = getattr(self, "results", None)
        if results:
            return results.pop(0)
        return None

    def startup(self) -> None:
        """Queue the Startup result (scenemanager.rs:192-194)."""
        if not hasattr(self, "results"):
            self.results = []
        self.results.append(SceneManagerResult(kind="startup"))

    def tick_batch(self, max_chunks: int) -> int:
        """Process up to `max_chunks` chunks, queueing results for
        receive() (scenemanager.rs:260-268). Returns the processed count."""
        if not hasattr(self, "results"):
            self.results = []
        processed = 0
        for _ in range(max_chunks):
            r = self.tick()
            if r is None:
                break
            self.results.append(r)
            processed += 1
        return processed

    def is_busy(self) -> bool:
        """scenemanager.rs:288-290."""
        return bool(self.dirty) or bool(self.commands)

    def remaining_chunks(self) -> int:
        """scenemanager.rs:293-295."""
        return len(self.dirty)

    def set_tile_list(self, tiles, tile_indices=None) -> None:
        """scenemanager.rs:164-166 — replace the flattened tile list (and
        uuid->index map) on the asset registry."""
        if self.assets is not None:
            self.assets.tile_list = list(tiles)
            if tile_indices is not None:
                self.assets.tile_indices = dict(tile_indices)
            self.assets._atlas = None

    def set_palette(self, palette) -> None:
        """scenemanager.rs:168-170."""
        if self.assets is not None:
            self.assets.palette = palette

    def set_builder_2d(self, builder) -> None:
        """scenemanager.rs:172-174 — swap/disable the 2D chunk builder."""
        self.d2 = builder

    def set_dirty_terrain_chunks(self, chunks) -> None:
        """scenemanager.rs:184-186: re-dirty the chunks under the given
        terrain chunks."""
        for tc in chunks:
            ox, oy = tc.origin
            self.add_dirty((ox // CHUNK_SIZE, oy // CHUNK_SIZE))

    def set_terrain_modifier_state(self, state: bool) -> None:
        """scenemanager.rs:188-190."""
        self.terrain_modifiers_enabled = bool(state)

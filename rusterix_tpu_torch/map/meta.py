"""MapMeta — a map bundled with its associated assets
(reference src/map/meta.rs:6-15)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class MapMeta:
    map: object
    tiles: Dict[str, object] = field(default_factory=dict)

    def to_json(self) -> dict:
        from .persist import map_to_json

        return {"map": map_to_json(self.map), "tiles": sorted(self.tiles.keys())}

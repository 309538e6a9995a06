"""Per-cell runtime debug capture for codegridfx modules.

Port of the reference's DebugModule/DebugGrid
(codegridfx/lib/src/debugmodule.rs:4-101): scripts compiled from code grids
inject `set_debug_loc(routine, x, y)` calls before each cell (see
codegridfx/module.py); when the region runs in debug mode, host builtins
record their outcome at the current location and the module streams back to
the editor via RegionMessage.DebugData (src/server/region.rs:1070-1075)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple


@dataclass
class DebugGrid:
    """One routine's captured values (debugmodule.rs DebugGrid)."""

    name: str
    result: Dict[Tuple[int, int], object] = field(default_factory=dict)
    errors: Set[Tuple[int, int]] = field(default_factory=set)


@dataclass
class DebugModule:
    """entity/item id -> captured routine grids (debugmodule.rs:4)."""

    ids: Dict[int, List[DebugGrid]] = field(default_factory=dict)

    def clear(self) -> None:
        self.ids.clear()

    def ensure_grid(self, id_: int, routine_name: str) -> DebugGrid:
        grids = self.ids.setdefault(id_, [])
        for g in grids:
            if g.name == routine_name:
                return g
        g = DebugGrid(routine_name)
        grids.append(g)
        return g

    def add_value(self, id_: int, routine_name: str, x: int, y: int, value) -> bool:
        self.ensure_grid(id_, routine_name).result[(x, y)] = value
        return True

    def add_error(self, id_: int, routine_name: str, x: int, y: int) -> None:
        self.ensure_grid(id_, routine_name).errors.add((x, y))

    def remove_error(self, id_: int, routine_name: str, x: int, y: int) -> None:
        self.ensure_grid(id_, routine_name).errors.discard((x, y))

    def get_value(self, id_: int, routine_name: str, x: int, y: int):
        for g in self.ids.get(id_, []):
            if g.name == routine_name:
                return g.result.get((x, y))
        return None

    def merge(self, other: "DebugModule") -> None:
        """Insert/overwrite entries from `other` (debugmodule.rs:16-37)."""
        for id_, other_grids in other.ids.items():
            for og in other_grids:
                g = self.ensure_grid(id_, og.name)
                g.errors |= og.errors
                g.result.update(og.result)

    def copy(self) -> "DebugModule":
        out = DebugModule()
        out.merge(self)
        return out

"""The editable Doom-style world map (reference src/map/mod.rs:55-143).

Vertices + linedefs + sectors with rich editing operations; lights, entities
and items live on the map; `as_mini` compiles the slim occlusion/collision
view. The camera mode selects how the client renders the map.
"""

from __future__ import annotations

import enum
import math
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.rect import Rect
from .elements import CompiledLinedef, Linedef, Sector, Vertex
from .mini import MapMini
from .value import ValueContainer


class MapCamera(enum.IntEnum):
    """reference src/map/mod.rs:34-39"""

    TwoD = 0
    ThreeDIso = 1
    ThreeDFirstPerson = 2


class MapToolType(enum.IntEnum):
    """reference src/map/mod.rs:41-52"""

    General = 0
    Selection = 1
    Vertex = 2
    Linedef = 3
    Sector = 4
    Rect = 5
    Effects = 6
    Game = 7
    MiniMap = 8
    World = 9
    Material = 10


@dataclass
class Map:
    id: str = field(default_factory=lambda: str(uuid_mod.uuid4()))
    name: str = ""
    offset: np.ndarray = field(default_factory=lambda: np.zeros(2, np.float32))
    grid_size: float = 30.0
    subdivisions: float = 1.0

    vertices: List[Vertex] = field(default_factory=list)
    linedefs: List[Linedef] = field(default_factory=list)
    sectors: List[Sector] = field(default_factory=list)

    terrain: object = None
    sky_texture: Optional[str] = None
    camera: MapCamera = MapCamera.TwoD
    camera_xz: Optional[np.ndarray] = None
    look_at_xz: Optional[np.ndarray] = None

    lights: List[object] = field(default_factory=list)
    entities: List[object] = field(default_factory=list)
    items: List[object] = field(default_factory=list)

    selected_vertices: List[int] = field(default_factory=list)
    selected_linedefs: List[int] = field(default_factory=list)
    selected_sectors: List[int] = field(default_factory=list)
    selected_entity_item: Optional[str] = None

    properties: ValueContainer = field(default_factory=ValueContainer)
    shapefx_graphs: Dict[str, object] = field(default_factory=dict)
    softrigs: Dict[str, object] = field(default_factory=dict)
    editing_rig: Optional[str] = None
    soft_animator: Optional[object] = None
    surfaces: Dict[str, object] = field(default_factory=dict)
    profiles: Dict[str, "Map"] = field(default_factory=dict)
    shaders: Dict[str, object] = field(default_factory=dict)
    changed: int = 0

    possible_polygon: List[int] = field(default_factory=list)

    def __post_init__(self):
        if self.terrain is None:
            from .terrain import Terrain

            self.terrain = Terrain()

    # ---- lookups ----

    def get_vertex(self, vid: int) -> Optional[Vertex]:
        for v in self.vertices:
            if v.id == vid:
                return v
        return None

    find_vertex = get_vertex

    def find_linedef(self, lid: int) -> Optional[Linedef]:
        for l in self.linedefs:
            if l.id == lid:
                return l
        return None

    def find_sector(self, sid: int) -> Optional[Sector]:
        for s in self.sectors:
            if s.id == sid:
                return s
        return None

    def _free_id(self, items) -> int:
        used = {x.id for x in items}
        i = 0
        while i in used:
            i += 1
        return i

    # ---- editing (reference map/mod.rs:538-1195) ----

    def add_vertex_at(self, x: float, y: float) -> int:
        """Find-or-create a vertex at (x, y) (mod.rs:538-558)."""
        existing = self.find_vertex_at(x, y)
        if existing is not None:
            return existing
        vid = self._free_id(self.vertices)
        self.vertices.append(Vertex(vid, x, y))
        return vid

    def find_vertex_at(self, x: float, y: float) -> Optional[int]:
        for v in self.vertices:
            if abs(v.x - x) < 1e-6 and abs(v.y - y) < 1e-6:
                return v.id
        return None

    def create_linedef(self, start_vertex: int, end_vertex: int) -> Tuple[int, Optional[int]]:
        """Create/reuse a linedef; auto-close a sector on a directed cycle
        (mod.rs:632-676)."""
        for l in self.linedefs:
            if l.start_vertex == start_vertex and l.end_vertex == end_vertex:
                cycle = self._find_directed_cycle_from_edge(l.id)
                sid = None
                if cycle:
                    self.possible_polygon = cycle
                    sid = self.create_sector_from_polygon()
                return l.id, sid

        lid = self._free_id(self.linedefs)
        self.linedefs.append(Linedef(lid, start_vertex, end_vertex))
        sid = None
        cycle = self._find_directed_cycle_from_edge(lid)
        if cycle:
            self.possible_polygon = cycle
            sid = self.create_sector_from_polygon()
            if sid is not None:
                ld = self.find_linedef(lid)
                if ld is not None and sid not in ld.sector_ids:
                    ld.sector_ids.append(sid)
        return lid, sid

    def create_linedef_manual(self, start_vertex: int, end_vertex: int) -> int:
        """No auto-close; track in possible_polygon (mod.rs:677-712)."""
        for l in self.linedefs:
            if l.start_vertex == start_vertex and l.end_vertex == end_vertex:
                if l.id not in self.possible_polygon:
                    self.possible_polygon.append(l.id)
                return l.id
        lid = self._free_id(self.linedefs)
        self.linedefs.append(Linedef(lid, start_vertex, end_vertex))
        self.possible_polygon.append(lid)
        return lid

    def close_polygon_manual(self) -> Optional[int]:
        if self._test_for_closed_polygon():
            return self.create_sector_from_polygon()
        return None

    def _find_directed_cycle_from_edge(self, lid: int) -> Optional[List[int]]:
        """Shortest directed cycle through lid: BFS from its end back to its
        start following linedef winding (mod.rs:769-830). BFS (not a greedy
        successor walk) so junction vertices shared between sectors pick the
        minimal ring."""
        start_ld = self.find_linedef(lid)
        if start_ld is None:
            return None
        from collections import deque

        frm, to = start_ld.end_vertex, start_ld.start_vertex
        queue = deque([frm])
        visited = {frm}
        parent = {}  # vertex -> (prev_vertex, edge_id)
        while queue:
            v = queue.popleft()
            for l in self.linedefs:
                if l.id == lid or l.start_vertex != v:
                    continue
                nxt = l.end_vertex
                if nxt in visited:
                    continue
                parent[nxt] = (v, l.id)
                if nxt == to:
                    path = []
                    cur = to
                    while cur in parent:
                        pv, eid = parent[cur]
                        path.append(eid)
                        if pv == frm:
                            break
                        cur = pv
                    path.reverse()
                    if len(path) + 1 < 3:
                        return None
                    return path + [lid]
                visited.add(nxt)
                queue.append(nxt)
        return None

    def _test_for_closed_polygon(self) -> bool:
        if len(self.possible_polygon) < 3:
            return False
        first = self.find_linedef(self.possible_polygon[0])
        last = self.find_linedef(self.possible_polygon[-1])
        if first is None or last is None:
            return False
        return last.end_vertex == first.start_vertex

    def create_sector_from_polygon(self) -> Optional[int]:
        """mod.rs:850-887"""
        if not self._test_for_closed_polygon():
            return None
        if self._find_sector_by_linedefs(self.possible_polygon) is not None:
            self.possible_polygon = []
            return None
        sid = self._free_id(self.sectors)
        for lid in self.possible_polygon:
            ld = self.find_linedef(lid)
            if ld is not None and sid not in ld.sector_ids:
                ld.sector_ids.append(sid)
        self.sectors.append(Sector(sid, list(self.possible_polygon)))
        self.possible_polygon = []
        return sid

    def _find_sector_by_linedefs(self, lids: List[int]) -> Optional[int]:
        for s in self.sectors:
            if len(s.linedefs) == len(lids) and all(i in lids for i in s.linedefs):
                return s.id
        return None

    def clear_selection(self) -> None:
        self.selected_vertices = []
        self.selected_linedefs = []
        self.selected_sectors = []
        self.selected_entity_item = None

    def copy_selected(self, cut: bool = False) -> "Map":
        """Selection -> normalized clipboard map (mod.rs:1527-1650):
        selected sectors pull in their linedefs, linedefs pull in their
        vertices; positions normalized to the selection's min corner;
        sectors copied only when their full ring was selected."""
        import copy as _copy

        clipboard = Map()
        linedef_ids = set(self.selected_linedefs)
        sector_ids = set(self.selected_sectors)
        for sid in sector_ids:
            s = self.find_sector(sid)
            if s is not None:
                linedef_ids.update(s.linedefs)
        vertex_ids = set(self.selected_vertices)
        for lid in linedef_ids:
            ld = self.find_linedef(lid)
            if ld is not None:
                vertex_ids.update((ld.start_vertex, ld.end_vertex))

        copied = [self.find_vertex(v) for v in vertex_ids]
        copied = [v for v in copied if v is not None]
        if not copied:
            return clipboard
        min_x = min(v.x for v in copied)
        min_y = min(v.y for v in copied)

        v_map, l_map = {}, {}
        for old in copied:
            nv = _copy.deepcopy(old)
            nv.id = clipboard._free_id(clipboard.vertices)
            nv.x -= min_x
            nv.y -= min_y
            v_map[old.id] = nv.id
            clipboard.vertices.append(nv)
        for lid in linedef_ids:
            ld = self.find_linedef(lid)
            if ld is None:
                continue
            nl = _copy.deepcopy(ld)
            nl.id = clipboard._free_id(clipboard.linedefs)
            nl.start_vertex = v_map[ld.start_vertex]
            nl.end_vertex = v_map[ld.end_vertex]
            nl.sector_ids = []
            l_map[ld.id] = nl.id
            clipboard.linedefs.append(nl)
        for sid in sector_ids:
            s = self.find_sector(sid)
            if s is None or not all(l in linedef_ids for l in s.linedefs):
                continue
            ns = _copy.deepcopy(s)
            ns.id = clipboard._free_id(clipboard.sectors)
            ns.linedefs = [l_map[l] for l in s.linedefs]
            for nl_id in ns.linedefs:
                nl = clipboard.find_linedef(nl_id)
                if nl is not None and ns.id not in nl.sector_ids:
                    nl.sector_ids.append(ns.id)
            clipboard.sectors.append(ns)

        if cut:
            self.delete_elements(
                list(vertex_ids), list(linedef_ids), list(sector_ids)
            )
            self.clear_selection()
        return clipboard

    def paste_at_position(self, local_map: "Map", position) -> None:
        """Insert a clipboard map at `position`, selecting the pasted
        elements (mod.rs:1653-1714)."""
        import copy as _copy

        self.clear_selection()
        v_map, l_map = {}, {}
        for v in local_map.vertices:
            nv = _copy.deepcopy(v)
            nv.id = self._free_id(self.vertices)
            nv.x += float(position[0])
            nv.y += float(position[1])
            self.vertices.append(nv)
            self.selected_vertices.append(nv.id)
            v_map[v.id] = nv.id
        for l in local_map.linedefs:
            nl = _copy.deepcopy(l)
            nl.id = self._free_id(self.linedefs)
            nl.start_vertex = v_map[l.start_vertex]
            nl.end_vertex = v_map[l.end_vertex]
            nl.sector_ids = []
            self.linedefs.append(nl)
            self.selected_linedefs.append(nl.id)
            l_map[l.id] = nl.id
        for s in local_map.sectors:
            ns = _copy.deepcopy(s)
            ns.id = self._free_id(self.sectors)
            ns.linedefs = [l_map[l] for l in s.linedefs]
            for nl_id in ns.linedefs:
                nl = self.find_linedef(nl_id)
                if nl is not None and ns.id not in nl.sector_ids:
                    nl.sector_ids.append(ns.id)
            self.sectors.append(ns)
            self.selected_sectors.append(ns.id)

    def geometry_clone(self) -> "Map":
        """Vertices/linedefs/sectors + shapefx graphs only (mod.rs:1717)."""
        import copy as _copy

        out = Map()
        out.vertices = _copy.deepcopy(self.vertices)
        out.linedefs = _copy.deepcopy(self.linedefs)
        out.sectors = _copy.deepcopy(self.sectors)
        out.shapefx_graphs = dict(self.shapefx_graphs)
        out.grid_size = getattr(self, "grid_size", 1.0)
        return out

    def extract_chunk_geometry(self, bbox) -> "Map":
        """Geometry intersecting a chunk bbox -> new map (mod.rs:1768-1850).
        `bbox` is a Rect."""
        import copy as _copy

        out = Map()
        v_map, l_map = {}, {}
        for l in self.linedefs:
            a = self.get_vertex(l.start_vertex)
            b = self.get_vertex(l.end_vertex)
            if a is None or b is None:
                continue
            if not (
                bbox.contains(a.x, a.y)
                or bbox.contains(b.x, b.y)
                or _segment_intersects_rect(a, b, bbox)
            ):
                continue
            for v in (a, b):
                if v.id not in v_map:
                    nv = _copy.deepcopy(v)
                    nv.id = out._free_id(out.vertices)
                    v_map[v.id] = nv.id
                    out.vertices.append(nv)
            nl = _copy.deepcopy(l)
            nl.id = out._free_id(out.linedefs)
            nl.start_vertex = v_map[l.start_vertex]
            nl.end_vertex = v_map[l.end_vertex]
            nl.sector_ids = []
            l_map[l.id] = nl.id
            out.linedefs.append(nl)
        for s in self.sectors:
            if not any(lid in l_map for lid in s.linedefs):
                continue
            ns = _copy.deepcopy(s)
            ns.id = out._free_id(out.sectors)
            ns.linedefs = [l_map[lid] for lid in s.linedefs if lid in l_map]
            for nl_id in ns.linedefs:
                nl = out.find_linedef(nl_id)
                if nl is not None and ns.id not in nl.sector_ids:
                    nl.sector_ids.append(ns.id)
            out.sectors.append(ns)
        return out

    def add_midpoint(self, linedef_id: int) -> Optional[int]:
        """Split a linedef at its midpoint (mod.rs:1080+)."""
        ld = self.find_linedef(linedef_id)
        if ld is None:
            return None
        v0 = self.get_vertex(ld.start_vertex)
        v1 = self.get_vertex(ld.end_vertex)
        if v0 is None or v1 is None:
            return None
        mid = self.add_vertex_at((v0.x + v1.x) / 2.0, (v0.y + v1.y) / 2.0)
        new_id = self._free_id(self.linedefs)
        second = Linedef(new_id, mid, ld.end_vertex)
        second.sector_ids = list(ld.sector_ids)
        second.properties = ld.properties.copy()
        ld.end_vertex = mid
        self.linedefs.append(second)
        for s in self.sectors:
            if linedef_id in s.linedefs:
                i = s.linedefs.index(linedef_id)
                s.linedefs.insert(i + 1, new_id)
        return mid

    def delete_elements(self, vertex_ids, linedef_ids, sector_ids) -> None:
        """mod.rs:902+ — cascade deletes."""
        all_linedefs = set(linedef_ids)
        for vid in vertex_ids:
            for l in self.linedefs:
                if l.start_vertex == vid or l.end_vertex == vid:
                    all_linedefs.add(l.id)
        all_sectors = set(sector_ids)
        for s in self.sectors:
            if any(l in all_linedefs for l in s.linedefs):
                all_sectors.add(s.id)
        self.sectors = [s for s in self.sectors if s.id not in all_sectors]
        self.linedefs = [l for l in self.linedefs if l.id not in all_linedefs]
        self.vertices = [v for v in self.vertices if v.id not in set(vertex_ids)]
        for l in self.linedefs:
            l.sector_ids = [s for s in l.sector_ids if s not in all_sectors]

    def sanitize(self) -> None:
        """Remove dangling references (mod.rs:1197+)."""
        vids = {v.id for v in self.vertices}
        self.linedefs = [
            l for l in self.linedefs if l.start_vertex in vids and l.end_vertex in vids
        ]
        lids = {l.id for l in self.linedefs}
        self.sectors = [
            s for s in self.sectors if all(i in lids for i in s.linedefs) and len(s.linedefs) >= 3
        ]
        sids = {s.id for s in self.sectors}
        for l in self.linedefs:
            l.sector_ids = [s for s in l.sector_ids if s in sids]

    # ---- queries ----

    def bounding_box(self) -> Optional[Rect]:
        if not self.vertices:
            return None
        xs = [v.x for v in self.vertices]
        ys = [v.y for v in self.vertices]
        return Rect(min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys))

    def sector_at(self, x: float, y: float) -> Optional[Sector]:
        for s in self.sectors:
            if s.layer is None and s.is_inside(self, (x, y)):
                return s
        for s in self.sectors:
            if s.is_inside(self, (x, y)):
                return s
        return None

    # ---- reference editor-helper surface (map/mod.rs:203-1160) ----

    def bbox(self) -> Optional[Rect]:
        """Reference name for bounding_box (mod.rs)."""
        return self.bounding_box()

    def is_empty(self) -> bool:
        return not (self.vertices or self.linedefs or self.sectors)

    def info(self) -> str:
        """One-line stats summary (mod.rs info)."""
        return (
            f"{len(self.vertices)} vertices, {len(self.linedefs)} linedefs, "
            f"{len(self.sectors)} sectors, {len(self.entities)} entities, "
            f"{len(self.items)} items"
        )

    def clear_temp(self) -> None:
        """Drop in-progress editor state (mod.rs:203-207)."""
        self.possible_polygon = []

    def find_vertex(self, vertex_id: int):
        """Reference name for get_vertex."""
        return self.get_vertex(vertex_id)

    def find_sector_at(self, x: float, y: float) -> Optional[Sector]:
        """Reference name for sector_at."""
        return self.sector_at(x, y)

    def find_free_vertex_id(self) -> int:
        return self._free_id(self.vertices)

    def find_free_linedef_id(self) -> int:
        return self._free_id(self.linedefs)

    def find_free_sector_id(self) -> int:
        return self._free_id(self.sectors)

    def has_selection(self) -> bool:
        return bool(
            self.selected_vertices
            or self.selected_linedefs
            or self.selected_sectors
        )

    def add_to_selection(self, vertices=(), linedefs=(), sectors=()) -> None:
        """mod.rs:1024-1043 (no duplicates)."""
        for v in vertices:
            if v not in self.selected_vertices:
                self.selected_vertices.append(v)
        for l in linedefs:
            if l not in self.selected_linedefs:
                self.selected_linedefs.append(l)
        for s in sectors:
            if s not in self.selected_sectors:
                self.selected_sectors.append(s)

    def remove_from_selection(self, vertices=(), linedefs=(), sectors=()) -> None:
        self.selected_vertices = [
            v for v in self.selected_vertices if v not in set(vertices)
        ]
        self.selected_linedefs = [
            l for l in self.selected_linedefs if l not in set(linedefs)
        ]
        self.selected_sectors = [
            s for s in self.selected_sectors if s not in set(sectors)
        ]

    def is_vertex_in_rect(self, vertex_id: int, rect: Rect) -> bool:
        v = self.get_vertex(vertex_id)
        return v is not None and (
            rect.x <= v.x <= rect.max_x and rect.y <= v.y <= rect.max_y
        )

    def is_linedef_in_rect(self, linedef_id: int, rect: Rect) -> bool:
        l = self.find_linedef(linedef_id)
        return l is not None and (
            self.is_vertex_in_rect(l.start_vertex, rect)
            and self.is_vertex_in_rect(l.end_vertex, rect)
        )

    def is_linedef_in_closed_polygon(self, linedef_id: int) -> bool:
        """mod.rs:1017-1021."""
        return any(linedef_id in s.linedefs for s in self.sectors)

    def test_for_closed_polygon(self):
        """Public reference name (mod.rs test_for_closed_polygon)."""
        return self._test_for_closed_polygon()

    def sorted_sectors_by_area(self) -> List[Sector]:
        """Largest first (mod.rs:1061-1077)."""
        return sorted(self.sectors, key=lambda s: -s.area(self))

    def find_sectors_with_vertex_indices(self, vertex_ids) -> List[int]:
        """Sectors whose linedef loop uses exactly these vertices
        (mod.rs:1135-1160)."""
        want = sorted(vertex_ids)
        out = []
        for s in self.sectors:
            verts = set()
            for lid in s.linedefs:
                l = self.find_linedef(lid)
                if l is not None:
                    verts.add(l.start_vertex)
                    verts.add(l.end_vertex)
            if sorted(verts) == want:
                out.append(s.id)
        return out

    def duplicate_vertex(self, vertex_id: int) -> Optional[int]:
        """mod.rs:734-744."""
        import copy as _copy

        v = self.get_vertex(vertex_id)
        if v is None:
            return None
        new_v = _copy.deepcopy(v)
        new_v.id = self.find_free_vertex_id()
        self.vertices.append(new_v)
        return new_v.id

    def replace_vertex_in_sector(
        self, sector_id: int, old_vertex_id: int, new_vertex_id: int
    ) -> None:
        """mod.rs:747-765."""
        s = self.find_sector(sector_id)
        if s is None:
            return
        for lid in s.linedefs:
            l = self.find_linedef(lid)
            if l is None:
                continue
            if l.start_vertex == old_vertex_id:
                l.start_vertex = new_vertex_id
            if l.end_vertex == old_vertex_id:
                l.end_vertex = new_vertex_id

    def update_vertex(self, vertex_id: int, new_position) -> None:
        """Move a vertex (into the active soft-rig keyform when editing one,
        mod.rs:504-540)."""
        if self.editing_rig is not None:
            rig = self.softrigs.get(self.editing_rig)
            if rig is not None and rig.keyforms:
                kf = rig.keyforms[0]
                pos = (float(new_position[0]), float(new_position[1]))
                for i, (vid, _) in enumerate(kf.vertex_positions):
                    if vid == vertex_id:
                        kf.vertex_positions[i] = (vid, pos)
                        return
                kf.vertex_positions.append((vertex_id, pos))
                return
        v = self.get_vertex(vertex_id)
        if v is not None:
            v.x = float(new_position[0])
            v.y = float(new_position[1])

    def add_vertex_at_3d(self, x: float, y: float, z: float, snap: bool = False) -> int:
        """3D vertex create-or-reuse with grid snap (mod.rs:560-585)."""
        if snap and self.subdivisions:
            step = 1.0 / self.subdivisions
            x = round(x / step) * step
            y = round(y / step) * step
            z = round(z / step) * step
        existing = self.find_vertex_at_3d(x, y, z)
        if existing is not None:
            return existing
        vid = self.add_vertex_at(x, y)
        self.get_vertex(vid).z = float(z)
        return vid

    def find_vertex_at_3d(self, x: float, y: float, z: float) -> Optional[int]:
        for v in self.vertices:
            if (
                abs(v.x - x) < 1e-5
                and abs(v.y - y) < 1e-5
                and abs(getattr(v, "z", 0.0) - z) < 1e-5
            ):
                return v.id
        return None

    def get_vertex_3d(self, vertex_id: int):
        """(x, z, y) world position of a vertex (mod.rs:463-500 — the
        reference swizzles map-y into world-z)."""
        v = self.get_vertex(vertex_id)
        if v is None:
            return None
        return np.array([v.x, getattr(v, "z", 0.0), v.y], np.float32)

    def get_surface_for_sector_id(self, sector_id: int):
        """mod.rs:218-222."""
        for surface in self.surfaces.values():
            if surface.sector_id == sector_id:
                return surface
        return None

    def update_surfaces(self) -> None:
        """Recompute every surface's plane/basis (mod.rs:232-238)."""
        for surface in self.surfaces.values():
            surface.calculate_geometry(self)

    # ---- compile / animate ----

    def as_mini(self, blocking_tiles=frozenset()) -> MapMini:
        """Compile the slim occlusion/collision view (mod.rs:241-378)."""
        mini = MapMini()
        for sector in self.sectors:
            occlusion = sector.properties.get_float_default("occlusion", 1.0)
            if occlusion < 1.0:
                bbox = sector.bounding_box(self)
                bbox = Rect(bbox.x - 0.1, bbox.y - 0.1, bbox.width + 0.2, bbox.height + 0.2)
                mini.occluded_sectors.append((bbox, occlusion))
        for l in self.linedefs:
            wall_height = l.properties.get_float_default("wall_height", 0.0)
            if wall_height > 0.0:
                v0 = self.get_vertex(l.start_vertex)
                v1 = self.get_vertex(l.end_vertex)
                if v0 is not None and v1 is not None:
                    mini.linedefs.append(
                        CompiledLinedef(
                            v0.as_vec2(),
                            v1.as_vec2(),
                            l.properties.get_float_default("wall_width", 0.0),
                            wall_height,
                        )
                    )
        return mini

    def tick(self, delta_time: float) -> None:
        """Advance soft-rig vertex animation (mod.rs:416+)."""
        if self.soft_animator is not None:
            self.soft_animator.update(delta_time)


def _segment_intersects_rect(a, b, rect) -> bool:
    """Segment-vs-rect test for extract_chunk_geometry (BBox::line_intersects)."""
    # quick reject by segment AABB
    if max(a.x, b.x) < rect.x or min(a.x, b.x) > rect.max_x:
        return False
    if max(a.y, b.y) < rect.y or min(a.y, b.y) > rect.max_y:
        return False

    def side(px, py, qx, qy, rx, ry):
        return (qx - px) * (ry - py) - (qy - py) * (rx - px)

    corners = [
        (rect.x, rect.y),
        (rect.max_x, rect.y),
        (rect.max_x, rect.max_y),
        (rect.x, rect.max_y),
    ]
    signs = [side(a.x, a.y, b.x, b.y, cx, cy) for cx, cy in corners]
    return not (all(s > 0 for s in signs) or all(s < 0 for s in signs))

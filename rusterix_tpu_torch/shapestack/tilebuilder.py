"""Character/item tile baking (reference src/shapestack/tilebuilder.rs).

Entities and items whose class has a character/item map (a 2D vector shape
styled by ShapeFX graphs) get their billboard tiles baked here: soft-rig
sequences matched by name prefix become animation frames (3 frames per rig
transition, looping), equipped items anchor extra geometry onto named
linedef slots, and item "color"/"color_targets" attributes override sector
colors.
"""

from __future__ import annotations

import copy
import re
from typing import Dict, List, Optional

import numpy as np

from ..map.softrig import blend_softrigs
from ..models.texture import Texture, Tile
from .stack import ShapeStack

TILE_SIZE = 64  # tilebuilder.rs:10
FRAMES_PER_TRANSITION = 3  # tilebuilder.rs:164


def tile_builder(map_, assets) -> None:
    """Build missing entity/item tiles for `_source_seq` sequences
    (tilebuilder.rs:9-127). Mutates assets.entity_tiles / assets.item_tiles."""
    for entity in map_.entities:
        if entity.attributes.contains("source"):
            continue
        seq = entity.attributes.get_source("_source_seq")
        name = getattr(seq, "name", None)
        if name is None:
            continue
        tiles = assets.entity_tiles.get(entity.id)
        if tiles is not None and name in tiles:
            continue
        class_name = entity.attributes.get_str_default("class_name", "")
        cmap = assets.character_maps.get(class_name)
        if cmap is None:
            continue
        overrides = compute_sector_overrides(cmap, entity)
        tile = build_tile(cmap, assets, name, TILE_SIZE, overrides, entity)
        assets.entity_tiles.setdefault(entity.id, {})[name] = tile

    for item in map_.items:
        if item.attributes.contains("source"):
            continue
        seq = item.attributes.get_source("_source_seq")
        name = getattr(seq, "name", None)
        if name is None:
            continue
        tiles = assets.item_tiles.get(item.id)
        if tiles is not None and name in tiles:
            continue
        class_name = item.attributes.get_str_default("class_name", "")
        imap = assets.item_maps.get(class_name)
        if imap is None:
            continue
        tile = build_tile(imap, assets, name, TILE_SIZE, {}, None)
        assets.item_tiles.setdefault(item.id, {})[name] = tile


def _matched_rigs(map_, base_sequence: str):
    """Rigs whose name starts with the sequence name, ordered by trailing
    number (tilebuilder.rs:137-157)."""
    out = []
    base = base_sequence.lower()
    for rig in map_.softrigs.values():
        nm = rig.name.lower()
        if nm.startswith(base):
            suffix = rig.name[len(base):]
            mt = re.search(r"(\d+)", suffix)
            out.append((rig, int(mt.group(1)) if mt else 0))
    out.sort(key=lambda p: p[1])
    return out


def _render_frame(map_, assets, size: int, sector_overrides, entity) -> Texture:
    tex = Texture.alloc(size, size)
    stack = ShapeStack((-5.0, -5.0), (5.0, 5.0))
    stack.render_geometry(tex.data, map_, assets, False, sector_overrides)
    if entity is not None:
        anchored = extract_anchored_geometry(entity, map_, assets)
        if anchored.vertices:
            stack.render_geometry(tex.data, anchored, assets, False, {})
    return tex


def build_tile(
    map_,
    assets,
    base_sequence: str,
    size: int = TILE_SIZE,
    sector_overrides: Optional[Dict[int, np.ndarray]] = None,
    entity=None,
) -> Tile:
    """Render a sequence to a Tile: 0 rigs -> single static frame; 1 rig ->
    single posed frame; N rigs -> 3-frame transitions looping back to the
    start, skipping duplicate last frames (tilebuilder.rs:129-257)."""
    sector_overrides = sector_overrides or {}
    rigs = _matched_rigs(map_, base_sequence)
    frames: List[Texture] = []

    if len(rigs) == 0:
        frames.append(_render_frame(map_, assets, size, sector_overrides, entity))
    elif len(rigs) == 1:
        rig = rigs[0][0]
        temp = copy.deepcopy(map_)
        temp.editing_rig = rig.id
        temp.softrigs[rig.id] = rig
        frames.append(_render_frame(temp, assets, size, sector_overrides, entity))
    else:
        rig_count = len(rigs)
        for i in range(rig_count):  # loop back to start
            rig_a = rigs[i][0]
            rig_b = rigs[(i + 1) % rig_count][0]
            for f in range(FRAMES_PER_TRANSITION - 1):  # skip last frame each
                t = f / (FRAMES_PER_TRANSITION - 1)
                blended = blend_softrigs(rig_a, rig_b, t)
                temp = copy.deepcopy(map_)
                temp.editing_rig = blended.id
                temp.softrigs[blended.id] = blended
                frames.append(
                    _render_frame(temp, assets, size, sector_overrides, entity)
                )

    return Tile(textures=frames)


def extract_anchored_geometry(entity, character_map, assets):
    """New map holding equipped-item geometry translated onto the character
    map's named anchor linedefs (tilebuilder.rs:260-357)."""
    from ..map.worldmap import Map

    new_map = Map()
    for _slot, item in getattr(entity, "equipped", {}).items():
        targets: List[str] = []
        gv = item.attributes.get("geo_targets")
        if gv is not None and isinstance(gv.data, (list, tuple)):
            targets = [str(s) for s in gv.data]
        else:
            slot_name = item.attributes.get_str_default("slot", "")
            if slot_name:
                targets = [slot_name]
        if not targets:
            continue

        class_name = item.attributes.get_str_default("class_name", "")
        item_map = assets.item_maps.get(class_name)
        if item_map is None:
            continue

        for gid, graph in getattr(item_map, "shapefx_graphs", {}).items():
            new_map.shapefx_graphs[gid] = graph

        for target_name in targets:
            target = next(
                (l for l in character_map.linedefs if getattr(l, "name", "") == target_name),
                None,
            )
            if target is None:
                continue
            v0 = character_map.get_vertex(target.start_vertex)
            v1 = character_map.get_vertex(target.end_vertex)
            if v0 is None or v1 is None:
                continue
            off_x = (v0.x + v1.x) * 0.5
            off_y = (v0.y + v1.y) * 0.5

            id_map = {}
            for v in item_map.vertices:
                nv = copy.deepcopy(v)
                nv.id = len(new_map.vertices)
                nv.x += off_x
                nv.y += off_y
                id_map[v.id] = nv.id
                new_map.vertices.append(nv)
            ld_id_map = {}
            for l in item_map.linedefs:
                nl = copy.deepcopy(l)
                nl.id = len(new_map.linedefs)
                nl.start_vertex = id_map[l.start_vertex]
                nl.end_vertex = id_map[l.end_vertex]
                ld_id_map[l.id] = nl.id
                new_map.linedefs.append(nl)
            for s in item_map.sectors:
                ns = copy.deepcopy(s)
                ns.id = len(new_map.sectors)
                ns.linedefs = [ld_id_map.get(lid, 0) for lid in s.linedefs]
                new_map.sectors.append(ns)
    return new_map


def compute_sector_overrides(map_, entity) -> Dict[int, np.ndarray]:
    """Item color overrides keyed by target sector name
    (tilebuilder.rs:360-376)."""
    overrides: Dict[int, np.ndarray] = {}
    for _slot, item in getattr(entity, "equipped", {}).items():
        cv = item.attributes.get("color")
        tv = item.attributes.get("color_targets")
        if cv is None or tv is None:
            continue
        color = cv.data
        targets = tv.data if isinstance(tv.data, (list, tuple)) else []
        if color is None or not targets:
            continue
        rgba = np.asarray(
            list(color) + [1.0] * (4 - len(color)) if len(color) < 4 else color,
            np.float32,
        )
        for sector in map_.sectors:
            if getattr(sector, "name", "") in targets:
                overrides[sector.id] = rgba
    return overrides

"""World-model persistence: the save-game / replication format.

The reference serializes the whole world model with serde — Map, Vertex,
Linedef, Sector, Surface, Value, Tile all derive Serialize/Deserialize
(reference src/map/mod.rs:53) and Entity/Item likewise (src/server/
entity.rs:10). SURVEY §5 calls this "the save-game/replication format".
This module is the JSON equivalent: a stable, human-readable dict shape
with one `kind`-tagged encoding for the Value enum, round-tripping
everything that affects rendering and simulation (plus editor selection
state, which the reference also persists).

Runtime state sync uses the dirty-bitmask delta protocol in
server/entity.py; this module is the full-snapshot layer underneath it.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ..models.batch import PixelSource, PixelSourceKind
from ..models.light import CompiledLight, Light, LightType
from .elements import Linedef, Sector, Vertex
from .surface import (
    Basis3,
    BillboardAnimation,
    ExtrudeUVMode,
    ExtrusionSpec,
    LoopOp,
    LoopOpKind,
    Plane,
    ProfileLoop,
    Surface,
)
from .terrain import Terrain, TerrainBlendMode, TerrainChunk
from .value import Value, ValueContainer, ValueKind


def _vec(a) -> list:
    return [float(x) for x in np.asarray(a).reshape(-1)]


# ---------------------------------------------------------------------------
# PixelSource
# ---------------------------------------------------------------------------


def source_to_json(s: PixelSource) -> dict:
    return {
        "kind": int(s.kind),
        "index": int(s.index),
        "entity_id": int(s.entity_id),
        "pixel": [int(c) for c in s.pixel],
        "uuid": s.uuid,
        "name": s.name,
    }


def source_from_json(d: dict) -> PixelSource:
    return PixelSource(
        kind=PixelSourceKind(d["kind"]),
        index=d.get("index", 0),
        entity_id=d.get("entity_id", 0),
        pixel=tuple(d.get("pixel", (0, 0, 0, 255))),
        uuid=d.get("uuid"),
        name=d.get("name"),
    )


# ---------------------------------------------------------------------------
# Lights
# ---------------------------------------------------------------------------


def light_to_json(l) -> dict:
    return {
        "compiled": isinstance(l, CompiledLight),
        "light_type": int(l.light_type),
        "position": _vec(l.position),
        "color": _vec(l.color),
        "intensity": float(l.intensity),
        "emitting": bool(l.emitting),
        "start_distance": float(l.start_distance),
        "end_distance": float(l.end_distance),
        "flicker": float(l.flicker),
        "direction": _vec(l.direction),
        "cone_angle": float(l.cone_angle),
        "normal": _vec(l.normal),
        "width": float(l.width),
        "height": float(l.height),
        "from_linedef": bool(l.from_linedef),
    }


def light_from_json(d: dict):
    cls = CompiledLight if d.get("compiled", True) else Light
    out = cls(light_type=LightType(d["light_type"]))
    out.position = np.asarray(d["position"], np.float32)
    out.color = np.asarray(d["color"], np.float32)
    out.intensity = d["intensity"]
    out.emitting = d["emitting"]
    out.start_distance = d["start_distance"]
    out.end_distance = d["end_distance"]
    out.flicker = d["flicker"]
    out.direction = np.asarray(d["direction"], np.float32)
    out.cone_angle = d["cone_angle"]
    out.normal = np.asarray(d["normal"], np.float32)
    out.width = d["width"]
    out.height = d["height"]
    out.from_linedef = d["from_linedef"]
    return out


# ---------------------------------------------------------------------------
# Value / ValueContainer
# ---------------------------------------------------------------------------


def value_to_json(v: Value) -> dict:
    k = v.kind
    if k == ValueKind.Source:
        data = source_to_json(v.data) if v.data is not None else None
    elif k == ValueKind.Light:
        data = light_to_json(v.data) if v.data is not None else None
    elif k == ValueKind.TileOverrides:
        data = [
            {"key": list(kk), "source": source_to_json(vv)}
            for kk, vv in (v.data or {}).items()
        ]
    elif isinstance(v.data, (tuple, list)):
        data = list(v.data)
    elif isinstance(v.data, (np.floating, np.integer)):
        data = v.data.item()
    else:
        data = v.data
    return {"kind": int(k), "data": data}


def value_from_json(d: dict) -> Value:
    k = ValueKind(d["kind"])
    data = d["data"]
    if k == ValueKind.Source and data is not None:
        data = source_from_json(data)
    elif k == ValueKind.Light and data is not None:
        data = light_from_json(data)
    elif k == ValueKind.TileOverrides and data is not None:
        data = {tuple(e["key"]): source_from_json(e["source"]) for e in data}
    elif k in (
        ValueKind.Vec2,
        ValueKind.Vec3,
        ValueKind.Vec4,
        ValueKind.Color,
        ValueKind.FloatArray,
        ValueKind.StrArray,
        ValueKind.IntArray,
    ) and data is not None:
        data = tuple(data)
    return Value(k, data)


def vc_to_json(vc: ValueContainer) -> dict:
    return {k: value_to_json(v) for k, v in vc.items()}


def vc_from_json(d: dict) -> ValueContainer:
    vc = ValueContainer()
    for k, v in d.items():
        vc._values[k] = value_from_json(v)
    return vc


# ---------------------------------------------------------------------------
# Map elements
# ---------------------------------------------------------------------------


def _vertex_to_json(v: Vertex) -> dict:
    return {
        "id": v.id, "x": v.x, "y": v.y, "z": v.z,
        "properties": vc_to_json(v.properties),
    }


def _vertex_from_json(d: dict) -> Vertex:
    return Vertex(
        id=d["id"], x=d["x"], y=d["y"], z=d.get("z", 0.0),
        properties=vc_from_json(d.get("properties", {})),
    )


def _linedef_to_json(l: Linedef) -> dict:
    return {
        "id": l.id,
        "start_vertex": l.start_vertex,
        "end_vertex": l.end_vertex,
        "name": l.name,
        "sector_ids": list(l.sector_ids),
        "properties": vc_to_json(l.properties),
        "creator_id": l.creator_id,
    }


def _linedef_from_json(d: dict) -> Linedef:
    return Linedef(
        id=d["id"],
        start_vertex=d["start_vertex"],
        end_vertex=d["end_vertex"],
        name=d.get("name", ""),
        sector_ids=list(d.get("sector_ids", [])),
        properties=vc_from_json(d.get("properties", {})),
        creator_id=d.get("creator_id", ""),
    )


def _sector_to_json(s: Sector) -> dict:
    return {
        "id": s.id,
        "linedefs": list(s.linedefs),
        "name": s.name,
        "layer": s.layer,
        "properties": vc_to_json(s.properties),
        "creator_id": s.creator_id,
    }


def _sector_from_json(d: dict) -> Sector:
    out = Sector(
        id=d["id"],
        linedefs=list(d.get("linedefs", [])),
        name=d.get("name", ""),
        layer=d.get("layer"),
        creator_id=d.get("creator_id", ""),
    )
    out.properties = vc_from_json(d.get("properties", {}))
    return out


def _surface_to_json(s: Surface) -> dict:
    return {
        "sector_id": s.sector_id,
        "id": s.id,
        "plane": {"origin": _vec(s.plane.origin), "normal": _vec(s.plane.normal)},
        "frame": {
            "right": _vec(s.frame.right),
            "up": _vec(s.frame.up),
            "normal": _vec(s.frame.normal),
        },
        "edit_scale": s.edit_scale,
        "extrusion": {
            "enabled": s.extrusion.enabled,
            "depth": s.extrusion.depth,
            "cap_front": s.extrusion.cap_front,
            "cap_back": s.extrusion.cap_back,
            "flip_normal": s.extrusion.flip_normal,
            "uv_mode": int(s.extrusion.uv_mode),
            "uv_scale": list(s.extrusion.uv_scale),
        },
        "profile": s.profile,
        "profile_loops": [
            {
                "path": [list(p) for p in pl.path],
                "op": {
                    "kind": int(pl.op.kind),
                    "height": pl.op.height,
                    "depth": pl.op.depth,
                    "tile_id": pl.op.tile_id,
                    "animation": int(pl.op.animation),
                    "target_side": pl.op.target_side,
                },
                "origin_profile_sector": pl.origin_profile_sector,
            }
            for pl in s.profile_loops
        ],
        "billboard_progress": s.billboard_progress,
    }


def _surface_from_json(d: dict) -> Surface:
    ex = d.get("extrusion", {})
    return Surface(
        sector_id=d["sector_id"],
        id=d["id"],
        plane=Plane(
            origin=np.asarray(d["plane"]["origin"], np.float32),
            normal=np.asarray(d["plane"]["normal"], np.float32),
        ),
        frame=Basis3(
            right=np.asarray(d["frame"]["right"], np.float32),
            up=np.asarray(d["frame"]["up"], np.float32),
            normal=np.asarray(d["frame"]["normal"], np.float32),
        ),
        edit_scale=d.get("edit_scale", 1.0),
        extrusion=ExtrusionSpec(
            enabled=ex.get("enabled", False),
            depth=ex.get("depth", 0.0),
            cap_front=ex.get("cap_front", True),
            cap_back=ex.get("cap_back", False),
            flip_normal=ex.get("flip_normal", False),
            uv_mode=ExtrudeUVMode(ex.get("uv_mode", 0)),
            uv_scale=tuple(ex.get("uv_scale", (1.0, 1.0))),
        ),
        profile=d.get("profile"),
        profile_loops=[
            ProfileLoop(
                path=[tuple(p) for p in pl["path"]],
                op=LoopOp(
                    kind=LoopOpKind(pl["op"]["kind"]),
                    height=pl["op"]["height"],
                    depth=pl["op"]["depth"],
                    tile_id=pl["op"]["tile_id"],
                    animation=BillboardAnimation(pl["op"]["animation"]),
                    target_side=pl["op"]["target_side"],
                ),
                origin_profile_sector=pl.get("origin_profile_sector"),
            )
            for pl in d.get("profile_loops", [])
        ],
        billboard_progress=d.get("billboard_progress", 0.0),
    )


def _terrain_to_json(t: Terrain) -> dict:
    return {
        "scale": t.scale,
        "chunks": [
            {
                "key": list(k),
                "origin": list(c.origin),
                "heights": c.heights.tolist(),
                "sources": [
                    {"key": list(kk), "source": source_to_json(vv)}
                    for kk, vv in c.sources.items()
                ],
                "blend_modes": [
                    {"key": list(kk), "mode": int(vv)}
                    for kk, vv in c.blend_modes.items()
                ],
            }
            for k, c in t.chunks.items()
        ],
    }


def _terrain_from_json(d: dict) -> Terrain:
    t = Terrain(scale=d.get("scale", 1.0))
    for cd in d.get("chunks", []):
        c = TerrainChunk(origin=tuple(cd["origin"]))
        c.heights = np.asarray(cd["heights"], np.float32)
        c.sources = {
            tuple(e["key"]): source_from_json(e["source"]) for e in cd["sources"]
        }
        c.blend_modes = {
            tuple(e["key"]): TerrainBlendMode(e["mode"]) for e in cd["blend_modes"]
        }
        t.chunks[tuple(cd["key"])] = c
    return t


# ---------------------------------------------------------------------------
# Map
# ---------------------------------------------------------------------------


def map_to_json(m) -> dict:
    """Map -> plain-JSON dict (reference serde shape, src/map/mod.rs:53)."""
    return {
        "id": m.id,
        "name": m.name,
        "offset": _vec(m.offset),
        "grid_size": m.grid_size,
        "subdivisions": m.subdivisions,
        "vertices": [_vertex_to_json(v) for v in m.vertices],
        "linedefs": [_linedef_to_json(l) for l in m.linedefs],
        "sectors": [_sector_to_json(s) for s in m.sectors],
        "sky_texture": m.sky_texture,
        "camera": int(m.camera),
        "camera_xz": _vec(m.camera_xz) if m.camera_xz is not None else None,
        "look_at_xz": _vec(m.look_at_xz) if m.look_at_xz is not None else None,
        "lights": [light_to_json(l) for l in m.lights],
        "entities": [entity_to_json(e) for e in m.entities],
        "items": [item_to_json(i) for i in m.items],
        "selected_vertices": list(m.selected_vertices),
        "selected_linedefs": list(m.selected_linedefs),
        "selected_sectors": list(m.selected_sectors),
        "properties": vc_to_json(m.properties),
        "surfaces": {k: _surface_to_json(s) for k, s in m.surfaces.items()},
        "profiles": {k: map_to_json(p) for k, p in m.profiles.items()},
        "terrain": _terrain_to_json(m.terrain),
        "shapefx_graphs": {
            k: _graph_to_json(g) for k, g in m.shapefx_graphs.items()
        },
    }


def _graph_to_json(g) -> dict:
    """ShapeFXGraph serde (reference shapefxgraph.rs:10 serde derive) —
    required so Flatten/Colorize terrain modifiers and ShapeFXGraphId
    pixel sources survive a save/load round trip."""
    return {
        "id": g.id,
        "nodes": [
            {
                "role": int(n.role),
                "id": n.id,
                "position": _vec(n.position),
                "values": vc_to_json(n.values),
            }
            for n in g.nodes
        ],
        "connections": [list(c) for c in g.connections],
    }


def _graph_from_json(d: dict):
    from ..shapefx import ShapeFX, ShapeFXGraph, ShapeFXRole

    g = ShapeFXGraph(id=d.get("id", ""))
    for nd in d.get("nodes", []):
        node = ShapeFX(ShapeFXRole(nd.get("role", 0)))
        node.id = nd.get("id", node.id)
        node.position = tuple(nd.get("position", (0.0, 0.0)))
        node.values = vc_from_json(nd.get("values", {}))
        g.nodes.append(node)
    g.connections = [tuple(c) for c in d.get("connections", [])]
    return g


def map_from_json(d: dict):
    from .worldmap import Map, MapCamera

    m = Map(id=d.get("id", ""), name=d.get("name", ""))
    m.offset = np.asarray(d.get("offset", (0, 0)), np.float32)
    m.grid_size = d.get("grid_size", 30.0)
    m.subdivisions = d.get("subdivisions", 1.0)
    m.vertices = [_vertex_from_json(v) for v in d.get("vertices", [])]
    m.linedefs = [_linedef_from_json(l) for l in d.get("linedefs", [])]
    m.sectors = [_sector_from_json(s) for s in d.get("sectors", [])]
    m.sky_texture = d.get("sky_texture")
    m.camera = MapCamera(d.get("camera", 0))
    if d.get("camera_xz") is not None:
        m.camera_xz = np.asarray(d["camera_xz"], np.float32)
    if d.get("look_at_xz") is not None:
        m.look_at_xz = np.asarray(d["look_at_xz"], np.float32)
    m.lights = [light_from_json(l) for l in d.get("lights", [])]
    m.entities = [entity_from_json(e) for e in d.get("entities", [])]
    m.items = [item_from_json(i) for i in d.get("items", [])]
    m.selected_vertices = list(d.get("selected_vertices", []))
    m.selected_linedefs = list(d.get("selected_linedefs", []))
    m.selected_sectors = list(d.get("selected_sectors", []))
    m.properties = vc_from_json(d.get("properties", {}))
    m.surfaces = {
        k: _surface_from_json(s) for k, s in d.get("surfaces", {}).items()
    }
    m.profiles = {k: map_from_json(p) for k, p in d.get("profiles", {}).items()}
    m.terrain = _terrain_from_json(d.get("terrain", {"scale": 1.0, "chunks": []}))
    m.shapefx_graphs = {
        k: _graph_from_json(g) for k, g in d.get("shapefx_graphs", {}).items()
    }
    return m


# ---------------------------------------------------------------------------
# Entity / Item (src/server/entity.rs:10, item.rs)
# ---------------------------------------------------------------------------


def item_to_json(it) -> dict:
    return {
        "id": it.id,
        "creator_id": it.creator_id,
        "position": _vec(it.position),
        "attributes": vc_to_json(it.attributes),
        "light": light_to_json(it.light) if it.light is not None else None,
    }


def item_from_json(d: dict):
    from ..server.item import Item

    it = Item()
    it.id = d["id"]
    it.creator_id = d.get("creator_id", "")
    it.position = np.asarray(d.get("position", (0, 0, 0)), np.float32)
    it.attributes = vc_from_json(d.get("attributes", {}))
    if d.get("light") is not None:
        it.light = light_from_json(d["light"])
    return it


def entity_to_json(e) -> dict:
    return {
        "id": e.id,
        "creator_id": e.creator_id,
        "position": _vec(e.position),
        "orientation": _vec(e.orientation),
        "tilt": float(e.tilt),
        "attributes": vc_to_json(e.attributes),
        "inventory": [
            item_to_json(it) if it is not None else None for it in e.inventory
        ],
        "equipped": {k: item_to_json(it) for k, it in e.equipped.items()},
        "wallet": dict(e.wallet.balances),
    }


def entity_from_json(d: dict):
    from ..server.entity import Entity

    e = Entity()
    e.id = d["id"]
    e.creator_id = d.get("creator_id", "")
    e.position = np.asarray(d.get("position", (0, 1, 0)), np.float32)
    e.orientation = np.asarray(d.get("orientation", (1, 0)), np.float32)
    e.tilt = d.get("tilt", 0.0)
    e.attributes = vc_from_json(d.get("attributes", {}))
    e.inventory = [
        item_from_json(it) if it is not None else None
        for it in d.get("inventory", [])
    ]
    e.equipped = {k: item_from_json(it) for k, it in d.get("equipped", {}).items()}
    e.wallet.balances = dict(d.get("wallet", {}))
    return e


# ---------------------------------------------------------------------------
# File helpers
# ---------------------------------------------------------------------------


def save_map(m, path: str) -> None:
    with open(path, "w") as f:
        json.dump(map_to_json(m), f)


def load_map(path: str):
    with open(path, "r") as f:
        return map_from_json(json.load(f))

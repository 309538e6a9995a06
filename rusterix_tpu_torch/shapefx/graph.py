"""ShapeFX node graph (reference src/shapestack/shapefxgraph.rs,
src/shapestack/shapefx.rs).

Nodes carry a role + ValueContainer parameters; connections are
(node, terminal) -> (node, terminal) pairs. The renderer reads terminals 0/1
of node 0 (the Render node) as the hit/miss hook chains — procedural sky,
fog, sun direction and ambient (rasterizer.rs:227-253)."""

from __future__ import annotations

import enum
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..map.value import ValueContainer


class ShapeFXRole(enum.IntEnum):
    """reference src/shapestack/shapefx.rs:49-81."""

    MaterialGroup = 0
    Gradient = 1
    Color = 2
    Outline = 3
    NoiseOverlay = 4
    Glow = 5
    Wood = 6
    Stone = 7
    GeometryGroup = 8
    LinedefGeometry = 9
    SectorGeometry = 10
    Flatten = 11
    Colorize = 12
    RenderGroup = 13
    Render = 14
    Fog = 15
    Sky = 16
    Material = 17
    PointLight = 18
    Circle = 19
    Line = 20
    Box = 21
    UIWidget = 22
    Shape = 23  # shape-graph root (reference ShapeFXRole::Shape)


@dataclass
class ShapeFX:
    role: ShapeFXRole
    values: ValueContainer = field(default_factory=ValueContainer)
    id: str = field(default_factory=lambda: str(uuid_mod.uuid4()))
    position: Tuple[float, float] = (0.0, 0.0)
    precomputed: list = field(default_factory=list)

    def render_setup(self, hour: float):
        """Precompute per-frame node values (shapefx.rs:935-1058).

        For Sky returns (sun_dir, day_factor)."""
        from .render import fog_setup, sky_setup

        self.precomputed = []
        if self.role == ShapeFXRole.Sky:
            return sky_setup(self, hour)
        if self.role == ShapeFXRole.Fog:
            fog_setup(self)
        if self.role == ShapeFXRole.Gradient:
            # shapefx.rs:938-958
            self.precomputed.append(
                (
                    float(max(self.values.get_int_default("steps", 4), 1)),
                    float(self.values.get_int_default("blend_mode", 0)),
                    float(self.values.get_int_default("edge", 0)),
                    float(self.values.get_int_default("interior", 1)),
                )
            )
            self.precomputed.append(
                (
                    self.values.get_float_default("thickness", 1.0),
                    self.values.get_float_default("distance_offset", 0.0),
                    float(self.values.get_int_default("line_mode", 0)),
                    0.0,
                )
            )
        return None

    def render_ambient_color(self, hour: float):
        from .render import sky_ambient_color

        if self.role == ShapeFXRole.Sky:
            return sky_ambient_color(self)
        return None

    def compile_material(self):
        """shapefx.rs:1227-1245."""
        from ..models.batch import Material, MaterialModifier, MaterialRole

        if self.role != ShapeFXRole.Material:
            return None
        return Material(
            role=MaterialRole(self.values.get_int_default("role", 0)),
            modifier=MaterialModifier(self.values.get_int_default("modifier", 0)),
            value=self.values.get_float_default("value", 1.0),
            flicker=self.values.get_float_default("flicker", 0.0),
        )

    def get_palette_color(self, named: str, palette) -> tuple:
        """Palette lookup of an int-valued color property -> RGBA8
        (reference shapefx.rs:2420-2427; black when out of range)."""
        idx = self.values.get_int_default(named, 0)
        if palette is not None and 0 <= idx < len(palette):
            r, g, b = (float(c) for c in palette[idx][:3])
            return (int(r * 255 + 0.5), int(g * 255 + 0.5), int(b * 255 + 0.5), 255)
        return (0, 0, 0, 255)

    def get_dominant_color(self, palette) -> tuple:
        """reference shapefx.rs:2412-2417: Gradient nodes use their
        'interior' color, everything else 'color'."""
        named = "interior" if self.role == ShapeFXRole.Gradient else "color"
        return self.get_palette_color(named, palette)

    def compile_light(self):
        """PointLight node -> Light."""
        from ..models.light import Light, LightType

        if self.role != ShapeFXRole.PointLight:
            return None
        light = Light(LightType.Point)
        light.intensity = self.values.get_float_default("intensity", 1.0)
        light.start_distance = self.values.get_float_default("start_distance", 1.0)
        light.end_distance = self.values.get_float_default("end_distance", 5.0)
        light.flicker = self.values.get_float_default("flicker", 0.0)
        return light


@dataclass
class ShapeFXGraph:
    """Nodes + (node, terminal) -> (node, terminal) connections
    (shapefxgraph.rs:10)."""

    nodes: List[ShapeFX] = field(default_factory=list)
    connections: List[Tuple[int, int, int, int]] = field(default_factory=list)
    id: str = field(default_factory=lambda: str(uuid_mod.uuid4()))

    @staticmethod
    def default_render_graph(with_sky: bool = False, with_fog: bool = False) -> "ShapeFXGraph":
        g = ShapeFXGraph(nodes=[ShapeFX(ShapeFXRole.Render)])
        terminal = 1
        if with_sky:
            g.nodes.append(ShapeFX(ShapeFXRole.Sky))
            g.connections.append((0, 1, len(g.nodes) - 1, 0))
        if with_fog:
            g.nodes.append(ShapeFX(ShapeFXRole.Fog))
            g.connections.append((0, 0, len(g.nodes) - 1, 0))
        return g

    def find_connected_input_node(
        self, node: int, terminal: int
    ) -> Optional[Tuple[int, int]]:
        """(output node, output terminal) -> connected (input node, input
        terminal) (shapefxgraph.rs:264-275)."""
        for (sn, st, dn, dt) in self.connections:
            if sn == node and st == terminal:
                return dn, dt
        return None

    def collect_nodes_from(self, node: int, terminal: int) -> List[int]:
        """Walk connections from (node, terminal) breadth-first
        (reference graph traversal used at rasterizer.rs:227-229)."""
        out: List[int] = []
        frontier = [(node, terminal)]
        seen = set()
        while frontier:
            n, t = frontier.pop(0)
            for (sn, st, dn, dt) in self.connections:
                if sn == n and st == t and dn not in seen:
                    seen.add(dn)
                    out.append(dn)
                    # continue from the target node's output terminals
                    frontier.extend((dn, ot) for ot in range(4))
        return out

    def has_role(self, role: ShapeFXRole) -> bool:
        return any(n.role == role for n in self.nodes)

    def get_dominant_color(self, palette) -> tuple:
        """Sector-preview color (reference shapefxgraph.rs:375-381):
        the second node's dominant color, mid-gray for trivial graphs."""
        if len(self.nodes) > 1:
            return self.nodes[1].get_dominant_color(palette)
        return (128, 128, 128, 255)

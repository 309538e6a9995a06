"""Per-tile texture blending presets + material profiles + render mode.

reference: src/vertexblend.rs (15 directional presets -> 4 corner weights),
src/material_profile.rs (color-driven metallic/roughness targets),
src/rendermode.rs."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Tuple


class VertexBlendPreset(enum.IntEnum):
    """reference src/vertexblend.rs:4-140 — corner weights for blending the
    secondary tile texture: (top_left, top_right, bottom_right, bottom_left)."""

    Solid = 0
    FullBlend = 1
    Secondary = 2
    Top = 3
    Bottom = 4
    Left = 5
    Right = 6
    TopSoft = 7
    BottomSoft = 8
    LeftSoft = 9
    RightSoft = 10
    TopLeft = 11
    TopRight = 12
    BottomRight = 13
    BottomLeft = 14
    TopLeftSoft = 15
    TopRightSoft = 16
    BottomRightSoft = 17
    BottomLeftSoft = 18

    def weights(self) -> Tuple[float, float, float, float]:
        return {
            VertexBlendPreset.Solid: (0.0, 0.0, 0.0, 0.0),
            VertexBlendPreset.FullBlend: (0.5, 0.5, 0.5, 0.5),
            VertexBlendPreset.Secondary: (1.0, 1.0, 1.0, 1.0),
            VertexBlendPreset.Top: (1.0, 1.0, 0.0, 0.0),
            VertexBlendPreset.Bottom: (0.0, 0.0, 1.0, 1.0),
            VertexBlendPreset.Left: (1.0, 0.0, 0.0, 1.0),
            VertexBlendPreset.Right: (0.0, 1.0, 1.0, 0.0),
            VertexBlendPreset.TopSoft: (0.5, 0.5, 0.0, 0.0),
            VertexBlendPreset.BottomSoft: (0.0, 0.0, 0.5, 0.5),
            VertexBlendPreset.LeftSoft: (0.5, 0.0, 0.0, 0.5),
            VertexBlendPreset.RightSoft: (0.0, 0.5, 0.5, 0.0),
            VertexBlendPreset.TopLeft: (1.0, 0.0, 0.0, 0.0),
            VertexBlendPreset.TopRight: (0.0, 1.0, 0.0, 0.0),
            VertexBlendPreset.BottomRight: (0.0, 0.0, 1.0, 0.0),
            VertexBlendPreset.BottomLeft: (0.0, 0.0, 0.0, 1.0),
            VertexBlendPreset.TopLeftSoft: (0.5, 0.0, 0.0, 0.0),
            VertexBlendPreset.TopRightSoft: (0.0, 0.5, 0.0, 0.0),
            VertexBlendPreset.BottomRightSoft: (0.0, 0.0, 0.5, 0.0),
            VertexBlendPreset.BottomLeftSoft: (0.0, 0.0, 0.0, 0.5),
        }[self]

    def orient_to_world(self, surface_normal) -> "VertexBlendPreset":
        """Flip Top/Bottom variants on non-horizontal surfaces so preset
        "Top" means world-up on walls (vertexblend.rs:109-140)."""
        if abs(float(surface_normal[1])) > 0.9:
            return self
        P = VertexBlendPreset
        return {
            P.Top: P.Bottom,
            P.Bottom: P.Top,
            P.TopSoft: P.BottomSoft,
            P.BottomSoft: P.TopSoft,
            P.TopLeft: P.BottomLeft,
            P.TopRight: P.BottomRight,
            P.BottomLeft: P.TopLeft,
            P.BottomRight: P.TopRight,
            P.TopLeftSoft: P.BottomLeftSoft,
            P.TopRightSoft: P.BottomRightSoft,
            P.BottomLeftSoft: P.TopLeftSoft,
            P.BottomRightSoft: P.TopRightSoft,
        }.get(self, self)


class MaterialProfileKind(enum.IntEnum):
    """reference src/material_profile.rs:5-14."""

    Wood = 0
    Stone = 1
    Dirt = 2
    Metal = 3
    Water = 4
    Plastic = 5
    Fabric = 6
    Glass = 7

    def evaluate_target(self, color) -> Tuple[float, float]:
        """(metallic, roughness) at full effect (material_profile.rs:16-79)."""
        r, g, b = float(color[0]), float(color[1]), float(color[2])
        max_c = max(r, g, b)
        min_c = min(r, g, b)
        saturation = max_c - min_c
        brightness = 0.2126 * r + 0.7152 * g + 0.0722 * b
        if self == MaterialProfileKind.Wood:
            return 0.05 * saturation, (0.70 - 0.20 * brightness + 0.20 * (1 - saturation)) - 0.50
        if self == MaterialProfileKind.Stone:
            return 0.0, (0.80 + 0.10 * (1 - brightness)) - 0.60
        if self == MaterialProfileKind.Dirt:
            return 0.0, (0.90 + 0.30 * (1 - saturation)) - 0.70
        if self == MaterialProfileKind.Metal:
            return 0.60 + 0.40 * saturation + 0.20, (0.60 + 0.40 * (1 - brightness)) - 0.60
        if self == MaterialProfileKind.Water:
            return 0.0, 0.10 - 0.09
        if self == MaterialProfileKind.Plastic:
            return 0.0, (0.70 + 0.20 * (1 - saturation)) - 0.60
        if self == MaterialProfileKind.Fabric:
            return 0.0, (0.70 + 0.20 * (1 - brightness)) - 0.40
        return 0.0, 0.05 - 0.04  # Glass


@dataclass
class RenderMode:
    """reference src/rendermode.rs."""

    d2_active: bool = True
    d3_active: bool = True
    ignore_background_shader: bool = False

    @staticmethod
    def render_all() -> "RenderMode":
        return RenderMode(True, True, False)

    @staticmethod
    def render_2d() -> "RenderMode":
        return RenderMode(True, False, False)

    @staticmethod
    def render_3d() -> "RenderMode":
        return RenderMode(False, True, False)

    def supports2d(self) -> bool:
        return self.d2_active

    def supports3d(self) -> bool:
        return self.d3_active

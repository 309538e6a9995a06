from .graph import ShapeFX, ShapeFXGraph, ShapeFXRole
from .render import fog_apply, sky_ambient_color, sky_miss, sky_setup

__all__ = [
    "ShapeFX",
    "ShapeFXGraph",
    "ShapeFXRole",
    "fog_apply",
    "sky_ambient_color",
    "sky_miss",
    "sky_setup",
]

"""TOML class-data application for entities and items
(reference src/server/data.rs): the generic attribute table plus the
special keys — `tile_id` -> PixelSource.tile_id under "source", `color`
hex -> Color value, `animation` names -> billboard codes, and the
`[light]` table -> an attached point light."""

from __future__ import annotations

import tomllib

from ..map.value import Value, ValueKind
from ..models.batch import PixelSource
from ..models.light import Light, LightType

#: human-readable billboard animation names -> codes (data.rs:80-90;
#: 0=None 1=OpenUp 2=OpenRight 3=OpenDown 4=OpenLeft 5=Fade)
ANIMATION_CODES = {"up": 1, "right": 2, "down": 3, "left": 4, "fade": 5}


def hex_to_rgb_f32(hex_str: str):
    """#RRGGBB -> (r, g, b) in 0..1; white for invalid input
    (data.rs:147-167)."""
    h = hex_str.lstrip("#")
    if len(h) != 6:
        return (1.0, 1.0, 1.0)
    try:
        return tuple(int(h[i : i + 2], 16) / 255.0 for i in (0, 2, 4))
    except ValueError:
        return (1.0, 1.0, 1.0)


def read_light(light: Light, values: dict) -> None:
    """[light] table -> Light fields (data.rs:125-140)."""
    if isinstance(values.get("flicker"), float):
        light.flicker = float(values["flicker"])
    light.start_distance = 0.0
    if isinstance(values.get("range"), float):
        light.end_distance = float(values["range"])
    if isinstance(values.get("strength"), float):
        light.intensity = float(values["strength"])
    if isinstance(values.get("color"), str):
        import numpy as np

        light.color = np.asarray(hex_to_rgb_f32(values["color"]), np.float32)


def _parse(toml_or_dict) -> dict:
    if isinstance(toml_or_dict, dict):
        return toml_or_dict
    try:
        return tomllib.loads(toml_or_dict)
    except Exception:
        return {}


def apply_entity_data(entity, toml_or_dict) -> None:
    """data.rs:5-44 apply_entity_data."""
    data = _parse(toml_or_dict)
    for attr, v in data.items():
        if attr == "attributes" and isinstance(v, dict):
            for key, value in v.items():
                if isinstance(value, str) and key == "tile_id":
                    entity.set_attribute("source", PixelSource.tile_id(value))
                else:
                    entity.set_attribute(key, value)
        elif attr == "light" and isinstance(v, dict):
            light = Light(LightType.Point)
            read_light(light, v)
            entity.set_attribute("light", Value.light(light))


def apply_item_data(item, toml_or_dict) -> None:
    """data.rs:46-123 apply_item_data (with the item-only specials)."""
    data = _parse(toml_or_dict)
    for attr, v in data.items():
        if attr == "attributes" and isinstance(v, dict):
            for key, value in v.items():
                if isinstance(value, list):
                    item.set_attribute(
                        key,
                        Value(ValueKind.StrArray, tuple(str(x) for x in value)),
                    )
                elif isinstance(value, str):
                    if key == "tile_id":
                        item.set_attribute("source", PixelSource.tile_id(value))
                    elif key == "color":
                        item.set_attribute(
                            "color", Value(ValueKind.Color, hex_to_rgb_f32(value))
                        )
                    elif key == "animation":
                        item.set_attribute(
                            "billboard_animation",
                            ANIMATION_CODES.get(value.lower(), 0),
                        )
                    elif key == "animation_clock":
                        item.set_attribute("animation_clock", value.lower())
                    elif key == "animation_duration":
                        try:
                            item.set_attribute(
                                "animation_duration", float(value)
                            )
                        except ValueError:
                            pass
                    else:
                        item.set_attribute(key, value)
                elif key == "animation_duration":
                    item.set_attribute("animation_duration", float(value))
                else:
                    item.set_attribute(key, value)
        elif attr == "light" and isinstance(v, dict):
            light = Light(LightType.Point)
            read_light(light, v)
            item.set_attribute("light", Value.light(light))

from .color import (
    BLACK,
    TRANSPARENT,
    WHITE,
    f32_to_u8_saturated,
    hash_u32,
    linear_to_srgb_fast,
    pixel_to_vec4,
    srgb_to_linear_fast,
    vec4_to_pixel,
)
from .rect import BBox3, Rect

__all__ = [
    "BLACK",
    "TRANSPARENT",
    "WHITE",
    "f32_to_u8_saturated",
    "hash_u32",
    "linear_to_srgb_fast",
    "pixel_to_vec4",
    "srgb_to_linear_fast",
    "vec4_to_pixel",
    "BBox3",
    "Rect",
]

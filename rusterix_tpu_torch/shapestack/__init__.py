from .context import ShapeContext
from .stack import (
    ShapeStack,
    create_screen_widgets,
    evaluate_screen_widget,
    evaluate_shape_color,
    evaluate_shape_distance,
)
from .tilebuilder import (
    build_tile,
    compute_sector_overrides,
    extract_anchored_geometry,
    tile_builder,
)

__all__ = [
    "ShapeContext",
    "ShapeStack",
    "create_screen_widgets",
    "evaluate_screen_widget",
    "evaluate_shape_color",
    "evaluate_shape_distance",
    "build_tile",
    "compute_sector_overrides",
    "extract_anchored_geometry",
    "tile_builder",
]

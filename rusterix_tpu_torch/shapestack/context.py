"""Per-pixel shape evaluation context, vectorized over the whole grid
(reference src/shapestack/shapecontext.rs — one struct per pixel there; one
array per field here)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class ShapeContext:
    """All fields are full-grid arrays except the scalars px/anti_aliasing."""

    uv: np.ndarray  # (H,W,2) 0..1 inside the shape bbox
    distance: np.ndarray  # (H,W) SDF in pixels (negative inside)
    px: float  # world units per pixel
    anti_aliasing: float = 1.0
    t: Optional[np.ndarray] = None  # (H,W) param along a linedef
    line_dir: Optional[Tuple[float, float]] = None
    override_color: Optional[np.ndarray] = None  # (4,) item color override
    shape_id: int = 0

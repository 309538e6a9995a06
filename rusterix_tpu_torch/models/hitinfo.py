"""Ray hit record (reference src/tracer/mod.rs:36-77)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .batch import GeometrySource


@dataclass
class HitInfo:
    t: float = float("inf")
    uv: np.ndarray = field(default_factory=lambda: np.zeros(2, np.float32))
    triangle_index: int = 0
    normal: Optional[np.ndarray] = None
    profile_id: Optional[int] = None
    geometry_source: GeometrySource = GeometrySource.Unknown
    hitpoint: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    batch_index: int = 0
    is_2d: bool = False

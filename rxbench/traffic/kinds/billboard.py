"""A billboard: an upright `width` x `height` quad of one flat colour
(`rgba`) standing on the floor on the camera's route, culling off. It
sweeps between `ahead[0]` and `ahead[1]` units beyond the eye over
`period_frames` (from a seeded phase), `side` units to the right of the
route, spanning across it. With `opacity` it goes to the opacity list and
its alpha blends."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np

QUAD = [(0, 1, 2), (0, 2, 3)]
QUAD_UV = [(0.0, 1.0), (1.0, 1.0), (1.0, 0.0), (0.0, 0.0)]


def draw(entry: dict, rng) -> float:
    """The entry's seeded state: the phase of its sweep."""
    return float(rng.uniform(0.0, 2.0 * math.pi))


def spec(entry: dict, i: int, phase: float, camera, cfg: dict) -> dict:
    lo, hi = entry["ahead"]
    t = 0.5 + 0.5 * math.sin(2.0 * math.pi * i / entry["period_frames"] + phase)
    xz, fwd = camera.along(i, lo + (hi - lo) * t)
    right = np.array([-fwd[1], fwd[0]])
    xz = xz + right * entry["side"]
    return {"kind": "billboard", "x": float(xz[0]), "z": float(xz[1]),
            "right": [float(right[0]), float(right[1])], "width": entry["width"],
            "height": entry["height"], "rgba": entry["rgba"], "opacity": entry["opacity"]}


def corners(s: dict) -> np.ndarray:
    """(4, 3) corners, counter-clockwise seen from behind the camera."""
    x, z = s["x"], s["z"]
    rx, rz = s["right"]
    hw = s["width"] / 2.0
    h = s["height"]
    return np.array([[x - rx * hw, 0.0, z - rz * hw], [x + rx * hw, 0.0, z + rz * hw],
                     [x + rx * hw, h, z + rz * hw], [x - rx * hw, h, z - rz * hw]], np.float32)


def port(s: dict):
    """-> (list, the port's Batch3D): the scene's dynamic list it joins
    ("opaque" or "opacity")."""
    from rusterix_tpu_torch.models import Batch3D, CullMode, PixelSource

    b = (Batch3D.new([(*p, 1.0) for p in corners(s)], QUAD, QUAD_UV)
         .set_cull_mode(CullMode.Off).set_source(PixelSource.pixel(tuple(s["rgba"])))
         .with_computed_normals())
    return ("opacity" if s["opacity"] else "opaque"), b


def reference(s: dict):
    """-> (list, a batch-like record that reference/render.scene_tables
    reads)."""
    c = corners(s)
    n = np.cross(c[1] - c[0], c[2] - c[0])
    n = n / np.linalg.norm(n)
    rec = SimpleNamespace(
        vertices=np.concatenate([c, np.ones((4, 1), np.float32)], 1),
        indices=np.array(QUAD), uvs=np.array(QUAD_UV, np.float32),
        normals=np.tile(n, (4, 1)), transform_3d=np.eye(4, dtype=np.float32),
        texture=None, pixel=tuple(s["rgba"]), repeat_mode=0, receives_light=True,
        ambient_color=None, mode=0)
    return ("opacity" if s["opacity"] else "opaque"), rec

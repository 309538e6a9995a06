"""A 2D rectangle in frame pixels of one flat colour (`rgba`), `width` x
`height` at row `y`, sliding right by `speed` pixels a frame from `x0` and
wrapping at the frame's edge."""

from __future__ import annotations


def draw(entry: dict, rng):
    """The entry's seeded state: none (one draw keeps the stream's order)."""
    rng.uniform()
    return None


def spec(entry: dict, i: int, _state, _camera, cfg: dict) -> dict:
    span = max(1, cfg["width"] - entry["width"])
    x = (entry["x0"] + entry["speed"] * i) % span
    return {"kind": "rect", "x": float(x), "y": entry["y"], "width": entry["width"],
            "height": entry["height"], "rgba": entry["rgba"]}


def port(s: dict):
    """-> ("d2", the port's Batch2D)."""
    from rusterix_tpu_torch.models import Batch2D, PixelSource

    return "d2", (Batch2D.from_rectangle(s["x"], s["y"], s["width"], s["height"])
                  .set_source(PixelSource.pixel(tuple(s["rgba"]))))


def reference(s: dict):
    """-> ("d2", (x, y, width, height, rgba))."""
    return "d2", (s["x"], s["y"], s["width"], s["height"], tuple(s["rgba"]))

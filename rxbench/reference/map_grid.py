"""The procedural map of the reference's benches/rasterize_map.rs, built
for the plain reference from the configuration's sizes alone: nothing of
the port builds it.

A grid of `rooms_x` x `rooms_y` square rooms of `room_size` units. Each
room's outline is walked from its corner, +x first, turning right
(towards +z) at each corner; each side is a wall, a doorway of `doorway`
units and a wall. Every room draws its own four sides, so a wall between
two rooms is drawn twice, once from each, coplanar, with its texture
running the other way. A wall is an upright quad of `wall_height`, its
texture coordinate u running 0 to the wall's length along it and v from
1 at the floor to 0 a unit up, repeating. A point light stands at the
centre of every room whose (column + row) is a multiple of `light_every`,
and a spot and an ambient light where the configuration puts them."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from .render import AMBIENT, POINT, SPOT


def segments(cfg: dict) -> np.ndarray:
    """Every room's walls as map segments (S, 4): x0, z0, x1, z1."""
    size, door = cfg["room_size"], cfg["doorway"]
    side = (size - door) / 2.0
    out = []
    for ry in range(cfg["rooms_y"]):
        for rx in range(cfg["rooms_x"]):
            p = np.array([rx * size, ry * size], np.float64)
            d = np.array([1.0, 0.0])
            for _ in range(4):
                for length, wall in ((side, True), (door, False), (side, True)):
                    q = p + d * length
                    if wall:
                        out.append([p[0], p[1], q[0], q[1]])
                    p = q
                d = np.array([-d[1], d[0]])
    return np.asarray(out, np.float32)


def checkerboard(size: int, square: int) -> np.ndarray:
    """(size, size, 4) RGBA8: grey (128) squares where the square's column
    plus row is even, black elsewhere, opaque."""
    y, x = np.mgrid[0:size, 0:size]
    grey = ((x // square) + (y // square)) % 2 == 0
    out = np.zeros((size, size, 4), np.uint8)
    out[..., :3] = np.where(grey[..., None], 128, 0)
    out[..., 3] = 255
    return out


def wall_records(cfg: dict) -> list:
    """One batch-like record (reference/render.scene_tables) a wall."""
    tex = checkerboard(*cfg["wall_texture"])
    h = float(cfg["wall_height"])
    out = []
    for x0, z0, x1, z1 in segments(cfg).astype(np.float64):
        length = float(np.hypot(x1 - x0, z1 - z0))
        n = np.array([-(z1 - z0), 0.0, x1 - x0]) / length
        out.append(SimpleNamespace(
            vertices=np.array([[x0, 0, z0, 1], [x1, 0, z1, 1], [x1, h, z1, 1], [x0, h, z0, 1]],
                              np.float32),
            indices=np.array([(0, 1, 2), (0, 2, 3)]),
            uvs=np.array([(0.0, h), (length, h), (length, 0.0), (0.0, 0.0)], np.float32),
            normals=np.tile(n, (4, 1)), transform_3d=np.eye(4, dtype=np.float32),
            texture=tex, pixel=None, repeat_mode=1, receives_light=True,
            ambient_color=None, mode=0))
    return out


def hex_rgb(text: str) -> list:
    return [int(text[k:k + 2], 16) / 255.0 for k in (1, 3, 5)]


def light_rows(cfg: dict) -> list:
    """The map's lights as render.py's rows: the spot, the ambient light,
    then the rooms' point lights."""
    dflt = cfg["light_defaults"]

    def row(kind, pos, color, inten, start, end):
        f = np.float32
        return {"type": kind, "pos": [float(f(c)) for c in pos],
                "color": [float(f(c)) for c in color], "intensity": float(f(inten)),
                "start": float(f(start)), "end": float(f(end)),
                "dir": [float(f(c)) for c in dflt["direction"]], "cone": float(f(dflt["cone"]))}

    white = hex_rgb(dflt["color"])
    sp, am, pl = cfg["spot_light"], cfg["ambient_light"], cfg["point_light"]
    rows = [row(SPOT, sp["position"], white, sp["intensity"], dflt["start"], sp["end"]),
            row(AMBIENT, am["position"], white, am["intensity"], dflt["start"], am["end"])]
    size = cfg["room_size"]
    for ry in range(cfg["rooms_y"]):
        for rx in range(cfg["rooms_x"]):
            if (rx + ry) % cfg["light_every"] == 0:
                rows.append(row(POINT, [(rx + 0.5) * size, pl["height"], (ry + 0.5) * size],
                                hex_rgb(pl["color"]), pl["intensity"], pl["start"], pl["end"]))
    return rows

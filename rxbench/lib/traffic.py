"""The one generator of the benchmark's traffic: a mix is a data file of
parameters, rxbench/traffic/<mix>.json, and this module turns it and a
seed into each frame's camera and dynamic batches.

The mix's "camera" names its kind, and each entry of its "dynamic" list
names the kind of batch it places every frame; each kind is a module
rxbench/traffic/kinds/<kind>.py, found by name (walk.py, billboard.py,
rect.py say what their parameters mean). Everything follows from the seed
and the frame's index, never from the clock."""

from __future__ import annotations

import math

import numpy as np

from . import manifest as mf


class Traffic:
    """Frames of one traffic mix for one seed."""

    def __init__(self, mix: dict, cfg: dict, seed: int):
        self.mix, self.cfg = mix, cfg
        rng = np.random.default_rng(seed)
        self.camera = mf.kind(mix["camera"]["kind"]).Camera(mix["camera"], cfg, rng)
        self.dynamic = []
        for entry in mix["dynamic"]:
            k = mf.kind(entry["kind"])
            self.dynamic.append((entry, k, k.draw(entry, rng)))

    def frame(self, i: int) -> dict:
        """Frame i -> {"eye", "target", "dynamic": [spec of each entry]}."""
        eye, target = self.camera.pose(i)
        return {"eye": eye, "target": target,
                "dynamic": [k.spec(e, i, state, self.camera, self.cfg)
                            for e, k, state in self.dynamic]}


def look_at(eye, target) -> np.ndarray:
    """Right-handed look-at view matrix, up +y."""
    eye = np.asarray(eye, np.float32)
    f = np.asarray(target, np.float32) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.array([0.0, 1.0, 0.0], np.float32))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -np.dot(s, eye), -np.dot(u, eye), np.dot(f, eye)
    return m


def perspective(fov_deg: float, width: int, height: int, near: float, far: float):
    """Right-handed perspective with depth in [0, 1]."""
    h = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = h * height / width
    m[1, 1] = h
    m[2, 2] = far / (near - far)
    m[2, 3] = -(far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def camera(frame: dict, cfg: dict):
    """-> (view, projection) matrices of a frame at the configuration's size."""
    return (look_at(frame["eye"], frame["target"]),
            perspective(cfg["fov"], cfg["width"], cfg["height"], cfg["near"], cfg["far"]))


def dynamic_parts(specs: list, side: str) -> dict:
    """A frame's dynamic batches by the list each joins -> {"opaque",
    "opacity", "d2": [...]}: the port's batches (`side` "port") or the
    reference's records ("reference")."""
    out = {"opaque": [], "opacity": [], "d2": []}
    for s in specs:
        where, item = getattr(mf.kind(s["kind"]), side)(s)
        out[where].append(item)
    return out

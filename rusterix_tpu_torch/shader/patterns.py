"""Procedural pattern bank for `sample(uv, "<pattern>")`.

The reference ships precomputed tileable pattern textures (value/fbm_value/
perlin/fbm_perlin/bricks/tiles/blocks — rusteria/src/textures/patterns.rs)
and samples them nearest-with-wrap (textures/mod.rs:127-146). We generate
equivalent tileable textures procedurally at import time (numpy, 256x256) —
capability parity; the exact noise realizations differ from the reference's
embedded PNGs by design (no asset copying).
"""

from __future__ import annotations

import numpy as np

SIZE = 256

PATTERN_NAMES = {
    "value": 0,
    "fbm_value": 1,
    "perlin": 2,
    "fbm_perlin": 3,
    "bricks": 4,
    "tiles": 5,
    "blocks": 6,
}


def _hash2(ix, iy, seed=0):
    h = (ix.astype(np.int64) * 374761393 + iy.astype(np.int64) * 668265263 + seed * 144665) & 0xFFFFFFFF
    h = (h ^ (h >> 13)) * 1274126177 & 0xFFFFFFFF
    h = h ^ (h >> 16)
    return (h & 0xFFFFFF).astype(np.float64) / float(0xFFFFFF)


def _value_noise(n, freq, seed=0):
    """Tileable value noise on an n x n grid with `freq` lattice cells."""
    ys, xs = np.mgrid[0:n, 0:n].astype(np.float64) / n * freq
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    fx = xs - x0
    fy = ys - y0
    ux = fx * fx * (3 - 2 * fx)
    uy = fy * fy * (3 - 2 * fy)

    def at(dx, dy):
        return _hash2((x0 + dx) % freq, (y0 + dy) % freq, seed)

    a = at(0, 0)
    b = at(1, 0)
    c = at(0, 1)
    d = at(1, 1)
    return (a * (1 - ux) + b * ux) * (1 - uy) + (c * (1 - ux) + d * ux) * uy


def _perlin_noise(n, freq, seed=0):
    """Tileable gradient (Perlin) noise in [0,1]."""
    ys, xs = np.mgrid[0:n, 0:n].astype(np.float64) / n * freq
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    fx = xs - x0
    fy = ys - y0

    def grad_dot(dx, dy):
        ang = _hash2((x0 + dx) % freq, (y0 + dy) % freq, seed) * 2 * np.pi
        gx, gy = np.cos(ang), np.sin(ang)
        return gx * (fx - dx) + gy * (fy - dy)

    ux = fx * fx * fx * (fx * (fx * 6 - 15) + 10)
    uy = fy * fy * fy * (fy * (fy * 6 - 15) + 10)
    n00 = grad_dot(0, 0)
    n10 = grad_dot(1, 0)
    n01 = grad_dot(0, 1)
    n11 = grad_dot(1, 1)
    v = (n00 * (1 - ux) + n10 * ux) * (1 - uy) + (n01 * (1 - ux) + n11 * ux) * uy
    return np.clip(v * 0.7071 + 0.5, 0.0, 1.0)


def _fbm(base_fn, n, octaves=5, seed=0):
    out = np.zeros((n, n))
    amp = 0.5
    freq = 4
    total = 0.0
    for o in range(octaves):
        out += amp * base_fn(n, freq, seed + o)
        total += amp
        amp *= 0.5
        freq *= 2
    return out / total


def _bricks(n):
    ys, xs = np.mgrid[0:n, 0:n].astype(np.float64) / n
    rows = 6.0
    cols = 3.0
    y = ys * rows
    row = np.floor(y)
    x = xs * cols + np.where(row % 2 == 0, 0.0, 0.5)
    fx = x - np.floor(x)
    fy = y - np.floor(y)
    mortar = 0.06
    brick = (
        (fx > mortar) & (fx < 1 - mortar) & (fy > mortar * cols / rows * 2) & (fy < 1 - mortar * cols / rows * 2)
    )
    tone = _value_noise(n, 12, seed=7) * 0.25
    return np.where(brick, 0.65 + tone, 0.25)


def _tiles(n):
    ys, xs = np.mgrid[0:n, 0:n].astype(np.float64) / n
    k = 4.0
    fx = xs * k - np.floor(xs * k)
    fy = ys * k - np.floor(ys * k)
    d = np.minimum(np.minimum(fx, 1 - fx), np.minimum(fy, 1 - fy))
    edge = np.clip(d / 0.06, 0.0, 1.0)
    tone = _value_noise(n, 8, seed=3) * 0.15
    return 0.25 + 0.55 * edge + tone


def _blocks(n):
    v = _value_noise(n, 8, seed=11)
    return np.floor(v * 5.0) / 4.0


_bank = None


def pattern_bank() -> np.ndarray:
    """(7, SIZE, SIZE) float32 pattern textures in [0,1]."""
    global _bank
    if _bank is None:
        n = SIZE
        _bank = np.stack(
            [
                _value_noise(n, 8, seed=1),
                _fbm(_value_noise, n, seed=2),
                _perlin_noise(n, 8, seed=4),
                _fbm(_perlin_noise, n, seed=5),
                _bricks(n),
                _tiles(n),
                _blocks(n),
            ]
        ).astype(np.float32)
    return _bank


def sample_pattern_jnp(bank, index, u, v):
    """Nearest-with-wrap sample (reference textures/mod.rs:127-146), in
    torch (the JAX package's function of the same name).

    bank: (7, SIZE, SIZE) f32 tensor; index: int tensor or scalar; u, v
    f32 tensors. Returns a value tensor broadcast like u (single channel
    in [0,1])."""
    import torch

    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    x = torch.remainder(torch.floor(uu * SIZE).to(torch.int32), SIZE)
    y = torch.remainder(torch.floor(vv * SIZE).to(torch.int32), SIZE)
    flat = bank.reshape(-1)
    idx = index * (SIZE * SIZE) + y * SIZE + x
    return flat[idx.long()]

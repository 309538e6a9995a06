"""Screen (background) shaders.

reference: src/shader/mod.rs (Shader trait), src/shader/vgradient.rs,
src/shader/grid.rs. Each shader implements `shade_grid`, a vectorized
whole-screen evaluation (jnp or numpy) returning (H, W, 4) uint8 — the
TPU-native replacement for the per-pixel `shade_pixel` loop
(src/rasterizer.rs:292-308).
"""

from __future__ import annotations

import numpy as np


class Shader:
    """Base screen shader."""

    def set_parameter_f32(self, key: str, value: float) -> None:
        pass

    def set_parameter_vec2(self, key: str, value) -> None:
        pass

    def shade_pixel(self, uv, screen):
        """Scalar host evaluation (tests/oracle)."""
        xp = np
        u = np.array([[uv[0]]], np.float32)
        v = np.array([[uv[1]]], np.float32)
        out = self.shade_grid_xy(u, v, screen, xp)
        return tuple(int(c) for c in np.asarray(out)[0, 0])

    def shade_grid_xy(self, u, v, screen, xp):
        """Vectorized evaluation over uv grids; xp is numpy or jax.numpy."""
        raise NotImplementedError

    def shade_grid(self, width: int, height: int, xp=np):
        """Full-screen bake. uv convention matches the reference:
        uv = (tile.x+tx)/width (pixel corner, src/rasterizer.rs:295-300)."""
        ys = xp.arange(height, dtype=xp.float32)[:, None] / xp.float32(height)
        xs = xp.arange(width, dtype=xp.float32)[None, :] / xp.float32(width)
        u = xp.broadcast_to(xs, (height, width))
        v = xp.broadcast_to(ys, (height, width))
        return self.shade_grid_xy(u, v, (float(width), float(height)), xp)


class VGrayGradientShader(Shader):
    """Vertical gray gradient (reference src/shader/vgradient.rs:11-15)."""

    def shade_grid_xy(self, u, v, screen, xp):
        intensity = xp.clip(v * 128.0, 0.0, 128.0).astype(xp.uint8)
        out = xp.stack(
            [intensity, intensity, intensity, xp.full_like(intensity, 255)],
            axis=-1,
        )
        return out


class GridShader(Shader):
    """Editor background grid (reference src/shader/grid.rs)."""

    def __init__(self):
        self.grid_size = 30.0
        self.subdivisions = 2.0
        self.offset = np.zeros(2, np.float32)

    def set_parameter_f32(self, key: str, value: float) -> None:
        if key == "grid_size":
            self.grid_size = value
        elif key == "subdivisions":
            self.subdivisions = value

    def set_parameter_vec2(self, key: str, value) -> None:
        if key == "offset":
            self.offset = np.asarray(value, np.float32)

    def shade_grid_xy(self, u, v, screen, xp):
        sw, sh = screen
        px = u * sw
        py = v * sh

        ox = sw / 2.0 + float(self.offset[0])
        oy = sh / 2.0 + float(self.offset[1])
        # align_pixel for odd thickness: round(p - 0.5) + 0.5
        ox = np.round(ox - 0.5) + 0.5
        oy = np.round(oy - 0.5) + 0.5

        gs = self.grid_size
        sub = max(1.0, round(self.subdivisions))

        rel_x = px - ox
        rel_y = py - oy

        def mul_dist(delta, value):
            return xp.abs(value - delta * xp.round(value / delta))

        dist_x = mul_dist(gs, rel_x)
        dist_y = mul_dist(gs, rel_y)
        is_line = xp.minimum(dist_x, dist_y) <= 0.5

        dtf_x = xp.abs(rel_x - gs * xp.floor(rel_x / gs))
        dtf_y = xp.abs(rel_y - gs * xp.floor(rel_y / gs))
        sub_size = gs / sub
        sub_x = mul_dist(sub_size, dtf_x)
        sub_y = mul_dist(sub_size, dtf_y)
        rc_x = xp.round(dist_x / sub_size)
        rc_y = xp.round(dist_y / sub_size)
        extra = gs - sub_size * sub
        sub_x = xp.where(rc_x == sub, sub_x + extra, sub_x)
        sub_y = xp.where(rc_y == sub, sub_y + extra, sub_y)
        is_subline = xp.minimum(sub_x, sub_y) <= 0.5

        bg = 0.05
        line = 0.15
        subline = 0.11
        val = xp.where(is_line, line, xp.where(is_subline, subline, bg))
        c = (xp.clip(val, 0.0, 1.0) * 255.0 + 0.5).astype(xp.uint8)
        a = xp.full_like(c, 255)
        return xp.stack([c, c, c, a], axis=-1)


class SolidColorShader(Shader):
    def __init__(self, rgba):
        self.rgba = tuple(int(c) for c in rgba)

    def shade_grid_xy(self, u, v, screen, xp):
        h, w = u.shape
        out = xp.zeros((h, w, 4), xp.uint8)
        for i, c in enumerate(self.rgba):
            out = out.at[..., i].set(c) if hasattr(out, "at") else out
        if not hasattr(out, "at"):
            out[..., :] = np.asarray(self.rgba, np.uint8)
        return out

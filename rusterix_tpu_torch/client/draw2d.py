"""Draw2D — software 2D blit/shape/text primitives on RGBA8 numpy buffers
(reference src/client/draw2d.rs:42-1395, ~40 primitives).

Used by the client for UI/screen composition (game widgets, messages, text);
all operations are vectorized numpy — the buffers are host-side frames or
widget surfaces that then upload as overlay textures.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _clip_rect(buf, x, y, w, h):
    bh, bw = buf.shape[:2]
    x0 = max(0, int(x))
    y0 = max(0, int(y))
    x1 = min(bw, int(x + w))
    y1 = min(bh, int(y + h))
    return x0, y0, x1, y1


class Draw2D:
    """All methods mutate `buf`: (H, W, 4) uint8."""

    def rect(self, buf, x, y, w, h, color) -> None:
        x0, y0, x1, y1 = _clip_rect(buf, x, y, w, h)
        if x1 > x0 and y1 > y0:
            buf[y0:y1, x0:x1] = np.asarray(color, np.uint8)

    def rect_outline(self, buf, x, y, w, h, color, thickness: int = 1) -> None:
        t = thickness
        self.rect(buf, x, y, w, t, color)
        self.rect(buf, x, y + h - t, w, t, color)
        self.rect(buf, x, y, t, h, color)
        self.rect(buf, x + w - t, y, t, h, color)

    def blend_rect(self, buf, x, y, w, h, color) -> None:
        """src-over with the rect color's alpha."""
        x0, y0, x1, y1 = _clip_rect(buf, x, y, w, h)
        if x1 <= x0 or y1 <= y0:
            return
        c = np.asarray(color, np.float32)
        a = c[3] / 255.0
        dst = buf[y0:y1, x0:x1].astype(np.float32)
        dst[..., :3] = c[:3] * a + dst[..., :3] * (1 - a)
        buf[y0:y1, x0:x1] = dst.astype(np.uint8)

    def hline(self, buf, x, y, length, color) -> None:
        self.rect(buf, x, y, length, 1, color)

    def vline(self, buf, x, y, length, color) -> None:
        self.rect(buf, x, y, 1, length, color)

    def line(self, buf, x0, y0, x1, y1, color) -> None:
        """Bresenham (draw2d line primitive)."""
        x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
        dx = abs(x1 - x0)
        dy = abs(y1 - y0)
        sx = 1 if x0 < x1 else -1
        sy = 1 if y0 < y1 else -1
        err = dx - dy
        h, w = buf.shape[:2]
        x, y = x0, y0
        while True:
            if 0 <= x < w and 0 <= y < h:
                buf[y, x] = np.asarray(color, np.uint8)
            if x == x1 and y == y1:
                break
            e2 = err * 2
            if e2 > -dy:
                err -= dy
                x += sx
            if e2 < dx:
                err += dx
                y += sy

    def circle(self, buf, cx, cy, radius, color, thickness: float = 1.0) -> None:
        x0, y0, x1, y1 = _clip_rect(buf, cx - radius - 1, cy - radius - 1, 2 * radius + 2, 2 * radius + 2)
        if x1 <= x0 or y1 <= y0:
            return
        ys, xs = np.mgrid[y0:y1, x0:x1]
        d = np.sqrt((xs - cx) ** 2 + (ys - cy) ** 2)
        mask = (d <= radius) & (d >= radius - thickness)
        buf[y0:y1, x0:x1][mask] = np.asarray(color, np.uint8)

    def disc(self, buf, cx, cy, radius, color) -> None:
        x0, y0, x1, y1 = _clip_rect(buf, cx - radius - 1, cy - radius - 1, 2 * radius + 2, 2 * radius + 2)
        if x1 <= x0 or y1 <= y0:
            return
        ys, xs = np.mgrid[y0:y1, x0:x1]
        mask = (xs - cx) ** 2 + (ys - cy) ** 2 <= radius * radius
        buf[y0:y1, x0:x1][mask] = np.asarray(color, np.uint8)

    def blit(self, buf, src, x, y) -> None:
        """Copy src (h, w, 4) at (x, y), clipped, alpha-ignored."""
        sh, sw = src.shape[:2]
        x0, y0, x1, y1 = _clip_rect(buf, x, y, sw, sh)
        if x1 <= x0 or y1 <= y0:
            return
        buf[y0:y1, x0:x1] = src[y0 - int(y) : y1 - int(y), x0 - int(x) : x1 - int(x)]

    def blend_blit(self, buf, src, x, y) -> None:
        """src-over alpha blit."""
        sh, sw = src.shape[:2]
        x0, y0, x1, y1 = _clip_rect(buf, x, y, sw, sh)
        if x1 <= x0 or y1 <= y0:
            return
        s = src[y0 - int(y) : y1 - int(y), x0 - int(x) : x1 - int(x)].astype(np.float32)
        d = buf[y0:y1, x0:x1].astype(np.float32)
        a = s[..., 3:4] / 255.0
        d[..., :3] = s[..., :3] * a + d[..., :3] * (1 - a)
        d[..., 3] = np.maximum(d[..., 3], s[..., 3])
        buf[y0:y1, x0:x1] = d.astype(np.uint8)

    def blit_scaled(self, buf, src, x, y, w, h) -> None:
        """Nearest-neighbor scaled blit (upscale path, client/mod.rs)."""
        sh, sw = src.shape[:2]
        if w <= 0 or h <= 0:
            return
        ys = (np.arange(h) * sh // h).clip(0, sh - 1)
        xs = (np.arange(w) * sw // w).clip(0, sw - 1)
        scaled = src[np.ix_(ys, xs)]
        self.blit(buf, scaled, x, y)

    # -- text --

    _font_cache = {}

    #: system fallback when no game font is supplied (the reference's text
    #: fns always receive a `&Font`; its editor populates Assets.fonts)
    DEFAULT_FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"

    def _font(self, size: int, font=None):
        """Resolve a font for `size`. `font` is a .ttf/.otf path (e.g. from
        `Assets.fonts[name]`, mirroring draw2d.rs:617+ `&Font` params) or
        None for the system default."""
        from PIL import ImageFont

        path = font if isinstance(font, str) else self.DEFAULT_FONT
        f = self._font_cache.get((path, size))
        if f is None:
            try:
                f = ImageFont.truetype(path, size)
            except OSError:
                try:
                    f = ImageFont.truetype(self.DEFAULT_FONT, size)
                except OSError:
                    f = ImageFont.load_default()
            self._font_cache[(path, size)] = f
        return f

    def text_size(self, text: str, size: int = 12, font=None) -> Tuple[int, int]:
        from PIL import Image, ImageDraw

        img = Image.new("RGBA", (1, 1))
        d = ImageDraw.Draw(img)
        box = d.textbbox((0, 0), text, font=self._font(size, font))
        return box[2] - box[0], box[3] - box[1]

    def text(self, buf, x, y, text: str, color, size: int = 12, font=None) -> None:
        from PIL import Image, ImageDraw

        if not text:
            return
        w, h = self.text_size(text, size, font)
        if w <= 0 or h <= 0:
            return
        img = Image.new("RGBA", (w + 2, h + size // 2 + 2), (0, 0, 0, 0))
        d = ImageDraw.Draw(img)
        d.text(
            (0, 0), text, font=self._font(size, font),
            fill=tuple(int(c) for c in color),
        )
        self.blend_blit(buf, np.asarray(img, np.uint8), x, y)

    def text_centered(
        self, buf, rect, text: str, color, size: int = 12, font=None
    ) -> None:
        x, y, w, h = rect
        tw, th = self.text_size(text, size, font)
        self.text(buf, x + (w - tw) // 2, y + (h - th) // 2, text, color, size, font)

    # -- SDF shape primitives (reference draw2d.rs:337-586) --

    @staticmethod
    def mix_color(a, b, v: float):
        """Lerp two RGBA8 colors (draw2d.rs:1385-1392)."""
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        return ((1.0 - v) * a + b * v).astype(np.uint8)

    @staticmethod
    def length(p) -> float:
        return float(np.hypot(p[0], p[1]))

    @staticmethod
    def _smoothstep(e0: float, e1: float, x):
        t = np.clip((x - e0) / (e1 - e0), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    def _sdf_paint(self, buf, x, y, w, h, d, color, border_color=None,
                   border_size: float = 0.0, alpha_scale=None) -> None:
        """Composite an SDF field over the rect region: fill_mask (-d clamped)
        mixes `color`, border_mask adds `border_color`
        (draw2d.rs:1369-1376)."""
        x0, y0, x1, y1 = _clip_rect(buf, x, y, w, h)
        if x1 <= x0 or y1 <= y0:
            return
        d = d[y0 - int(y) : y1 - int(y), x0 - int(x) : x1 - int(x)]
        t = np.clip(-d, 0.0, 1.0)
        if alpha_scale is not None:
            t = t * alpha_scale
        dst = buf[y0:y1, x0:x1].astype(np.float32)
        c = np.asarray(color, np.float32)
        mixed = dst * (1.0 - t[..., None]) + c * t[..., None]
        if border_color is not None and border_size > 0.0:
            b = np.clip(d + border_size, 0.0, 1.0) - np.clip(d, 0.0, 1.0)
            bc = np.asarray(border_color, np.float32)
            mixed = mixed * (1.0 - b[..., None]) + bc * b[..., None]
        sel = d < 1.0
        out = buf[y0:y1, x0:x1].copy()
        out[sel] = mixed.astype(np.uint8)[sel]
        buf[y0:y1, x0:x1] = out

    def _rect_grid(self, x, y, w, h):
        ys, xs = np.mgrid[0 : int(h), 0 : int(w)].astype(np.float32)
        return xs + int(x), ys + int(y)

    def _rounded_rect_sdf(self, x, y, w, h, rounding):
        """Per-corner rounded-rect SDF (draw2d.rs:374-410)."""
        cx = round(x + w / 2.0)
        cy = round(y + h / 2.0)
        xs, ys = self._rect_grid(x, y, w, h)
        px = xs - cx
        py = ys - cy
        r0 = np.where(px > 0.0, rounding[0], rounding[2])
        r1 = np.where(px > 0.0, rounding[1], rounding[3])
        r = np.where(py <= 0.0, r1, r0)
        qx = np.abs(px) - w / 2.0 + r
        qy = np.abs(py) - h / 2.0 + r
        return (
            np.minimum(np.maximum(qx, qy), 0.0)
            + np.hypot(np.maximum(qx, 0.0), np.maximum(qy, 0.0))
            - r
        )

    def rounded_rect(self, buf, x, y, w, h, color, rounding) -> None:
        """rounding = (top-right, bottom-right, top-left, bottom-left)."""
        d = self._rounded_rect_sdf(x, y, w, h, rounding)
        a = np.asarray(color, np.float32)[3] / 255.0
        self._sdf_paint(buf, x, y, w, h, d, color, alpha_scale=a)

    def rounded_rect_with_border(
        self, buf, x, y, w, h, color, rounding, border_color, border_size: float
    ) -> None:
        d = self._rounded_rect_sdf(x, y, w, h, rounding)
        a = np.asarray(color, np.float32)[3] / 255.0
        self._sdf_paint(buf, x, y, w, h, d, color, border_color, border_size,
                        alpha_scale=a)

    def circle_with_border(
        self, buf, x, y, w, h, color, radius, border_color, border_size: float
    ) -> None:
        """draw2d.rs:337-371."""
        cx = x + w / 2.0
        cy = y + h / 2.0
        xs, ys = self._rect_grid(x, y, w, h)
        d = np.hypot(xs - cx, ys - cy) - radius
        self._sdf_paint(buf, x, y, w, h, d, color, border_color, border_size)

    def hexagon_with_border(
        self, buf, x, y, w, h, color, border_color, border_size: float
    ) -> None:
        """draw2d.rs:484-528 (pointy-top hexagon SDF)."""
        hb = border_size / 2.0
        cx = round(x + w / 2.0 - hb)
        cy = round(y + h / 2.0 - hb)
        xs, ys = self._rect_grid(x, y, w, h)
        px = np.abs(xs - cx)
        py = np.abs(ys - cy)
        r = w / 2.33
        kx, ky, kz = -0.8660254, 0.5, 0.57735026
        dot = np.minimum(kx * px + ky * py, 0.0)
        px = px - 2.0 * kx * dot
        py = py - 2.0 * ky * dot
        # canonical hexagon SDF. The reference's body (draw2d.rs:507-509)
        # clamps the whole reflected vector and signs by the clamped |y| —
        # which is never negative, so ported literally it fills nothing;
        # this is the formula it was clearly transcribing.
        d = np.hypot(px - np.clip(px, -kz * r, kz * r), py - r) * np.sign(py - r)
        alpha = np.asarray(color, np.float32)[3] / 255.0
        self._sdf_paint(buf, x, y, w, h, d, color, border_color, border_size,
                        alpha_scale=alpha)

    def rhombus_with_border(
        self, buf, x, y, w, h, color, border_color, border_size: float
    ) -> None:
        """draw2d.rs:530-586 (diamond SDF from the rect half-extents)."""
        cx = x + w / 2.0
        cy = y + h / 2.0
        xs, ys = self._rect_grid(x, y, w, h)
        px = np.abs(xs - cx)
        py = np.abs(ys - cy)
        bx = w / 2.0
        by = h / 2.0
        # ndot(b, b - 2p) / length(b), clamped param form of the rhombus SDF
        f = np.clip(
            (bx * (bx - 2.0 * px) - by * (by - 2.0 * py)) / (bx * bx + by * by),
            -1.0,
            1.0,
        )
        d = np.hypot(px - 0.5 * bx * (1.0 - f), py - 0.5 * by * (1.0 + f))
        d = d * np.sign(px * by + py * bx - bx * by)
        a = np.asarray(color, np.float32)[3] / 255.0
        self._sdf_paint(buf, x, y, w, h, d, color, border_color, border_size,
                        alpha_scale=a)

    def square_pattern(self, buf, x, y, w, h, color, line_color,
                       pattern_size: int) -> None:
        """Grid-line fill (draw2d.rs:588-608)."""
        x0, y0, x1, y1 = _clip_rect(buf, x, y, w, h)
        if x1 <= x0 or y1 <= y0:
            return
        ys, xs = np.mgrid[y0:y1, x0:x1]
        on_line = (xs % pattern_size == 0) | (ys % pattern_size == 0)
        region = buf[y0:y1, x0:x1]
        region[...] = np.where(
            on_line[..., None],
            np.asarray(line_color, np.uint8),
            np.asarray(color, np.uint8),
        )

    # -- rect/outline aliases matching the reference names --

    def rect_safe(self, buf, x, y, w, h, color) -> None:
        self.rect(buf, x, y, w, h, color)  # rect() already clips

    def blend_rect_safe(self, buf, x, y, w, h, color) -> None:
        self.blend_rect(buf, x, y, w, h, color)

    def rect_outline_thickness(self, buf, x, y, w, h, color, thickness) -> None:
        self.rect_outline(buf, x, y, w, h, color, thickness)

    def rect_outline_border(self, buf, x, y, w, h, color, border: int) -> None:
        """Outline inset by `border` px (draw2d.rs rect_outline_border)."""
        self.rect_outline(
            buf, x + border, y + border, w - 2 * border, h - 2 * border, color
        )

    def rect_outline_border_safe(self, buf, x, y, w, h, color, border: int) -> None:
        self.rect_outline_border(buf, x, y, w, h, color, border)

    # -- slice/chunk blits (the reference's blit family) --

    def copy_slice(self, buf, src, x, y) -> None:
        self.blit(buf, src, x, y)

    def blend_slice(self, buf, src, x, y) -> None:
        self.blend_blit(buf, src, x, y)

    def blend_slice_safe(self, buf, src, x, y) -> None:
        self.blend_blit(buf, src, x, y)  # blend_blit already clips

    def blend_slice_alpha(self, buf, src, x, y, alpha: float) -> None:
        """src-over with a whole-slice alpha multiplier."""
        s = src.astype(np.float32).copy()
        s[..., 3] *= alpha
        self.blend_blit(buf, s.astype(np.uint8), x, y)

    def blend_slice_f32(self, buf, src_f32, x, y) -> None:
        """src in f32 0..1 -> src-over blit."""
        self.blend_blit(
            buf, np.clip(src_f32 * 255.0 + 0.5, 0, 255).astype(np.uint8), x, y
        )

    def blend_slice_offset(self, buf, src, x, y, off_x: int, off_y: int,
                           w: int, h: int) -> None:
        """Blend a (off_x, off_y, w, h) sub-rect of src at (x, y)."""
        self.blend_blit(buf, src[off_y : off_y + h, off_x : off_x + w], x, y)

    def scale_chunk(self, buf, src, x, y, w, h) -> None:
        self.blit_scaled(buf, src, x, y, w, h)

    def _scaled(self, src, w, h, linear: bool = False) -> np.ndarray:
        sh, sw = src.shape[:2]
        if not linear:
            ys = (np.arange(h) * sh // h).clip(0, sh - 1)
            xs = (np.arange(w) * sw // w).clip(0, sw - 1)
            return src[np.ix_(ys, xs)]
        fy = (np.arange(h) + 0.5) * sh / h - 0.5
        fx = (np.arange(w) + 0.5) * sw / w - 0.5
        y0 = np.clip(np.floor(fy).astype(int), 0, sh - 1)
        x0 = np.clip(np.floor(fx).astype(int), 0, sw - 1)
        y1 = np.clip(y0 + 1, 0, sh - 1)
        x1 = np.clip(x0 + 1, 0, sw - 1)
        wy = (fy - y0)[:, None, None]
        wx = (fx - x0)[None, :, None]
        s = src.astype(np.float32)
        top = s[np.ix_(y0, x0)] * (1 - wx) + s[np.ix_(y0, x1)] * wx
        bot = s[np.ix_(y1, x0)] * (1 - wx) + s[np.ix_(y1, x1)] * wx
        return (top * (1 - wy) + bot * wy + 0.5).astype(np.uint8)

    def blend_scale_chunk(self, buf, src, x, y, w, h) -> None:
        self.blend_blit(buf, self._scaled(src, w, h), x, y)

    def blend_scale_chunk_alpha(self, buf, src, x, y, w, h, alpha: float) -> None:
        self.blend_slice_alpha(buf, self._scaled(src, w, h), x, y, alpha)

    def blend_scale_chunk_linear(self, buf, src, x, y, w, h) -> None:
        self.blend_blit(buf, self._scaled(src, w, h, linear=True), x, y)

    def blend_mask(self, buf, x, y, mask, color) -> None:
        """Paint `color` using a (h, w) u8 coverage mask as alpha — the
        glyph-composite primitive (draw2d.rs:42-80)."""
        mh, mw = mask.shape[:2]
        rgba = np.empty((mh, mw, 4), np.uint8)
        rgba[..., :3] = np.asarray(color, np.uint8)[:3]
        rgba[..., 3] = (
            mask.astype(np.float32) * (np.asarray(color, np.float32)[3] / 255.0)
        ).astype(np.uint8)
        self.blend_blit(buf, rgba, x, y)

    # -- aligned text in a rect (draw2d.rs:611-1360 text_rect family) --

    def get_text_size(self, text: str, size: int = 12) -> Tuple[int, int]:
        return self.text_size(text, size)

    def get_text_layout(self, text: str, size: int = 12):
        """Per-character x offsets + total size (fontdue layout analogue)."""
        xs = []
        acc = 0
        for i in range(len(text)):
            xs.append(acc)
            acc = self.text_size(text[: i + 1], size)[0]
        w, h = self.text_size(text, size)
        return xs, (w, h)

    def _text_rect_impl(self, buf, rect, text, color, size, halign, valign,
                        background=None, clip=False) -> None:
        """Aligned, '...'-truncated text in a rect (draw2d.rs:611-700)."""
        x, y, w, h = (int(v) for v in rect)
        txt = text.rstrip().replace("\n", "")
        if not txt:
            return
        tw, th = self.text_size(txt, size)
        add_trail = False
        while txt and tw >= w:
            txt = txt[:-1]
            tw, th = self.text_size(txt + "...", size)
            add_trail = True
        if add_trail:
            txt += "..."
        if background is not None:
            self.rect(buf, x, y, w, h, background)
        tx = {
            "left": x,
            "center": x + (w - tw) // 2,
            "right": x + w - tw,
        }.get(halign, x + (w - tw) // 2)
        ty = {
            "top": y,
            "center": y + (h - th) // 2,
            "bottom": y + h - th,
        }.get(valign, y + (h - th) // 2)
        if clip:
            sub = buf[y : y + h, x : x + w]
            tmp = sub.copy()
            self.text(tmp, tx - x, ty - y, txt, color, size)
            sub[...] = tmp
        else:
            self.text(buf, tx, ty, txt, color, size)

    def text_rect(self, buf, rect, text, color, size=12, halign="center",
                  valign="center", background=None) -> None:
        self._text_rect_impl(buf, rect, text, color, size, halign, valign,
                             background)

    def text_rect_clip(self, buf, rect, text, color, size=12, halign="center",
                       valign="center") -> None:
        self._text_rect_impl(buf, rect, text, color, size, halign, valign,
                             clip=True)

    def text_rect_blend(self, buf, rect, text, color, size=12, halign="center",
                        valign="center") -> None:
        self._text_rect_impl(buf, rect, text, color, size, halign, valign)

    def text_rect_blend_safe(self, buf, rect, text, color, size=12,
                             halign="center", valign="center") -> None:
        self._text_rect_impl(buf, rect, text, color, size, halign, valign)

    def text_rect_blend_clip(self, buf, rect, text, color, size=12,
                             halign="center", valign="center") -> None:
        self._text_rect_impl(buf, rect, text, color, size, halign, valign,
                             clip=True)

    def text_blend(self, buf, x, y, text, color, size: int = 12) -> None:
        self.text(buf, x, y, text, color, size)

"""Textures, animated tiles, and the device texture atlas.

TPU-first re-design of the reference's `Texture`/`Tile`
(reference: src/texture.rs; src/map/tile.rs). Host-side a texture is a numpy
(H, W, 4) uint8 array plus optional packed material/normal `data_ext`
(format documented at src/texture.rs:27-44). For rendering, every texture the
scene can reference is packed into **one atlas array** on the host
(`TextureAtlas.build`); the device shading pass samples the atlas with
vectorized gathers instead of the reference's per-pixel `Texture::sample`
virtual dispatch (src/texture.rs:203-232).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .batch import RepeatMode, SampleMode


class TileRole(enum.IntEnum):
    """reference src/map/tile.rs:6-80 (10 editor roles, reference order —
    serialized role indices depend on it; default is ManMade)."""

    Character = 0
    Nature = 1
    Mountain = 2
    Road = 3
    Water = 4
    ManMade = 5
    Dungeon = 6
    Effect = 7
    Icon = 8
    UI = 9

    def to_color(self):
        """Role hex colors (tile.rs:21-33) as RGBA8."""
        hexes = [
            "d9ac8b", "3e6958", "b1a58d", "624c3c", "243d5c",
            "e0c872", "b03a48", "d4804d", "5c8b93", "e3cfb4",
        ]
        h = hexes[int(self)]
        return (int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16), 255)

    # legacy alias
    color = to_color

    def to_string(self) -> str:
        """Display names (tile.rs:36-48)."""
        return "Man Made" if self == TileRole.ManMade else self.name

    @staticmethod
    def from_index(index: int) -> "TileRole":
        """tile.rs:65-78 (out of range -> ManMade, the default)."""
        try:
            return TileRole(index)
        except ValueError:
            return TileRole.ManMade

    @staticmethod
    def iterator():
        return iter(TileRole)


class Texture:
    """RGBA8 texture (+ optional packed material/normal data_ext).

    reference: src/texture.rs:46-199 (constructors) and :203-553 (sampling).
    """

    def __init__(self, data: np.ndarray, data_ext: Optional[np.ndarray] = None):
        data = np.asarray(data, np.uint8)
        assert data.ndim == 3 and data.shape[2] == 4, "texture must be (H, W, 4) u8"
        self.data = data
        self.data_ext = data_ext  # (H, W, 4) u8: [mat_lo, mat_hi, nx, ny]

    # -- constructors --

    @staticmethod
    def new(data, width: int, height: int) -> "Texture":
        arr = np.asarray(data, np.uint8).reshape(height, width, 4)
        return Texture(arr)

    @staticmethod
    def alloc(width: int, height: int) -> "Texture":
        return Texture(np.zeros((height, width, 4), np.uint8))

    @staticmethod
    def white() -> "Texture":
        return Texture(np.full((1, 1, 4), 255, np.uint8))

    @staticmethod
    def black() -> "Texture":
        t = np.zeros((1, 1, 4), np.uint8)
        t[..., 3] = 255
        return Texture(t)

    @staticmethod
    def from_color(rgba) -> "Texture":
        return Texture(np.asarray(rgba, np.uint8).reshape(1, 1, 4))

    @staticmethod
    def checkerboard(size: int, square_size: int) -> "Texture":
        """reference src/texture.rs:85-110 (gray/black squares)."""
        y, x = np.mgrid[0:size, 0:size]
        is_white = ((x // square_size) + (y // square_size)) % 2 == 0
        data = np.zeros((size, size, 4), np.uint8)
        data[..., :3] = np.where(is_white[..., None], 128, 0)
        data[..., 3] = 255
        return Texture(data)

    @staticmethod
    def from_image(source) -> "Texture":
        """Load from a path, bytes, or file-like object — the reference's
        IntoDataInput unification (src/intodata.rs:5-33)."""
        import io

        from PIL import Image

        if isinstance(source, (bytes, bytearray, memoryview)):
            source = io.BytesIO(bytes(source))
        img = Image.open(source).convert("RGBA")
        return Texture(np.asarray(img, np.uint8))

    @staticmethod
    def from_image_safe(path) -> Optional["Texture"]:
        try:
            return Texture.from_image(path)
        except Exception:
            return None

    # -- basic properties / edits --

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    def fill(self, rgba) -> None:
        self.data[:, :] = np.asarray(rgba, np.uint8)

    def get_pixel(self, x: int, y: int):
        return tuple(int(c) for c in self.data[y, x])

    def set_pixel(self, x: int, y: int, rgba) -> None:
        self.data[y, x] = np.asarray(rgba, np.uint8)

    def resized(self, width: int, height: int) -> "Texture":
        from PIL import Image

        img = Image.fromarray(self.data, "RGBA").resize(
            (width, height), Image.NEAREST
        )
        return Texture(np.asarray(img, np.uint8))

    def is_fully_opaque(self) -> bool:
        return bool((self.data[..., 3] == 255).all())

    # -- sampling (host reference implementation; device uses the atlas) --

    def _apply_repeat(self, u: float, v: float, repeat_mode: RepeatMode):
        """reference src/texture.rs:203-232"""
        if repeat_mode == RepeatMode.ClampXY:
            u = min(1.0, max(0.0, u))
            v = min(1.0, max(0.0, v))
        elif repeat_mode == RepeatMode.RepeatXY:
            u = u - np.floor(u)
            v = v - np.floor(v)
        elif repeat_mode == RepeatMode.RepeatX:
            u = u - np.floor(u)
            v = min(1.0, max(0.0, v))
        else:  # RepeatY
            u = min(1.0, max(0.0, u))
            v = v - np.floor(v)
        return float(u), float(v)

    def sample(
        self,
        u: float,
        v: float,
        sample_mode: SampleMode = SampleMode.Nearest,
        repeat_mode: RepeatMode = RepeatMode.ClampXY,
    ):
        u, v = self._apply_repeat(u, v, repeat_mode)
        if sample_mode == SampleMode.Nearest:
            return self.sample_nearest(u, v)
        return self.sample_linear(u, v)

    def sample_nearest(self, u: float, v: float):
        """reference src/texture.rs:307-324: round(u*(w-1)), clamped."""
        tx = int(np.clip(np.round(u * (self.width - 1)), 0, self.width - 1))
        ty = int(np.clip(np.round(v * (self.height - 1)), 0, self.height - 1))
        return tuple(int(c) for c in self.data[ty, tx])

    def sample_blur(self, u, v, sample_mode, repeat_mode, blur_strength: float):
        """reference src/texture.rs:236-303: 3x3 inverse-distance blur."""
        u, v = self._apply_repeat(u, v, repeat_mode)
        if sample_mode == SampleMode.Linear or blur_strength == 0.0:
            return self.sample(u, v, sample_mode, RepeatMode.ClampXY)
        blur = min(1.0, max(0.0, blur_strength))
        tx = int(np.clip(np.floor(u * self.width + 0.5), 0, self.width - 1))
        ty = int(np.clip(np.floor(v * self.height + 0.5), 0, self.height - 1))
        acc = np.zeros(4, np.float64)
        total = 0.0
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nx = int(np.clip(tx + dx, 0, self.width - 1))
                ny = int(np.clip(ty + dy, 0, self.height - 1))
                wgt = (1.0 / max(abs(dx) + abs(dy), 1)) * blur
                acc += self.data[ny, nx].astype(np.float64) * wgt
                total += wgt
        out = np.round(acc / total).astype(np.int32)
        return tuple(int(c) for c in out)

    def sample_nearest_blur(self, u: float, v: float, blur_strength: float):
        """reference src/texture.rs:327-411 — same 3x3 inverse-distance
        kernel as sample_blur, nearest center, clamped."""
        return self.sample_blur(
            u, v, SampleMode.Nearest, RepeatMode.ClampXY, blur_strength
        )

    def sample_linear(self, u: float, v: float):
        """reference src/texture.rs:414-460 bilinear."""
        x = u * (self.width - 1)
        y = v * (self.height - 1)
        x0 = int(np.floor(x))
        y0 = int(np.floor(y))
        x1 = min(x0 + 1, self.width - 1)
        y1 = min(y0 + 1, self.height - 1)
        dx = x - np.floor(x)
        dy = y - np.floor(y)
        c00 = self.data[y0, x0].astype(np.float32)
        c10 = self.data[y0, x1].astype(np.float32)
        c01 = self.data[y1, x0].astype(np.float32)
        c11 = self.data[y1, x1].astype(np.float32)
        c = (
            c00 * (1 - dx) * (1 - dy)
            + c10 * dx * (1 - dy)
            + c01 * (1 - dx) * dy
            + c11 * dx * dy
        )
        return tuple(int(q) for q in np.round(c).astype(np.int32))

    # -- unified material/normal format (reference src/texture.rs:652-823) --

    def ensure_data_ext(self) -> None:
        if self.data_ext is None:
            self.data_ext = np.zeros((self.height, self.width, 4), np.uint8)

    @staticmethod
    def pack_materials(roughness: float, metallic: float, opacity: float, emissive: float) -> int:
        r = int(round(np.clip(roughness, 0, 1) * 15))
        m = int(round(np.clip(metallic, 0, 1) * 15))
        o = int(round(np.clip(opacity, 0, 1) * 15))
        e = int(round(np.clip(emissive, 0, 1) * 15))
        return r | (m << 4) | (o << 8) | (e << 12)

    @staticmethod
    def unpack_materials(packed: int):
        return (
            (packed & 0xF) / 15.0,
            ((packed >> 4) & 0xF) / 15.0,
            ((packed >> 8) & 0xF) / 15.0,
            ((packed >> 12) & 0xF) / 15.0,
        )

    @staticmethod
    def pack_normal(nx: float, ny: float) -> int:
        x = int(round((np.clip(nx, -1, 1) * 0.5 + 0.5) * 255))
        y = int(round((np.clip(ny, -1, 1) * 0.5 + 0.5) * 255))
        return x | (y << 8)

    @staticmethod
    def unpack_normal(packed: int):
        return (
            (packed & 0xFF) / 255.0 * 2.0 - 1.0,
            ((packed >> 8) & 0xFF) / 255.0 * 2.0 - 1.0,
        )

    def set_materials(self, x: int, y: int, roughness, metallic, opacity, emissive) -> None:
        self.ensure_data_ext()
        packed = self.pack_materials(roughness, metallic, opacity, emissive)
        self.data_ext[y, x, 0] = packed & 0xFF
        self.data_ext[y, x, 1] = (packed >> 8) & 0xFF

    def get_materials(self, x: int, y: int):
        if self.data_ext is None:
            return (0.0, 0.0, 1.0, 0.0)
        packed = int(self.data_ext[y, x, 0]) | (int(self.data_ext[y, x, 1]) << 8)
        return self.unpack_materials(packed)

    def set_normal(self, x: int, y: int, nx: float, ny: float) -> None:
        self.ensure_data_ext()
        packed = self.pack_normal(nx, ny)
        self.data_ext[y, x, 2] = packed & 0xFF
        self.data_ext[y, x, 3] = (packed >> 8) & 0xFF

    def get_normal(self, x: int, y: int):
        if self.data_ext is None:
            return (0.0, 0.0)
        packed = int(self.data_ext[y, x, 2]) | (int(self.data_ext[y, x, 3]) << 8)
        return self.unpack_normal(packed)

    # single-channel material setters, preserving the others
    # (reference texture.rs:753-774)

    def set_roughness(self, x: int, y: int, roughness: float) -> None:
        _, m, o, e = self.get_materials(x, y)
        self.set_materials(x, y, roughness, m, o, e)

    def set_metallic(self, x: int, y: int, metallic: float) -> None:
        r, _, o, e = self.get_materials(x, y)
        self.set_materials(x, y, r, metallic, o, e)

    def set_opacity(self, x: int, y: int, opacity: float) -> None:
        r, m, _, e = self.get_materials(x, y)
        self.set_materials(x, y, r, m, opacity, e)

    def set_emissive(self, x: int, y: int, emissive: float) -> None:
        r, m, o, _ = self.get_materials(x, y)
        self.set_materials(x, y, r, m, o, emissive)

    def set_materials_all(self, roughness, metallic, opacity, emissive) -> None:
        """Fill the material bytes for every pixel, preserving normals
        (texture.rs:714-750)."""
        self.ensure_data_ext()
        packed = self.pack_materials(roughness, metallic, opacity, emissive)
        self.data_ext[..., 0] = packed & 0xFF
        self.data_ext[..., 1] = (packed >> 8) & 0xFF

    def set_default_materials(self) -> None:
        """roughness=0.5, metallic=0, opacity=1, emissive=0 everywhere
        (texture.rs:779-800)."""
        self.set_materials_all(0.5, 0.0, 1.0, 0.0)

    @staticmethod
    def from_rgbabuffer(pixels: np.ndarray) -> "Texture":
        """(H, W, 4) u8 buffer -> Texture (texture.rs:142-149)."""
        return Texture(np.asarray(pixels, np.uint8))

    def to_rgba(self) -> np.ndarray:
        """texture.rs:550-552 — the raw (H, W, 4) u8 buffer."""
        return self.data

    def generate_normals(self, wrap: bool = False) -> None:
        """Sobel height→normal baking, vectorized (reference src/texture.rs:558-638)."""
        self.ensure_data_ext()
        rgb = self.data[..., :3].astype(np.float32) / 255.0
        lum = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]

        mode = "wrap" if wrap else "edge"
        p = np.pad(lum, 1, mode=mode)
        tl = p[:-2, :-2]
        tc = p[:-2, 1:-1]
        tr = p[:-2, 2:]
        cl = p[1:-1, :-2]
        cr = p[1:-1, 2:]
        bl = p[2:, :-2]
        bc = p[2:, 1:-1]
        br = p[2:, 2:]
        gx = -tl + tr - 2 * cl + 2 * cr - bl + br
        gy = -tl - 2 * tc - tr + bl + 2 * bc + br
        nx = -gx
        ny = -gy
        nz = np.ones_like(nx)
        ln = np.sqrt(nx * nx + ny * ny + nz * nz)
        with np.errstate(divide="ignore", invalid="ignore"):
            nx = np.where(ln > 0, nx / ln, 0.0)
            ny = np.where(ln > 0, ny / ln, 0.0)
        px = np.round((np.clip(nx, -1, 1) * 0.5 + 0.5) * 255).astype(np.uint16)
        py = np.round((np.clip(ny, -1, 1) * 0.5 + 0.5) * 255).astype(np.uint16)
        self.data_ext[..., 2] = (px & 0xFF).astype(np.uint8)
        self.data_ext[..., 3] = (py & 0xFF).astype(np.uint8)


@dataclass
class Tile:
    """Animated texture: frame list + metadata (reference src/map/tile.rs:83-222)."""

    textures: List[Texture] = field(default_factory=list)
    id: Optional[str] = None
    role: TileRole = TileRole.ManMade
    blocking: bool = False
    scale: float = 1.0
    tags: str = ""
    render_mode: int = 0
    #: optional codegridfx shader Module when the frames are shader-generated
    #: (tile.rs:88-89); regenerate_from_module() rebakes the frames from it
    module: Optional[object] = None

    @staticmethod
    def empty() -> "Tile":
        return Tile()

    @staticmethod
    def from_texture(texture: Texture) -> "Tile":
        return Tile(textures=[texture])

    @staticmethod
    def from_textures(textures: List[Texture]) -> "Tile":
        """tile.rs:113-123."""
        return Tile(textures=list(textures))

    def is_empty(self) -> bool:
        return not self.textures

    def to_buffer_array(self) -> List[np.ndarray]:
        """Frame color buffers (tile.rs:144-150)."""
        return [t.data for t in self.textures]

    def to_material_array(self) -> List[np.ndarray]:
        """Frame data_ext material buffers where present (tile.rs:153-160)."""
        return [t.data_ext for t in self.textures if t.data_ext is not None]

    def append(self, texture: Texture) -> None:
        self.textures.append(texture)

    def set_frames(self, textures: List[Texture]) -> None:
        self.textures = list(textures)

    def resized(self, width: int, height: int) -> "Tile":
        return Tile(
            textures=[t.resized(width, height) for t in self.textures],
            id=self.id,
            role=self.role,
            blocking=self.blocking,
            scale=self.scale,
            tags=self.tags,
            module=self.module,
        )

    def first(self) -> Texture:
        return self.textures[0] if self.textures else Texture.white()

    def set_module(self, module, frames: int = 1, size: int = 128,
                   palette=None) -> None:
        """Attach a codegridfx shader module and bake the frames from it
        (tile.rs:88-89 `module: Option<Module>`; the reference editor
        rebuilds tile textures from the module's shader on edit)."""
        self.module = module
        self.regenerate_from_module(frames=frames, size=size, palette=palette)

    def regenerate_from_module(self, frames: Optional[int] = None,
                               size: int = 128, palette=None) -> bool:
        """Rebake this tile's frames from its attached codegridfx module.

        The module's grid builds rusteria source (codegridfx Module.build
        with is_shader, module.rs:1078-1095) which is baked at `frames`
        evenly-spaced times — a time-dependent shader becomes an animated
        tile riding the existing tile_first/tile_count atlas machinery.
        Returns False when no shader module is attached or the build fails."""
        if self.module is None:
            return False
        build = getattr(self.module, "build_shader", None)
        src = build() if callable(build) else ""
        if not src:
            return False
        from ..shader import Rusteria

        prog = Rusteria.parse_and_compile(src)
        if prog is None or not prog.shade_index:
            return False
        if frames is None:
            frames = max(1, len(self.textures))
        new_frames = []
        for i in range(frames):
            rgba = Rusteria.bake_tile(
                prog, size, palette, time=i / float(frames)
            )
            new_frames.append(Texture(rgba))
        self.textures = new_frames
        return True


@dataclass
class TextureAtlas:
    """All scene-reachable textures shelf-packed into one device array.

    Device layout (all jnp-convertible numpy):
      data      : (AH, AW, 4) uint8 atlas texels
      rects     : (N, 4) int32 per-texture (x, y, w, h)
      opaque    : (N,) bool per-texture "all alpha == 255"
      tile_first: (K, ) int32 first texture index of tile k
      tile_count: (K, ) int32 frame count of tile k
    The shading pass resolves an animated tile to a texture id with
    ``tile_first[k] + frame % tile_count[k]`` (reference picks the frame the
    same way, src/rasterizer.rs:1104-1107).
    """

    data: np.ndarray
    rects: np.ndarray
    opaque: np.ndarray
    tile_first: np.ndarray
    tile_count: np.ndarray

    @staticmethod
    def build(tiles: List[Tile], max_width: int = 2048) -> "TextureAtlas":
        textures: List[Texture] = []
        tile_first = []
        tile_count = []
        for tile in tiles:
            frames = tile.textures if tile.textures else [Texture.white()]
            tile_first.append(len(textures))
            tile_count.append(len(frames))
            textures.extend(frames)
        if not textures:
            textures = [Texture.white()]
            tile_first = [0]
            tile_count = [1]

        # Shelf pack, tallest first, keep original order in rects.
        order = sorted(range(len(textures)), key=lambda i: -textures[i].height)
        rects = np.zeros((len(textures), 4), np.int32)
        shelf_x, shelf_y, shelf_h = 0, 0, 0
        atlas_w = max(
            min(max_width, max(t.width for t in textures)),
            1,
        )
        # Try to use a near-square atlas width.
        total_area = sum(t.width * t.height for t in textures)
        atlas_w = max(atlas_w, 1 << int(np.ceil(np.log2(max(np.sqrt(total_area), 1)))))
        atlas_w = min(atlas_w, max_width)

        for i in order:
            t = textures[i]
            if shelf_x + t.width > atlas_w:
                shelf_y += shelf_h
                shelf_x, shelf_h = 0, 0
            rects[i] = (shelf_x, shelf_y, t.width, t.height)
            shelf_x += t.width
            shelf_h = max(shelf_h, t.height)
        atlas_h = shelf_y + shelf_h

        data = np.zeros((atlas_h, atlas_w, 4), np.uint8)
        for i, t in enumerate(textures):
            x, y, w, h = rects[i]
            data[y : y + h, x : x + w] = t.data

        return TextureAtlas(
            data=data,
            rects=rects,
            opaque=np.array([t.is_fully_opaque() for t in textures], bool),
            tile_first=np.asarray(tile_first, np.int32),
            tile_count=np.asarray(tile_count, np.int32),
        )

    @staticmethod
    def empty() -> "TextureAtlas":
        return TextureAtlas.build([])

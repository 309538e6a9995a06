"""Geometry batches (host-side, numpy SoA).

TPU-first re-design of the reference's `Batch2D`/`Batch3D`
(reference: src/batch/batch2d.rs, src/batch/batch3d.rs, src/batch/mod.rs).

Host-side the batch is an editable container (numpy arrays). Per frame the
scene packer (ops/scene_pack.py) concatenates all batches into padded SoA
device buffers; projection/clipping then runs as one vmapped jitted pass
(ops/setup_pass.py) instead of the reference's per-batch rayon loop
(src/scene.rs:154-200).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def _cross3(a, b):
    """3-vector cross without np.cross's moveaxis machinery (the generic
    path is ~20x the flops for single vectors; billboards rebuild per
    frame in the engine loop)."""
    return np.array(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ],
        np.float32,
    )


class PrimitiveMode(enum.IntEnum):
    """reference src/batch/mod.rs:6-14"""

    Triangles = 0
    Lines = 1
    LineStrip = 2
    LineLoop = 3


class CullMode(enum.IntEnum):
    """reference src/batch/mod.rs:16-24"""

    Off = 0
    Front = 1
    Back = 2


class GeometrySource(enum.IntEnum):
    """reference src/batch/mod.rs:26-37"""

    Unknown = 0
    Vertex = 1
    Linedef = 2
    Sector = 3
    Entity = 4
    Item = 5


class RepeatMode(enum.IntEnum):
    """reference src/texture.rs:14-25"""

    ClampXY = 0
    RepeatXY = 1
    RepeatX = 2
    RepeatY = 3


class SampleMode(enum.IntEnum):
    """reference src/texture.rs:5-12"""

    Nearest = 0
    Linear = 1


class PixelSourceKind(enum.IntEnum):
    """Int-coded source descriptor (reference src/map/pixelsource.rs:23-37).

    On device every triangle carries (kind, a, b); the shading pass resolves
    kinds with vectorized selects instead of the reference's per-pixel match
    (src/rasterizer.rs:1101-1222).
    """

    Off = 0
    StaticTileIndex = 1
    DynamicTileIndex = 2
    Pixel = 3
    Color = 4
    EntityTile = 5
    ItemTile = 6
    Terrain = 7
    TileId = 8
    MaterialId = 9
    Sequence = 10
    ShapeFXGraphId = 11


class PixelSource:
    """Pixel-source descriptor (reference src/map/pixelsource.rs:23-37).

    NOT a dataclass: the `pixel` payload field shares its name with the
    `PixelSource.pixel(...)` variant constructor (mirroring the reference
    enum), so __init__ must set the instance attribute explicitly — a
    dataclass would capture the staticmethod as the field default."""

    def __init__(
        self,
        kind: PixelSourceKind = PixelSourceKind.Off,
        index: int = 0,  # StaticTileIndex/DynamicTileIndex; EntityTile seq
        entity_id: int = 0,  # EntityTile/ItemTile id
        pixel: tuple = (0, 0, 0, 255),  # Pixel/Color RGBA8
        uuid: Optional[str] = None,  # TileId / MaterialId / ShapeFXGraphId
        name: Optional[str] = None,  # Sequence
    ):
        self.kind = kind
        self.index = index
        self.entity_id = entity_id
        self.pixel = pixel
        self.uuid = uuid
        self.name = name

    def _key(self):
        return (self.kind, self.index, self.entity_id, self.pixel, self.uuid,
                self.name)

    def __eq__(self, other):
        return isinstance(other, PixelSource) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"PixelSource(kind={self.kind!r}, index={self.index})"

    # Constructors mirroring the reference enum variants
    @staticmethod
    def off() -> "PixelSource":
        return PixelSource(PixelSourceKind.Off)

    @staticmethod
    def static_tile_index(i: int) -> "PixelSource":
        return PixelSource(PixelSourceKind.StaticTileIndex, index=i)

    @staticmethod
    def dynamic_tile_index(i: int) -> "PixelSource":
        return PixelSource(PixelSourceKind.DynamicTileIndex, index=i)

    @staticmethod
    def pixel(rgba) -> "PixelSource":
        return PixelSource(PixelSourceKind.Pixel, pixel=tuple(rgba))

    @staticmethod
    def color(rgba) -> "PixelSource":
        return PixelSource(PixelSourceKind.Color, pixel=tuple(rgba))

    @staticmethod
    def entity_tile(entity_id: int, seq: int) -> "PixelSource":
        return PixelSource(PixelSourceKind.EntityTile, index=seq, entity_id=entity_id)

    @staticmethod
    def item_tile(item_id: int, seq: int) -> "PixelSource":
        return PixelSource(PixelSourceKind.ItemTile, index=seq, entity_id=item_id)

    @staticmethod
    def terrain() -> "PixelSource":
        return PixelSource(PixelSourceKind.Terrain)

    @staticmethod
    def tile_id(uuid: str) -> "PixelSource":
        return PixelSource(PixelSourceKind.TileId, uuid=uuid)

    @staticmethod
    def sequence(name: str) -> "PixelSource":
        return PixelSource(PixelSourceKind.Sequence, name=name)

    @staticmethod
    def shapefx_graph(uuid: str) -> "PixelSource":
        return PixelSource(PixelSourceKind.ShapeFXGraphId, uuid=uuid)

    @staticmethod
    def noise2d(p, scale=(1.0, 1.0), octaves: int = 4):
        """Vectorized value-noise fbm used by Color tile baking
        (reference src/map/pixelsource.rs:168-204). `p` is (..., 2)."""
        p = np.asarray(p, np.float32)

        def _hash(q):
            p3 = np.stack([q[..., 0], q[..., 1], q[..., 0]], -1) * np.float32(0.13)
            p3 = p3 - np.floor(p3)
            dot = (
                p3[..., 0] * (p3[..., 1] + 3.333)
                + p3[..., 1] * (p3[..., 2] + 3.333)
                + p3[..., 2] * (p3[..., 0] + 3.333)
            )
            p3 = p3 + dot[..., None]
            v = (p3[..., 0] + p3[..., 1]) * p3[..., 2]
            return v - np.floor(v)

        def _noise(x):
            i = np.floor(x)
            f = x - i
            a = _hash(i)
            b = _hash(i + np.float32([1, 0]))
            c = _hash(i + np.float32([0, 1]))
            d = _hash(i + np.float32([1, 1]))
            u = f * f * (3.0 - 2.0 * f)
            return (
                a + (b - a) * u[..., 0]
                + (c - a) * u[..., 1] * (1.0 - u[..., 0])
                + (d - b) * u[..., 0] * u[..., 1]
            )

        x = p * np.float32(8.0) * np.asarray(scale, np.float32)
        if octaves == 0:
            return _noise(x)
        v = np.zeros(x.shape[:-1], np.float32)
        a = 0.5
        cs, sn = np.cos(0.5), np.sin(0.5)
        rot = np.array([[cs, sn], [-sn, cs]], np.float32)
        for _ in range(octaves):
            v = v + a * _noise(x)
            x = x @ rot.T * 2.0 + np.float32(100.0)
            a *= 0.5
        return v

    def to_tile(self, assets, size: int, values=None, map_=None):
        """Bake this source into a Tile for editor previews
        (reference src/map/pixelsource.rs:43-120): TileId/MaterialId look
        up assets; Color synthesizes a size x size texture with optional
        fbm noise on RGB/hue/luminance (noise_target / noise_intensity /
        pixelization props); ShapeFXGraphId returns the graph's dominant
        palette color. Other variants -> None."""
        from ..map.value import ValueContainer
        from ..utils.color import hsl_to_rgb_many, rgb_to_hsl
        from .texture import Texture, Tile

        if values is None:
            values = ValueContainer()
        if self.kind == PixelSourceKind.TileId:
            return assets.tiles.get(self.uuid)
        if self.kind == PixelSourceKind.MaterialId:
            return assets.materials.get(self.uuid)
        if self.kind in (PixelSourceKind.Color, PixelSourceKind.Pixel):
            target = values.get_int_default("noise_target", 0)
            intensity = values.get_float_default("noise_intensity", 0.0)
            pix = max(values.get_int_default("pixelization", 1), 1)
            base = np.asarray(self.pixel, np.float32) / 255.0
            xs = np.arange(0, size, pix)
            gx, gy = np.meshgrid(xs, xs)
            p = np.stack([gx, gy], -1).astype(np.float32) / float(size)
            # the reference scales by intensity twice (pixelsource.rs:64-65);
            # kept for parity
            noise = self.noise2d(p) * intensity
            un = (noise * 2.0 - 1.0) * intensity
            buf = np.empty((len(xs), len(xs), 4), np.float32)
            buf[..., 3] = base[3] if len(base) > 3 else 1.0
            if target == 0:  # RGB
                buf[..., :3] = np.clip(
                    base[None, None, :3] * (1.0 + un[..., None]), 0.0, 1.0
                )
                buf[..., 3] = 1.0
            else:
                h, s, l = rgb_to_hsl(base[:3])
                if target == 1:  # Hue
                    buf[..., :3] = hsl_to_rgb_many((h + un) % 1.0, s, l)
                else:  # Luminance
                    buf[..., :3] = hsl_to_rgb_many(
                        h, s, np.clip(l + un, 0.0, 1.0)
                    )
            data = np.repeat(np.repeat(buf, pix, axis=0), pix, axis=1)[:size, :size]
            tile = Tile.empty()
            tile.append(Texture((data * 255.0 + 0.5).astype(np.uint8)))
            return tile
        if self.kind == PixelSourceKind.ShapeFXGraphId:
            graph = None
            if map_ is not None:
                graph = getattr(map_, "shapefx_graphs", {}).get(self.uuid)
            if graph is not None:
                rgba = graph.get_dominant_color(assets.palette)
            else:
                rgba = (0, 0, 0, 255)
            tile = Tile.empty()
            tile.append(Texture.from_color(rgba))
            return tile
        return None


class MaterialRole(enum.IntEnum):
    """reference src/shapestack/material.rs:8-38"""

    Matte = 0
    Glossy = 1
    Metallic = 2
    Transparent = 3
    Emissive = 4


class MaterialModifier(enum.IntEnum):
    """reference src/shapestack/material.rs:58-75"""

    Nothing = 0
    Luminance = 1
    Saturation = 2
    InvLuminance = 3
    InvSaturation = 4


@dataclass
class Material:
    """Per-batch material (reference src/shapestack/material.rs:113-150)."""

    role: MaterialRole = MaterialRole.Matte
    modifier: MaterialModifier = MaterialModifier.Nothing
    value: float = 1.0
    flicker: float = 0.0

    def modify(self, color_rgb, strength: float) -> float:
        """reference src/shapestack/material.rs:77-110 `MaterialModifier::modify`"""
        r, g, b = float(color_rgb[0]), float(color_rgb[1]), float(color_rgb[2])
        if self.modifier == MaterialModifier.Nothing:
            return strength
        if self.modifier in (MaterialModifier.Luminance, MaterialModifier.InvLuminance):
            lum = 0.2126 * r + 0.7152 * g + 0.0722 * b
            if self.modifier == MaterialModifier.Luminance:
                return lum * strength
            return (1.0 - lum) * strength
        mx = max(r, g, b)
        mn = min(r, g, b)
        sat = (mx - mn) / mx if mx > 0.0 else 0.0
        if self.modifier == MaterialModifier.Saturation:
            return sat * strength
        return (1.0 - sat) * strength


def _as_f32(a, cols):
    arr = np.asarray(a, dtype=np.float32)
    if arr.size == 0:
        return np.zeros((0, cols), np.float32)
    return arr.reshape(-1, cols)


def _as_idx(indices):
    arr = np.asarray(indices, dtype=np.int32)
    if arr.size == 0:
        return np.zeros((0, 3), np.int32)
    return arr.reshape(-1, 3)


@dataclass
class Batch3D:
    """A batch of 3D triangles (reference src/batch/batch3d.rs:15-78).

    Vertices are [x,y,z,w]; per-batch render state matches the reference.
    No `projected_vertices`/`edges` members: projection outputs live in the
    device-side setup pass products, not in this host container.
    """

    vertices: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))
    indices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))
    uvs: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    mode: PrimitiveMode = PrimitiveMode.Triangles
    repeat_mode: RepeatMode = RepeatMode.ClampXY
    cull_mode: CullMode = CullMode.Off
    source: PixelSource = field(default_factory=PixelSource.off)
    transform_3d: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    receives_light: bool = True
    material: Optional[Material] = None
    ambient_color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    shader: Optional[int] = None
    profile_id: Optional[int] = None
    geometry_source: GeometrySource = GeometrySource.Unknown
    # vertex blending: per-pixel mix toward `source2` by the interpolated
    # per-vertex weight (reference scenevm add_poly_3d_blended consumption,
    # weights from VertexBlendPreset corners — d3chunkbuilder.rs:194-214)
    source2: Optional[PixelSource] = None
    blend_weights: Optional[np.ndarray] = None  # (len(vertices),) f32
    #: whole-batch alpha multiplier (reference DynamicObject::with_opacity,
    #: used by fading door billboards — scene_handler.rs:703-728)
    opacity: float = 1.0

    # ---- constructors ----

    @staticmethod
    def empty() -> "Batch3D":
        return Batch3D()

    @staticmethod
    def new(vertices, indices, uvs) -> "Batch3D":
        return Batch3D(
            vertices=_as_f32(vertices, 4),
            indices=_as_idx(indices),
            uvs=_as_f32(uvs, 2),
        )

    @staticmethod
    def from_box(x, y, z, width, height, depth) -> "Batch3D":
        """Axis-aligned box, 24 verts / 12 tris (reference batch3d.rs:140-236)."""
        x0, y0, z0 = x, y, z
        x1, y1, z1 = x + width, y + height, z + depth
        vertices = [
            # front (+z at z0 side in reference layout)
            [x0, y0, z0, 1.0], [x1, y0, z0, 1.0], [x1, y1, z0, 1.0], [x0, y1, z0, 1.0],
            # back
            [x0, y0, z1, 1.0], [x1, y0, z1, 1.0], [x1, y1, z1, 1.0], [x0, y1, z1, 1.0],
            # left
            [x0, y0, z0, 1.0], [x0, y1, z0, 1.0], [x0, y1, z1, 1.0], [x0, y0, z1, 1.0],
            # right
            [x1, y0, z0, 1.0], [x1, y1, z0, 1.0], [x1, y1, z1, 1.0], [x1, y0, z1, 1.0],
            # top
            [x0, y1, z0, 1.0], [x1, y1, z0, 1.0], [x1, y1, z1, 1.0], [x0, y1, z1, 1.0],
            # bottom
            [x0, y0, z0, 1.0], [x1, y0, z0, 1.0], [x1, y0, z1, 1.0], [x0, y0, z1, 1.0],
        ]
        indices = [
            (0, 1, 2), (0, 2, 3),
            (4, 6, 5), (4, 7, 6),
            (8, 9, 10), (8, 10, 11),
            (12, 14, 13), (12, 15, 14),
            (16, 17, 18), (16, 18, 19),
            (20, 23, 22), (20, 22, 21),
        ]
        uv_face = [[0.0, 1.0], [1.0, 1.0], [1.0, 0.0], [0.0, 0.0]]
        uvs = uv_face * 6
        return Batch3D.new(vertices, indices, uvs)

    @staticmethod
    def from_obj(text_or_path) -> "Batch3D":
        """OBJ from a path, source text, or bytes (the reference's
        IntoDataInput unification, src/intodata.rs:5-33)."""
        from .wavefront import Wavefront

        if isinstance(text_or_path, (bytes, bytearray, memoryview)):
            text_or_path = bytes(text_or_path).decode("utf-8")
        if "\n" not in str(text_or_path) and len(str(text_or_path)) < 4096:
            try:
                with open(text_or_path, "r") as f:
                    text = f.read()
            except (OSError, ValueError):
                text = str(text_or_path)
        else:
            text = str(text_or_path)
        return Wavefront.parse_string(text).to_batch()

    # ---- mutators ----

    def add(self, vertices, indices, uvs) -> None:
        base = len(self.vertices)
        self.vertices = np.concatenate([self.vertices, _as_f32(vertices, 4)])
        self.uvs = np.concatenate([self.uvs, _as_f32(uvs, 2)])
        self.indices = np.concatenate([self.indices, _as_idx(indices) + base])

    def _push_quad(self, p0, p1, p2, p3, n) -> None:
        base = len(self.vertices)
        quad = np.array(
            [[*p0, 1.0], [*p1, 1.0], [*p2, 1.0], [*p3, 1.0]], np.float32
        )
        self.vertices = np.concatenate([self.vertices, quad])
        self.uvs = np.concatenate(
            [self.uvs, np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)]
        )
        self.indices = np.concatenate(
            [
                self.indices,
                np.array([[base, base + 1, base + 2], [base, base + 2, base + 3]], np.int32),
            ]
        )
        if len(self.normals) < len(self.vertices):
            add = len(self.vertices) - len(self.normals)
            self.normals = np.concatenate(
                [self.normals, np.tile(np.asarray(n, np.float32), (add, 1))]
            )

    def add_line(self, a, b, thickness: float, normal) -> None:
        """Line as an extruded quad (reference batch3d.rs:256-318)."""
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        d = b - a
        dlen = float(np.linalg.norm(d))
        if dlen < 1e-6:
            return
        dn = d / dlen
        n = np.asarray(normal, np.float32)
        if float(np.linalg.norm(n)) < 1e-6:
            n = np.array([0, 1, 0], np.float32)
        else:
            n = n / np.linalg.norm(n)
        if abs(float(np.dot(dn, n))) > 0.999:
            ax, ay, az = np.abs(dn)
            if ax <= ay and ax <= az:
                n = np.array([1, 0, 0], np.float32)
            elif ay <= az:
                n = np.array([0, 1, 0], np.float32)
            else:
                n = np.array([0, 0, 1], np.float32)
        side = _cross3(n, dn)
        if not np.all(np.isfinite(side)) or float(np.linalg.norm(side)) < 1e-6:
            side = _cross3(dn, np.array([0, 1, 0], np.float32))
            if float(np.linalg.norm(side)) < 1e-6:
                side = _cross3(dn, np.array([1, 0, 0], np.float32))
        side_n = side / np.linalg.norm(side)
        half = side_n * (thickness * 0.5)
        cap = dn * (thickness * 0.5)
        a_ext = a - cap
        b_ext = b + cap
        self._push_quad(a_ext - half, a_ext + half, b_ext + half, b_ext - half, n)

    def add_quad(self, center, normal, size: float) -> None:
        """reference batch3d.rs:321-358"""
        center = np.asarray(center, np.float32)
        n = np.asarray(normal, np.float32)
        if float(np.linalg.norm(n)) < 1e-6:
            n = np.array([0, 1, 0], np.float32)
        else:
            n = n / np.linalg.norm(n)
        helper = (
            np.array([1, 0, 0], np.float32)
            if abs(n[0]) < 0.9
            else np.array([0, 1, 0], np.float32)
        )
        u = _cross3(n, helper)
        u = u / np.linalg.norm(u)
        v = _cross3(n, u)
        v = v / np.linalg.norm(v)
        h = size * 0.5
        self._push_quad(
            center - u * h - v * h,
            center + u * h - v * h,
            center + u * h + v * h,
            center - u * h + v * h,
            n,
        )

    def add_vertex_billboard(self, center, view_right, view_up, size: float) -> None:
        """Camera-facing quad (reference batch3d.rs:361-404)."""
        center = np.asarray(center, np.float32)
        r = np.asarray(view_right, np.float32)
        u = np.asarray(view_up, np.float32)
        if float(np.linalg.norm(r)) < 1e-6:
            r = np.array([1, 0, 0], np.float32)
        else:
            r = r / np.linalg.norm(r)
        if float(np.linalg.norm(u)) < 1e-6:
            u = np.array([0, 1, 0], np.float32)
        else:
            u = u / np.linalg.norm(u)
        n = _cross3(r, u)
        n = n / np.linalg.norm(n)
        h = size * 0.5
        self._push_quad(
            center - r * h - u * h,
            center + r * h - u * h,
            center + r * h + u * h,
            center - r * h + u * h,
            n,
        )

    def compute_vertex_normals(self) -> None:
        """Smooth per-vertex normals (reference batch3d.rs:771-809)."""
        v = self.vertices[:, :3]
        normals = np.zeros((len(v), 3), np.float64)
        counts = np.zeros(len(v), np.int64)
        for i0, i1, i2 in self.indices:
            n = np.cross(v[i1] - v[i0], v[i2] - v[i0])
            ln = np.linalg.norm(n)
            if ln > 0:
                n = n / ln
            for i in (i0, i1, i2):
                normals[i] += n
                counts[i] += 1
        nz = counts > 0
        normals[nz] /= counts[nz, None]
        lens = np.linalg.norm(normals, axis=1, keepdims=True)
        lens[lens == 0] = 1.0
        self.normals = (normals / lens).astype(np.float32)

    def with_computed_normals(self) -> "Batch3D":
        import copy

        new = copy.deepcopy(self)
        new.compute_vertex_normals()
        return new

    def intersect(self, ray, simplified: bool = False):
        """Brute-force Möller-Trumbore (reference batch3d.rs:846-946)."""
        from .hitinfo import HitInfo

        o = np.asarray(ray.origin, np.float32)
        d = np.asarray(ray.dir, np.float32)
        d = d / np.linalg.norm(d)
        if len(self.indices) == 0:
            return None
        v = self.vertices[:, :3]
        p0 = v[self.indices[:, 0]]
        p1 = v[self.indices[:, 1]]
        p2 = v[self.indices[:, 2]]
        e1 = p1 - p0
        e2 = p2 - p0
        h = np.cross(np.broadcast_to(d, e2.shape), e2)
        a = np.einsum("ij,ij->i", e1, h)
        ok = np.abs(a) >= 1e-6
        f = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)
        s = o - p0
        u = f * np.einsum("ij,ij->i", s, h)
        ok &= (u >= 0.0) & (u <= 1.0)
        q = np.cross(s, e1)
        vv = f * (q @ d)
        ok &= (vv >= 0.0) & (u + vv <= 1.0)
        t = f * np.einsum("ij,ij->i", e2, q)
        ok &= t > 1e-4
        if not ok.any():
            return None
        t_masked = np.where(ok, t, np.inf)
        i = int(np.argmin(t_masked))
        ti, ui, vi = float(t[i]), float(u[i]), float(vv[i])
        hit = HitInfo(
            t=ti,
            triangle_index=i,
            profile_id=self.profile_id,
            geometry_source=self.geometry_source,
            hitpoint=o + d * ti,
        )
        if not simplified:
            w = 1.0 - ui - vi
            i0, i1, i2 = self.indices[i]
            hit.uv = (
                w * self.uvs[i0] + ui * self.uvs[i1] + vi * self.uvs[i2]
            ).astype(np.float32)
            if len(self.normals) > 0:
                n = (
                    self.normals[i0] * w + self.normals[i1] * ui + self.normals[i2] * vi
                )
            else:
                n = np.cross(p1[i] - p0[i], p2[i] - p0[i])
            ln = np.linalg.norm(n)
            if ln > 0:
                n = n / ln
            if float(np.dot(n, d)) > 0.0:
                n = -n
            hit.normal = n.astype(np.float32)
        return hit

    def aabb(self):
        from ..utils.rect import BBox3

        if len(self.vertices) == 0:
            return BBox3()
        return BBox3.from_points(self.vertices[:, :3])

    # ---- builder-style setters (reference batch3d.rs:421-480) ----

    def set_mode(self, mode):
        self.mode = mode
        return self

    def set_repeat_mode(self, m):
        self.repeat_mode = m
        return self

    def set_cull_mode(self, m):
        self.cull_mode = m
        return self

    def set_source(self, s):
        self.source = s
        return self

    def set_shader(self, idx):
        self.shader = idx
        return self

    def set_ambient_color(self, c):
        self.ambient_color = np.asarray(c, np.float32)
        return self

    def set_transform(self, m):
        self.transform_3d = np.asarray(m, np.float32)
        return self

    def set_receives_light(self, b):
        self.receives_light = b
        return self

    def set_material(self, m):
        self.material = m
        return self

    def set_profile_id(self, p):
        self.profile_id = p
        return self

    def set_geometry_source(self, g):
        self.geometry_source = g
        return self


@dataclass
class Batch2D:
    """A batch of 2D triangles / lines (reference src/batch/batch2d.rs:10-61)."""

    vertices: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    indices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))
    uvs: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    mode: PrimitiveMode = PrimitiveMode.Triangles
    repeat_mode: RepeatMode = RepeatMode.ClampXY
    source: PixelSource = field(default_factory=PixelSource.off)
    transform: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32))
    receives_light: bool = True
    material: Optional[Material] = None
    shader: Optional[int] = None

    @staticmethod
    def empty() -> "Batch2D":
        return Batch2D()

    @staticmethod
    def new(vertices, indices, uvs) -> "Batch2D":
        return Batch2D(
            vertices=_as_f32(vertices, 2),
            indices=_as_idx(indices),
            uvs=_as_f32(uvs, 2),
        )

    @staticmethod
    def from_rectangle(x, y, width, height) -> "Batch2D":
        """reference batch2d.rs:109-128"""
        vertices = [[x, y], [x, y + height], [x + width, y + height], [x + width, y]]
        indices = [(0, 1, 2), (0, 2, 3)]
        uvs = [[0, 0], [0, 1], [1, 1], [1, 0]]
        return Batch2D.new(vertices, indices, uvs)

    def add_rectangle(self, x, y, width, height) -> None:
        base = len(self.vertices)
        self.vertices = np.concatenate(
            [
                self.vertices,
                np.array(
                    [[x, y], [x, y + height], [x + width, y + height], [x + width, y]],
                    np.float32,
                ),
            ]
        )
        self.uvs = np.concatenate(
            [self.uvs, np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)]
        )
        self.indices = np.concatenate(
            [
                self.indices,
                np.array([[base, base + 1, base + 2], [base, base + 2, base + 3]], np.int32),
            ]
        )

    def add(self, vertices, indices, uvs) -> None:
        base = len(self.vertices)
        self.vertices = np.concatenate([self.vertices, _as_f32(vertices, 2)])
        self.uvs = np.concatenate([self.uvs, _as_f32(uvs, 2)])
        self.indices = np.concatenate([self.indices, _as_idx(indices) + base])

    def add_wrapped(self, vertices, indices, uvs, wrap_size: float) -> None:
        """9-way toroidal duplication for tileable bakes (batch2d.rs:183-232)."""
        offsets = [
            (0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, 1), (1, -1), (-1, -1)
        ]
        v = _as_f32(vertices, 2)
        idx = _as_idx(indices)
        u = _as_f32(uvs, 2)
        for ox, oy in offsets:
            off = np.array([ox * wrap_size, oy * wrap_size], np.float32)
            self.add(v + off, idx, u)

    def add_line(self, start, end, thickness: float) -> None:
        """Line as a 2D quad (reference batch2d.rs:234-279)."""
        start = np.asarray(start, np.float32)
        end = np.asarray(end, np.float32)
        d = end - start
        length = float(np.linalg.norm(d))
        if length < 1e-12:
            return
        n = np.array([-d[1], d[0]], np.float32) / length * (thickness * 0.5)
        base = len(self.vertices)
        self.vertices = np.concatenate(
            [self.vertices, np.stack([start - n, start + n, end + n, end - n])]
        )
        self.uvs = np.concatenate(
            [self.uvs, np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)]
        )
        self.indices = np.concatenate(
            [
                self.indices,
                np.array([[base, base + 1, base + 2], [base, base + 2, base + 3]], np.int32),
            ]
        )

    # builder setters

    def set_mode(self, mode):
        self.mode = mode
        return self

    def set_repeat_mode(self, m):
        self.repeat_mode = m
        return self

    def set_source(self, s):
        self.source = s
        return self

    def set_shader(self, idx):
        self.shader = idx
        return self

    def set_transform(self, m):
        self.transform = np.asarray(m, np.float32)
        return self

    def set_receives_light(self, b):
        self.receives_light = b
        return self

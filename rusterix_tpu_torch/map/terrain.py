"""Sparse heightmap terrain (reference src/terrain/mod.rs, src/terrain/chunk.rs).

Heights live in per-chunk dense grids created on write; sampling is bilinear
(mod.rs:148-175), normals via central differences (mod.rs:301+). Mesh
generation emits one quad per tile (chunk.rs:253+); `bake_chunk`-style
texture baking happens in the chunk builder. Device-side the heightmap is a
padded array for the Terrain pixel source.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np


def _source_patch(src, assets, size: int) -> Optional[np.ndarray]:
    """Resolve a per-tile PixelSource to a (size,size,4) u8 patch."""
    from ..models.batch import PixelSourceKind

    if src is None or assets is None:
        return None
    tex = None
    if src.kind in (PixelSourceKind.TileId, PixelSourceKind.MaterialId):
        tile = assets.tiles.get(src.uuid)
        if tile is not None and tile.textures:
            tex = tile.textures[0]
    elif src.kind == PixelSourceKind.StaticTileIndex:
        if 0 <= src.index < len(assets.tile_list):
            tile = assets.tile_list[src.index]
            if tile.textures:
                tex = tile.textures[0]
    elif src.kind in (PixelSourceKind.Pixel, PixelSourceKind.Color):
        patch = np.empty((size, size, 4), np.uint8)
        patch[:] = np.asarray(src.pixel, np.uint8)
        return patch
    if tex is None:
        return None
    data = tex.data
    ys = (np.arange(size) * data.shape[0] // size).clip(0, data.shape[0] - 1)
    xs = (np.arange(size) * data.shape[1] // size).clip(0, data.shape[1] - 1)
    return data[ys][:, xs]


class TerrainBlendMode(enum.IntEnum):
    """reference src/terrain/chunk.rs:13"""

    Smooth = 0
    Sharp = 1


CHUNK_SIZE = 16


@dataclass
class TerrainHit:
    """reference src/terrain/mod.rs:418-425 — editor ray-pick result."""

    world_pos: np.ndarray
    grid_pos: Tuple[int, int]
    height: float


@dataclass
class TerrainChunk:
    """reference src/terrain/chunk.rs:21-35 — per-tile height + source maps."""

    origin: Tuple[int, int]
    heights: np.ndarray = None  # (CHUNK_SIZE+1, CHUNK_SIZE+1) control heights
    sources: Dict[Tuple[int, int], object] = field(default_factory=dict)
    blend_modes: Dict[Tuple[int, int], TerrainBlendMode] = field(default_factory=dict)

    def __post_init__(self):
        if self.heights is None:
            self.heights = np.zeros((CHUNK_SIZE + 1, CHUNK_SIZE + 1), np.float32)


@dataclass
class Terrain:
    chunks: Dict[Tuple[int, int], TerrainChunk] = field(default_factory=dict)
    scale: float = 1.0

    def is_empty(self) -> bool:
        return not self.chunks or all(
            not c.heights.any() and not c.sources for c in self.chunks.values()
        )

    def _chunk_for(self, tx: int, ty: int, create: bool = False) -> Optional[TerrainChunk]:
        key = (tx // CHUNK_SIZE, ty // CHUNK_SIZE)
        c = self.chunks.get(key)
        if c is None and create:
            c = TerrainChunk(origin=(key[0] * CHUNK_SIZE, key[1] * CHUNK_SIZE))
            self.chunks[key] = c
        return c

    def set_height(self, tx: int, ty: int, h: float) -> None:
        c = self._chunk_for(tx, ty, create=True)
        c.heights[ty - c.origin[1], tx - c.origin[0]] = h

    def get_height(self, tx: int, ty: int) -> float:
        c = self._chunk_for(tx, ty)
        if c is None:
            return 0.0
        lx = tx - c.origin[0]
        ly = ty - c.origin[1]
        if 0 <= lx <= CHUNK_SIZE and 0 <= ly <= CHUNK_SIZE:
            return float(c.heights[ly, lx])
        return 0.0

    def set_source(self, tx: int, ty: int, source) -> None:
        c = self._chunk_for(tx, ty, create=True)
        c.sources[(tx, ty)] = source

    def get_source(self, tx: int, ty: int):
        c = self._chunk_for(tx, ty)
        return None if c is None else c.sources.get((tx, ty))

    def sample_height(self, x: float, y: float) -> float:
        """Bilinear height (reference mod.rs:148-175)."""
        gx = x / self.scale
        gy = y / self.scale
        x0 = int(np.floor(gx))
        y0 = int(np.floor(gy))
        fx = gx - x0
        fy = gy - y0
        h00 = self.get_height(x0, y0)
        h10 = self.get_height(x0 + 1, y0)
        h01 = self.get_height(x0, y0 + 1)
        h11 = self.get_height(x0 + 1, y0 + 1)
        return float(
            (h00 * (1 - fx) + h10 * fx) * (1 - fy) + (h01 * (1 - fx) + h11 * fx) * fy
        )

    def heights_at(self, ix, iy) -> np.ndarray:
        """Vectorized get_height over integer tile-index arrays."""
        ix = np.asarray(ix, np.int64)
        iy = np.asarray(iy, np.int64)
        out = np.zeros(ix.shape, np.float32)
        cx = np.floor_divide(ix, CHUNK_SIZE)
        cy = np.floor_divide(iy, CHUNK_SIZE)
        keys = np.unique(np.stack([cx.reshape(-1), cy.reshape(-1)], -1), axis=0)
        for kx, ky in keys:
            c = self.chunks.get((int(kx), int(ky)))
            if c is None:
                continue
            m = (cx == kx) & (cy == ky)
            out[m] = c.heights[iy[m] - c.origin[1], ix[m] - c.origin[0]]
        return out

    def sample_height_many(self, x, y) -> np.ndarray:
        """Vectorized bilinear sample_height over world-coordinate arrays."""
        gx = np.asarray(x, np.float64) / self.scale
        gy = np.asarray(y, np.float64) / self.scale
        x0 = np.floor(gx).astype(np.int64)
        y0 = np.floor(gy).astype(np.int64)
        fx = (gx - x0).astype(np.float32)
        fy = (gy - y0).astype(np.float32)
        h00 = self.heights_at(x0, y0)
        h10 = self.heights_at(x0 + 1, y0)
        h01 = self.heights_at(x0, y0 + 1)
        h11 = self.heights_at(x0 + 1, y0 + 1)
        return (h00 * (1 - fx) + h10 * fx) * (1 - fy) + (
            h01 * (1 - fx) + h11 * fx
        ) * fy

    def compute_steepness_many(self, x, y) -> np.ndarray:
        """Vectorized compute_steepness over world-coordinate arrays."""
        eps = 0.5
        h = self.sample_height_many(x, y)
        hx = self.sample_height_many(np.asarray(x) + eps, y)
        hy = self.sample_height_many(x, np.asarray(y) + eps)
        dx = (hx - h) / max(self.scale, 1e-6)
        dy = (hy - h) / max(self.scale, 1e-6)
        ny = 1.0 / np.sqrt(dx * dx + 1.0 + dy * dy)
        return 1.0 - np.clip(ny, -1.0, 1.0)

    def sample_normal(self, x: float, y: float, eps: float = 0.1) -> np.ndarray:
        """Central-difference normal (reference mod.rs:301+)."""
        hx0 = self.sample_height(x - eps, y)
        hx1 = self.sample_height(x + eps, y)
        hy0 = self.sample_height(x, y - eps)
        hy1 = self.sample_height(x, y + eps)
        n = np.array([hx0 - hx1, 2.0 * eps, hy0 - hy1], np.float32)
        ln = np.linalg.norm(n)
        return n / ln if ln > 0 else np.array([0, 1, 0], np.float32)

    def compute_steepness(self, x: float, y: float) -> float:
        """1 - normal.y of the height field (reference terrain/mod.rs:64-78):
        0 = flat, -> 1 = vertical."""
        eps = 0.5
        h = self.sample_height(x, y)
        hx = self.sample_height(x + eps, y)
        hy = self.sample_height(x, y + eps)
        dx = (hx - h) / max(self.scale, 1e-6)
        dy = (hy - h) / max(self.scale, 1e-6)
        n = np.array([-dx, 1.0, -dy], np.float32)
        n /= max(np.linalg.norm(n), 1e-20)
        return float(1.0 - np.clip(n[1], -1.0, 1.0))

    def exists(self, tx: int, ty: int) -> bool:
        """True if a control height was written at (tx, ty)
        (reference terrain/mod.rs:483-490)."""
        c = self._chunk_for(tx, ty)
        if c is None:
            return False
        lx, ly = tx - c.origin[0], ty - c.origin[1]
        return bool(c.heights[ly, lx] != 0.0) or (tx, ty) in c.sources

    def ray_terrain_hit(self, origin, direction, max_distance: float = 150.0):
        """Editor picking: march a ray against the height field
        (reference terrain/mod.rs:427-480: 0.1-unit steps, then a 4-iter
        binary refine once the ray dips under the surface).

        -> TerrainHit(world_pos, grid_pos, height) or None. The coarse
        march is vectorized over all 1500 sample points at once."""
        o = np.asarray(origin, np.float32)
        d = np.asarray(direction, np.float32)
        step = 0.1
        n = min(1500, max(1, int(np.ceil(max_distance / step))))
        ts = np.arange(n, dtype=np.float32) * step
        pts = o[None, :] + d[None, :] * ts[:, None]
        h = self.sample_height_many(pts[:, 0], pts[:, 2])
        below = pts[:, 1] - h < 0.01
        idx = np.argmax(below)
        if not below[idx]:
            return None
        low = max(float(ts[idx]) - step, 0.0)
        high = float(ts[idx])
        for _ in range(4):
            mid = 0.5 * (low + high)
            p = o + d * mid
            if p[1] - self.sample_height(p[0], p[2]) < 0.01:
                high = mid
            else:
                low = mid
        t_hit = 0.5 * (low + high)
        p = o + d * t_hit
        hh = self.sample_height(float(p[0]), float(p[2]))
        world = np.array([p[0], hh, p[2]], np.float32)
        grid = (
            int(np.floor(world[0] / self.scale)),
            int(np.floor(world[2] / self.scale)),
        )
        return TerrainHit(world_pos=world, grid_pos=grid, height=float(hh))

    def bake_chunk(self, map_, chunk_key: Tuple[int, int], assets,
                   pixels_per_tile: int = 8, palette=None):
        """Bake one chunk's terrain texture: per-tile PixelSource fill
        (reference terrain/mod.rs:318 bake_chunk) followed by the ShapeFX
        geometry-node modifier passes. -> ((S,S,4) u8 | None, height
        overrides dict) or None for a missing chunk; the texture is None
        when the chunk has neither tile sources nor graphs to paint."""
        c = self.chunks.get(chunk_key)
        if c is None:
            return None
        has_graphs = map_ is not None and bool(getattr(map_, "shapefx_graphs", None))
        if not c.sources and not has_graphs:
            # nothing to paint: plain height-only chunks keep the per-tile
            # PixelSource.terrain() path and upload no texture
            return None, {}
        s = CHUNK_SIZE * pixels_per_tile
        tex = np.zeros((s, s, 4), np.uint8)
        tex[..., 3] = 255
        ox, oy = c.origin
        for (tx, ty), src in c.sources.items():
            patch = _source_patch(src, assets, pixels_per_tile)
            if patch is None:
                continue
            lx, ly = (tx - ox) * pixels_per_tile, (ty - oy) * pixels_per_tile
            if 0 <= lx < s and 0 <= ly < s:
                tex[ly : ly + pixels_per_tile, lx : lx + pixels_per_tile] = patch
        heights: Dict[Tuple[int, int], float] = {}
        if has_graphs:
            from ..shapefx.geometry import process_chunk_modifiers

            heights = process_chunk_modifiers(
                map_, self, c, texture=tex, palette=palette
            )
        return tex, heights

    def bounds(self) -> Optional[Tuple[int, int, int, int]]:
        if not self.chunks:
            return None
        xs = [c.origin[0] for c in self.chunks.values()]
        ys = [c.origin[1] for c in self.chunks.values()]
        return (
            min(xs),
            min(ys),
            max(xs) + CHUNK_SIZE,
            max(ys) + CHUNK_SIZE,
        )

    def ray_hit(self, origin, direction, max_dist: float = 100.0, step: float = 0.1):
        """Ray-march against the heightfield (reference mod.rs:427+)."""
        o = np.asarray(origin, np.float32)
        d = np.asarray(direction, np.float32)
        n = np.linalg.norm(d)
        if n == 0:
            return None
        d = d / n
        t = 0.0
        while t < max_dist:
            p = o + d * t
            h = self.sample_height(p[0], p[2])
            if p[1] <= h:
                return p, t
            t += step
        return None

    def build_mesh(self, chunk_key: Tuple[int, int], height_overrides=None,
                   chunk_uvs: bool = False):
        """One quad per tile of a chunk -> (verts4, indices, uvs, normals)
        (reference chunk.rs:253+).

        `height_overrides`: {(tx,ty): h} from the ShapeFX geometry-node
        Height pass (Flatten). `chunk_uvs`: uv spans [0,1] across the whole
        chunk (for the baked chunk texture) instead of per tile."""
        c = self.chunks.get(chunk_key)
        if c is None:
            return None
        ov = height_overrides or {}

        def hgt(tx, ty):
            return ov.get((tx, ty), self.get_height(tx, ty))

        ox, oy = c.origin
        verts, uvs, normals, indices = [], [], [], []
        for ly in range(CHUNK_SIZE):
            for lx in range(CHUNK_SIZE):
                tx, ty = ox + lx, oy + ly
                h00 = hgt(tx, ty)
                h10 = hgt(tx + 1, ty)
                h01 = hgt(tx, ty + 1)
                h11 = hgt(tx + 1, ty + 1)
                base = len(verts)
                s = self.scale
                verts.extend(
                    [
                        [tx * s, h00, ty * s, 1.0],
                        [(tx + 1) * s, h10, ty * s, 1.0],
                        [(tx + 1) * s, h11, (ty + 1) * s, 1.0],
                        [tx * s, h01, (ty + 1) * s, 1.0],
                    ]
                )
                if chunk_uvs:
                    n = float(CHUNK_SIZE)
                    uvs.extend(
                        [
                            [lx / n, ly / n],
                            [(lx + 1) / n, ly / n],
                            [(lx + 1) / n, (ly + 1) / n],
                            [lx / n, (ly + 1) / n],
                        ]
                    )
                else:
                    uvs.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
                for vx, vy in ((tx, ty), (tx + 1, ty), (tx + 1, ty + 1), (tx, ty + 1)):
                    normals.append(self.sample_normal(vx * s, vy * s))
                indices.append((base, base + 2, base + 1))
                indices.append((base, base + 3, base + 2))
        return (
            np.asarray(verts, np.float32),
            np.asarray(indices, np.int32),
            np.asarray(uvs, np.float32),
            np.asarray(normals, np.float32),
        )

"""Built scene chunk (reference src/chunk.rs:23-57).

A spatial unit of renderable geometry: 2D/3D batch lists, opacity batches,
baked terrain, per-chunk lights, occlusion boxes and collision. The Scene
holds chunks keyed by (cx, cy); the packer flattens them into device SoA.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..utils.rect import Rect

CHUNK_SIZE = 16  # world units per chunk (reference scenemanager.rs:67)


@dataclass
class BillboardMetadata:
    """reference src/chunk.rs:11-20"""

    geo_id: int = 0
    position: tuple = (0.0, 0.0, 0.0)
    size: float = 1.0
    is_door: bool = False
    is_window: bool = False


@dataclass
class ChunkCollision:
    """Per-chunk collision shapes (reference src/collision_world.rs:17)."""

    blocking_volumes: List[object] = field(default_factory=list)
    walkable_floors: List[object] = field(default_factory=list)
    dynamic_openings: List[object] = field(default_factory=list)


@dataclass
class Chunk:
    origin: Tuple[int, int] = (0, 0)
    size: int = CHUNK_SIZE
    bbox: Rect = field(default_factory=Rect)

    batches2d: List[object] = field(default_factory=list)
    batches3d: List[object] = field(default_factory=list)
    batches3d_opacity: List[object] = field(default_factory=list)

    terrain_batch2d: Optional[object] = None
    terrain_batch3d: Optional[object] = None
    terrain_texture: Optional[object] = None

    lights: List[object] = field(default_factory=list)
    occluded_sectors: List[Tuple[Rect, float]] = field(default_factory=list)
    collision: ChunkCollision = field(default_factory=ChunkCollision)
    billboards: List[BillboardMetadata] = field(default_factory=list)

    shaders: List[object] = field(default_factory=list)
    shader_textures: Dict[int, object] = field(default_factory=dict)

    def add_shader(self, code: str, assets=None, bake_size: int = 64):
        """Compile a rusteria shader and pre-bake a texture
        (reference src/chunk.rs:84-132)."""
        from ..models.texture import Texture
        from ..shader import Rusteria

        program = Rusteria.parse_and_compile(code)
        if program is None:
            return None
        self.shaders.append(program)
        idx = len(self.shaders) - 1
        if program.shade_index:
            import numpy as np

            img = Rusteria.shade_image(program, bake_size, bake_size)
            u8 = (np.clip(img, 0, 1) * 255 + 0.5).astype("uint8")
            rgba = np.concatenate(
                [u8, np.full((bake_size, bake_size, 1), 255, "uint8")], axis=-1
            )
            tex = Texture(rgba)
            tex.generate_normals(True)
            self.shader_textures[idx] = tex
        return idx

    def get_occlusion(self, point) -> float:
        """reference src/chunk.rs:154-161"""
        x, y = float(point[0]), float(point[1])
        occ = 1.0
        for rect, o in self.occluded_sectors:
            if rect.x <= x <= rect.max_x and rect.y <= y <= rect.max_y:
                occ = min(occ, o)
        return occ

    def sample_terrain_texture(self, world_pos, scale=(1.0, 1.0)):
        """reference src/chunk.rs:135-151"""
        if self.terrain_texture is None:
            return (255, 0, 255, 255)
        u = (float(world_pos[0]) - self.origin[0]) / self.size
        v = (float(world_pos[1]) - self.origin[1]) / self.size
        return self.terrain_texture.sample(u, v)

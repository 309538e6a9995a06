from .chunk import CHUNK_SIZE, BillboardMetadata, Chunk, ChunkCollision
from .d2builder import D2Builder
from .d2builder import D2MaterialBuilder
from .d2preview import D2PreviewBuilder
from .d3builder import D3Builder, resolve_source
from .mapscript import MapScript, compile_source_map
from .terraingen import TerrainConfig, TerrainGenerator, sample_height_at
from .surfacebuilder import (
    SurfaceBillboard,
    build_jamb,
    build_surface_batches,
    build_surface_uvs,
    feature_meshes,
    fix_winding,
    partition_tile_and_blend_overrides,
    read_profile_loops,
    split_loops_for_base,
    subdivide_triangles_into_tiles,
)
from .scenemanager import (
    SceneManager,
    SceneManagerCmd,
    SceneManagerCmdKind,
    SceneManagerResult,
)

__all__ = [
    "CHUNK_SIZE",
    "BillboardMetadata",
    "Chunk",
    "ChunkCollision",
    "D2Builder",
    "D2MaterialBuilder",
    "D2PreviewBuilder",
    "D3Builder",
    "resolve_source",
    "MapScript",
    "compile_source_map",
    "TerrainConfig",
    "TerrainGenerator",
    "sample_height_at",
    "SurfaceBillboard",
    "build_jamb",
    "build_surface_batches",
    "build_surface_uvs",
    "feature_meshes",
    "fix_winding",
    "partition_tile_and_blend_overrides",
    "read_profile_loops",
    "split_loops_for_base",
    "subdivide_triangles_into_tiles",
    "SceneManager",
    "SceneManagerCmd",
    "SceneManagerCmdKind",
    "SceneManagerResult",
]

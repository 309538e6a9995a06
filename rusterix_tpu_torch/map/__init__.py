from .elements import CompiledLinedef, Linedef, Sector, Vertex
from .geometry import earcut, polygon_area, triangulate_polygon
from .meta import MapMeta
from .mini import MapMini
from .particle import Particle, ParticleEmitter
from .softrig import Keyform, SoftRig, SoftRigAnimator
from .surface import (
    BillboardAnimation,
    ExtrusionSpec,
    LoopOp,
    LoopOpKind,
    ProfileLoop,
    Surface,
)
from .terrain import Terrain, TerrainBlendMode, TerrainChunk, TerrainHit
from .value import Value, ValueContainer, ValueKind
from .worldmap import Map, MapCamera, MapToolType

__all__ = [
    "CompiledLinedef",
    "Linedef",
    "Sector",
    "Vertex",
    "earcut",
    "polygon_area",
    "triangulate_polygon",
    "MapMeta",
    "MapMini",
    "Particle",
    "ParticleEmitter",
    "Keyform",
    "SoftRig",
    "SoftRigAnimator",
    "BillboardAnimation",
    "ExtrusionSpec",
    "LoopOp",
    "LoopOpKind",
    "ProfileLoop",
    "Surface",
    "Terrain",
    "TerrainBlendMode",
    "TerrainChunk",
    "TerrainHit",
    "Value",
    "ValueContainer",
    "ValueKind",
    "Map",
    "MapCamera",
    "MapToolType",
]

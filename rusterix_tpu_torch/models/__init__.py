from .assets import Assets, default_palette
from .batch import (
    Batch2D,
    Batch3D,
    CullMode,
    GeometrySource,
    Material,
    MaterialModifier,
    MaterialRole,
    PixelSource,
    PixelSourceKind,
    PrimitiveMode,
    RepeatMode,
    SampleMode,
)
from .blend import MaterialProfileKind, RenderMode, VertexBlendPreset
from .camera import D3Camera, D3FirstPCamera, D3IsoCamera, D3OrbitCamera, Ray
from .hitinfo import HitInfo
from .light import CompiledLight, Light, LightType, pack_lights
from .render_settings import DaylightSimulation, RenderSettings
from .scene import Scene
from .shader import GridShader, Shader, SolidColorShader, VGrayGradientShader
from .texture import Texture, TextureAtlas, Tile, TileRole
from .wavefront import Wavefront

__all__ = [
    "Assets",
    "default_palette",
    "Batch2D",
    "Batch3D",
    "CullMode",
    "GeometrySource",
    "Material",
    "MaterialModifier",
    "MaterialRole",
    "PixelSource",
    "PixelSourceKind",
    "PrimitiveMode",
    "RepeatMode",
    "SampleMode",
    "D3Camera",
    "D3FirstPCamera",
    "D3IsoCamera",
    "D3OrbitCamera",
    "Ray",
    "MaterialProfileKind",
    "RenderMode",
    "VertexBlendPreset",
    "HitInfo",
    "CompiledLight",
    "Light",
    "LightType",
    "pack_lights",
    "Scene",
    "RenderSettings",
    "DaylightSimulation",
    "GridShader",
    "Shader",
    "SolidColorShader",
    "VGrayGradientShader",
    "Texture",
    "TextureAtlas",
    "Tile",
    "TileRole",
    "Wavefront",
]

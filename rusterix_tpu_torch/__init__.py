"""rusterix_tpu_torch — the PyTorch / CUDA port of rusterix_tpu.

The JAX package `rusterix_tpu` stays the reference. This package renders
the 3D frame of `Rasterizer.rasterize` on an NVIDIA GPU through
hand-written CUDA kernels (csrc/), with plain torch versions that run on
the CPU. It imports torch and never jax, and loads no file of the JAX
package: the host-side scene model, builders, map, server, scripting VM
and shape layers (`models`, `builders`, `map`, `utils`, `native`,
`server`, `lang`, `vm`, `shapestack`, `shapefx`, `codegridfx`,
`client`, `rusterix`, `ops.scene_pack`, `ops.matrices`) are the port's own
copies of the JAX package's numpy and plain-Python modules; the path
tracer (`tracer`) is plain torch.

The exports follow the JAX package's (`rusterix_tpu/__init__.py`): the
scene model, the rusteria shader compiler (`Rusteria`, `ShaderProgram`),
the game client (`Client`, `Daylight`, `Draw2D`, `MsgParser`) and the
engine facade (`Rusterix`, `DrawMode`); `Tracer` and `AccumBuffer` are
exported from `rusterix_tpu_torch.tracer`, as the JAX package exports them.
"""

__version__ = "0.1.0"

from .models import (  # noqa: F401
    Assets,
    Batch2D,
    Batch3D,
    CompiledLight,
    CullMode,
    D3Camera,
    DaylightSimulation,
    D3FirstPCamera,
    D3IsoCamera,
    D3OrbitCamera,
    GeometrySource,
    GridShader,
    HitInfo,
    Light,
    LightType,
    Material,
    MaterialModifier,
    MaterialRole,
    PixelSource,
    PixelSourceKind,
    PrimitiveMode,
    Ray,
    RenderSettings,
    RepeatMode,
    SampleMode,
    Scene,
    Shader,
    Texture,
    TextureAtlas,
    Tile,
    TileRole,
    VGrayGradientShader,
    Wavefront,
    pack_lights,
)
from .builders import (  # noqa: F401
    Chunk,
    D2Builder,
    D3Builder,
    MapScript,
    SceneManager,
    compile_source_map,
)
from .client import Client, Daylight, Draw2D, MsgParser  # noqa: F401
from .device import resolve_device  # noqa: F401
from .map import (  # noqa: F401
    CompiledLinedef,
    Linedef,
    Map,
    MapCamera,
    MapMini,
    Sector,
    Terrain,
    Value,
    ValueContainer,
    Vertex,
)
from .ops.matrices import invert, look_at_rh  # noqa: F401
from .ops.raster import Rasterizer, packed_to_torch, render_frame  # noqa: F401
from .ops.scene_pack import PackedScene  # noqa: F401
from .rusterix import DrawMode, Rusterix  # noqa: F401
from .server import (  # noqa: F401
    CollisionWorld,
    Entity,
    EntityAction,
    EntityActionKind,
    EntityUpdate,
    Item,
    PlayerCamera,
    RegionMessage,
    Wallet,
)
from .server.server import Server  # noqa: F401
from .shader import Program as ShaderProgram, Rusteria  # noqa: F401
from .vm import VM, VMValue  # noqa: F401
from .utils import (  # noqa: F401
    BLACK,
    TRANSPARENT,
    WHITE,
    Rect,
    hash_u32,
    pixel_to_vec4,
    vec4_to_pixel,
)

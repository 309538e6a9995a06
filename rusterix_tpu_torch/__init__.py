"""rusterix_tpu_torch — the PyTorch / CUDA port of rusterix_tpu.

The JAX package `rusterix_tpu` stays the reference. This package renders
the 3D frame of `Rasterizer.rasterize` on an NVIDIA GPU through
hand-written CUDA kernels (csrc/), with plain torch versions that run on
the CPU. It imports torch and never jax, and loads no file of the JAX
package: the host-side scene model, builders and packer (`models`,
`builders`, `map`, `utils`, `native`, `ops.scene_pack`, `ops.matrices`)
are the port's own copies of the JAX package's numpy modules.
"""

from .builders import D3Builder, MapScript  # noqa: F401
from .device import resolve_device  # noqa: F401
from .models import (  # noqa: F401
    Assets,
    Batch3D,
    D3Camera,
    D3FirstPCamera,
    D3IsoCamera,
    D3OrbitCamera,
    Light,
    LightType,
    PixelSource,
    SampleMode,
    Scene,
    Texture,
    pack_lights,
)
from .ops.matrices import invert, look_at_rh  # noqa: F401
from .ops.raster import Rasterizer, packed_to_torch, render_frame  # noqa: F401
from .ops.scene_pack import PackedScene  # noqa: F401

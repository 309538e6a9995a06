"""rusterix_tpu_torch — the PyTorch / CUDA port of rusterix_tpu.

The JAX package `rusterix_tpu` stays the reference. This package renders
the opaque 3D frame (`Rasterizer.rasterize`) on an NVIDIA GPU through one
hand-written CUDA kernel (csrc/megakernel.cu), with plain torch versions
that run on the CPU. It imports torch and never jax: the host-side scene
model, builders and packer are the JAX package's numpy modules, mounted
without their jax-importing package files (see `_host`).
"""

from ._host import (  # noqa: F401
    Assets,
    Batch3D,
    D3Builder,
    D3Camera,
    D3FirstPCamera,
    D3IsoCamera,
    D3OrbitCamera,
    Light,
    LightType,
    MapScript,
    PackedScene,
    PixelSource,
    SampleMode,
    Scene,
    Texture,
    invert,
    look_at_rh,
    pack_lights,
)
from .device import resolve_device  # noqa: F401
from .ops.raster import Rasterizer, packed_to_torch, render_frame  # noqa: F401

"""The jax-free host layer: the JAX package's numpy modules, mounted.

`rusterix_tpu`'s scene model, map builders, scene packer and matrix
helpers are plain numpy. Its two package `__init__` files (the top one and
`ops/`) import jax, and a machine that runs the port has no jax. So this
module mounts `rusterix_tpu/` and `rusterix_tpu/ops/` under the private
name `rusterix_tpu_torch._ref` as bare namespace packages whose `__path__`
points at the JAX package's directories: neither `__init__.py` runs, and
`_ref.models`, `_ref.builders`, `_ref.map`, `_ref.ops.scene_pack` and
`_ref.ops.matrices` load from the very same files. Packing is therefore the
same as the JAX package's by construction.

The mount is the same in every process, whether jax is installed or not.
The one lazily imported jax-backed package on this path, `shader` (the
rusteria compiler, reached only when a scene carries rusteria shaders), is
replaced by a stub that raises `NotImplementedError` on use.
"""

from __future__ import annotations

import importlib
import importlib.machinery
import importlib.util
import os
import sys
import types

_JAX_PKG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rusterix_tpu"
)
_REF = __name__.rsplit(".", 1)[0] + "._ref"


def _namespace(name: str, path: str) -> types.ModuleType:
    spec = importlib.machinery.ModuleSpec(name, None, is_package=True)
    spec.submodule_search_locations = [path]
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    return mod


class _ShaderStub(types.ModuleType):
    """Stands in for `rusterix_tpu.shader` (the jax shader compiler)."""

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise NotImplementedError(
            f"rusteria shaders ({attr}) need the shader compiler, which "
            "rusterix_tpu_torch has not ported yet"
        )


def _mount() -> None:
    if _REF in sys.modules:
        return
    root = _namespace(_REF, _JAX_PKG)
    root.ops = _namespace(_REF + ".ops", os.path.join(_JAX_PKG, "ops"))
    # `from ..shader import Rusteria` and `from ..shader.jaxc import Rusteria`
    # (the packer's bake path) both land on the stub
    stub = _ShaderStub(_REF + ".shader")
    stub.__path__ = []
    stub.jaxc = _ShaderStub(_REF + ".shader.jaxc")
    sys.modules[stub.__name__] = stub
    sys.modules[stub.jaxc.__name__] = stub.jaxc
    root.shader = stub


_mount()


def ref_module(name: str) -> types.ModuleType:
    """Import `rusterix_tpu.<name>` through the mount (no jax)."""
    return importlib.import_module(f"{_REF}.{name}")


_models = ref_module("models")
_builders = ref_module("builders")
_matrices = ref_module("ops.matrices")
_scene_pack = ref_module("ops.scene_pack")

Scene = _models.Scene
Batch3D = _models.Batch3D
Assets = _models.Assets
Texture = _models.Texture
Light = _models.Light
LightType = _models.LightType
D3Camera = _models.D3Camera
D3FirstPCamera = _models.D3FirstPCamera
D3IsoCamera = _models.D3IsoCamera
D3OrbitCamera = _models.D3OrbitCamera
PixelSource = _models.PixelSource
SampleMode = _models.SampleMode
pack_lights = _models.pack_lights
PackedScene = _scene_pack.PackedScene
SRC_OFF = _scene_pack.SRC_OFF
SRC_TEXTURE = _scene_pack.SRC_TEXTURE
SRC_PIXEL = _scene_pack.SRC_PIXEL
next_pow2 = _scene_pack.next_pow2
D3Builder = _builders.D3Builder
MapScript = _builders.MapScript
look_at_rh = _matrices.look_at_rh
invert = _matrices.invert

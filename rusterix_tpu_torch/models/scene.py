"""Scene container (reference src/scene.rs:8-50).

The host Scene owns batch lists, lights, dynamic tile textures, shaders and
built chunks. There is no `project` method here: projection is performed
device-side by the jitted setup pass over the packed scene
(ops/setup_pass.py), replacing the reference's rayon fan-out
(src/scene.rs:154-200).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .batch import Batch2D, Batch3D
from .light import CompiledLight
from .shader import Shader
from .texture import Tile


@dataclass
class Scene:
    background: Optional[Shader] = None
    lights: List[CompiledLight] = field(default_factory=list)
    dynamic_lights: List[CompiledLight] = field(default_factory=list)
    d3_static: List[Batch3D] = field(default_factory=list)
    d3_dynamic: List[Batch3D] = field(default_factory=list)
    #: dynamic transparent batches (animated door billboards etc.)
    d3_dynamic_opacity: List[Batch3D] = field(default_factory=list)
    d3_overlay: List[Batch3D] = field(default_factory=list)
    d2_static: List[Batch2D] = field(default_factory=list)
    d2_dynamic: List[Batch2D] = field(default_factory=list)
    dynamic_textures: List[Tile] = field(default_factory=list)
    animation_frame: int = 1
    #: bump touch_dynamic() after editing only the dynamic lists (entity
    #: billboards, floating 2D) — the static device cache stays valid
    dynamic_revision: int = 0
    #: bump (or call touch()) after editing batches/lights so cached device
    #: buffers are re-uploaded; animation_frame changes do NOT require it
    revision: int = 0
    mapmini: object = None
    shaders: List[object] = field(default_factory=list)  # compiled shader programs
    shaders_with_opacity: List[bool] = field(default_factory=list)
    chunks: Dict[Tuple[int, int], object] = field(default_factory=dict)

    @staticmethod
    def empty() -> "Scene":
        return Scene()

    @staticmethod
    def from_static(d2: List[Batch2D], d3: List[Batch3D]) -> "Scene":
        return Scene(d2_static=list(d2), d3_static=list(d3))

    # builder-style setters (reference scene.rs:137-151)
    def set_background(self, shader: Shader) -> "Scene":
        self.background = shader
        return self

    def set_lights(self, lights: List[CompiledLight]) -> "Scene":
        self.lights = list(lights)
        return self

    def add_shader(self, code: str) -> Optional[int]:
        """Compile a rusteria shader source (reference scene.rs:108-134).

        Compilation targets a jitted JAX pixel function (shader/compiler.py)
        instead of the reference's bytecode interpreter.
        """
        if not code:
            return None
        from ..shader import Rusteria

        program = Rusteria.parse_and_compile(code)
        if program is None:
            return None
        self.shaders.append(program)
        self.shaders_with_opacity.append(program.supports_opacity)
        return len(self.shaders) - 1

    def anim_tick(self) -> None:
        """reference scene.rs:149-151"""
        self.animation_frame += 1

    def touch_dynamic(self) -> None:
        """Dynamic-only edit: entity billboards / floating 2D changed."""
        self.dynamic_revision += 1

    def touch(self) -> None:
        """Mark scene content changed (device buffers will be re-uploaded)."""
        self.revision += 1

    def compute_static_normals(self) -> None:
        for b in self.d3_static:
            b.compute_vertex_normals()

    def compute_dynamic_normals(self) -> None:
        for b in self.d3_dynamic:
            b.compute_vertex_normals()

    def all_d3_batches(self, include_dynamic: bool = True):
        """Opaque 3D batches in reference draw order (chunks, static, dynamic,
        overlay — src/rasterizer.rs:312-405). With include_dynamic=False the
        dynamic list is left out (it packs separately per frame; z-buffering
        makes the order deviation observable only on exact z-ties)."""
        batches = []
        for chunk in self.chunks.values():
            batches.extend(getattr(chunk, "batches3d", []))
            tb = getattr(chunk, "terrain_batch3d", None)
            if tb is not None:
                batches.append(tb)
        batches.extend(self.d3_static)
        if include_dynamic:
            batches.extend(self.d3_dynamic)
        batches.extend(self.d3_overlay)
        return batches

    def all_d3_opacity_batches(self, include_dynamic: bool = True):
        batches = []
        for chunk in self.chunks.values():
            batches.extend(getattr(chunk, "batches3d_opacity", []))
        if include_dynamic:
            batches.extend(self.d3_dynamic_opacity)
        return batches

    def all_d2_batches(self, include_dynamic: bool = True):
        batches = []
        for chunk in self.chunks.values():
            batches.extend(getattr(chunk, "batches2d", []))
            tb = getattr(chunk, "terrain_batch2d", None)
            if tb is not None:
                batches.append(tb)
        batches.extend(self.d2_static)
        if include_dynamic:
            batches.extend(self.d2_dynamic)
        return batches

    def all_lights(self):
        lights = list(self.lights) + list(self.dynamic_lights)
        for chunk in self.chunks.values():
            lights.extend(getattr(chunk, "lights", []))
        return lights

    def intersect(self, ray, d2: bool = False):
        """Brute-force ray intersection over all batches
        (reference scene.rs:217-276)."""
        best = None
        for bi, batch in enumerate(self.all_d3_batches()):
            hit = batch.intersect(ray)
            if hit is not None and (best is None or hit.t < best.t):
                hit.batch_index = bi
                best = hit
        return best

"""Rasterizer facade — the public render API of the port (counterpart of
`rusterix_tpu/ops/raster.py`, its megakernel branch).

`Rasterizer.setup(None, view, proj, device="cuda").rasterize(scene, W, H,
tile, assets)` packs the scene on the host (the port's copy of the JAX
package's numpy packer, `ops/scene_pack.py`), uploads it once into a scene
cache, and renders each frame as: setup pass -> megakernel table + Morton /
front-to-back sort -> the megakernel (B1) -> RGBA8 unpack. With GGX
reflections (`set_reflections`), the visibility pre-pass (B2) rebuilds the
G-buffer's winners, the reflection rays go through the ray-intersect
kernel (B3), and the reflections are composited over the opaque frame.
The 2D line overlay is drawn last, on the host. Every feature outside that
slice raises `NotImplementedError` naming it; none degrades silently.
"""

from __future__ import annotations

import uuid
from typing import Optional

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..models import Assets, SampleMode, pack_lights
from ..models.blend import RenderMode
from ..utils.color import hash_u32, srgb_to_linear_fast
from .megakernel import (
    light_spec_from,
    mega_render,
    morton_ftb_sort,
    pack_background_u32,
    pack_light_params,
    pack_mega_params,
    pack_mega_table,
    pack_occ_params,
    unpack_frame_u32,
)
from .composite import frame_to_u8
from .matrices import invert
from .reflect import apply_reflections, reflection_pass_scaled
from .scene_pack import PackedScene, next_pow2
from .setup_pass import setup_pass
from .visibility_pallas import visibility_pass_pallas


def packed_to_torch(packed: PackedScene, device) -> dict:
    """The JAX package's numpy PackedScene -> the port's device tensors:
    {"d3": {field: tensor}, "atlas": {"flat_u32" (N,) i32 holding the u32
    texels, "w" int, "rects", "tile_first", "tile_count"}}."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    atlas = packed.atlas_index.atlas
    texels = np.ascontiguousarray(atlas.data.reshape(-1, 4)).view(np.int32).reshape(-1)
    return {
        "d3": {k: put(v) for k, v in vars(packed.d3).items() if v is not None},
        "atlas": {
            "flat_u32": put(texels),
            "w": int(atlas.data.shape[1]),
            "rects": put(atlas.rects),
            "tile_first": put(atlas.tile_first),
            "tile_count": put(atlas.tile_count),
        },
    }


def frame_inputs(d3, lights, atlas, uniforms, background, width: int,
                 height: int, sample_mode: int = 0, has_fog: bool = False,
                 light_spec: tuple = None, sun_off: bool = False,
                 brdf_ggx: bool = False, refl_samples: int = 0,
                 refl_scale: int = 1) -> dict:
    """The frame's preparation before its kernels: setup pass, megakernel
    table, Morton + front-to-back sort and the parameter packs -> dict with
    the setup pass's `attr` and `tri_id`, the sorted `vis_s`, `alive_s`,
    `bbox_s`, the sorted position -> slot permutation `sort_perm`, and
    `mega_args` / `mega_kwargs` for mega_render.

    d3/atlas: packed_to_torch tensors; lights/uniforms: the host (numpy)
    dicts the Rasterizer builds each frame (pack_light_params,
    pack_mega_params and pack_occ_params carry them to the device);
    background (H, W, 4) f32 on the device. The reflection settings are
    read by render_frame."""
    dev = d3["pos"].device
    vis, attr, bbox, alive, tri_id = setup_pass(
        d3["pos"], d3["uv"], d3["nrm"], d3["valid"], d3["cull"],
        torch.from_numpy(uniforms["view"]).to(dev),
        torch.from_numpy(uniforms["proj"]).to(dev),
        width, height,
    )
    table = pack_mega_table(attr, tri_id, d3, atlas, int(uniforms["anim_frame"]), False)
    vis_s, bbox_s, alive_s, table_s, s_near, sort_perm = morton_ftb_sort(
        vis, bbox, alive.float(), table, width, height, return_perm=True
    )
    args = (
        vis_s, alive_s, bbox_s, table_s, atlas["flat_u32"],
        pack_background_u32(background),
        pack_mega_params(uniforms, width, height, atlas["w"], dev, has_fog),
        pack_light_params(lights, dev),
        pack_occ_params(uniforms, dev),
        width, height, sample_mode,
    )
    return {
        "attr": attr, "tri_id": tri_id,
        "vis_s": vis_s, "alive_s": alive_s, "bbox_s": bbox_s, "sort_perm": sort_perm,
        "mega_args": args,
        "mega_kwargs": {"light_spec": light_spec, "sun_off": sun_off, "s_near": s_near,
                        "brdf_ggx": brdf_ggx},
    }


def visibility_prepass(fi: dict, width: int, height: int):
    """The G-buffer's visibility before shading (B2 on the sorted
    candidates) -> (z, idx, hit) with idx mapped back to the setup pass's
    slots through the sort permutation."""
    z, i_s, hit = visibility_pass_pallas(fi["vis_s"], fi["alive_s"], fi["bbox_s"], width, height)
    idx = torch.where(hit, fi["sort_perm"][torch.clamp(i_s, min=0).long()], -1)
    return z, idx, hit


def render_frame(d3, lights, atlas, uniforms, background, width: int,
                 height: int, sample_mode: int = 0, has_fog: bool = False,
                 light_spec: tuple = None, sun_off: bool = False,
                 brdf_ggx: bool = False, refl_samples: int = 0,
                 refl_scale: int = 1):
    """One 3D frame on the device -> (H, W, 4) uint8 tensor: the JAX
    render_frame's megakernel branch (ops/raster.py:233-387 and :500
    there). The opaque frame comes from the megakernel (B1); with
    reflections, the visibility pre-pass (B2) gives the G-buffer its
    winners before shading, the reflection pass traces its rays through the
    ray-intersect kernel (B3), and the result is composited in f32 over the
    quantized opaque frame. Arguments as for frame_inputs."""
    fi = frame_inputs(
        d3, lights, atlas, uniforms, background, width, height, sample_mode,
        has_fog, light_spec, sun_off, brdf_ggx,
    )
    pre = visibility_prepass(fi, width, height) if refl_samples else None
    rgba_u32, _z_eff = mega_render(*fi["mega_args"], **fi["mega_kwargs"])
    if not refl_samples:
        return unpack_frame_u32(rgba_u32)
    # the passes after the opaque frame blend in f32 over its quantized
    # bytes, as the reference's u8 tile buffer does (rasterizer.rs:464-495)
    frame = unpack_frame_u32(rgba_u32).float() * (1.0 / 255.0)
    refl, rmask = reflection_pass_scaled(
        *pre, fi["attr"], fi["tri_id"], d3, atlas, lights, uniforms,
        width, height, sample_mode, refl_samples, scale=refl_scale,
    )
    return frame_to_u8(apply_reflections(frame, refl, rmask))


def draw_lines_bresenham(pixels: np.ndarray, segments: np.ndarray, colors: np.ndarray):
    """Exact port of rasterize_line_bresenham (src/rasterizer.rs:1777-1841)
    over the full frame. Mutates `pixels` (H,W,4)."""
    if len(segments) and native.draw_lines_native(pixels, segments, colors):
        return
    h, w = pixels.shape[:2]
    for (x0f, y0f, x1f, y1f), color in zip(segments, colors):
        x0, y0, x1, y1 = int(x0f), int(y0f), int(x1f), int(y1f)
        dx = abs(x1 - x0)
        dy = abs(y1 - y0)
        sx = 1 if x0 < x1 else -1
        sy = 1 if y0 < y1 else -1
        err = dx - dy
        x, y = x0, y0
        while x != x1 or y != y1:
            if 0 <= x < w and 0 <= y < h:
                pixels[y, x] = color
            e2 = err * 2
            if e2 > -dy:
                err -= dy
                x += sx
            if e2 < dx:
                err += dx
                y += sy


#: process-wide device-resident scene cache (survives Rasterizer instances:
#: the reference constructs a fresh Rasterizer::setup every frame)
_SCENE_CACHE: dict = {}
_BG_CACHE: dict = {}


def _unported(feature: str):
    return NotImplementedError(f"{feature} is not ported to rusterix_tpu_torch yet")


class Rasterizer:
    """Public API mirroring the reference (src/rasterizer.rs:92-185), on
    the device the caller names."""

    def __init__(self, projection_matrix_2d, view_matrix, projection_matrix,
                 device=None):
        self.device = resolve_device(device)
        self.projection_matrix_2d = projection_matrix_2d
        self.view_matrix = np.asarray(view_matrix, np.float32)
        self.projection_matrix = np.asarray(projection_matrix, np.float32)
        self.inverse_view_matrix = invert(self.view_matrix)
        self.inverse_projection_matrix = invert(self.projection_matrix)
        self.camera_pos = self.inverse_view_matrix[:3, 3].copy()
        if projection_matrix_2d is not None:
            self.proj2d = np.asarray(projection_matrix_2d, np.float32)
        else:
            self.proj2d = np.eye(3, dtype=np.float32)

        self.render_mode = RenderMode.render_all()
        self.sample_mode = SampleMode.Nearest
        self.background_color: Optional[tuple] = None
        self.ambient_color: Optional[np.ndarray] = None
        self.hour = 12.0
        self.time = 0.0
        self.sun_dir: Optional[np.ndarray] = None
        self.sun_color: Optional[np.ndarray] = None
        self.day_factor = 0.0
        self.hash_anim = 0
        self._rs_has_fog = False
        self._rs_bump_strength = 1.0
        self._fog_color = np.zeros(4, np.float32)
        self._fog_end = 1e9
        self._fog_fade = 1.0
        #: 0 = the ShapeFX Fog node's linear fade, 1 = SceneVM exp^2 fog
        self._fog_mode = 0.0
        self._fog_density = 0.0
        #: range cap of reflection rays (RenderSettings max_sky_distance)
        self._rs_sky_distance = 50.0
        #: direct-light BRDF: "fast" (Blinn-Phong) or "ggx" (set_brdf)
        self.brdf = "fast"
        #: GGX reflection rays per pixel, 0 = off (set_reflections)
        self.reflection_samples = 0
        self.reflection_scale = 1
        #: depth-peeled transparency layers (RenderSettings
        #: max_transparency_bounces); they matter with opacity batches only
        self.transparency_layers = 1
        # features of the JAX Rasterizer outside the ported slice; set them
        # and rasterize() raises NotImplementedError naming them
        self.supersample = 1
        self.tonemap = "srgb"
        self.sky_light_enabled = False
        self.shadow_settings = None
        self.ao_settings = None
        self.render_graph = None
        self.brush_preview = None
        #: the last frame's render_frame arguments (every tensor in it is
        #: held by the scene cache anyway); checks re-run the kernel and
        #: its plain version on them
        self.frame_args: Optional[dict] = None

    @staticmethod
    def setup(projection_matrix_2d, view_matrix, projection_matrix,
              device=None) -> "Rasterizer":
        return Rasterizer(projection_matrix_2d, view_matrix, projection_matrix, device)

    def set_brdf(self, model: str) -> "Rasterizer":
        """Direct-light shading model of the 3D pass: "fast" (Blinn-Phong
        with Schlick Fresnel, rasterizer.rs:1906-1951) or "ggx" (Cook-Torrance
        with the GGX NDF, 3d_shader.wgsl:559-650)."""
        model = str(model).lower()
        if model not in ("fast", "ggx"):
            raise ValueError(f"unknown brdf model '{model}' (fast|ggx)")
        self.brdf = model
        return self

    def set_reflections(self, samples: int, scale: int = None) -> "Rasterizer":
        """GGX importance-sampled reflection rays per pixel (0 disables),
        range-capped by max_sky_distance (3d_shader.wgsl:764-826). `scale`
        > 1 (reflections at 1/scale resolution) is not ported: rasterize()
        raises on it."""
        self.reflection_samples = max(0, int(samples))
        if scale is not None:
            self.reflection_scale = max(1, int(scale))
        return self

    # builder-style setters (rasterizer.rs:155-182)
    def set_render_mode(self, mode) -> "Rasterizer":
        self.render_mode = mode
        return self

    def background(self, pixel) -> "Rasterizer":
        self.background_color = tuple(int(c) for c in pixel)
        return self

    def ambient(self, rgba) -> "Rasterizer":
        self.ambient_color = np.asarray(rgba, np.float32)
        return self

    def set_sample_mode(self, mode) -> "Rasterizer":
        self.sample_mode = mode
        return self

    def set_time(self, t: float) -> "Rasterizer":
        self.time = t
        return self

    def apply_render_settings(self, rs, hour: float = None) -> "Rasterizer":
        """Sky color, sun, ambient, exp^2 fog, the reflection samples and
        their range cap from a RenderSettings block (reference
        src/render_settings.rs:10-120). The block's shadow and AO knobs
        belong to unported passes."""
        if hour is not None:
            self.hour = hour
        if rs.simulation.enabled:
            rs.apply_hour(self.hour)
        self.background_color = tuple(int(round(c * 255.0)) for c in rs.sky_color) + (255,)
        if rs.sun_enabled:
            self.sun_dir = np.asarray(rs.sun_direction, np.float32)
            self.sun_color = np.asarray(rs.sun_color, np.float32)
            self.day_factor = float(rs.sun_intensity)
        else:
            self.sun_dir = None
            self.day_factor = 0.0
        amb = np.asarray(rs.ambient_color, np.float32) * float(rs.ambient_strength)
        self.ambient_color = np.concatenate([amb, [1.0]]).astype(np.float32)
        self._rs_sky_distance = float(rs.max_sky_distance)
        self.reflection_samples = max(0, int(rs.reflection_samples))
        self.transparency_layers = int(np.clip(rs.max_transparency_bounces, 1, 8))
        self._rs_bump_strength = float(np.clip(rs.bump_strength, 0.0, 1.0))
        if rs.fog_density > 0.0:
            self._rs_has_fog = True
            self._fog_color = np.asarray(tuple(rs.fog_color) + (1.0,), np.float32)
            self._fog_mode = 1.0
            self._fog_density = float(rs.fog_density)
            self._fog_end = 0.0
            self._fog_fade = 1.0 / max(float(rs.fog_density), 1e-6)
        else:
            self._rs_has_fog = False
            self._fog_mode = 0.0
        return self

    # -- helpers --

    def _background_array(self, scene, width, height) -> np.ndarray:
        """Background fill + optional background shader bake
        (rasterizer.rs:277-308). Returns (H,W,4) f32 0..1."""
        key = (
            getattr(scene, "_cache_uid", None),
            scene.background is not None,
            width,
            height,
            self.background_color,
        )
        cached = _BG_CACHE.get(key)
        if cached is not None:
            return cached
        if scene.background is not None:
            bg_u8 = np.asarray(scene.background.shade_grid(width, height, np))
            bg = bg_u8.astype(np.float32) / 255.0
        elif self.background_color is not None:
            bg = np.broadcast_to(
                np.asarray(self.background_color, np.float32) / 255.0, (height, width, 4)
            ).copy()
        else:
            bg = np.zeros((height, width, 4), np.float32)
        if len(_BG_CACHE) > 8:
            _BG_CACHE.clear()
        _BG_CACHE[key] = bg
        return bg

    def _flicker_factors(self, lights) -> np.ndarray:
        """Per-light flicker factor for this frame (light.rs:656-672)."""
        out = np.ones(len(lights["valid"]), np.float32)
        for i in range(len(out)):
            fl = float(lights["flicker"][i])
            if fl > 0.0:
                x, y, z = lights["position"][i]

                def as_u32(val):
                    if not np.isfinite(val) or val <= 0.0:
                        return 0
                    return min(int(val), 0xFFFFFFFF)

                combined = (
                    self.hash_anim + (as_u32(x) + as_u32(y) + as_u32(z)) * 100
                ) & 0xFFFFFFFF
                out[i] = 1.0 - min(1.0, combined / 0xFFFFFFFF) * fl
        return out

    def _uniforms(self, scene) -> dict:
        amb = self.ambient_color if self.ambient_color is not None else np.zeros(4, np.float32)
        sun = self.sun_dir if self.sun_dir is not None else np.array([0, -1, 0], np.float32)
        sun_c = self.sun_color if self.sun_color is not None else np.ones(3, np.float32)
        return {
            "view": np.asarray(self.view_matrix, np.float32),
            "proj": np.asarray(self.projection_matrix, np.float32),
            "inv_view": np.asarray(self.inverse_view_matrix, np.float32),
            "inv_proj": np.asarray(self.inverse_projection_matrix, np.float32),
            "camera_pos": np.asarray(self.camera_pos, np.float32),
            "ambient": np.asarray(amb, np.float32),
            "has_ambient": np.float32(1.0 if self.ambient_color is not None else 0.0),
            "sun_dir": np.asarray(sun, np.float32),
            "sun_color": np.asarray(sun_c, np.float32),
            "day_factor": np.float32(self.day_factor),
            "has_sun": np.float32(
                1.0 if (self.sun_dir is not None and self.day_factor > 0) else 0.0
            ),
            "anim_frame": np.int32(scene.animation_frame),
            "time": np.float32(self.time),
            "fog_color": np.asarray(self._fog_color, np.float32),
            "fog_end": np.float32(self._fog_end),
            "fog_fade": np.float32(self._fog_fade),
            "fog_mode": np.float32(self._fog_mode),
            "fog_density": np.float32(self._fog_density),
            "refl_dist": np.float32(self._rs_sky_distance),
            "refl_sky": self._refl_sky_linear(),
            "bump_strength": np.float32(self._rs_bump_strength),
        }

    def _refl_sky_linear(self) -> np.ndarray:
        """Linear sky color reflected by rays that miss (the WGSL picks the
        sky color, 3d_shader.wgsl:797; the background fill is the sky color
        after apply_render_settings)."""
        bg = self.background_color
        if bg is None:
            return np.zeros(3, np.float32)
        return np.asarray(srgb_to_linear_fast(np.asarray(bg[:3], np.float32) / 255.0), np.float32)

    def _refuse_unported_settings(self, mesh):
        refl = self.reflection_samples > 0
        checks = {
            "mesh= (the multi-chip row-sharded frame)": mesh is not None,
            "SSAA > 1 (set_supersample)": self.supersample > 1,
            "the scenevm tonemap": self.tonemap != "srgb",
            "reflections at a reduced scale (reflection_scale > 1)": refl
            and self.reflection_scale > 1,
            "reflections with shadows": refl and self.shadow_settings is not None,
            "sky light": self.sky_light_enabled,
            "shadows": self.shadow_settings is not None,
            "ambient occlusion": self.ao_settings is not None,
            "render-graph sky/fog nodes": self.render_graph is not None,
            "the brush preview": self.brush_preview is not None,
        }
        for name, on in checks.items():
            if on:
                raise _unported(name)

    def _refuse_unported_scene(self, scene, packed):
        d3 = packed.d3
        opacity = self.render_mode.d3_active and bool(packed.d3_opacity.valid.any())
        checks = {
            "reflections on transparency layers (transparency_layers > 1)": opacity
            and self.reflection_samples > 0 and self.transparency_layers > 1,
            "dynamic batches": bool(
                scene.d3_dynamic or scene.d3_dynamic_opacity or scene.d2_dynamic
            ),
            "runtime or baked shaders": bool(getattr(scene, "shaders", None))
            or bool(packed.runtime_shaders),
            "opacity batches": opacity,
            "2D batches": self.render_mode.d2_active and bool(packed.d2.valid.any()),
            "vertex blend": bool((d3.kind2 >= 0).any()),
            "material": bool((d3.rough != 0.5).any() or d3.metal.any()),
            "matmap": bool((d3.m1_slot >= 0).any()),
        }
        for name, on in checks.items():
            if on:
                raise _unported(name)

    def rasterize(
        self,
        scene,
        width: int,
        height: int,
        tile_size: int = 128,
        assets=None,
        packed: Optional[PackedScene] = None,
        readback: bool = True,
        mesh=None,
    ):
        """Render the scene -> (H, W, 4) uint8 numpy frame.

        `tile_size` is accepted for API parity; the kernel's tiling is its
        own. `readback=False` returns the (H, W, 4) uint8 tensor on the
        device instead (no copy to the host; the 2D line overlay is skipped
        in that mode). `packed` renders a PackedScene built elsewhere (e.g.
        by the JAX package) instead of packing the scene."""
        self._refuse_unported_settings(mesh)
        if assets is None:
            assets = Assets.default()
        self.hash_anim = hash_u32(scene.animation_frame & 0xFFFFFFFF)

        # device-resident scene cache, keyed by uuid tokens (not id(), which
        # CPython reuses after GC) and the device
        if not hasattr(scene, "_cache_uid"):
            scene._cache_uid = uuid.uuid4().hex
        if not hasattr(assets, "_cache_uid"):
            assets._cache_uid = uuid.uuid4().hex
        key = (scene._cache_uid, scene.revision, assets._cache_uid, str(self.device))
        cache = _SCENE_CACHE.get(key)
        if cache is None or packed is not None:
            if packed is None:
                packed = PackedScene.from_scene(scene, assets, static_only=True)
            cache = {"packed": packed, **packed_to_torch(packed, self.device)}
            _SCENE_CACHE.clear()  # one live packed scene per process is enough
            _SCENE_CACHE[key] = cache
        packed = cache["packed"]
        self._refuse_unported_scene(scene, packed)
        d3 = cache["d3"]
        if not self.render_mode.d3_active:
            d3 = dict(d3, valid=torch.zeros_like(d3["valid"]))

        # lights repack every frame (they're tiny): the reference reads
        # light positions fresh per frame
        live_lights = scene.all_lights()
        cap = packed.lights["valid"].shape[0]
        if len(live_lights) > cap:
            cap = next_pow2(len(live_lights), lo=4)
        lights = pack_lights(live_lights, cap)
        lights["flicker_factor"] = self._flicker_factors(lights)

        uniforms = self._uniforms(scene)
        if packed.occlusion is not None:
            uniforms["occ_box"] = packed.occlusion["occ_box"]
            uniforms["occ_val"] = packed.occlusion["occ_val"]

        if self.render_mode.ignore_background_shader and scene.background is not None:
            scene_bg = scene.background
            scene.background = None
            bg_np = self._background_array(scene, width, height)
            scene.background = scene_bg
        else:
            bg_np = self._background_array(scene, width, height)
        hit = cache.get("background")
        if hit is None or hit[0] is not bg_np:
            hit = (bg_np, torch.from_numpy(bg_np).to(self.device))
            cache["background"] = hit
        background = hit[1]

        frame_args = dict(
            d3=d3, lights=lights, atlas=cache["atlas"], uniforms=uniforms,
            background=background, width=width, height=height,
            sample_mode=int(self.sample_mode),
            has_fog=self._rs_has_fog,
            light_spec=light_spec_from(lights),
            sun_off=not (self.sun_dir is not None and self.day_factor > 0),
            brdf_ggx=self.brdf == "ggx",
            refl_samples=self.reflection_samples if self.render_mode.d3_active else 0,
            refl_scale=self.reflection_scale,
        )
        self.frame_args = frame_args
        frame = render_frame(**frame_args)
        if not readback:
            return frame
        out = frame.cpu().numpy()

        segs = packed.d2_lines.segments
        if len(segs):
            ones = np.ones((len(segs), 1), np.float32)
            p0 = np.concatenate([segs[:, 0:2], ones], axis=1) @ self.proj2d.T
            p1 = np.concatenate([segs[:, 2:4], ones], axis=1) @ self.proj2d.T
            projected = np.concatenate([p0[:, :2], p1[:, :2]], axis=1)
            out = out.copy()
            draw_lines_bresenham(out, projected, packed.d2_lines.colors)
        return out

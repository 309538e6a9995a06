"""Rasterizer facade — the public render API of the port (counterpart of
`rusterix_tpu/ops/raster.py`: its megakernel branch, and its split branch
for runtime shaders).

`Rasterizer.setup(None, view, proj, device="cuda").rasterize(scene, W, H,
tile, assets)` packs the scene on the host (the port's copy of the JAX
package's numpy packer, `ops/scene_pack.py`), uploads it once into a scene
cache, and renders each frame as: setup pass -> megakernel table + Morton /
front-to-back sort -> the megakernel (B1) -> RGBA8 unpack. With ambient
occlusion, GGX reflections or sky light, the visibility pre-pass (B2) gives
the winners before shading: the screen-space AO factor (`ops/ao.py`) feeds
B1's ambient terms, the reflection rays (at full or reduced resolution) and
the sky-light rays go through the ray-intersect kernel (B3), and their
terms are composited over the opaque frame. With shadows, the casting
lights' cube maps and the sun's map are baked once per scene and light set
(`ops/shadow.py`, cached in `_SHADOW_CACHE`) and looked up by B1's shadow
variant and by the reflection hits; with opacity batches the maps also
bake depth-peeled transparent layers, which attenuate the light through
glass (B1's transmittance). After the opaque frame come, in the JAX
package's order, the reflections and the sky light, the render graph's sky
miss pass (`composite.sky_miss_pass`), the editor's brush preview, and the
opacity batches: `transparency_layers` depth-peeled layers (plain torch:
a setup pass of the opacity pack, then per layer a visibility pass and
`_shade_opacity`, with GGX reflections per layer when they are on),
blended back to front, and last the 2D batches in painter's order
(`composite.d2_pass`, lit by the 2D lights, the map's walls blocking them).
Vertex-blended batches (a second source mixed in by a per-vertex weight)
take B1's has_blend variant and the G-buffer's blend branch. Batches
under a rusteria shader (`Scene.add_shader`, `Batch3D.set_shader`) render
through the shader's pack-time bake (`ops/scene_pack.py`, evaluated by
`shader/jaxc.py` on the rasterizer's device): its atlas tile, one frame or
16 animation frames, with the constant roughness / metallic it wrote
(B1's has_material) or its per-pixel material sidecar tiles (has_matmap:
emissive, roughness, metallic and a written normal); the G-buffer reads
the same. A shader that reads its inputs (colour, normal, hit point,
material) cannot bake: it is a runtime shader, and a frame with one takes
the split path, as the JAX package's does: B2 over the candidates in
Morton order (`visibility_pallas.morton_sort`), then `shade.shade_pass`
(plain torch; the G-buffer runs each runtime shader over the frame on the
pixel's registers and merges its outputs where the winner carries it) and
`composite.compose_opaque`, with the passes after the opaque frame over
that f32 frame; the opacity layers and the 2D pass run their batches'
runtime shaders too. Dynamic batch lists (entity billboards, dynamic 2D)
pack every frame and follow the cached static packs on the device; with
shadows their depth is composited into the cached maps (dynamic casters).
`set_tonemap("scenevm")` encodes the lit colour with the SceneVM transform
in B1 and in the reflection composite. With SSAA the frame renders at n
times the size and is box-filtered down. The 2D line overlay is drawn
last, on the host. `screen_to_world` / `screen_ray` pick through the last
frame's size. Nothing falls back: a kernel that cannot build or launch
raises.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..models import Assets, SampleMode, pack_lights
from ..models.blend import RenderMode
from ..utils.color import hash_u32, linear_to_srgb_fast, srgb_to_linear_fast
from .megakernel import (
    light_param_rows,
    light_spec_from,
    mega_param_row,
    mega_params_key,
    occ_param_rows,
    mega_render,
    morton_ftb_sort,
    pack_background_u32,
    pack_light_params,
    pack_mega_params,
    pack_mega_table,
    pack_occ_params,
    unpack_frame_u32,
)
from . import arena
from .ao import ssao_pass, tap_offsets
from .arena import Staged, leaf, pack_arena, unpack_arena
from .composite import (
    blend_opacity,
    brush_preview_pass,
    compose_opaque,
    d2_pass,
    frame_to_u8,
    sky_miss_pass,
)
from .matrices import invert
from .reflect import apply_reflections, reflection_pass_scaled, sky_light_pass
from .scene_pack import PackedScene, next_pow2
from .setup_pass import setup_pass
from .shade import _div, resolve_texel, run_shaders, shade_pass, shader_state, take_iso
from .visibility import visibility_pass
from .visibility_pallas import morton_sort, visibility_pass_pallas


def packed_to_torch(packed: PackedScene, device) -> dict:
    """The JAX package's numpy PackedScene -> the port's device tensors:
    {"d3": {field: tensor}, "d3_op": {field: tensor} (the opacity batches),
    "d2": {field: tensor} (the 2D triangles), "atlas": {"flat_u32" (N,) i32
    holding the u32 texels, "w" int, "rects", "tile_first", "tile_count"}}."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    atlas = packed.atlas_index.atlas
    texels = np.ascontiguousarray(atlas.data.reshape(-1, 4)).view(np.int32).reshape(-1)
    return {
        "d3": {k: put(v) for k, v in vars(packed.d3).items() if v is not None},
        "d3_op": {k: put(v) for k, v in vars(packed.d3_opacity).items() if v is not None},
        "d2": {k: put(v) for k, v in vars(packed.d2).items()},
        "atlas": {
            "flat_u32": put(texels),
            "w": int(atlas.data.shape[1]),
            "rects": put(atlas.rects),
            "tile_first": put(atlas.tile_first),
            "tile_count": put(atlas.tile_count),
        },
    }


def frame_setup(d3, lights, atlas, uniforms, width: int, height: int, has_blend: bool = False,
                has_material: bool = False, has_matmap: bool = False, planes=None,
                split: bool = False) -> dict:
    """What every row of the frame shares before its kernels -> dict with
    the setup pass's `vis`, `attr`, `bbox`, `alive` (f32) and `tri_id`, the
    megakernel `table`, and the light and occluder packs `lights` and `occ`,
    on d3's device. `planes`: the setup pass's five outputs when the caller
    has them (a row-sharded frame gathers them from its triangle shards).
    `split`: the frame takes the split path (runtime shaders), which runs
    no B1: `table` is None."""
    dev = d3["pos"].device
    if planes is None:
        planes = setup_pass(
            d3["pos"], d3["uv"], d3["nrm"], d3["valid"], d3["cull"],
            leaf(uniforms, "view", dev), leaf(uniforms, "proj", dev),
            width, height, bw=d3["bw"] if has_blend else None,
        )
    vis, attr, bbox, alive, tri_id = planes
    return {
        "vis": vis, "attr": attr, "bbox": bbox, "alive": alive.float(), "tri_id": tri_id,
        "table": None if split else pack_mega_table(
            attr, tri_id, d3, atlas, int(uniforms["anim_frame"]), has_blend, has_material,
            has_matmap),
        "lights": pack_light_params(lights, dev),
        "occ": pack_occ_params(uniforms, dev),
    }


def frame_inputs(d3, lights, atlas, uniforms, background, width: int,
                 height: int, sample_mode: int = 0, has_fog: bool = False,
                 light_spec: tuple = None, sun_off: bool = False,
                 brdf_ggx: bool = False, shadow_rows=None, shadow_params=None,
                 shadow_spec: tuple = None, tonemap: bool = False, has_blend: bool = False,
                 has_material: bool = False, has_matmap: bool = False, y0: int = 0,
                 rows: int = None, shared: dict = None, shaders: tuple = (),
                 **_later) -> dict:
    """The preparation of B1's rows: frame_setup (the setup pass, megakernel
    table and packs), the Morton + front-to-back sort and the parameter
    pack -> dict with the setup pass's `attr` and `tri_id`, the rows `y0`
    and `rows`, the sorted `vis_s`, `alive_s`, `bbox_s`, the sorted
    position -> slot permutation `sort_perm`, and `mega_args` /
    `mega_kwargs` for mega_render. Takes render_frame's arguments; those of
    the passes after the opaque frame (`_later`) are compose_rows'.

    d3/atlas: packed_to_torch tensors; lights/uniforms: the host (numpy)
    dicts the Rasterizer builds each frame (pack_light_params,
    pack_mega_params and pack_occ_params carry them to the device);
    background (rows, W, 4) f32 on the device; shadow_rows / shadow_params /
    shadow_spec: a bake of shadow.bake_shadow_pack (None: no shadows).
    `has_blend`: the pack has vertex-blended batches (kind2 >= 0); the setup
    pass then interpolates their blend weight plane and the table carries
    the blend columns B1 mixes the second texel by. `has_material`: the
    pack has batches with a constant roughness / metallic other than the
    defaults (0.5, 0), from baked shaders; `has_matmap`: batches whose baked
    shader wrote per-pixel material (the M1 / M2 sidecar tiles; implies
    has_material). Both add their table columns and B1's variants. `y0` and
    `rows`: B1 renders the rows [y0, y0 + rows) of the height-row frame (a
    slab of a row-sharded frame; default all of them), and the sort's near
    bound clips to them. `shared`: frame_setup's result, when the caller
    has it.

    `shaders` (the pack's runtime shaders, non-empty): the frame takes the
    split path instead, as the JAX package's render_frame does (its
    ops/raster.py:317-356): the candidates sorted along the Morton curve
    (morton_sort of a slot permutation, `sort_perm` = the sorted slots)
    for B2, `split` True, `background` the rows' f32 background, and no
    B1 arguments (`mega_args` None)."""
    dev = d3["pos"].device
    rows = height if rows is None else rows
    split = bool(shaders)
    s = shared or frame_setup(d3, lights, atlas, uniforms, width, height, has_blend,
                              has_material, has_matmap, split=split)
    if split:
        slot_id = torch.arange(s["vis"].shape[0], dtype=torch.int32, device=dev)
        vis_s, bbox_s, alive_s, slot_s = morton_sort(s["vis"], s["bbox"], s["alive"], slot_id,
                                                     width, height)
        return {
            "attr": s["attr"], "tri_id": s["tri_id"], "y0": y0, "rows": rows,
            "vis_s": vis_s, "alive_s": alive_s, "bbox_s": bbox_s, "sort_perm": slot_s,
            "split": True, "background": background, "mega_args": None,
            "mega_kwargs": {},
        }
    vis_s, bbox_s, alive_s, table_s, s_near, sort_perm = morton_ftb_sort(
        s["vis"], s["bbox"], s["alive"], s["table"], width, height, y0g=y0, rows_local=rows,
        return_perm=True,
    )
    args = (
        vis_s, alive_s, bbox_s, table_s, atlas["flat_u32"],
        pack_background_u32(background),
        pack_mega_params(uniforms, width, height, atlas["w"], dev, has_fog, y0=y0,
                         shadow_params=shadow_params),
        s["lights"], s["occ"], width, rows, sample_mode,
    )
    return {
        "attr": s["attr"], "tri_id": s["tri_id"], "y0": y0, "rows": rows,
        "vis_s": vis_s, "alive_s": alive_s, "bbox_s": bbox_s, "sort_perm": sort_perm,
        "split": False, "mega_args": args,
        "mega_kwargs": {"light_spec": light_spec, "sun_off": sun_off, "s_near": s_near,
                        "brdf_ggx": brdf_ggx, "shadow_rows": shadow_rows,
                        "shadow_spec": shadow_spec, "tonemap": tonemap,
                        "has_blend": has_blend, "has_material": has_material,
                        "has_matmap": has_matmap},
    }


def needs_prepass(ao_taps: tuple = None, refl_samples: int = 0, sky_light: bool = False,
                  shaders: tuple = (), **_frame) -> bool:
    """Whether a frame with these settings runs the visibility pass B2
    before shading: AO, reflections and the sky light need its winners,
    and the split path (runtime shaders) shades from them."""
    return bool(ao_taps) or refl_samples > 0 or bool(sky_light) or bool(shaders)


def visibility_prepass(fi: dict, width: int, height: int, y0: int = 0):
    """The G-buffer's visibility before shading (B2 on the sorted
    candidates: front-to-back for B1's frames, the Morton order on the
    split path) -> (z, idx, hit) with idx mapped back to the setup pass's
    slots through the sort permutation. `y0`: the rows [y0, y0 + height)
    of the frame (a slab of a row-sharded frame)."""
    z, i_s, hit = visibility_pass_pallas(fi["vis_s"], fi["alive_s"], fi["bbox_s"], width, height,
                                         y0)
    idx = torch.where(hit, take_iso(fi["sort_perm"], torch.clamp(i_s, min=0)), -1)
    return z, idx, hit


def ambient_occlusion(pre, uniforms, height: int, ao_taps: tuple):
    """The frame's (H, W) AO factor from the pre-pass (z, idx, hit), with
    the projection's depth constants and the world size of a pixel in f32,
    as the JAX render_frame computes them (ops/raster.py:282-285 there)."""
    z, _idx, hit = pre
    proj = np.asarray(uniforms["proj"], np.float32)
    px_scale = np.float32(2.0) / (proj[1, 1] * np.float32(height))
    return ssao_pass(z, hit, proj[2, 2], proj[2, 3], np.float32(uniforms["ao_radius"]),
                     px_scale, ao_taps)


def opaque_rows(fi: dict, pre, ao_img, d3, lights, atlas, uniforms, width: int, height: int,
                sample_mode: int = 0, has_fog: bool = False, shadow_rows=None,
                shadow_params=None, shadow_spec: tuple = None, brdf_ggx: bool = False,
                tonemap: bool = False, has_blend: bool = False, has_material: bool = False,
                has_matmap: bool = False, shaders: tuple = (), **_frame):
    """The opaque frame of the rows frame_inputs `fi` prepared -> (opaque,
    z_eff (rows, W)). B1's frames: opaque is its packed RGBA8 (rows, W)
    i32, from mega_render with the AO factor `ao_img`. The split path
    (fi["split"], runtime shaders): shade_pass over the winners `pre` (z,
    idx, hit) of B2 on the Morton order, at the rows' offset, and
    compose_opaque over the rows' background, so opaque is the (rows, W, 4)
    f32 frame, not quantized (the JAX package's XLA branch). Takes
    render_frame's arguments."""
    if not fi["split"]:
        return mega_render(*fi["mega_args"], **dict(fi["mega_kwargs"], ao_img=ao_img))
    z, idx, hit = pre
    shaded, wrote = shade_pass(
        z, idx, hit, fi["attr"], fi["tri_id"], d3, atlas, lights, uniforms, width, fi["rows"],
        sample_mode, y0=fi["y0"], full_height=height, shaders=shaders, has_fog=has_fog,
        has_blend=has_blend, has_material=has_material, has_matmap=has_matmap,
        shadow=None if shadow_spec is None else (shadow_rows, shadow_params, shadow_spec),
        ao=ao_img, brdf_ggx=brdf_ggx, tonemap=tonemap)
    return compose_opaque(shaded, wrote, z, fi["background"])


#: candidates a step of the opacity layers' visibility pass takes; the
#: result does not depend on it (see shadow.BAKE_CHUNK)
LAYER_CHUNK = 64


def _shade_opacity(z, idx, hit, attr_planes, tri_id, meta, atlas, uniforms, width: int,
                   height: int, sample_mode: int = 0, y0: int = 0, shaders: tuple = ()):
    """Opacity-pass shading: texel only, no lighting (reference
    d3_rasterize_opacity, src/rasterizer.rs:1425-1690; the JAX package's
    `_shade_opacity`) -> (color (H, W, 4) f32 with the alpha times the
    batch opacity, z_eff (1.0 where no layer surface), tri id (H, W)). `y0`
    offsets the pixel rows (row-sharded frames). `shaders`: the pack's
    runtime shaders; where a pixel's surface carries one, its colour and
    opacity registers replace the linear texel colour and the alpha (the
    registers: uv / 4, that colour, roughness 0.5, the alpha as opacity,
    zeros elsewhere)."""
    dev = z.device
    slot = torch.clamp(idx, min=0).long()
    t = tri_id[slot].long()
    planes = attr_planes[slot]
    px = (torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5).expand(
        height, width)
    py = (torch.arange(height, dtype=torch.float32, device=dev)[:, None] + float(y0)
          + 0.5).expand(height, width)

    def interp(i):
        return planes[..., 3 * i] * px + planes[..., 3 * i + 1] * py + planes[..., 3 * i + 2]

    inv_w = interp(0)
    u = interp(1) / inv_w
    v = interp(2) / inv_w
    texel = resolve_texel(meta["kind"][t], meta["tex_slot"][t], meta["rgba"][t],
                          meta["repeat"][t], u, v, atlas, uniforms["anim_frame"], sample_mode)
    lin = srgb_to_linear_fast(texel[..., :3])
    # whole-batch alpha multiplier (fading door billboards,
    # scene_handler.rs:703-728 DynamicObject::with_opacity)
    opac = texel[..., 3] * meta["opacity"][t]
    if shaders:
        zeros = torch.zeros_like(u)

        def state():
            return shader_state(u, v, lin, zeros + 0.5, zeros, zeros, opac, zeros, zeros,
                                uniforms)

        for m, out_s in run_shaders(shaders, meta["shader"][t], state, uniforms):
            lin = torch.where(m[..., None], out_s["color"], lin)
            opac = torch.where(m, out_s["opacity"][..., 0], opac)
    # the srgb -> linear -> srgb round trip through the fast polynomials, as
    # the reference's pipeline has it (rasterizer.rs:1634-1676)
    out = torch.cat([linear_to_srgb_fast(lin), opac[..., None]], dim=-1)
    z_eff = torch.where(hit, z, 1.0)
    color = torch.where(hit[..., None], out, 0.0)
    return color, z_eff, t


def opacity_setup(d3_op, uniforms, width: int, height: int):
    """The setup pass of the opacity pack for a width x height frame ->
    (planes, attribute planes, alive as f32, tri id)."""
    view = leaf(uniforms, "view", d3_op["pos"].device)
    proj = leaf(uniforms, "proj", d3_op["pos"].device)
    vis_o, attr_o, _bbox, alive_o, tri_id_o = setup_pass(
        d3_op["pos"], d3_op["uv"], d3_op["nrm"], d3_op["valid"], d3_op["cull"], view, proj,
        width, height,
    )
    return vis_o, attr_o, alive_o.float(), tri_id_o


def opacity_layers(d3_op, atlas, uniforms, width: int, height: int, sample_mode: int = 0,
                   layers: int = 1, reflect_layer=None, y0: int = 0, rows: int = None,
                   setup=None, shaders: tuple = ()):
    """The opacity batches' depth-peeled layers -> [(color (H, W, 4),
    z_eff (H, W))], nearest first: layer k is the k-th nearest transparent
    surface of each pixel (strictly farther than layer k-1 through the raw
    1/z ceiling), as the JAX package's render_frame peels them
    (rusterix_tpu/ops/raster.py:423-482). The layers' visibility is the
    plain pass in XLA's plane rounding (`plane_fma`), as the JAX package
    runs them through its XLA pass. `reflect_layer(z, idx, hit, attr,
    tri_id, color)` -> color composites a layer's reflections (None: off).
    `y0` and `rows`: peel only the rows [y0, y0 + rows) of the frame (a
    slab of a row-sharded frame; default all `height` rows); `setup`:
    opacity_setup's result, when the caller has it; `shaders`: the pack's
    runtime shaders (_shade_opacity)."""
    vis_o, attr_o, alive_of, tri_id_o = setup or opacity_setup(d3_op, uniforms, width, height)
    rows = height if rows is None else rows
    out, ceil = [], None
    for _layer in range(layers):
        z_o, idx_o, hit_o, inv_o = visibility_pass(
            vis_o, alive_of, width, rows, chunk=LAYER_CHUNK, y0=y0, z_ceil=ceil,
            return_invz=True, plane_fma=True)
        color_o, zeff_o, _t = _shade_opacity(z_o, idx_o, hit_o, attr_o, tri_id_o, d3_op, atlas,
                                             uniforms, width, rows, sample_mode, y0, shaders)
        if reflect_layer is not None:
            color_o = reflect_layer(z_o, idx_o, hit_o, attr_o, tri_id_o, color_o)
        out.append((color_o, zeff_o))
        ceil = inv_o
    return out


def compose_rows(fi, opaque, z_eff, pre, ao_img, d3, lights, atlas, uniforms, width: int,
                 height: int, sample_mode: int = 0, refl_samples: int = 0, refl_scale: int = 1,
                 sky_light: bool = False, shadow_rows=None, shadow_params=None,
                 shadow_spec: tuple = None, tonemap: bool = False, d3_op=None,
                 has_opacity: bool = False, transparency_layers: int = 1,
                 preserve_transparency: bool = False, has_sky: bool = False,
                 sky_pre: dict = None, has_brush: bool = False, has_blend: bool = False,
                 d2=None, has_d2: bool = False, has_lights: bool = False,
                 has_ambient: bool = False, has_material: bool = False,
                 has_matmap: bool = False, op_setup=None, shaders: tuple = (), **_inputs):
    """The passes after the opaque frame on the rows frame_inputs `fi`
    prepared (fi["y0"], fi["rows"] of the height-row frame) -> (rows, W, 4)
    uint8 tensor. opaque_rows' outputs `opaque` (B1's packed RGBA8, or the
    split path's f32 frame) and `z_eff`, the pre-pass `pre` (z, idx, hit)
    where AO, reflections, the sky light or the split path need it, and
    the AO factor `ao_img` of these rows (or None). Takes render_frame's
    arguments (those of B1's preparation, `_inputs`, are frame_inputs');
    `op_setup`: opacity_setup's result, when the caller has it. `shaders`
    (the pack's runtime shaders) reach every G-buffer, the opacity layers
    and the 2D pass."""
    y0, rows = fi["y0"], fi["rows"]
    later = has_sky or has_opacity or has_d2 or has_brush or refl_samples or sky_light
    if fi["split"]:
        frame = opaque
    elif not later:
        return unpack_frame_u32(opaque)
    else:
        # the passes after B1 blend in f32 over its quantized bytes, as the
        # reference's u8 tile buffer does (rasterizer.rs:464-495)
        frame = unpack_frame_u32(opaque).float() * (1.0 / 255.0)
    shadow = None if shadow_spec is None else (shadow_rows, shadow_params, shadow_spec)
    g_args = {"has_blend": has_blend, "has_material": has_material, "has_matmap": has_matmap,
              "shaders": shaders, "y0": y0, "full_height": height}
    if refl_samples:
        refl, rmask = reflection_pass_scaled(
            *pre, fi["attr"], fi["tri_id"], d3, atlas, lights, uniforms, width, rows,
            sample_mode, refl_samples, scale=refl_scale, shadow=shadow, **g_args)
        frame = apply_reflections(frame, refl, rmask, tonemap=tonemap)
    if sky_light:
        sky_term, sky_mask = sky_light_pass(
            *pre, fi["attr"], fi["tri_id"], d3, atlas, uniforms, width, rows, sample_mode,
            **g_args)
        if ao_img is not None:
            sky_term = sky_term * ao_img[..., None]
        frame = apply_reflections(frame, sky_term, sky_mask, tonemap=tonemap)
    if has_sky:
        frame = sky_miss_pass(frame, z_eff, sky_pre, uniforms, width, height, y0)
    if has_brush:
        frame = brush_preview_pass(frame, z_eff, uniforms, width, height, y0)
    if has_opacity:
        reflect_layer = None
        if refl_samples:
            def reflect_layer(z_o, idx_o, hit_o, attr_o, tri_id_o, color_o):
                refl_o, rmask_o = reflection_pass_scaled(
                    z_o, idx_o, hit_o, attr_o, tri_id_o, d3_op, atlas, lights, uniforms,
                    width, rows, sample_mode, refl_samples, scale=refl_scale, shadow=shadow,
                    scene_d3=d3, **g_args)
                # the layer colour is display-encoded with the fast sRGB
                # pair (_shade_opacity) whatever the frame's tonemap is
                return apply_reflections(color_o, refl_o, rmask_o, tonemap=False)

        layers = opacity_layers(d3_op, atlas, uniforms, width, height, sample_mode,
                                transparency_layers, reflect_layer, y0=y0, rows=rows,
                                setup=op_setup, shaders=shaders)
        for color_o, zeff_o in reversed(layers):
            frame = blend_opacity(frame, z_eff, color_o, zeff_o, preserve_transparency)
    if has_d2:
        frame = d2_pass(frame, d2, atlas, lights, uniforms, width, rows, sample_mode,
                        preserve_transparency, has_lights=has_lights, has_ambient=has_ambient,
                        shaders=shaders, y0=y0)
    return frame_to_u8(frame)


def render_frame(d3, lights, atlas, uniforms, background, width: int, height: int, **settings):
    """One frame on the device -> (H, W, 4) uint8 tensor: the JAX
    render_frame's megakernel branch (ops/raster.py:233-500 there), or with
    runtime shaders (`shaders`, the pack's) its split branch
    (ops/raster.py:317-356 there): B2 over the Morton-ordered candidates,
    then shade_pass with the shaders and compose_opaque, and the passes
    below over that f32 frame. Otherwise the opaque frame comes from the
    megakernel (B1). With AO (`ao_taps` from
    tap_offsets, radius uniforms["ao_radius"]), reflections or sky light,
    the visibility pre-pass (B2) gives the winners before shading; the AO
    factor scales B1's ambient terms; the reflection pass (at 1/refl_scale
    resolution) and the sky-light pass trace their rays through the
    ray-intersect kernel (B3), and each term is composited in f32 over the
    quantized opaque frame, the sky light scaled by the AO factor. With a
    shadow bake, B1 and the reflection hits look up the same maps. `tonemap`
    selects the SceneVM display transform. Then, in f32: the sky miss pass
    (`has_sky`, sky_pre from shapefx.render.sky_device_params) on the pixels
    B1 left to the background, the brush preview (`has_brush`, the brush_*
    uniforms), and with `has_opacity` the `transparency_layers` layers of
    the opacity pack `d3_op`, each with its own reflections when
    refl_samples > 0 (its G-buffer from its own surfaces, its rays traced
    and shaded against the opaque pack), blended back to front. Last, with
    `has_d2`, the 2D triangles `d2` in painter's order (composite.d2_pass,
    lit when `has_lights` / `has_ambient`). `has_blend` (vertex-blended
    batches), `has_material` and `has_matmap` (baked shader materials)
    reach B1 and every G-buffer. `settings`: the keyword arguments of
    frame_inputs (B1's preparation) and compose_rows (the passes after it);
    the Rasterizer's frame_args hold every one."""
    fi = frame_inputs(d3, lights, atlas, uniforms, background, width, height, **settings)
    pre = visibility_prepass(fi, width, height) if needs_prepass(**settings) else None
    ao_taps = settings.get("ao_taps")
    ao_img = ambient_occlusion(pre, uniforms, height, ao_taps) if ao_taps else None
    opaque, z_eff = opaque_rows(fi, pre, ao_img, d3, lights, atlas, uniforms, width, height,
                                **settings)
    return compose_rows(fi, opaque, z_eff, pre, ao_img, d3, lights, atlas, uniforms, width,
                        height, **settings)


def with_frame_leaves(leaves, d3, d3_op, d2, lights, uniforms, shadow_rows=None,
                      shadow_spec=None, shadow_cams=None, hide_3d: bool = False,
                      **settings) -> dict:
    """render_frame's arguments over the frame's per-frame leaves on the
    device. `leaves`: the per-frame tree (d3_dyn, d3_op_dyn, d2_dyn,
    lights, uniforms, derived) as device tensors (views of the arena, or
    the per-leaf uploads); `d3`, `d3_op`, `d2`: the static packs; `lights`
    and `uniforms`: the host dicts. -> the arguments with the dynamic packs
    appended to the static ones (their valid masks zeroed with `hide_3d`,
    the render mode's 3D off), the dynamic casters' depth composited into
    the shadow maps through `shadow_cams` (None: no dynamic casters), and
    the lights and uniforms as arena.Staged dicts over their device leaves,
    with the packs B1 derives from them (`derived`)."""
    d3_dyn, d3_op_dyn, d2_dyn, lights_d, uniforms_d, derived = leaves
    if d3_dyn is not None:
        dyn = {"d3": d3_dyn, "d3_op": d3_op_dyn, "d2": d2_dyn}
        if hide_3d:
            for part in ("d3", "d3_op"):
                dyn[part] = dict(dyn[part], valid=torch.zeros_like(dyn[part]["valid"]))
        d3, d3_op, d2 = ({k: torch.cat([static[k], dyn[part][k]]) for k in static}
                         for part, static in (("d3", d3), ("d3_op", d3_op), ("d2", d2)))
        if shadow_cams is not None:
            # dynamic casters (the reference's trace_shadow_unified ->
            # trace_billboards, 3d_shader.wgsl:436-460): the dynamic pack's
            # depth min-composited into the cached static maps
            from .shadow import composite_dynamic_depth

            dd = dyn["d3"]
            shadow_rows = composite_dynamic_depth(shadow_rows, shadow_spec, shadow_cams,
                                                  dd["pos"], dd["uv"], dd["nrm"], dd["valid"])
    u_packs = {"occ_params": (None, derived["occ_params"])}
    if "mega_params" in derived:
        key = mega_params_key(settings["width"], settings["height"], settings["atlas"]["w"],
                              settings.get("has_fog", False), 0, settings.get("shadow_params"))
        u_packs["mega_params"] = (key, derived["mega_params"])
    return dict(settings, d3=d3, d3_op=d3_op, d2=d2,
                lights=Staged(lights, lights_d, {"light_params": (None, derived["light_params"])}),
                uniforms=Staged(uniforms, uniforms_d, u_packs), shadow_rows=shadow_rows,
                shadow_spec=shadow_spec)


def render_frame_arena(arena_dev, arena_layout, **frame):
    """render_frame behind the frame's one upload (the JAX package's
    render_frame_arena): the per-frame tree (the dynamic packs, the lights,
    the uniforms and the packs derived from them) arrives as one int32
    buffer on the device, `arena_dev`, laid out by `arena_layout`
    (arena.pack_arena), and its leaves are viewed back out here (no copy).
    `frame`: with_frame_leaves' arguments (render_frame's, with the static
    packs and the host lights and uniforms). -> (the (H, W, 4) uint8
    frame, the render_frame arguments it was rendered with)."""
    args = with_frame_leaves(unpack_arena(arena_dev, arena_layout), **frame)
    return render_frame(**args), args


def ssaa_downsample(frame_u8, ss: int):
    """Box-filter an (H*ss, W*ss, 4) uint8 frame down to (H, W, 4): the mean
    of each ss x ss block (a sum of integers, exact, divided once), rounded
    half up, as the JAX package's _ssaa_downsample."""
    h, w, c = frame_u8.shape
    f = frame_u8.float().reshape(h // ss, ss, w // ss, ss, c).sum(dim=(1, 3))
    return torch.floor(_div(f, float(ss * ss)) + 0.5).to(torch.uint8)


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
#: shadow-map bakes: (scene key, settings, casting lights' rows, positions
#: and ranges, sun direction, max shadow distance, transmittance steps)
#: -> (flat table on the device, params (40,) np.float32, spec). A static
#: scene with static lights bakes once; a casting light that moves re-bakes.
_SHADOW_CACHE: dict = {}
#: id(Sky node) -> (node, device sky params, snapshot of its precomputed
#: vec4s, device): the node rides along so that its id() cannot be reused
#: by another node while cached
_SKY_DEV_CACHE: dict = {}


@dataclass
class BrushPreview:
    """Editor brush highlight (reference rasterizer.rs:13-17)."""

    position: np.ndarray
    radius: float = 1.0
    falloff: float = 0.5


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
            m = np.asarray(projection_matrix_2d, np.float32)
            self.translationd2 = np.array([m[0, 2], m[1, 2]], np.float32)
            self.scaled2 = float(m[0, 0])
            self.proj2d = m
        else:
            self.translationd2 = np.zeros(2, np.float32)
            self.scaled2 = 1.0
            self.proj2d = np.eye(3, dtype=np.float32)
        #: the map's slim collision view (MapMini) whose walls block the 2D
        #: lights when the scene carries none
        self.mapmini = None
        #: the last frame's (width, height) before supersampling (picking)
        self._last_size = (1, 1)

        self.render_mode = RenderMode.render_all()
        self.sample_mode = SampleMode.Nearest
        self.background_color: Optional[tuple] = None
        self.ambient_color: Optional[np.ndarray] = None
        self.preserve_transparency = False
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
        #: shadow occluder range cap and transparency steps (RenderSettings
        #: max_shadow_distance / max_shadow_steps)
        self._rs_shadow_distance = 50.0
        self._rs_shadow_steps = 16.0
        #: per-light geometry shadows, None = off (set_shadows)
        self.shadow_settings = None
        #: direct-light BRDF: "fast" (Blinn-Phong) or "ggx" (set_brdf)
        self.brdf = "fast"
        #: GGX reflection rays per pixel, 0 = off (set_reflections)
        self.reflection_samples = 0
        self.reflection_scale = 1
        #: depth-peeled transparency layers (RenderSettings
        #: max_transparency_bounces); they matter with opacity batches only
        self.transparency_layers = 1
        #: directional sky-bounce ambient, one mirror ray per pixel
        #: (set_sky_light)
        self.sky_light_enabled = False
        #: screen-space ambient occlusion, None = off (set_ambient_occlusion);
        #: samples and radius default to RenderSettings ao_samples / ao_radius
        self.ao_settings = None
        self._rs_ao_samples = 4.0
        self._rs_ao_radius = 0.5
        #: supersampled antialiasing factor (set_supersample)
        self.supersample = 1
        #: display transform of lit 3D pixels: "srgb" or "scenevm" (set_tonemap)
        self.tonemap = "srgb"
        #: a ShapeFXGraph whose Render node's hit/miss chains add the Sky
        #: node (sun, day factor, ambient and the sky miss pass) and the Fog
        #: node (linear distance fog); None = off
        self.render_graph = None
        #: editor brush highlight on the background (BrushPreview or None)
        self.brush_preview = None
        #: the last frame's render_frame arguments (every tensor in it is
        #: held by the scene cache anyway); checks re-run the kernel and
        #: its plain version on them
        self.frame_args: Optional[dict] = None
        #: the last unsharded frame's (arena on the device, layout, with_frame_leaves
        #: arguments), or None when it went leaf by leaf (profiling reads it)
        self.frame_arena = None

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

    def set_tonemap(self, mode: str) -> "Rasterizer":
        """Display transform of lit 3D pixels: "srgb" (the fast sRGB
        polynomial of the Rust renderer, rasterizer.rs:27-33) or "scenevm"
        (Reinhard, then gamma 2.2, 3d_shader.wgsl:871-873). It applies to
        B1's shading and the reflection composite; fullbright texels and the
        unlit opacity layers keep their raw sRGB bytes."""
        mode = str(mode).lower()
        if mode not in ("srgb", "scenevm"):
            raise ValueError(f"unknown tonemap '{mode}' (srgb|scenevm)")
        self.tonemap = mode
        return self

    def set_reflections(self, samples: int, scale: int = None) -> "Rasterizer":
        """GGX importance-sampled reflection rays per pixel (0 disables),
        range-capped by max_sky_distance (3d_shader.wgsl:764-826). `scale`
        > 1 traces them at 1/scale resolution and upsamples bilinearly."""
        self.reflection_samples = max(0, int(samples))
        if scale is not None:
            self.reflection_scale = max(1, int(scale))
        return self

    def set_sky_light(self, enabled: bool = True) -> "Rasterizer":
        """Directional sky-bounce ambient: per pixel one ray along the view
        ray mirrored about the normal, up to max_sky_distance; where it
        reaches the sky, sky_rgb * max(N.y, 0) * albedo (* AO when AO is on)
        is added (SceneVM `sky_contribution`, 3d_shader.wgsl:744-758)."""
        self.sky_light_enabled = bool(enabled)
        return self

    def set_shadows(self, enabled: bool = True, *, res: int = 128, sun_res: int = 256,
                    max_lights: int = 4, bias: float = 0.05,
                    dynamic_casters: bool = True) -> "Rasterizer":
        """Per-light geometry shadows (the reference's SceneVM trace_shadow
        family, 3d_shader.wgsl:436-517): up to `max_lights` brightest
        point/spot lights render 6-face cube depth maps at `res`^2, the sun
        one `sun_res`^2 map (ops/shadow.py). The maps bake from the static
        geometry and stay cached until the scene revision, a casting
        light's position or range, or the sun changes. max_shadow_distance
        and max_shadow_steps come from apply_render_settings. With
        `dynamic_casters`, the dynamic batches' depth is min-composited into
        the cached maps every frame (shadow.composite_dynamic_depth), so
        moving entities cast shadows too."""
        if enabled:
            self.shadow_settings = {
                "res": int(res),
                "sun_res": int(sun_res),
                "max_lights": int(max_lights),
                "bias": float(bias),
                "dynamic_casters": bool(dynamic_casters),
            }
        else:
            self.shadow_settings = None
        return self

    def set_ambient_occlusion(self, enabled: bool = True, samples: int = None,
                              radius: float = None) -> "Rasterizer":
        """Screen-space ambient occlusion on the visibility depth
        (ops/ao.py), scaling only the ambient terms (SceneVM `compute_ao`,
        3d_shader.wgsl:519-560). samples and radius default to the
        RenderSettings ao_samples / ao_radius; samples == 0 or radius <= 0
        turns the pass off."""
        if enabled:
            self.ao_settings = {
                "samples": None if samples is None else int(samples),
                "radius": None if radius is None else float(radius),
            }
        else:
            self.ao_settings = None
        return self

    def set_supersample(self, n: int) -> "Rasterizer":
        """Render at n x n samples per pixel and box-filter down on the
        device (n = 1 disables)."""
        self.supersample = max(1, int(n))
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
        """Sky color, sun, ambient, exp^2 fog, the AO samples and radius,
        the reflection samples and their range cap, the shadow range cap
        and steps from a RenderSettings block (reference
        src/render_settings.rs:10-120)."""
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
        self._rs_shadow_distance = float(rs.max_shadow_distance)
        self._rs_shadow_steps = float(rs.max_shadow_steps)
        self._rs_ao_samples = float(rs.ao_samples)
        self._rs_ao_radius = float(rs.ao_radius)
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
            "proj2d": np.asarray(self.proj2d, np.float32),
            "translationd2": np.asarray(self.translationd2, np.float32),
            "scaled2": np.float32(self.scaled2),
            "time": np.float32(self.time),
            "fog_color": np.asarray(self._fog_color, np.float32),
            "fog_end": np.float32(self._fog_end),
            "fog_fade": np.float32(self._fog_fade),
            "fog_mode": np.float32(self._fog_mode),
            "fog_density": np.float32(self._fog_density),
            "ao_radius": np.float32(self._ao_radius_eff()),
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

    def _ao_radius_eff(self) -> float:
        if self.ao_settings is None:
            return 0.0
        r = self.ao_settings["radius"]
        return float(self._rs_ao_radius if r is None else r)

    def _ao_taps(self):
        """The frame's AO tap offsets (None = AO off)."""
        if self.ao_settings is None:
            return None
        n = self.ao_settings["samples"]
        n = int(self._rs_ao_samples if n is None else n)
        if n <= 0 or self._ao_radius_eff() <= 0.0:
            return None  # compute_ao's early return
        return tap_offsets(n)

    def _shadow_pack(self, cache, packed, lights, scene_key):
        """Bake (or fetch the cached) shadow maps of this frame's casting
        lights -> (flat table, params (40,) np.float32, spec, cams: the
        cameras of the maps, shadow.bake_shadow_cams, which the dynamic
        casters render through), or four Nones when nothing casts. The
        casting lights are the `max_lights` brightest valid point/spot rows
        (the first rows among equals). With
        opacity batches and max_shadow_steps > 0, each map also bakes up to
        4 depth-peeled transparent layers (the transmittance)."""
        cfg = self.shadow_settings
        types = np.asarray(lights["type"])
        valid = np.asarray(lights["valid"])
        inten = np.asarray(lights["intensity"])
        rows_idx = [i for i in range(len(types)) if valid[i] > 0.5 and int(types[i]) in (0, 3)]
        rows_idx.sort(key=lambda i: -float(inten[i]))
        cast = sorted(rows_idx[: cfg["max_lights"]])
        sun_dir = self.sun_dir if (self.sun_dir is not None and self.day_factor > 0) else None
        if not cast and sun_dir is None:
            return None, None, None, None
        with_trans = self._rs_shadow_steps > 0 and bool(packed.d3_opacity.valid.any())
        # the reference walks up to max_shadow_steps transparent surfaces per
        # shadow ray (3d_shader.wgsl:484); the maps keep at most 4 layers
        trans_steps = int(np.clip(self._rs_shadow_steps, 1, 4))
        light_key = tuple(
            (i, tuple(np.round(lights["position"][i], 4).tolist()),
             round(float(lights["end"][i]), 4))
            for i in cast
        )
        sun_key = tuple(np.round(sun_dir, 4).tolist()) if sun_dir is not None else None
        key = (scene_key, tuple(sorted(cfg.items())), light_key, sun_key,
               round(self._rs_shadow_distance, 4), with_trans, trans_steps)
        hit = _SHADOW_CACHE.get(key)
        if hit is not None:
            return hit
        from .shadow import bake_shadow_cams, bake_shadow_pack, scene_bounds

        bounds = scene_bounds(packed.d3.pos, packed.d3.valid)
        rows, params, spec = bake_shadow_pack(
            cache["d3"], cache["d3_op"] if with_trans else None, lights, cast, sun_dir,
            res=cfg["res"], sun_res=cfg["sun_res"], with_trans=with_trans,
            trans_steps=trans_steps,
            max_shadow_distance=self._rs_shadow_distance,
            bias=cfg["bias"], bounds=bounds,
        )
        entry = (rows, params, spec, bake_shadow_cams(lights, spec, sun_dir, bounds))
        if len(_SHADOW_CACHE) > 8:
            _SHADOW_CACHE.clear()
        _SHADOW_CACHE[key] = entry
        return entry

    def _render_graph_hooks(self):
        """The render graph's hit and miss hooks (reference
        rasterizer.rs:227-253) -> (has_sky, has_fog, sky_pre): the Sky node
        sets the sun direction, the day factor and the ambient colour and,
        on the miss chain, adds the sky miss pass (its device parameters
        cached per node and content in _SKY_DEV_CACHE); the Fog node on the
        hit chain sets the linear distance fog."""
        has_sky, has_fog, sky_pre = False, self._rs_has_fog, None
        if self.render_graph is None:
            return has_sky, has_fog, sky_pre
        from ..shapefx import ShapeFXRole
        from ..shapefx.render import sky_device_params

        hit_nodes = self.render_graph.collect_nodes_from(0, 0)
        miss_nodes = self.render_graph.collect_nodes_from(0, 1)
        for ni in hit_nodes + miss_nodes:
            node = self.render_graph.nodes[ni]
            result = node.render_setup(self.hour)
            if node.role == ShapeFXRole.Sky:
                if result is not None:
                    self.sun_dir, self.day_factor = result
                amb = node.render_ambient_color(self.hour)
                if amb is not None:
                    self.ambient_color = amb
                if ni in miss_nodes:
                    has_sky = True
                    # keyed on the precomputed content: sky_setup also reads
                    # node.values, so the hour alone is not enough
                    snap = tuple(a.tobytes() for a in node.precomputed)
                    hit = _SKY_DEV_CACHE.get(id(node))
                    if (hit is not None and hit[0] is node and hit[2] == snap
                            and hit[3] == self.device):
                        sky_pre = hit[1]
                    else:
                        if len(_SKY_DEV_CACHE) > 32:
                            _SKY_DEV_CACHE.clear()
                        sky_pre = sky_device_params(node, self.device)
                        _SKY_DEV_CACHE[id(node)] = (node, sky_pre, snap, self.device)
            elif node.role == ShapeFXRole.Fog and ni in hit_nodes:
                has_fog = True
                self._fog_color = node.precomputed[0]
                self._fog_end = float(node.precomputed[1][0])
                self._fog_fade = float(node.precomputed[1][1])
                self._fog_mode = 0.0  # the node's linear fade
        return has_sky, has_fog, sky_pre

    def screen_to_world(self, x: float, y: float, z_ndc: float) -> np.ndarray:
        """reference rasterizer.rs:1707-1728 (host-side picking) -> (3,)
        f32 world position of the screen point (x, y) at NDC depth z_ndc,
        for the last frame's size."""
        w, h = self._last_size
        ndc = np.array([2.0 * (x / w) - 1.0, 1.0 - 2.0 * (y / h), z_ndc, 1.0], np.float32)
        view = self.inverse_projection_matrix @ ndc
        view = view / view[3]
        world = self.inverse_view_matrix @ view
        return world[:3]

    def screen_ray(self, x: float, y: float):
        """reference rasterizer.rs:1844-1871 -> the Ray from the near plane
        through the screen point (x, y), unit direction."""
        from ..models.camera import Ray

        near = self.screen_to_world(x, y, -1.0)
        far = self.screen_to_world(x, y, 1.0)
        d = far - near
        d = d / max(np.linalg.norm(d), 1e-20)
        return Ray(near, d.astype(np.float32))

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
        by the JAX package) instead of packing the scene. With
        set_supersample(n) the frame renders at (n*H, n*W) and is
        box-filtered down to (H, W) on the device before the readback.

        `mesh` (parallel.make_mesh: a tuple of torch devices) renders the
        frame row-sharded (parallel.render_frame_sharded): the triangles
        split over the slabs through the setup pass, the rows through every
        pass after it, byte-equal to the frame without a mesh. Reflections
        render at full resolution on this path whatever the reflection
        scale, as in the JAX package.

        The scene's dynamic batch lists (entity billboards, dynamic 2D) pack
        every frame into capacities that only grow (scene_pack.pack_dynamic,
        stable_dynamic_caps) and are concatenated after the cached static
        packs on the device; with shadows and dynamic casters their depth is
        composited into the cached maps. Runtime shaders (the pack's
        runtime_shaders: shaders that read their inputs and cannot bake)
        take the split path (render_frame), with a mesh as without."""
        if assets is None:
            assets = Assets.default()
        self.hash_anim = hash_u32(scene.animation_frame & 0xFFFFFFFF)
        self._last_size = (width, height)
        # SSAA: everything below renders at the scaled size (the projection
        # matrix depends on the aspect only)
        ss = max(1, int(self.supersample))
        width, height = width * ss, height * ss
        has_sky, has_fog, sky_pre = self._render_graph_hooks()

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
                packed = PackedScene.from_scene(scene, assets, static_only=True,
                                                device=self.device)
            cache = {"packed": packed, **packed_to_torch(packed, self.device)}
            _SCENE_CACHE.clear()  # one live packed scene per process is enough
            _SCENE_CACHE[key] = cache
        packed = cache["packed"]
        if mesh is not None:
            from ..parallel import check_mesh

            mesh = check_mesh(mesh)
        d3, d3_op, d2 = cache["d3"], cache["d3_op"], cache["d2"]

        # dynamic batches: packed every frame on the host into stable
        # capacities; they ride the frame's one upload and are appended to the
        # static packs on the device (with_frame_leaves): entity motion
        # uploads a few KB, never the static world
        has_dyn = bool(scene.d3_dynamic or scene.d3_dynamic_opacity or scene.d2_dynamic)
        dyn = (None, None, None)
        dyn_lines = None
        if has_dyn:
            from .scene_pack import pack_dynamic, stable_dynamic_caps

            caps = stable_dynamic_caps(scene, cache.get("dyn_caps"))
            cache["dyn_caps"] = caps
            p3, p3op, p2, dyn_lines = pack_dynamic(scene, packed.atlas_index, *caps)
            dyn = tuple({k: np.ascontiguousarray(getattr(part, k)) for k in static}
                        for part, static in ((p3, d3), (p3op, d3_op), (p2, d2)))
        hide_3d = not self.render_mode.d3_active
        if hide_3d:
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
        if ss > 1:
            # 2D geometry lives in output pixels: at the scaled size the 2D
            # projection's affine rows and the grid mapping scale by ss
            p2 = uniforms["proj2d"].copy()
            p2[:2, :] *= np.float32(ss)
            uniforms["proj2d"] = p2
            uniforms["translationd2"] = uniforms["translationd2"] * np.float32(ss)
            uniforms["scaled2"] = np.float32(uniforms["scaled2"] * ss)
        if self.brush_preview is not None:
            uniforms["brush_pos"] = np.asarray(self.brush_preview.position, np.float32)
            uniforms["brush_radius"] = np.float32(self.brush_preview.radius)
            uniforms["brush_falloff"] = np.float32(self.brush_preview.falloff)
        if packed.occlusion is not None:
            uniforms["occ_box"] = packed.occlusion["occ_box"]
            uniforms["occ_val"] = packed.occlusion["occ_val"]
        mini = scene.mapmini if scene.mapmini is not None else self.mapmini
        if mini is not None and getattr(mini, "all_linedefs", None):
            segs = mini.pack_device()
            uniforms["seg_a"] = segs["seg_a"]
            uniforms["seg_b"] = segs["seg_b"]
            uniforms["seg_valid"] = segs["seg_valid"]

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

        shadow_rows = shadow_params = shadow_spec = shadow_cams = None
        if self.shadow_settings is not None and self.render_mode.d3_active:
            shadow_rows, shadow_params, shadow_spec, cams = self._shadow_pack(
                cache, packed, lights, key)
            if has_dyn and self.shadow_settings["dynamic_casters"]:
                shadow_cams = cams

        frame_args = dict(
            d3=d3, lights=lights, atlas=cache["atlas"], uniforms=uniforms,
            background=background, width=width, height=height,
            sample_mode=int(self.sample_mode),
            has_fog=has_fog,
            light_spec=light_spec_from(lights),
            sun_off=not (self.sun_dir is not None and self.day_factor > 0),
            brdf_ggx=self.brdf == "ggx",
            refl_samples=self.reflection_samples if self.render_mode.d3_active else 0,
            refl_scale=self.reflection_scale,
            ao_taps=self._ao_taps() if self.render_mode.d3_active else None,
            sky_light=self.sky_light_enabled and self.render_mode.d3_active,
            shadow_rows=shadow_rows, shadow_params=shadow_params, shadow_spec=shadow_spec,
            tonemap=self.tonemap == "scenevm",
            # the JAX package passes its reflection intersect the live slot
            # ranges of the static and dynamic packs (_refl_live_ranges);
            # B3 here gates every slot by the pack's valid mask, so the
            # dynamic slots need no range
            d3_op=d3_op,
            has_opacity=self.render_mode.d3_active and bool(
                packed.d3_opacity.valid.any() or (has_dyn and len(scene.d3_dynamic_opacity))),
            transparency_layers=self.transparency_layers,
            preserve_transparency=self.preserve_transparency,
            has_sky=has_sky, sky_pre=sky_pre,
            has_brush=self.brush_preview is not None,
            has_blend=bool((packed.d3.kind2 >= 0).any()),
            # as the JAX package derives them (its ops/raster.py:1495-1500):
            # a matmap implies a material
            has_material=bool((packed.d3.rough != 0.5).any() or packed.d3.metal.any()
                              or (packed.d3.m1_slot >= 0).any()),
            has_matmap=bool((packed.d3.m1_slot >= 0).any()),
            d2=d2,
            has_d2=self.render_mode.d2_active and bool(
                packed.d2.valid.any() or (has_dyn and len(scene.d2_dynamic))),
            shaders=packed.runtime_shaders,
            has_lights=len(live_lights) > 0,
            has_ambient=self.ambient_color is not None,
        )
        # the per-frame tree: the dynamic packs, the lights, the uniforms and
        # the packs B1 derives from them, in one host-to-device copy (ops/
        # arena.py) for the unsharded frame; the mesh path, and a tree the
        # arena refuses, upload leaf by leaf, as the JAX package's do
        derived = {"light_params": light_param_rows(lights),
                   "occ_params": occ_param_rows(uniforms)}
        if not packed.runtime_shaders:
            derived["mega_params"] = mega_param_row(
                uniforms, width, height, cache["atlas"]["w"], has_fog, 0, shadow_params)
        per_frame = (*dyn, lights, uniforms, derived)
        arena_np, arena_layout = (None, None) if mesh is not None else pack_arena(per_frame)
        frame_args.update(shadow_cams=shadow_cams, hide_3d=hide_3d)
        self.frame_arena = None
        if arena_np is not None:
            arena_dev = arena.upload(arena_np, self.device)
            self.frame_arena = (arena_dev, arena_layout, frame_args)
            frame, self.frame_args = render_frame_arena(arena_dev, arena_layout, **frame_args)
        else:
            self.frame_args = with_frame_leaves(arena.upload_leaves(per_frame, self.device),
                                                **frame_args)
            if mesh is not None:
                from ..parallel import render_frame_sharded

                fa = {k: v for k, v in self.frame_args.items() if k != "refl_scale"}
                frame = render_frame_sharded(mesh, **fa)
            else:
                frame = render_frame(**self.frame_args)
        if ss > 1:
            frame = ssaa_downsample(frame, ss)
        if not readback:
            return frame
        out = frame.cpu().numpy()

        line_sets = [packed.d2_lines] + ([dyn_lines] if dyn_lines is not None else [])
        line_sets = [ls for ls in line_sets if len(ls.segments)]
        if line_sets:
            segs = np.concatenate([ls.segments for ls in line_sets])
            colors = np.concatenate([ls.colors for ls in line_sets])
            ones = np.ones((len(segs), 1), np.float32)
            p0 = np.concatenate([segs[:, 0:2], ones], axis=1) @ self.proj2d.T
            p1 = np.concatenate([segs[:, 2:4], ones], axis=1) @ self.proj2d.T
            projected = np.concatenate([p0[:, :2], p1[:, :2]], axis=1)
            out = out.copy()
            draw_lines_bresenham(out, projected, colors)
        return out

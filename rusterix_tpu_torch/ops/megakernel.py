"""The opaque-frame megakernel: visibility + attributes + texel + lighting
+ compose for one screen tile per CUDA block (torch side of
`rusterix_tpu/ops/megakernel.py`).

This module holds the kernel's preparation (the per-candidate table, the
Morton + front-to-back super order, the parameter packs), its launch
wrapper `mega_render` and its plain torch version `mega_render_reference`.
The kernel itself is `rusterix_tpu_torch/csrc/megakernel.cu`.

`mega_render` launches the CUDA kernel for CUDA tensors and runs the plain
version for CPU tensors; nothing else chooses between them.

Mega attr-table layout (f32 columns, the JAX package's layout):
  0-17  attribute planes (inv_w, u, v, nx, ny, nz) x (a, b, c)
  18 kind | 19 repeat (+4 = fullbright) | 20 has_normals
  21-24 rgba (SRC_PIXEL color) | 25-27 batch ambient rgb
  28-31 anim-resolved atlas rect (rx, ry, rw, rh)
  material extension (has_material; baked shaders' constant material):
  32 roughness | 33 metallic
  matmap extension (has_matmap, which implies has_material; the per-pixel
  material sidecar tiles of baked shaders):
  34-37 M1 rect (emissive rgb | roughness texels) | 38-41 M2 rect (encoded
  normal | metallic texels) | 42 em_scale | 43 writes_normal | 44 matmap_on
  blend extension (has_blend; it starts at mb = 45 with the matmap, 34 with
  the material alone, else 32):
  mb+0..2 blend weight plane | mb+3 kind2 | mb+4..7 rgba2 |
  mb+8..11 second rect | 4 columns of padding
The CUDA kernel reads rows 16 bytes at a time, but for a blend extension
that follows the material columns, which it reads one float at a time.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import device_scalar, device_table
from .arena import staged_pack
from .scene_pack import SRC_PIXEL, SRC_TEXTURE
from .setup_pass import _fma
from .shadow import shadow_factor
from .visibility import scan_candidates
from .visibility_pallas import (
    CHUNK,
    GROUP,
    SUPER,
    TILE_H,
    TILE_W,
    morton_perm,
    prepare_visibility,
    tile_box_hits,
)

N_PARAMS = 80
#: launches of the CUDA kernel (one per mega_render call on CUDA tensors)
launches = 0
#: shared memory one block may use on the card (H100: 227 KB)
SMEM_PER_BLOCK = 232448


def pack_mega_table(attr_planes, tri_id, meta, atlas, anim_frame,
                    has_blend: bool, has_material: bool = False,
                    has_matmap: bool = False):
    """Per-candidate rows for the megakernel (layout in the module header).

    meta: the packed d3 fields as tensors; atlas: dict with `rects`,
    `tile_first`, `tile_count` tensors. The texture rect is anim-resolved
    here, per candidate, so the kernel never touches the tile tables."""
    if has_matmap and not has_material:
        raise ValueError("has_matmap implies has_material (fixed column layout)")

    def resolve_rect(slot_col):
        slot = torch.clamp(slot_col.long(), min=0)
        count = torch.clamp(atlas["tile_count"][slot], min=1)
        tex_id = atlas["tile_first"][slot] + torch.remainder(
            device_scalar(int(anim_frame), torch.int64, count.device), count
        )
        return atlas["rects"][tex_id.long()].float()

    # receives_light=False rides the repeat column as +4 (decoded in-kernel)
    repeat_enc = meta["repeat"].float() + 4.0 * (meta["receives_light"] < 0.5).float()
    tri_cols = [
        meta["kind"].float()[:, None],
        repeat_enc[:, None],
        meta["has_normals"].float()[:, None],
        meta["rgba"].float(),
        meta["ambient"].float(),
        resolve_rect(meta["tex_slot"]),
    ]
    if has_material:
        tri_cols += [meta["rough"][:, None], meta["metal"][:, None]]
    if has_matmap:
        tri_cols += [
            resolve_rect(meta["m1_slot"]),
            resolve_rect(meta["m2_slot"]),
            meta["em_scale"][:, None],
            meta["nmap"][:, None],
            (meta["m1_slot"] >= 0).float()[:, None],
        ]
    if has_blend:
        tri_cols += [
            meta["kind2"].float()[:, None],
            meta["rgba2"].float(),
            resolve_rect(meta["tex_slot2"]),
        ]
    g = torch.cat(tri_cols, dim=1)[tri_id.long()]
    n_front = 14 + (2 if has_material else 0) + (11 if has_matmap else 0)
    cols = [attr_planes[:, :18], g[:, :n_front]]
    if has_blend:
        cols += [
            attr_planes[:, 18:21],
            g[:, n_front:],
            torch.zeros((attr_planes.shape[0], 4), device=g.device),
        ]
    return torch.cat(cols, dim=1)


def _tri_near_bound(vis_planes, bbox, alive, width, y0g, rows_local):
    """Conservative per-candidate nearest invz: the invz plane evaluated at
    the screen-clipped bbox corners (the max over the box bounds the max
    over the triangle). Each corner is `fma(pa, x, pb*y) + pc`, the rounding
    the JAX package's CPU build gives the same expression."""
    bx0 = torch.clamp(bbox[:, 0], 0.0, float(width))
    by0 = torch.clamp(bbox[:, 1], float(y0g), float(y0g + rows_local))
    bx1 = torch.clamp(bbox[:, 2], 0.0, float(width))
    by1 = torch.clamp(bbox[:, 3], float(y0g), float(y0g + rows_local))
    pa, pb, pc = vis_planes[:, 9], vis_planes[:, 10], vis_planes[:, 11]

    def corner(x, y):
        return _fma(pa, x, pb * y) + pc

    tri_near = torch.maximum(
        torch.maximum(corner(bx0, by0), corner(bx1, by0)),
        torch.maximum(corner(bx0, by1), corner(bx1, by1)),
    )
    return torch.where(alive > 0.5, tri_near, float("-inf"))


def morton_ftb_sort(vis_planes, bbox, alive, table, width: int, height: int,
                    y0g=0.0, rows_local: int = None, return_perm: bool = False):
    """Morton + front-to-back super ordering in one row gather.

    Pads every array to a multiple of GROUP rows, orders candidates along
    the Morton curve, then orders the super-chunks nearest-first by their
    near bound. `height` is the whole frame's (the Morton curve's
    normalisation); the near bound clips to rows [y0g, y0g + rows_local),
    the rows one slab of a row-sharded frame owns (default: the whole
    frame). Returns (vis_s, bbox_s, alive_s, table_s, s_near) and, with
    `return_perm`, the sorted position -> original slot permutation."""
    t2 = vis_planes.shape[0]
    pad = (-t2) % GROUP
    if pad:
        vis_planes = torch.nn.functional.pad(vis_planes, (0, 0, 0, pad))
        bbox = torch.nn.functional.pad(bbox, (0, 0, 0, pad))
        alive = torch.nn.functional.pad(alive, (0, pad))
        table = torch.nn.functional.pad(table, (0, 0, 0, pad))
        t2 += pad
    ns = t2 // GROUP
    p1 = morton_perm(bbox, alive, width, height).long()
    rows = float(height if rows_local is None else rows_local)
    tri_near = _tri_near_bound(vis_planes, bbox, alive, width, float(y0g), rows)
    s_near = tri_near[p1].reshape(ns, GROUP).amax(dim=1)
    # stable: dead supers tie at -inf and must keep their index order
    order = torch.argsort(-s_near, stable=True)
    s_near = torch.clamp(s_near[order], min=-1e30)
    perm = p1.reshape(ns, GROUP)[order].reshape(-1)
    nv = vis_planes.shape[1]
    combined = torch.cat([vis_planes, bbox, alive[:, None], table], dim=1)[perm]
    out = (
        combined[:, :nv],
        combined[:, nv : nv + 4],
        combined[:, nv + 4],
        combined[:, nv + 5 :],
        s_near,
    )
    if return_perm:
        return out + (perm.to(torch.int32),)
    return out


def light_spec_from(lights) -> tuple:
    """(row, type) pairs of the VALID light rows (host numpy lights)."""
    types = np.asarray(lights["type"])
    valid = np.asarray(lights["valid"])
    return tuple((i, int(t)) for i, t in enumerate(types) if float(valid[i]) > 0.5)


def light_param_rows(lights) -> np.ndarray:
    """SoA host light dict -> (L, 24) f32 rows (the JAX package's layout;
    the one-hot type columns 3/21/22/23 stay for layout parity)."""
    L = lights["position"].shape[0]
    t = np.asarray(lights["type"]).astype(np.int32)
    out = np.zeros((L, 24), np.float32)
    out[:, 0:3] = lights["position"]
    out[:, 3] = t == 0
    out[:, 21] = (t == 1) | (t == 2)
    out[:, 22] = t == 3
    out[:, 23] = t == 4
    out[:, 4] = lights["start"]
    out[:, 5] = lights["end"]
    out[:, 6] = np.asarray(lights["intensity"], np.float32) * np.asarray(
        lights["flicker_factor"], np.float32
    )
    out[:, 7:10] = lights["color"]
    out[:, 10:13] = lights["direction"]
    out[:, 13] = np.cos(np.asarray(lights["cone_angle"], np.float32))
    out[:, 14] = lights["width"]
    out[:, 15] = lights["height"]
    out[:, 16:19] = lights["normal"]
    out[:, 19] = lights["from_linedef"]
    out[:, 20] = lights["valid"]
    return out


def pack_light_params(lights, device) -> torch.Tensor:
    """light_param_rows on `device`: the rows that came in the frame's arena
    (lights Staged, ops/arena.py), else an upload."""
    staged = staged_pack(lights, "light_params")
    if staged is not None:
        return staged
    return torch.from_numpy(light_param_rows(lights)).to(device)


def occ_param_rows(uniforms) -> np.ndarray:
    """Occluded-sector boxes -> (B, 5) [x0 z0 x1 z1 value] (mini.rs:57);
    one inverted dummy box (matches no pixel) when there is none."""
    if "occ_box" in uniforms:
        box = np.asarray(uniforms["occ_box"], np.float32)
        val = np.asarray(uniforms["occ_val"], np.float32)[:, None]
        return np.concatenate([box, val], axis=1)
    return np.array([[1e9, 1e9, -1e9, -1e9, 1.0]], np.float32)


def pack_occ_params(uniforms, device) -> torch.Tensor:
    """occ_param_rows on `device`: from the frame's arena when the uniforms
    came through one, else an upload."""
    staged = staged_pack(uniforms, "occ_params")
    if staged is not None:
        return staged
    return torch.from_numpy(occ_param_rows(uniforms)).to(device)


def mega_params_key(width: int, height: int, atlas_w, has_fog: bool = False, y0: int = 0,
                    shadow_params=None) -> tuple:
    """What mega_param_row derives its pack from besides the uniforms."""
    return (width, height, atlas_w, has_fog, y0, id(shadow_params))


def pack_mega_params(uniforms, width: int, height: int, atlas_w, device,
                     has_fog: bool = False, y0: int = 0,
                     shadow_params=None) -> torch.Tensor:
    """mega_param_row on `device`: the pack that came in the frame's arena
    for the same arguments (uniforms Staged), else an upload."""
    staged = staged_pack(uniforms, "mega_params",
                         mega_params_key(width, height, atlas_w, has_fog, y0, shadow_params))
    if staged is not None:
        return staged
    return torch.from_numpy(mega_param_row(uniforms, width, height, atlas_w, has_fog, y0,
                                           shadow_params)).to(device)


def mega_param_row(uniforms, width: int, height: int, atlas_w, has_fog: bool = False,
                   y0: int = 0, shadow_params=None) -> np.ndarray:
    """Camera/ambient/sun scalars, fog at 48-53, the atlas width at 54, the
    sun color at 55-57, the row offset at 58, shadow parameters at 59-74,
    bump strength at 75, fog mode/density at 76-77 -> (80,) f32.
    `height` is the whole frame's; `y0` is the first row of a slab of a
    row-sharded frame (0 for a whole frame). shadow_params: the (40,)
    params of shadow.bake_shadow_pack; its first 16 slots (max shadow
    distance, bias, the sun camera) go to 59-74."""
    p = np.zeros(N_PARAMS, np.float32)
    p[75] = uniforms.get("bump_strength", 1.0)
    if shadow_params is not None:
        p[59:75] = np.asarray(shadow_params, np.float32)[:16]
    p[0:16] = np.asarray(uniforms["inv_proj"], np.float32).reshape(-1)
    p[16:32] = np.asarray(uniforms["inv_view"], np.float32).reshape(-1)
    p[32:35] = uniforms["camera_pos"]
    p[35] = uniforms["has_ambient"]
    p[36:39] = np.asarray(uniforms["ambient"])[:3]
    p[41] = width
    p[42] = height
    p[43] = uniforms["has_sun"]
    p[44:47] = uniforms["sun_dir"]
    p[47] = uniforms["day_factor"]
    p[48] = 1.0 if has_fog else 0.0
    p[49:52] = np.asarray(uniforms["fog_color"])[:3]
    p[52] = uniforms["fog_end"]
    p[53] = uniforms["fog_fade"]
    p[54] = atlas_w
    p[55:58] = uniforms.get("sun_color", np.ones(3, np.float32))
    p[58] = y0
    p[76] = uniforms.get("fog_mode", 0.0)
    p[77] = uniforms.get("fog_density", 0.0)
    return p


def pack_background_u32(background) -> torch.Tensor:
    """(H,W,4) f32 0..1 -> (H,W) i32 holding packed RGBA8 (lib.rs:63-68;
    little-endian r,g,b,a)."""
    q = torch.floor(torch.clamp(background, 0.0, 1.0) * 255.0 + 0.5)
    return q.to(torch.uint8).contiguous().view(torch.int32)[..., 0]


def unpack_frame_u32(rgba_u32) -> torch.Tensor:
    """(H,W) packed i32 -> (H,W,4) u8 (byte order r,g,b,a)."""
    h, w = rgba_u32.shape
    return rgba_u32.contiguous().view(torch.uint8).reshape(h, w, 4)


# ---------------------------------------------------------------- the call


def _check_variants(has_blend, has_material, has_matmap, shadow_rows, shadow_spec,
                    s_near, stage_cut=0):
    if stage_cut in (3, 4):
        # the JAX kernel's cuts 3 and 4 sit inside TPU mechanisms: 3 skips
        # the per-chunk pull-in of the winners' attribute rows into VMEM
        # (this kernel tracks a slot index and reads the row once, after the
        # scan), 4 runs only the gates the TPU's scalar core evaluates
        raise NotImplementedError(
            f"megakernel variant stage_cut={stage_cut} is not ported to "
            "rusterix_tpu_torch: it cuts inside a TPU mechanism the CUDA kernel "
            "does not have (3: the per-chunk attribute pull-in; 4: the "
            "scalar-core gates); stage_cut 1 and 2 are"
        )
    if stage_cut not in (0, 1, 2):
        raise ValueError(f"mega_render: stage_cut {stage_cut} is not 0, 1 or 2")
    if has_matmap and not has_material:
        raise ValueError("mega_render: has_matmap implies has_material (the table's fixed "
                         "column layout)")
    if s_near is None:
        raise ValueError("mega_render takes inputs presorted by morton_ftb_sort (s_near)")
    if (shadow_rows is None) != (shadow_spec is None):
        raise ValueError("mega_render: shadow_rows and shadow_spec come together")
    if shadow_rows is not None and shadow_rows.dim() != 1:
        raise ValueError(f"mega_render: shadow_rows is {tuple(shadow_rows.shape)}, not the "
                         "flat (N,) table of shadow.bake_shadow_pack")


def _check_ao(ao_img, height: int, width: int, device):
    """ao_img must be None or an (H, W) f32 tensor on the planes' device."""
    if ao_img is None:
        return None
    if tuple(ao_img.shape) != (height, width) or ao_img.dtype != torch.float32:
        raise ValueError(f"mega_render: ao_img is {tuple(ao_img.shape)} {ao_img.dtype}, "
                         f"not ({height}, {width}) float32")
    if ao_img.device != device:
        raise ValueError(f"mega_render: ao_img is on {ao_img.device}, planes on {device}")
    return ao_img.contiguous()


def _prepare(vis_planes, alive, bbox, attr):
    """Dead candidates -> impossible planes, empty boxes, zero attributes;
    the merged super (GROUP) and chunk (CHUNK) boxes as (n, 4) i32."""
    planes, sboxes, cboxes = prepare_visibility(vis_planes, alive, bbox)
    attr = torch.where((alive > 0.5)[:, None], attr, 0.0)
    return planes, attr.float().contiguous(), sboxes, cboxes


def _light_rows(light_spec, n_rows: int) -> tuple:
    """The light rows the loop visits: light_spec's (row, type code) pairs,
    or for light_spec None every row of the table with type None (the
    generic loop reads each row's type from its one-hot columns)."""
    if light_spec is None:
        return tuple((r, None) for r in range(n_rows))
    return tuple((int(r), int(t)) for r, t in light_spec)


def _light_list(light_spec, device):
    """light_spec -> (n, 2) i32 [row, type code] for the kernel's loop, or
    None for the generic loop, which visits every row in order and derives
    the type codes from the rows on the card."""
    if light_spec is None:
        return None
    return device_table(_light_rows(light_spec, 0), torch.int32, device).reshape(-1, 2)


def _shadow_launch_tables(shadow_rows, shadow_spec, light_rows, device):
    """The shadow variant's launch inputs -> (flat f32 table or None,
    (n_lights, 4) i32 [cube base, res, transmittance base, steps] per light
    of the light list (base -1: the light casts no map; transmittance base
    -1: no transparent layers) or None, (sun base, sun res, transmittance
    base, steps) with base -1 when there is no sun map). `light_rows`:
    _light_rows' list, in the loop's order."""
    if shadow_rows is None:
        return None, None, (-1, 0, -1, 0)
    if shadow_rows.device != device or shadow_rows.dtype != torch.float32:
        raise ValueError(f"mega_render: shadow_rows is {shadow_rows.dtype} on "
                         f"{shadow_rows.device}, not float32 on {device}")
    sun_entry, cube_entries = shadow_spec
    # each map, and each transmittance region: `steps` (depth, alpha) pairs
    # of map-sized planes
    maps = [(int(e[1]), 6 * int(e[2]) ** 2) for e in cube_entries]
    maps += [(int(e[3]), 12 * int(e[4]) * int(e[2]) ** 2) for e in cube_entries if e[3] >= 0]
    if sun_entry is not None:
        maps.append((int(sun_entry[0]), int(sun_entry[1]) ** 2))
        if sun_entry[2] >= 0:
            maps.append((int(sun_entry[2]), 2 * int(sun_entry[3]) * int(sun_entry[1]) ** 2))
    for e in list(cube_entries) + ([sun_entry] if sun_entry is not None else []):
        steps = int(e[-1])
        if e[-2] >= 0 and not 1 <= steps <= 4:
            raise ValueError(f"mega_render: {steps} transmittance steps, not 1-4")
    n = shadow_rows.numel()
    for base, size in maps:
        if base < 0 or base + size > n:
            raise ValueError(f"mega_render: a map of {size} texels at {base} leaves the "
                             f"{n}-texel shadow table")
    cube = {int(e[0]): tuple(int(v) for v in e[1:5]) for e in cube_entries}
    rows = tuple(cube.get(int(r), (-1, 0, -1, 0)) for r, _t in light_rows)
    sun_map = (-1, 0, -1, 0) if sun_entry is None else tuple(int(v) for v in sun_entry)
    return shadow_rows.contiguous(), device_table(rows, torch.int32, device), sun_map


def mega_render(
    vis_planes, alive, bbox, attr, atlas_u32, bg_u32, params, lights_packed,
    occ_packed, width: int, height: int, sample_mode: int = 0,
    has_blend: bool = False, has_material: bool = False,
    has_matmap: bool = False, light_spec: tuple = None, sun_off: bool = False,
    s_near=None, shadow_rows=None, shadow_spec: tuple = None, ao_img=None,
    brdf_ggx: bool = False, tonemap: bool = False, stage_cut: int = 0,
    full_height: int = None,
):
    """One composed opaque frame -> (rgba_u32 (H,W) i32, z_eff (H,W) f32).

    Inputs come from morton_ftb_sort (planes, bbox, alive, table and
    s_near, padded to GROUP rows and in front-to-back super order); the
    atlas is the flat u32 texel array as (N,) i32; bg_u32 from
    pack_background_u32; params, lights and occlusion boxes from the pack_*
    helpers. z_eff is 1.0 where the opaque pass did not write.

    Row-sharded frames: with a row offset y0 in params[58]
    (pack_mega_params(y0=)), the (H, W) outputs, bg_u32 and ao_img are the
    slab of rows [y0, y0 + H) of the frame, and the pixel centres, the
    tiles' box gates, the planes, the lighting, the fog and the shadow
    lookups take the frame's rows (the planes and boxes stay in the
    frame's screen coordinates; params[42] is the frame's height).
    `full_height` is accepted for the JAX signature and ignored.
    `light_spec` lists the (row, type code) of the valid light rows; None
    runs the generic loop, a blend over every row of the table weighted by
    the one-hot type columns (3, 21, 22, 23), which needs no host read of
    the lights and gives the specialised frame's bytes (the
    weights are exact 0 and 1 and the terms they drop finite). `brdf_ggx`
    shades direct light with Cook-Torrance GGX (roughness 0.5, metallic 0)
    instead of the fast Blinn-Phong BRDF. `ao_img`, an (H, W) f32
    ambient-occlusion factor (ops/ao.ssao_pass), multiplies the two ambient
    terms (the hemisphere and the batch ambient) of each shaded pixel.
    `shadow_rows` (the flat f32 table of shadow.bake_shadow_pack, on the
    planes' device) with its `shadow_spec` adds per-light geometry shadows:
    each casting light's cube factor scales that light's radiance, the sun
    map's factor the sun's (params 59-74 from pack_mega_params'
    shadow_params). Where a map has transmittance layers (a spec entry
    with a transmittance base >= 0), each of its `steps` depth-peeled
    transparent layers that lies strictly between the light and the
    receiver, within the max shadow distance, scales the factor by
    (1 - its alpha). `tonemap` encodes the lit colour with the SceneVM
    transform (Reinhard, then gamma 1/2.2 as exp(log(t) / 2.2)) in place
    of the fast sRGB polynomial; fullbright texels keep their raw bytes.
    `has_blend`: the table carries the blend extension (pack_mega_table with
    has_blend); where a winner's kind2 >= 0 its texel mixes toward the
    second source's by the clipped weight plane over 1/w. `has_material`:
    the table carries each batch's constant roughness and metallic, which
    set the Fresnel F0 (per channel), the diffuse and ambient scales and,
    in the fast BRDF, the specular power exp2(shininess * log2(n.h)) with
    shininess = clip(2 / max(roughness^2, 1e-4) - 2, 1, 2048); with
    `brdf_ggx`, the GGX constants. `has_matmap` (with has_material): where a
    winner's matmap is on, its roughness, metallic and emissive come from
    the M1 / M2 sidecar texels at the pixel (the same sampler as the base
    texel); where its shader wrote normals, the decoded normal (2 m2 - 1,
    normalised; zero below length 0.02) replaces the shading normal, or at
    a bump strength (params[75]) between 0 and 1 is mixed with it and
    renormalised; the emissive (M1 rgb times em_scale) is added after the
    lights.

    `stage_cut` is the JAX kernel's profiling instrument: the kernel stops
    after a stage, so that timing cuts 1, 2 and 0 splits its time into the
    scan, the interpolation + texel fetch, and the lighting + fog + pack.
    1: the visibility scan only; the first output is the winning sorted slot
    per pixel (-1 where none), the second the winning 1/z (1.0 where none).
    2: scan + interpolation + texel; the first output is the quantized texel
    (RGBA8) in every 64x128 tile with a winner (opaque black where the pixel
    has none) and the background in the other tiles, the second the winning
    1/z. Cuts 3 and 4 are refused (see _check_variants).

    CUDA tensors launch the hand-written kernel (csrc/megakernel.cu); CPU
    tensors run mega_render_reference."""
    _check_variants(has_blend, has_material, has_matmap, shadow_rows, shadow_spec,
                    s_near, stage_cut)
    if vis_planes.device.type != "cuda":
        return mega_render_reference(
            vis_planes, alive, bbox, attr, atlas_u32, bg_u32, params,
            lights_packed, occ_packed, width, height, sample_mode,
            light_spec=light_spec, sun_off=sun_off, s_near=s_near,
            brdf_ggx=brdf_ggx, stage_cut=stage_cut, ao_img=ao_img,
            shadow_rows=shadow_rows, shadow_spec=shadow_spec, tonemap=tonemap,
            has_blend=has_blend, has_material=has_material, has_matmap=has_matmap,
        )
    return prepare_launch(
        vis_planes, alive, bbox, attr, atlas_u32, bg_u32, params,
        lights_packed, occ_packed, width, height, sample_mode, light_spec,
        sun_off, s_near, brdf_ggx, stage_cut, ao_img, shadow_rows, shadow_spec,
        tonemap, has_blend, has_material, has_matmap,
    )()


def prepare_launch(vis_planes, alive, bbox, attr, atlas_u32, bg_u32, params,
                   lights_packed, occ_packed, width, height, sample_mode, light_spec,
                   sun_off, s_near, brdf_ggx=False, stage_cut=0, ao_img=None,
                   shadow_rows=None, shadow_spec=None, tonemap=False, has_blend=False,
                   has_material=False, has_matmap=False):
    """Check and prepare mega_render's inputs for the CUDA kernel -> a
    function of no arguments that launches the kernel on them and returns
    (rgba, z_eff), the same two tensors at every call. mega_render is one
    such call; timing the returned function alone times the kernel without
    the preparation."""
    from .. import _cuda

    dev = vis_planes.device
    planes, attr, sboxes, cboxes = _prepare(vis_planes, alive, bbox, attr)
    inputs = {
        "s_near": s_near.float().contiguous(),
        "atlas": atlas_u32.contiguous(),
        "bg": bg_u32.contiguous(),
        "params": params.float().contiguous(),
        "lights": lights_packed.float().contiguous(),
        "occ": occ_packed.float().contiguous(),
    }
    for name, t in inputs.items():
        if t.device != dev:
            raise ValueError(f"mega_render: {name} is on {t.device}, planes on {dev}")
    ao_img = _check_ao(ao_img, height, width, dev)
    if inputs["atlas"].dtype != torch.int32 or inputs["bg"].dtype != torch.int32:
        raise TypeError("mega_render: atlas and bg_u32 must be int32 (u32 bits)")
    if tuple(inputs["bg"].shape) != (height, width):
        raise ValueError(f"mega_render: bg_u32 is {tuple(inputs['bg'].shape)}, not {(height, width)}")
    if inputs["params"].numel() != N_PARAMS or inputs["lights"].shape[1] != 24:
        raise ValueError("mega_render: params must be (80,) and lights (L, 24)")
    _check_variants(has_blend, has_material, has_matmap, shadow_rows, shadow_spec,
                    s_near, stage_cut)
    mat = 2 if has_matmap else 1 if has_material else 0
    front = (32, 34, 45)[mat]
    need = front + (12 if has_blend else 0)
    if attr.shape[1] < need:
        raise ValueError(f"mega_render: attr table has {attr.shape[1]} columns, needs {need}")
    if attr.shape[1] % 4:
        # the kernel reads a row as 16-byte loads
        attr = torch.nn.functional.pad(attr, (0, -attr.shape[1] % 4)).contiguous()
    if sample_mode not in (0, 1):
        raise ValueError(f"mega_render: sample_mode {sample_mode} is not 0 or 1")
    n_rows = inputs["lights"].shape[0]
    light_rows = _light_rows(light_spec, n_rows)
    if any(r >= n_rows for r, _t in light_rows):
        raise ValueError("mega_render: light_spec names a row past the light table")
    llist = _light_list(light_spec, dev)
    n_lights = len(light_rows)
    shadow, lshadow, sun_map = _shadow_launch_tables(shadow_rows, shadow_spec, light_rows, dev)
    ns = planes.shape[0] // GROUP
    lib = _cuda.library()
    smem = lib.rx_mega_smem_bytes(ns, n_lights, inputs["occ"].shape[0])
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"mega_render: {ns} supers, {n_lights} lights and {inputs['occ'].shape[0]} "
            f"occlusion boxes need {smem} bytes of shared memory a block; the card has "
            f"{SMEM_PER_BLOCK}")

    rgba = torch.empty((height, width), dtype=torch.int32, device=dev)
    zeff = torch.empty((height, width), dtype=torch.float32, device=dev)
    ptr = ctypes.c_void_p
    call_args = (
        ptr(planes.data_ptr()), ptr(attr.data_ptr()), ptr(sboxes.data_ptr()),
        ptr(cboxes.data_ptr()), ptr(inputs["s_near"].data_ptr()),
        ptr(inputs["atlas"].data_ptr()), ptr(inputs["bg"].data_ptr()),
        ptr(inputs["params"].data_ptr()), ptr(inputs["lights"].data_ptr()),
        ptr(None if llist is None else llist.data_ptr()), ptr(inputs["occ"].data_ptr()),
        ptr(None if ao_img is None else ao_img.data_ptr()),
        ptr(None if shadow is None else shadow.data_ptr()),
        ptr(None if lshadow is None else lshadow.data_ptr()),
        ptr(rgba.data_ptr()), ptr(zeff.data_ptr()),
        ns, attr.shape[1], inputs["atlas"].numel(),
        n_lights, inputs["occ"].shape[0], height, width,
        int(sample_mode), int(bool(sun_off)), int(bool(brdf_ggx)), int(stage_cut),
        int(sun_map[0]), int(sun_map[1]), int(sun_map[2]), int(sun_map[3]),
        int(bool(tonemap)), int(bool(has_blend)), mat,
    )
    # alive while the closure is
    keep = (planes, attr, sboxes, cboxes, inputs, llist, ao_img, shadow, lshadow)

    def launch():
        global launches
        err = lib.rx_mega_render(*call_args, ptr(torch.cuda.current_stream(dev).cuda_stream))
        if err != 0:
            raise RuntimeError(
                f"megakernel launch failed: CUDA error {err} ({_cuda.error_string(err)})")
        launches += 1
        return rgba, zeff

    launch.keep = keep
    return launch


def lookup_fma_cuda(a, b, c):
    """a*b + c through B1's shadow-lookup FMA (`xla_fma`, __fmaf_rn) on the
    card, element for element (f32 CUDA tensors of one shape): the
    operation the plain version writes as `_fma`, for holding the two
    to each other."""
    from .. import _cuda

    a, b, c = (t.float().contiguous() for t in (a, b, c))
    if not (a.is_cuda and a.shape == b.shape == c.shape and a.device == b.device == c.device):
        raise ValueError("lookup_fma_cuda takes three f32 CUDA tensors of one shape")
    out = torch.empty_like(a)
    ptr = ctypes.c_void_p
    err = _cuda.library().rx_xla_fma(ptr(a.data_ptr()), ptr(b.data_ptr()), ptr(c.data_ptr()),
                                     ptr(out.data_ptr()), a.numel(),
                                     ptr(torch.cuda.current_stream(a.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"xla_fma launch failed: CUDA error {err} ({_cuda.error_string(err)})")
    return out


# -------------------------------------------------- the plain torch version


def _srgb_to_linear(x):
    return (0.6975 * x * x + 0.3025) * x


def _linear_to_srgb(x):
    sq = torch.sqrt(torch.clamp(x, min=0.0))
    return 1.055 * sq - 0.055 * (sq * sq)


def _tonemap_scenevm(x):
    """The SceneVM display transform as the JAX kernel writes it (Reinhard,
    then gamma 1/2.2 through exp and log, 3d_shader.wgsl:871-873)."""
    t = torch.clamp(x, min=0.0)
    t = t / (t + 1.0)
    return torch.exp(torch.log(torch.clamp(t, min=1e-30)) * (1.0 / 2.2))


def _smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _apply_repeat(u, v, repeat):
    """texture.rs:203-232 select form (repeat 1 both, 2 u, 3 v, else clamp)."""
    ur = (repeat == 1.0) | (repeat == 2.0)
    vr = (repeat == 1.0) | (repeat == 3.0)
    return (
        torch.where(ur, u - torch.floor(u), torch.clamp(u, 0.0, 1.0)),
        torch.where(vr, v - torch.floor(v), torch.clamp(v, 0.0, 1.0)),
    )


def _texel_lookup(atlas, u, v, rect, kind, rgba_cols, repeat, sample_mode,
                  atlas_w, reads=None, live=None):
    """Texel resolve -> (r, g, b, a) f32 0..1, a direct gather on the flat
    u32 atlas; out-of-range and non-texture pixels read 0. With a `reads`
    list, the flat indices read (by the pixels of `live`, if given) are
    appended to it."""
    is_tex = kind == float(SRC_TEXTURE)
    is_pix = kind == float(SRC_PIXEL)
    uu, vv = _apply_repeat(u, v, repeat)
    uu = torch.where(is_tex, uu, 0.0)
    vv = torch.where(is_tex, vv, 0.0)
    rx, ry, rw, rh = rect
    n = atlas.shape[0]

    def fetch(x, y):
        flat = (ry + y).to(torch.int32) * atlas_w + (rx + x).to(torch.int32)
        ok = is_tex & (flat >= 0) & (flat < n)
        if reads is not None:
            reads.append(flat[ok if live is None else ok & live])
        t32 = torch.where(ok, atlas[torch.where(ok, flat, 0).long()], 0)
        return [((t32 >> s) & 0xFF).float() for s in (0, 8, 16, 24)]

    if sample_mode == 0:
        tx = torch.clamp(torch.floor(uu * (rw - 1.0) + 0.5), torch.zeros_like(rw), rw - 1.0)
        ty = torch.clamp(torch.floor(vv * (rh - 1.0) + 0.5), torch.zeros_like(rh), rh - 1.0)
        tex = fetch(tx, ty)
    else:
        x = uu * (rw - 1.0)
        y = vv * (rh - 1.0)
        x0 = torch.clamp(torch.floor(x), torch.zeros_like(rw), rw - 1.0)
        y0 = torch.clamp(torch.floor(y), torch.zeros_like(rh), rh - 1.0)
        x1 = torch.minimum(x0 + 1.0, rw - 1.0)
        y1 = torch.minimum(y0 + 1.0, rh - 1.0)
        dx = x - torch.floor(x)
        dy = y - torch.floor(y)
        taps = [
            (fetch(x0, y0), (1 - dx) * (1 - dy)),
            (fetch(x1, y0), dx * (1 - dy)),
            (fetch(x0, y1), (1 - dx) * dy),
            (fetch(x1, y1), dx * dy),
        ]
        tex = []
        for c in range(4):
            acc = taps[0][0][c] * taps[0][1]
            for chans, w in taps[1:]:
                acc = acc + chans[c] * w
            tex.append(torch.floor(acc + 0.5))
    is_tex_f = is_tex.float()
    is_pix_f = is_pix.float()
    other = 1.0 - is_tex_f - is_pix_f
    out = []
    for c in range(4):
        val = is_tex_f * tex[c] * (1.0 / 255.0) + is_pix_f * rgba_cols[c]
        if c == 3:
            val = val + other  # SRC_OFF -> opaque black (rasterizer.rs:1222)
        out.append(val)
    return out


def _visibility(planes, sboxes, cboxes, s_near, hp, wp, y0: int = 0):
    """The kernel's scan, tile for tile: supers in front-to-back order,
    super and chunk boxes gating each 64x128 tile, and the tile's early
    stop once s_near[s] <= min(best over the tile). The tiles start at the
    frame's row y0. -> best (hp, wp) in the max-1/z domain, idx (hp, wp)
    i32 sorted slot or -1, and the number of pixel-candidate tests the scan
    performed."""
    dev = planes.device
    n_th, n_tw = hp // TILE_H, wp // TILE_W
    xs = (torch.arange(wp, dtype=torch.float32, device=dev) + 0.5).reshape(
        1, 1, n_tw, TILE_W, 1
    )
    ys = (torch.arange(hp, dtype=torch.float32, device=dev) + float(y0) + 0.5).reshape(
        n_th, TILE_H, 1, 1, 1
    )
    s_hit = tile_box_hits(sboxes, n_th, n_tw, y0)
    c_hit = tile_box_hits(cboxes, n_th, n_tw, y0).repeat_interleave(CHUNK, dim=2)  # per slot
    best = torch.ones((n_th, TILE_H, n_tw, TILE_W), device=dev)
    idx = torch.full((n_th, TILE_H, n_tw, TILE_W), -1, dtype=torch.int32, device=dev)
    minb = torch.ones((n_th, n_tw), device=dev)
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(s_near.shape[0]):
        active = s_hit[:, :, s] & (s_near[s] > minb)
        if not bool(active.any()):
            continue
        for c in range(s * SUPER, (s + 1) * SUPER):
            t0 = c * CHUNK
            gate = active[:, :, None] & c_hit[:, :, t0 : t0 + CHUNK]
            tests += gate.sum()
            best, idx = scan_candidates(
                planes[t0 : t0 + CHUNK], xs, ys, best, idx, t0,
                gate=gate[:, None, :, None, :],
            )
        minb = best.amin(dim=(1, 3))
    return best.reshape(hp, wp), idx.reshape(hp, wp), int(tests) * TILE_H * TILE_W


def _light_terms(lrow, lt, tpx, tpy, tpz, dist, inv_dist, lambert):
    """One light row of a known type code `lt` (the specialised loop: only
    its own type's attenuation path) -> its radiance scale at each pixel
    before the shadow and the colour. `lambert` is max(N.L, 0)."""
    start, end, intensity, valid = lrow[4], lrow[5], lrow[6], lrow[20]
    rng_f = (dist < end).float()
    near_f = (dist <= start).float()
    if lt not in (1, 2, 3):  # point, area, daylight
        smooth_att = near_f + (1.0 - near_f) * _smoothstep(end, start, dist)
    if lt not in (0, 1, 2, 3):  # area and daylight
        angle_att = torch.clamp(
            (lrow[16] * tpx + lrow[17] * tpy + lrow[18] * tpz) * inv_dist, min=0.0
        )
    if lt == 0:
        scale = intensity * smooth_att
    elif lt in (1, 2):
        scale = intensity
    elif lt == 3:
        lin_att = near_f + (1.0 - near_f) * (
            1.0 - (dist - start) / torch.clamp(end - start, min=1e-20)
        )
        cosang = torch.clamp(
            (lrow[10] * tpx + lrow[11] * tpy + lrow[12] * tpz) * inv_dist, -1.0, 1.0
        )
        spot_ok_f = (cosang >= lrow[13]).float()
        scale = spot_ok_f * intensity * lin_att
    elif lt == 4:
        area = lrow[14] * lrow[15]
        area_main = angle_att * smooth_att * area * intensity
        area_linedef = smooth_att * area * intensity
        area_c = lrow[19] * area_linedef + (1.0 - lrow[19]) * area_main
        inner_f = (dist < 0.1).float()
        scale = inner_f + (1.0 - inner_f) * area_c
    else:
        scale = angle_att * smooth_att * intensity
    if lt in (1, 2):
        ok_f = valid
    elif lt == 3:
        ok_f = valid * rng_f * spot_ok_f
    else:
        ok_f = valid * rng_f
    return ok_f * scale * (lambert if lt in (0, 3, 4) else 1.0)


def _generic_light_terms(lrow, tpx, tpy, tpz, dist, inv_dist, lambert):
    """One light row in the generic loop (light_spec None): every type's
    term, blended by the row's one-hot type columns (3 point, 21 ambient,
    22 spot, 23 area, none of them daylight), as the JAX kernel writes it
    (rusterix_tpu/ops/megakernel.py:1144-1272). With exact 0 / 1 weights
    and finite terms it equals _light_terms of the row's type."""
    start, end, intensity, valid = lrow[4], lrow[5], lrow[6], lrow[20]
    f_point, f_amb, f_spot, f_area = lrow[3], lrow[21], lrow[22], lrow[23]
    f_day = 1.0 - f_point - f_amb - f_spot - f_area
    rng_f = (dist < end).float()
    near_f = (dist <= start).float()
    smooth_att = near_f + (1.0 - near_f) * _smoothstep(end, start, dist)
    point_c = intensity * smooth_att
    lin_att = near_f + (1.0 - near_f) * (
        1.0 - (dist - start) / torch.clamp(end - start, min=1e-20)
    )
    cosang = torch.clamp(
        (lrow[10] * tpx + lrow[11] * tpy + lrow[12] * tpz) * inv_dist, -1.0, 1.0
    )
    spot_ok_f = (cosang >= lrow[13]).float()
    spot_c = spot_ok_f * intensity * lin_att
    angle_att = torch.clamp(
        (lrow[16] * tpx + lrow[17] * tpy + lrow[18] * tpz) * inv_dist, min=0.0
    )
    area = lrow[14] * lrow[15]
    area_main = angle_att * smooth_att * area * intensity
    area_linedef = smooth_att * area * intensity
    area_c = lrow[19] * area_linedef + (1.0 - lrow[19]) * area_main
    inner_f = (dist < 0.1).float()
    area_c = inner_f + (1.0 - inner_f) * area_c
    day_c = angle_att * smooth_att * intensity
    scale = (f_point * point_c + f_amb * intensity + f_spot * spot_c + f_area * area_c
             + f_day * day_c)
    ok_f = valid * (f_amb + (1.0 - f_amb) * rng_f)
    ok_f = ok_f * (1.0 - f_spot * (1.0 - spot_ok_f))
    needs = f_point + f_spot + f_area
    lam = needs * lambert + (1.0 - needs)
    return ok_f * scale * lam


def mega_render_reference(
    vis_planes, alive, bbox, attr, atlas_u32, bg_u32, params, lights_packed,
    occ_packed, width: int, height: int, sample_mode: int = 0,
    light_spec: tuple = None, sun_off: bool = False, s_near=None,
    brdf_ggx: bool = False, return_work: bool = False, stage_cut: int = 0,
    ao_img=None, shadow_rows=None, shadow_spec: tuple = None, tonemap: bool = False,
    has_blend: bool = False, has_material: bool = False, has_matmap: bool = False,
):
    """Plain torch version of the megakernel: the kernel body's per-pixel
    math transcribed op for op (the JAX kernel's `_mega_kernel` stages 1-6),
    vectorised over pixels and chunked over candidates in sorted order.
    Same inputs and outputs as mega_render; with `return_work`, a third
    output counts the work this data needs: "vis_tests", the
    pixel-candidate visibility tests the scan performed (gated by the boxes
    and stopped early as the kernel is), "cube_reads" / "sun_reads", the
    shadow-map depth texels read (live pixels only, as the kernel reads
    them), "trans_steps", the transmittance layer steps taken (each
    reads a depth and an alpha texel), and "atlas_texels", the distinct
    atlas texels read (the material sidecars by opaque pixels only, as the
    kernel reads them). `stage_cut` 1 and 2 stop where the kernel's cuts do (see
    mega_render). The row offset is params[58]; light_spec None runs the
    JAX kernel's generic one-hot light blend over every row, term for term."""
    if s_near is None:
        raise ValueError("mega_render_reference needs s_near")
    if stage_cut not in (0, 1, 2):
        raise ValueError(f"mega_render_reference: stage_cut {stage_cut} is not 0, 1 or 2")
    if has_matmap and not has_material:
        raise ValueError("mega_render_reference: has_matmap implies has_material")
    ao_img = _check_ao(ao_img, height, width, vis_planes.device)
    light_rows = _light_rows(light_spec, lights_packed.shape[0])
    _shadow_launch_tables(shadow_rows, shadow_spec, light_rows, vis_planes.device)
    planes, attr, sboxes, cboxes = _prepare(vis_planes, alive, bbox, attr)
    hp = height + (-height % TILE_H)
    wp = width + (-width % TILE_W)
    y0 = int(params[58].item())
    best, idx, tests = _visibility(planes, sboxes, cboxes, s_near.float(), hp, wp, y0)
    work = {"vis_tests": tests, "cube_reads": 0, "sun_reads": 0, "trans_steps": 0,
            "atlas_texels": 0}
    reads = [] if return_work else None

    def count_texels():
        if reads:
            work["atlas_texels"] = int(torch.unique(torch.cat(reads)).numel())
    # a tile shades when any of its pixels, padding included, has a winner
    tile_hit = (idx >= 0).reshape(hp // TILE_H, TILE_H, wp // TILE_W, TILE_W).any(dim=3).any(dim=1)
    tile_hit = tile_hit.repeat_interleave(TILE_H, 0).repeat_interleave(TILE_W, 1)[:height, :width]
    best = best[:height, :width]
    idx = idx[:height, :width]
    if stage_cut == 1:
        out = (idx.contiguous(), best.contiguous())
        return out + (work,) if return_work else out
    hit = idx >= 0
    a = attr[torch.clamp(idx, min=0).long()]  # (H, W, n_attr)
    a = torch.where(hit[..., None], a, 0.0)
    A = [a[..., i] for i in range(32)]
    P = params.float()
    dev = vis_planes.device

    z = 1.0 / best
    xg = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    yg = (torch.arange(height, dtype=torch.float32, device=dev) + float(y0) + 0.5)[:, None]

    # ---- stage 2: plane interpolation ----
    def interp(i):
        return A[3 * i] * xg + A[3 * i + 1] * yg + A[3 * i + 2]

    inv_w = interp(0)
    safe_w = torch.where(inv_w == 0.0, 1.0, inv_w)
    u = interp(1) / safe_w
    v = interp(2) / safe_w
    nx, ny, nz = interp(3), interp(4), interp(5)
    kind = A[18]
    fullbright = (A[19] >= 4.0).float()
    repeat = A[19] - 4.0 * fullbright
    has_n = A[20]
    rgba_cols = A[21:25]
    amb_r, amb_g, amb_b = A[25], A[26], A[27]
    rect = (A[28], A[29], A[30], A[31])

    # ---- stage 3: texel resolve ----
    atlas_w = int(P[54].item())
    tex = _texel_lookup(atlas_u32, u, v, rect, kind, rgba_cols, repeat, sample_mode, atlas_w,
                        reads)
    if has_blend:
        # the blend extension after the material and matmap columns
        mb = 45 if has_matmap else 34 if has_material else 32
        B = [a[..., mb + i] for i in range(12)]
        tex2 = _texel_lookup(atlas_u32, u, v, tuple(B[8:12]), B[3], B[4:8], repeat,
                             sample_mode, atlas_w, reads)
        b_w = torch.clamp((B[0] * xg + B[1] * yg + B[2]) / safe_w, 0.0, 1.0)
        blend_on = (B[3] >= 0.0).float() * b_w
        tex = [t1 * (1.0 - blend_on) + t2 * blend_on for t1, t2 in zip(tex, tex2)]
    tex_r, tex_g, tex_b, tex_a = tex

    def q(x):
        return torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5)

    def pack(r, g, b, alpha):
        packed = torch.stack([r, g, b, alpha], dim=-1)
        return packed.to(torch.uint8).contiguous().view(torch.int32)[..., 0]

    if stage_cut == 2:
        count_texels()
        texel = pack(q(tex_r), q(tex_g), q(tex_b), q(tex_a))
        out = (torch.where(tile_hit, texel, bg_u32), best.contiguous())
        return out + (work,) if return_work else out

    if has_matmap:
        # the per-pixel material sidecars: M1 = emissive rgb (over em_scale)
        # | roughness, M2 = encoded normal (n + 1) / 2 | metallic, read
        # through the base texel's sampler and repeat mode
        m_on = a[..., 44]
        kindm = torch.where(m_on > 0.5, float(SRC_TEXTURE), 0.0)
        zeros4 = [torch.zeros_like(u)] * 4
        opaque = q(tex_a) >= 255.0
        m1 = _texel_lookup(atlas_u32, u, v, tuple(a[..., 34 + i] for i in range(4)), kindm,
                           zeros4, repeat, sample_mode, atlas_w, reads, opaque)
        m2 = _texel_lookup(atlas_u32, u, v, tuple(a[..., 38 + i] for i in range(4)), kindm,
                           zeros4, repeat, sample_mode, atlas_w, reads, opaque)
    count_texels()

    # ---- stage 4: lighting (rasterizer.rs:1319-1412 + light.rs:491-653) ----
    x_ndc = 2.0 * (xg / P[41]) - 1.0
    y_ndc = 1.0 - 2.0 * (yg / P[42])

    def mat(base, r, c):
        return P[base + 4 * r + c]

    def row(base, r, x, y, zz):
        return mat(base, r, 0) * x + mat(base, r, 1) * y + mat(base, r, 2) * zz + mat(base, r, 3)

    vx, vy, vz, vw = (row(0, r, x_ndc, y_ndc, z) for r in range(4))
    inv_vw = 1.0 / vw
    vx, vy, vz = vx * inv_vw, vy * inv_vw, vz * inv_vw
    wx, wy, wz = (row(16, r, vx, vy, vz) for r in range(3))

    vdx, vdy, vdz = P[32] - wx, P[33] - wy, P[34] - wz
    vlen = torch.sqrt(vdx * vdx + vdy * vdy + vdz * vdz)
    inv_vlen = 1.0 / torch.clamp(vlen, min=1e-30)
    vdx, vdy, vdz = vdx * inv_vlen, vdy * inv_vlen, vdz * inv_vlen

    nlen = torch.sqrt(nx * nx + ny * ny + nz * nz)
    inv_nlen = 1.0 / torch.clamp(nlen, min=1e-30)
    ux, uy, uz = nx * inv_nlen, ny * inv_nlen, nz * inv_nlen
    flip = torch.where(ux * vdx + uy * vdy + uz * vdz < 0.0, -1.0, 1.0)
    n_ok = has_n > 0.5
    ux = torch.where(n_ok, ux * flip, 0.0)
    uy = torch.where(n_ok, uy * flip, 0.0)
    uz = torch.where(n_ok, uz * flip, 0.0)

    if has_matmap:
        # a written normal replaces the interpolated one unflipped (or, at a
        # bump strength below 1, mixes with it); byte-127 "zero" texels
        # decode below length 0.02 and keep hemisphere-only lighting
        ndx, ndy, ndz = m2[0] * 2.0 - 1.0, m2[1] * 2.0 - 1.0, m2[2] * 2.0 - 1.0
        dlen = torch.sqrt(ndx * ndx + ndy * ndy + ndz * ndz)
        inv_dlen = torch.where(dlen > 0.02, 1.0 / torch.clamp(dlen, min=1e-30), 0.0)
        use_n = (a[..., 43] > 0.5) & (m_on > 0.5)
        bump_k = P[75]
        wx_n, wy_n, wz_n = ndx * inv_dlen, ndy * inv_dlen, ndz * inv_dlen
        mixed_x = wx_n * bump_k + ux * (1.0 - bump_k)
        mixed_y = wy_n * bump_k + uy * (1.0 - bump_k)
        mixed_z = wz_n * bump_k + uz * (1.0 - bump_k)
        mlen = torch.sqrt(mixed_x * mixed_x + mixed_y * mixed_y + mixed_z * mixed_z)
        inv_ml = torch.where((inv_dlen > 0.0) & (mlen > 1e-20),
                             1.0 / torch.clamp(mlen, min=1e-30), 0.0)
        use_full = use_n & (bump_k >= 1.0)
        use_mix = use_n & (bump_k > 0.0) & (bump_k < 1.0)
        ux = torch.where(use_full, wx_n, torch.where(use_mix, mixed_x * inv_ml, ux))
        uy = torch.where(use_full, wy_n, torch.where(use_mix, mixed_y * inv_ml, uy))
        uz = torch.where(use_full, wz_n, torch.where(use_mix, mixed_z * inv_ml, uz))

    base_r = _srgb_to_linear(tex_r)
    base_g = _srgb_to_linear(tex_g)
    base_b = _srgb_to_linear(tex_b)
    if has_material:
        # the batch's constant material (per pixel from the sidecars where
        # the matmap is on): F0 per channel, the diffuse scale by the
        # largest F0, the ambient by the constant 0.04 F0
        m_rough = torch.clamp(a[..., 32], 0.0, 1.0)
        m_metal = torch.clamp(a[..., 33], 0.0, 1.0)
        if has_matmap:
            m_rough = torch.where(m_on > 0.5, m1[3], m_rough)
            m_metal = torch.where(m_on > 0.5, m2[3], m_metal)
        f0_r = 0.04 + (base_r - 0.04) * m_metal
        f0_g = 0.04 + (base_g - 0.04) * m_metal
        f0_b = 0.04 + (base_b - 0.04) * m_metal
        f0_max = torch.maximum(f0_r, torch.maximum(f0_g, f0_b))
        kd_scale = (1.0 - m_metal) * (1.0 - f0_max)
        kd_r, kd_g, kd_b = base_r * kd_scale, base_g * kd_scale, base_b * kd_scale
        ka_scale = (1.0 - m_metal) * 0.96
        ka_r, ka_g, ka_b = base_r * ka_scale, base_g * ka_scale, base_b * ka_scale
        alpha_m = torch.clamp(m_rough * m_rough, min=1e-4)
        shininess = torch.clamp(2.0 / alpha_m - 2.0, 1.0, 2048.0)
        r_g = torch.clamp(m_rough, 0.045, 1.0)
        a_g = r_g * r_g
        a2, k_g, metal_g = a_g * a_g, (r_g + 1.0) * (r_g + 1.0) * 0.125, m_metal
    else:
        kd_r = base_r * 0.96
        kd_g = base_g * 0.96
        kd_b = base_b * 0.96
        ka_r, ka_g, ka_b = kd_r, kd_g, kd_b
        f0_r = f0_g = f0_b = None
        # roughness 0.5 and metallic 0 folded into the GGX constants:
        # a2 = 0.5^4, Smith k = 1.5^2 / 8
        a2, k_g, metal_g = 0.0625, 0.28125, None

    def fresnel(x5):
        if f0_r is None:
            fr = 0.04 + 0.96 * x5
            return fr, fr, fr
        return f0_r + (1.0 - f0_r) * x5, f0_g + (1.0 - f0_g) * x5, f0_b + (1.0 - f0_b) * x5

    hemi = 0.5 * (uy + 1.0)
    if ao_img is not None:
        hemi = hemi * ao_img

    # ---- per-light geometry shadows (ops/shadow.py's lookup, in the JAX
    # kernel's expression order); texels are read only for live pixels:
    # covered and, for a cube, inside the light's range (Chebyshev ma0 <=
    # dist, so ma0 >= end means no radiance)
    Lp = lights_packed.float()
    shadow_cube, sun_shadow = {}, None
    if shadow_spec is not None:
        sun_entry, cube_entries = shadow_spec
        sp = P[59:75]  # max shadow distance, bias, the sun camera
        for entry in cube_entries:
            lrow = Lp[entry[0]]
            ma0 = torch.maximum((wx - lrow[0]).abs(),
                                torch.maximum((wy - lrow[1]).abs(), (wz - lrow[2]).abs()))
            shadow_cube[entry[0]], reads = shadow_factor(
                shadow_rows, sp, entry, wx, wy, wz, ux, uy, uz, lpos=lrow[0:3],
                live=hit & (ma0 < lrow[5]), return_reads=True)
            if return_work:
                work["cube_reads"] += int(reads.sum())
                work["trans_steps"] += int(reads.sum()) * (entry[4] if entry[3] >= 0 else 0)
        if sun_entry is not None and not sun_off:
            sun_shadow, reads = shadow_factor(shadow_rows, sp, sun_entry, wx, wy, wz, ux, uy, uz,
                                              live=hit, return_reads=True)
            if return_work:
                work["sun_reads"] = int(reads.sum())
                work["trans_steps"] += int(reads.sum()) * (sun_entry[3] if sun_entry[2] >= 0 else 0)

    occlusion = torch.ones_like(wx)
    occ = occ_packed.float()
    for bi in range(occ.shape[0]):
        inside = (wx >= occ[bi, 0]) & (wz >= occ[bi, 1]) & (wx <= occ[bi, 2]) & (wz <= occ[bi, 3])
        occlusion = torch.minimum(occlusion, torch.where(inside, occ[bi, 4], 1.0))

    lit_r = P[35] * P[36] * ka_r * hemi
    lit_g = P[35] * P[37] * ka_g * hemi
    lit_b = P[35] * P[38] * ka_b * hemi

    def brdf_fast(ldx, ldy, ldz, rad_r, rad_g, rad_b):
        n_dot_l = torch.clamp(ux * ldx + uy * ldy + uz * ldz, min=0.0)
        hx, hy, hz = ldx + vdx, ldy + vdy, ldz + vdz
        hl = torch.sqrt(hx * hx + hy * hy + hz * hz)
        inv_hl = 1.0 / torch.clamp(hl, min=1e-30)
        n_dot_h = torch.clamp((ux * hx + uy * hy + uz * hz) * inv_hl, min=0.0)
        if has_material:
            spec_b = torch.where(
                n_dot_h > 0.0,
                torch.exp2(shininess * torch.log2(torch.clamp(n_dot_h, min=1e-38))), 0.0)
        else:
            nh2 = n_dot_h * n_dot_h
            spec_b = nh2 * nh2 * nh2
        n_dot_v = torch.clamp(ux * vdx + uy * vdy + uz * vdz, min=0.0)
        x1 = 1.0 - torch.clamp(n_dot_v, 0.0, 1.0)
        x2 = x1 * x1
        x5 = x2 * x2 * x1
        fr, fg, fb = fresnel(x5)
        sb = spec_b * n_dot_l
        dead = n_dot_l <= 0.0
        return (
            torch.where(dead, 0.0, (kd_r * n_dot_l + fr * sb) * rad_r),
            torch.where(dead, 0.0, (kd_g * n_dot_l + fg * sb) * rad_g),
            torch.where(dead, 0.0, (kd_b * n_dot_l + fb * sb) * rad_b),
        )

    def brdf_ggx_fn(ldx, ldy, ldz, rad_r, rad_g, rad_b):
        # Cook-Torrance GGX (the JAX kernel's `brdf` closure): the material's
        # constants, or roughness 0.5 and metallic 0 folded in
        k = k_g
        n_dot_l = torch.clamp(ux * ldx + uy * ldy + uz * ldz, min=0.0)
        n_dot_v = torch.clamp(ux * vdx + uy * vdy + uz * vdz, min=0.0)
        hx, hy, hz = ldx + vdx, ldy + vdy, ldz + vdz
        hl = torch.sqrt(hx * hx + hy * hy + hz * hz)
        inv_hl = 1.0 / torch.clamp(hl, min=1e-30)
        n_dot_h = torch.clamp((ux * hx + uy * hy + uz * hz) * inv_hl, min=0.0)
        denom_d = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
        dist = a2 / (3.14159265358979 * denom_d * denom_d + 1e-7)
        gv = n_dot_v / (n_dot_v * (1.0 - k) + k + 1e-7)
        gl = n_dot_l / (n_dot_l * (1.0 - k) + k + 1e-7)
        s = dist * gv * gl / (4.0 * n_dot_l * n_dot_v + 1e-7)
        h_dot_v = torch.clamp((hx * vdx + hy * vdy + hz * vdz) * inv_hl, min=0.0)
        x1 = 1.0 - torch.clamp(h_dot_v, 0.0, 1.0)
        x2 = x1 * x1
        x5 = x2 * x2 * x1
        fr, fg, fb = fresnel(x5)
        # (1 - metallic) * n.l / pi; without material 1 - 0 is exact
        dd = n_dot_l * 0.31830988618379 if metal_g is None else \
            (1.0 - metal_g) * n_dot_l * 0.31830988618379
        sl = s * n_dot_l
        dead = (n_dot_l <= 0.0) | (n_dot_v <= 0.0)
        return (
            torch.where(dead, 0.0, ((1.0 - fr) * dd * base_r + fr * sl) * rad_r),
            torch.where(dead, 0.0, ((1.0 - fg) * dd * base_g + fg * sl) * rad_g),
            torch.where(dead, 0.0, ((1.0 - fb) * dd * base_b + fb * sl) * rad_b),
        )

    brdf = brdf_ggx_fn if brdf_ggx else brdf_fast

    if not sun_off:
        sdx, sdy, sdz = -P[44], -P[45], -P[46]
        slen = torch.sqrt(sdx * sdx + sdy * sdy + sdz * sdz)
        inv_slen = 1.0 / torch.clamp(slen, min=1e-30)
        day = P[47]
        day_rgb = [day * P[55], day * P[56], day * P[57]]
        if sun_shadow is not None:
            day_rgb = [c * sun_shadow for c in day_rgb]
        sr, sg, sb = brdf(sdx * inv_slen, sdy * inv_slen, sdz * inv_slen, *day_rgb)
        lit_r = lit_r + P[43] * sr
        lit_g = lit_g + P[43] * sg
        lit_b = lit_b + P[43] * sb

    lit_r = lit_r * occlusion
    lit_g = lit_g * occlusion
    lit_b = lit_b * occlusion
    lit_r = lit_r + amb_r * ka_r * hemi
    lit_g = lit_g + amb_g * ka_g * hemi
    lit_b = lit_b + amb_b * ka_b * hemi

    for li, lt in light_rows:
        lrow = Lp[li]
        tpx, tpy, tpz = wx - lrow[0], wy - lrow[1], wz - lrow[2]
        dist = torch.sqrt(tpx * tpx + tpy * tpy + tpz * tpz)
        inv_dist = 1.0 / torch.clamp(dist, min=1e-20)
        ldx, ldy, ldz = -tpx * inv_dist, -tpy * inv_dist, -tpz * inv_dist
        lambert = torch.clamp(ux * ldx + uy * ldy + uz * ldz, min=0.0)
        if lt is None:
            rad = _generic_light_terms(lrow, tpx, tpy, tpz, dist, inv_dist, lambert)
        else:
            rad = _light_terms(lrow, lt, tpx, tpy, tpz, dist, inv_dist, lambert)
        if li in shadow_cube:
            rad = rad * shadow_cube[li]
        rad_r, rad_g, rad_b = lrow[7] * rad, lrow[8] * rad, lrow[9] * rad
        cr, cg, cb = brdf(ldx, ldy, ldz, rad_r, rad_g, rad_b)
        has_rad = ((rad_r != 0.0) | (rad_g != 0.0) | (rad_b != 0.0)).float()
        lit_r = lit_r + has_rad * cr
        lit_g = lit_g + has_rad * cg
        lit_b = lit_b + has_rad * cb

    if has_matmap:
        # emissive, once, after every light
        em = m_on * a[..., 42]
        lit_r = lit_r + m1[0] * em
        lit_g = lit_g + m1[1] * em
        lit_b = lit_b + m1[2] * em

    encode = _tonemap_scenevm if tonemap else _linear_to_srgb
    out_r = encode(lit_r)
    out_g = encode(lit_g)
    out_b = encode(lit_b)
    # fullbright batches bypass lighting entirely (raw sRGB texel)
    out_r = fullbright * tex_r + (1.0 - fullbright) * out_r
    out_g = fullbright * tex_g + (1.0 - fullbright) * out_g
    out_b = fullbright * tex_b + (1.0 - fullbright) * out_b

    # ---- stage 5: distance fog (linear node fade or SceneVM exp^2) ----
    fog_lin = torch.clamp((vlen - P[52]) / P[53], 0.0, 1.0)
    fog_exp = 1.0 - torch.exp(-P[77] * vlen * vlen)
    fog_t = P[48] * (P[76] * fog_exp + (1.0 - P[76]) * fog_lin)
    out_r = out_r * (1.0 - fog_t) + P[49] * fog_t
    out_g = out_g * (1.0 - fog_t) + P[50] * fog_t
    out_b = out_b * (1.0 - fog_t) + P[51] * fog_t

    # ---- stage 6: compose + RGBA8 pack ----
    a_u8 = q(tex_a)
    wrote = hit & (a_u8 >= 255)
    rgba = torch.where(wrote, pack(q(out_r), q(out_g), q(out_b), a_u8), bg_u32)
    zeff = torch.where(wrote, z, 1.0)
    return (rgba, zeff, work) if return_work else (rgba, zeff)

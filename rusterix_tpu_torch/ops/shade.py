"""G-buffer reconstruction from the visibility winners (torch counterpart of
`rusterix_tpu/ops/shade.py`, the parts the reflection pass needs).

`gbuffer_pass` re-derives, per pixel, the world position, the shading
normal facing the viewer, the linear albedo and the material of the winning
candidate from the setup pass's attribute planes and the packed scene's
per-triangle fields. It takes the unblended scenes without material,
matmap or runtime shaders; the other variants raise NotImplementedError.

The atlas is the port's flat u32 texel array (`packed_to_torch`); a texel
index outside it reads 255 in every channel, as the JAX package's gather
(`jnp.take`, mode "fill" on a u8 table) does.

Products are written out in the rounding XLA's CPU build gives the JAX
package's expressions where a discrete outcome depends on them: `screen_to_world`'s 4x4
products sum pairwise, as XLA's einsum does, and 3-term dots (the
normalizations) are fused chains (`_fma`). On the 128x64 map the world
positions are then bit-equal to the JAX package's and the view directions
differ in the last bit on 13 of 8192 pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.color import srgb_to_linear_fast
from .scene_pack import SRC_PIXEL, SRC_TEXTURE
from .setup_pass import _fma

REPEAT_XY = 1
REPEAT_X = 2
REPEAT_Y = 3


def _round_half_away(x):
    """Rust f32::round (half away from zero) for non-negative inputs."""
    return torch.floor(x + 0.5)


def apply_repeat(u, v, repeat):
    """reference src/texture.rs:203-232 (vectorized select)."""
    u_out = torch.where((repeat == REPEAT_XY) | (repeat == REPEAT_X),
                        u - torch.floor(u), torch.clamp(u, 0.0, 1.0))
    v_out = torch.where((repeat == REPEAT_XY) | (repeat == REPEAT_Y),
                        v - torch.floor(v), torch.clamp(v, 0.0, 1.0))
    return u_out, v_out


def _take(table, idx):
    """table[idx] with indices outside the table clamped (the lanes they
    feed are masked by the caller, or read the fill value)."""
    return table[torch.clamp(idx.long(), 0, table.shape[0] - 1)]


def _to_int(x):
    """f32 -> i32 as XLA converts: truncation, saturating at the i32 range,
    NaN to 0 (only pixels no caller reads carry such values)."""
    x = torch.clamp(x, -2147483648.0, 2147483520.0)
    return torch.where(torch.isnan(x), 0.0, x).to(torch.int32)


def _texels(atlas, flat):
    """RGBA8 texels at flat atlas indices -> (..., 4) f32 0..255; indices
    outside the atlas read 255 (the JAX gather's fill for u8)."""
    tab = atlas["flat_u32"]
    ok = (flat >= 0) & (flat < tab.shape[0])
    t32 = tab[torch.where(ok, flat, 0).long()]
    chans = torch.stack([(t32 >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1)
    return torch.where(ok[..., None], chans, 255).float()


def sample_atlas_nearest(atlas, tex_id, u, v):
    """Nearest texel (reference src/texture.rs:307-324): round(u*(w-1)),
    clamped -> (..., 4) f32 0..255."""
    r = _take(atlas["rects"], tex_id)
    rx, ry, rw, rh = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    tx = _to_int(_round_half_away(u * (rw.float() - 1.0)))
    ty = _to_int(_round_half_away(v * (rh.float() - 1.0)))
    tx = torch.minimum(torch.clamp(tx, min=0), rw - 1)
    ty = torch.minimum(torch.clamp(ty, min=0), rh - 1)
    return _texels(atlas, (ry + ty) * atlas["w"] + (rx + tx))


def sample_atlas_linear(atlas, tex_id, u, v):
    """Bilinear (reference src/texture.rs:414-460) -> (..., 4) f32 0..255."""
    r = _take(atlas["rects"], tex_id)
    rx, ry, rw, rh = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    x = u * (rw.float() - 1.0)
    y = v * (rh.float() - 1.0)
    x0 = _to_int(torch.floor(x))
    y0 = _to_int(torch.floor(y))
    x1 = torch.minimum(x0 + 1, rw - 1)
    y1 = torch.minimum(y0 + 1, rh - 1)
    x0 = torch.minimum(torch.clamp(x0, min=0), rw - 1)
    y0 = torch.minimum(torch.clamp(y0, min=0), rh - 1)
    dx = (x - torch.floor(x))[..., None]
    dy = (y - torch.floor(y))[..., None]

    def tex(xx, yy):
        return _texels(atlas, (ry + yy) * atlas["w"] + (rx + xx))

    c = (
        tex(x0, y0) * (1 - dx) * (1 - dy)
        + tex(x1, y0) * dx * (1 - dy)
        + tex(x0, y1) * (1 - dx) * dy
        + tex(x1, y1) * dx * dy
    )
    return _round_half_away(c)


def resolve_texel(kind, tex_slot, rgba, repeat, u, v, atlas, anim_frame,
                  sample_mode: int, default_alpha: float = 1.0):
    """Per-pixel texel resolve for all source kinds at once -> RGBA 0..1.

    atlas: the port's dict ("flat_u32", "w", "rects", "tile_first",
    "tile_count")."""
    uu, vv = apply_repeat(u, v, repeat)
    slot = torch.clamp(tex_slot, min=0)
    count = torch.clamp(_take(atlas["tile_count"], slot), min=1)
    tex_id = _take(atlas["tile_first"], slot) + torch.remainder(
        torch.as_tensor(int(anim_frame), dtype=count.dtype, device=count.device), count
    )
    sample = sample_atlas_nearest if sample_mode == 0 else sample_atlas_linear
    tx = sample(atlas, tex_id, uu, vv) * (1.0 / 255.0)

    texel = torch.where((kind == SRC_TEXTURE)[..., None], tx, 0.0)
    texel = torch.where((kind == SRC_PIXEL)[..., None], rgba, texel)
    # SRC_OFF / unsupported -> opaque black (rasterizer.rs:1222)
    is_other = (kind != SRC_TEXTURE) & (kind != SRC_PIXEL)
    black = torch.zeros_like(rgba)
    black[..., 3] = default_alpha
    return torch.where(is_other[..., None], black, texel)


def _dot(a, b):
    """3-term dot over the last axis as XLA's CPU reduction fuses it:
    fma(a2, b2, fma(a1, b1, a0*b0))."""
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _normalize(v, eps=1e-30):
    n = torch.sqrt(_dot(v, v))[..., None]
    return v / torch.clamp(n, min=eps)


def _mat_vec_pairwise(m, v):
    """rows of m (4, 4) against the 4 component fields v -> 4 fields, each
    (m0*v0 + m1*v1) + (m2*v2 + m3*v3): XLA's einsum at HIGHEST on the CPU."""
    out = []
    for i in range(4):
        p = [m[i, j] * v[j] for j in range(4)]
        out.append((p[0] + p[1]) + (p[2] + p[3]))
    return out


def _div(x, d: float):
    """x / d with d as an f32 tensor on x's device: CUDA divides by a
    Python number as x * (1/d), which rounds differently from x / d."""
    return x / torch.tensor(d, dtype=torch.float32, device=x.device)


def screen_to_world(px, py, z_ndc, inv_proj, inv_view, width, height):
    """reference rasterizer.rs:1707-1728 -> (..., 3). inv_proj and inv_view
    are (4, 4) f32 tensors on the fields' device."""
    x_ndc = 2.0 * _div(px, width) - 1.0
    y_ndc = 1.0 - 2.0 * _div(py, height)
    view = _mat_vec_pairwise(inv_proj, [x_ndc, y_ndc, z_ndc, torch.ones_like(px)])
    view = [c / view[3] for c in view]
    world = _mat_vec_pairwise(inv_view, view)
    return torch.stack(world[:3], dim=-1)


def _uniform(uniforms, key, device):
    return torch.from_numpy(np.ascontiguousarray(uniforms[key], np.float32)).to(device)


def gbuffer_pass(z, idx, hit, attr_planes, tri_id, meta, atlas, uniforms,
                 width: int, height: int, sample_mode: int = 0,
                 has_blend: bool = False, has_material: bool = False,
                 has_matmap: bool = False, shaders: tuple = (), stride: int = 1):
    """Per-pixel G-buffer from the winning candidates -> dict of (H, W)
    and (H, W, 3) fields: world, view_dir, normal, base, roughness,
    metallic, texel (RGBA 0..1), fullbright.

    z, idx, hit: the visibility result at (height, width), idx indexing the
    setup pass's (unsorted) candidate slots; attr_planes (T2, 21) and
    tri_id (T2,) from the setup pass; meta: the packed d3 fields; uniforms:
    the Rasterizer's host dict. `stride` > 1: the (height, width) inputs
    are every stride-th pixel of a full-resolution frame; the attribute
    planes (full-resolution screen space) are evaluated at the true pixel
    centres x*stride + 0.5 and the unprojection uses the full frame's size."""
    refused = {
        "vertex blend (has_blend)": has_blend,
        "material (has_material)": has_material,
        "matmap (has_matmap)": has_matmap,
        "runtime shaders": bool(shaders),
    }
    for name, on in refused.items():
        if on:
            raise NotImplementedError(
                f"gbuffer_pass with {name} is not ported to rusterix_tpu_torch yet")
    dev = z.device
    slot = torch.clamp(idx, min=0).long()

    # one fused row gather: the 18 plane floats and the meta fields of the
    # winner; receives_light=False rides the repeat column as +4
    repeat_enc = meta["repeat"].float() + 4.0 * (meta["receives_light"] < 0.5).float()
    meta_mat = torch.cat([
        meta["kind"].float()[:, None],
        meta["tex_slot"].float()[:, None],
        repeat_enc[:, None],
        meta["has_normals"].float()[:, None],
        meta["shader"].float()[:, None],
        meta["rgba"].float(),
        meta["ambient"].float(),
    ], dim=1)
    fused = torch.cat([attr_planes[:, :18], meta_mat[tri_id.long()]], dim=1)
    g = fused[slot]  # (H, W, 30)
    planes = g[..., :18]
    kind = g[..., 18].to(torch.int32)
    tex_slot = g[..., 19].to(torch.int32)
    repeat = g[..., 20].to(torch.int32)
    fullbright = repeat >= 4
    repeat = repeat & 3
    has_n = g[..., 21]
    rgba = g[..., 23:27]

    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] * stride + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None] * stride + 0.5
    px, py = px.expand(height, width), py.expand(height, width)

    def interp(i):
        return planes[..., 3 * i] * px + planes[..., 3 * i + 1] * py + planes[..., 3 * i + 2]

    inv_w = interp(0)
    u = interp(1) / inv_w
    v = interp(2) / inv_w
    n_raw = torch.stack([interp(3), interp(4), interp(5)], dim=-1)

    world = screen_to_world(
        px, py, z, _uniform(uniforms, "inv_proj", dev), _uniform(uniforms, "inv_view", dev),
        float(width * stride), float(height * stride),
    )

    # normal: interpolate, then flip toward the viewer (rasterizer.rs:1083-1099)
    n_unit = _normalize(n_raw)
    view_dir = _normalize(_uniform(uniforms, "camera_pos", dev) - world)
    n_flip = torch.where((_dot(n_unit, view_dir) < 0.0)[..., None], -n_unit, n_unit)
    normal = torch.where(has_n[..., None] > 0.5, n_flip, 0.0)

    texel = resolve_texel(kind, tex_slot, rgba, repeat, u, v, atlas,
                          uniforms["anim_frame"], sample_mode)
    return {
        "world": world,
        "view_dir": view_dir,
        "normal": normal,
        "base": srgb_to_linear_fast(texel[..., :3]),
        "roughness": torch.full_like(u, 0.5),
        "metallic": torch.zeros_like(u),
        "texel": texel,
        "fullbright": fullbright,
    }

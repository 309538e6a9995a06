"""G-buffer reconstruction from the visibility winners (torch counterpart of
`rusterix_tpu/ops/shade.py`, the parts the reflection pass needs).

`gbuffer_pass` re-derives, per pixel, the world position, the shading
normal facing the viewer, the linear albedo and the material of the winning
candidate from the setup pass's attribute planes and the packed scene's
per-triangle fields, with vertex-blended batches mixed toward their second
texel and baked shaders' materials (the batch's constant roughness and
metallic, or the per-pixel M1 / M2 sidecar texels with the emissive and a
written normal). Runtime shaders raise NotImplementedError.
`light_radiance` evaluates every light at every pixel (the 2D pass's
lights).

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


def _sqrt_f32(x):
    """The correctly rounded f32 square root (XLA's and CUDA's), taken in
    f64 (torch's vectorised f32 CPU square root misses the last bit on some
    inputs)."""
    return torch.sqrt(x.double()).float()


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


# light type codes (models/light.py LightType)
LT_POINT = 0
LT_AMBIENT = 1
LT_AMBIENT_DAYLIGHT = 2
LT_SPOT = 3
LT_AREA = 4
LT_DAYLIGHT = 5


def lights_to_torch(lights, device) -> dict:
    """The host SoA light dict (models.pack_lights plus "flicker_factor")
    -> the same fields as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in lights.items()}


def _smoothstep(edge0, edge1, x):
    """t*t*(3 - 2t) with 3 - 2t fused, as XLA's CPU build rounds it."""
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * _fma(t, -2.0, 3.0)


def light_radiance(lights, world, normal, d2: bool = False):
    """`CompiledLight::radiance_at` over all pixels x lights (JAX
    `ops/shade.py::light_radiance`; light.rs:491-653).

    lights: lights_to_torch's dict; world (..., 3); normal (..., 3) or
    None. `d2` takes the 2D area-light footprint (the map view's lights lie
    in the x/z plane). -> radiance (..., L, 3), zero for invalid or
    out-of-range contributions."""
    lp = lights["position"]
    lt = lights["type"]
    w = world[..., None, :]
    to_point = w - lp
    # the square root in f64: torch's vectorised f32 CPU square root is not
    # correctly rounded (XLA's and CUDA's are)
    dist = torch.sqrt(_dot(to_point, to_point).double()).float()

    start = lights["start"]
    end = lights["end"]
    intensity = lights["intensity"] * lights["flicker_factor"]
    color = lights["color"]

    in_range = dist < end
    smooth_att = torch.where(dist <= start, 1.0, _smoothstep(end, start, dist))

    point_c = intensity * smooth_att
    ambient_c = intensity.expand(dist.shape)
    lin_att = torch.where(
        dist <= start, 1.0, 1.0 - (dist - start) / torch.clamp(end - start, min=1e-20))
    dir_to_point = to_point / torch.clamp(dist, min=1e-20)[..., None]
    cosang = torch.clamp(_dot(lights["direction"].expand(dir_to_point.shape), dir_to_point),
                         -1.0, 1.0)
    spot_ok = torch.arccos(cosang) <= lights["cone_angle"]
    spot_c = torch.where(spot_ok, intensity * lin_att, 0.0)

    area = lights["width"] * lights["height"]
    angle_att = torch.clamp(_dot(lights["normal"].expand(dir_to_point.shape), dir_to_point),
                            min=0.0)
    if d2:
        ax = torch.clamp(1.0 - (to_point[..., 0] / (lights["width"] * 0.5)).abs(), min=0.0)
        ay = torch.clamp(1.0 - (to_point[..., 1] / (lights["height"] * 0.5)).abs(), min=0.0)
        area_main = ax * ay * smooth_att * lights["intensity"]
    else:
        area_main = angle_att * smooth_att * area * lights["intensity"]
    area_linedef = smooth_att * area * lights["intensity"]
    area_c = torch.where(lights["from_linedef"] > 0.5, area_linedef, area_main)
    area_c = torch.where(dist < 0.1, 1.0, area_c)
    day_c = angle_att * smooth_att * lights["intensity"]

    is_amb = (lt == LT_AMBIENT) | (lt == LT_AMBIENT_DAYLIGHT)
    scale = torch.where(lt == LT_POINT, point_c, torch.where(
        is_amb, ambient_c, torch.where(lt == LT_SPOT, spot_c, torch.where(
            lt == LT_AREA, area_c, day_c))))
    # ambient lights have no range; spots add the cone
    valid = torch.where(is_amb, lights["valid"] > 0.5, (lights["valid"] > 0.5) & in_range)
    valid = valid & torch.where(lt == LT_SPOT, spot_ok, True)
    incoming = color * scale[..., None]
    if normal is not None:
        to_light = lp - w
        ldir = to_light / torch.clamp(
            torch.sqrt(_dot(to_light, to_light).double()).float(), min=1e-30)[..., None]
        lambert = torch.clamp(_dot(normal[..., None, :], ldir), min=0.0)
        needs_lambert = ~(is_amb | (lt == LT_DAYLIGHT))
        incoming = incoming * torch.where(needs_lambert, lambert, 1.0)[..., None]
    return torch.where(valid[..., None], incoming, 0.0)


def gbuffer_pass(z, idx, hit, attr_planes, tri_id, meta, atlas, uniforms,
                 width: int, height: int, sample_mode: int = 0,
                 has_blend: bool = False, has_material: bool = False,
                 has_matmap: bool = False, shaders: tuple = (), stride: int = 1,
                 y0: int = 0, full_height: int = None):
    """Per-pixel G-buffer from the winning candidates -> dict of (H, W)
    and (H, W, 3) fields: world, view_dir, normal, base, roughness,
    metallic, texel (RGBA 0..1), fullbright.

    z, idx, hit: the visibility result at (height, width), idx indexing the
    setup pass's (unsorted) candidate slots; attr_planes (T2, 21) and
    tri_id (T2,) from the setup pass; meta: the packed d3 fields; uniforms:
    the Rasterizer's host dict. `stride` > 1: the (height, width) inputs
    are every stride-th pixel of a full-resolution frame; the attribute
    planes (full-resolution screen space) are evaluated at the true pixel
    centres x*stride + 0.5 and the unprojection uses the full frame's size.
    `y0` offsets the pixel rows (a slab of a row-sharded frame) and
    `full_height` is then the frame's height (default height * stride),
    which the unprojection takes.
    `has_blend`: attr_planes carry the blend weight plane (columns 18-20)
    and meta kind2 / tex_slot2 / rgba2; where kind2 >= 0 the texel mixes
    toward the second source by the clipped perspective-correct weight.
    `has_material`: meta rough / metal are the batches' constant material
    (clipped to [0, 1]); `has_matmap` (with has_material): where a winner's
    m1_slot >= 0 its roughness, metallic and emissive (M1 rgb times
    em_scale) come from the M1 / M2 sidecar texels at the pixel, and where
    its nmap is set the decoded M2 normal replaces the shading normal (or,
    at uniforms["bump_strength"] between 0 and 1, mixes into it), as the
    JAX package's gbuffer_pass computes them."""
    if shaders:
        raise NotImplementedError(
            "gbuffer_pass with runtime shaders is not ported to rusterix_tpu_torch yet")
    if has_matmap and not has_material:
        raise ValueError("gbuffer_pass: has_matmap implies has_material")
    dev = z.device
    slot = torch.clamp(idx, min=0).long()

    # one fused row gather: the 18 plane floats and the meta fields of the
    # winner; receives_light=False rides the repeat column as +4
    repeat_enc = meta["repeat"].float() + 4.0 * (meta["receives_light"] < 0.5).float()
    meta_cols = [
        meta["kind"].float()[:, None],
        meta["tex_slot"].float()[:, None],
        repeat_enc[:, None],
        meta["has_normals"].float()[:, None],
        meta["shader"].float()[:, None],
        meta["rgba"].float(),
        meta["ambient"].float(),
    ]
    if has_material:
        meta_cols += [meta["rough"].float()[:, None], meta["metal"].float()[:, None]]
    if has_matmap:
        meta_cols += [meta["m1_slot"].float()[:, None], meta["m2_slot"].float()[:, None],
                      meta["em_scale"].float()[:, None], meta["nmap"].float()[:, None]]
    cols = [attr_planes[:, :18], torch.cat(meta_cols, dim=1)[tri_id.long()]]
    # the blend columns follow the material and matmap ones
    mb = 30 + (2 if has_material else 0) + (4 if has_matmap else 0)
    if has_blend:
        blend_mat = torch.cat([meta["kind2"].float()[:, None],
                               meta["tex_slot2"].float()[:, None],
                               meta["rgba2"].float()], dim=1)
        cols += [attr_planes[:, 18:21], blend_mat[tri_id.long()]]
    g = torch.cat(cols, dim=1)[slot]  # (H, W, mb), with the blend mb + 9
    planes = g[..., :18]
    kind = g[..., 18].to(torch.int32)
    tex_slot = g[..., 19].to(torch.int32)
    repeat = g[..., 20].to(torch.int32)
    fullbright = repeat >= 4
    repeat = repeat & 3
    has_n = g[..., 21]
    rgba = g[..., 23:27]

    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] * stride + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None] * stride + float(y0) + 0.5
    px, py = px.expand(height, width), py.expand(height, width)

    def interp(i):
        return planes[..., 3 * i] * px + planes[..., 3 * i + 1] * py + planes[..., 3 * i + 2]

    inv_w = interp(0)
    u = interp(1) / inv_w
    v = interp(2) / inv_w
    n_raw = torch.stack([interp(3), interp(4), interp(5)], dim=-1)

    world = screen_to_world(
        px, py, z, _uniform(uniforms, "inv_proj", dev), _uniform(uniforms, "inv_view", dev),
        float(width * stride), float(height * stride if full_height is None else full_height),
    )

    # normal: interpolate, then flip toward the viewer (rasterizer.rs:1083-1099)
    n_unit = _normalize(n_raw)
    view_dir = _normalize(_uniform(uniforms, "camera_pos", dev) - world)
    n_flip = torch.where((_dot(n_unit, view_dir) < 0.0)[..., None], -n_unit, n_unit)
    normal = torch.where(has_n[..., None] > 0.5, n_flip, 0.0)

    texel = resolve_texel(kind, tex_slot, rgba, repeat, u, v, atlas,
                          uniforms["anim_frame"], sample_mode)
    if has_blend:
        kind2 = g[..., mb + 3].to(torch.int32)
        # the weight plane and the mix in XLA's CPU rounding:
        # fma(a, x, b*y) + c, and fma(texel2, w, texel * (1 - w))
        pb = g[..., mb:mb + 3]
        b_w = torch.clamp((_fma(pb[..., 0], px, pb[..., 1] * py) + pb[..., 2]) / inv_w,
                          0.0, 1.0)[..., None]
        texel2 = resolve_texel(kind2, g[..., mb + 4].to(torch.int32), g[..., mb + 5:mb + 9],
                               repeat, u, v, atlas, uniforms["anim_frame"], sample_mode)
        texel = torch.where((kind2 >= 0)[..., None],
                            _fma(texel2, b_w, texel * (1.0 - b_w)), texel)

    if has_material:
        roughness = torch.clamp(g[..., 30], 0.0, 1.0)
        metallic = torch.clamp(g[..., 31], 0.0, 1.0)
    else:
        roughness = torch.full_like(u, 0.5)
        metallic = torch.zeros_like(u)
    emissive = torch.zeros_like(n_raw)
    if has_matmap:
        # the sidecars through the base texel's sampler: M1 = emissive rgb
        # (over em_scale) | roughness, M2 = encoded normal | metallic
        m1s, m2s = g[..., 32].to(torch.int32), g[..., 33].to(torch.int32)
        m_on = m1s >= 0
        kindm = torch.where(m_on, SRC_TEXTURE, 0)
        zeros4 = torch.zeros_like(rgba)
        m1 = resolve_texel(kindm, m1s, zeros4, repeat, u, v, atlas, uniforms["anim_frame"],
                           sample_mode)
        m2 = resolve_texel(kindm, m2s, zeros4, repeat, u, v, atlas, uniforms["anim_frame"],
                           sample_mode)
        roughness = torch.where(m_on, m1[..., 3], roughness)
        metallic = torch.where(m_on, m2[..., 3], metallic)
        emissive = torch.where(m_on[..., None], m1[..., :3] * g[..., 34:35], emissive)
        # the written normal (byte-127 "zero" texels decode below length
        # 0.02 and keep hemisphere-only lighting), replacing the shading
        # normal at bump >= 1 or mixed into it (SceneVM's
        # normalize(mix(N, N_written, bump))); lengths as XLA fuses the dots
        n_dec = m2[..., :3] * 2.0 - 1.0
        dlen = _sqrt_f32(_dot(n_dec, n_dec))[..., None]
        n_dir = torch.where(dlen > 0.02, n_dec / torch.clamp(dlen, min=1e-30), 0.0)
        bump_k = float(np.float32(uniforms.get("bump_strength", 1.0)))
        mixed = _fma(normal, 1.0 - bump_k, n_dir * bump_k)
        mlen = _sqrt_f32(_dot(mixed, mixed))[..., None]
        mixed = torch.where((dlen > 0.02) & (mlen > 1e-20),
                            mixed / torch.clamp(mlen, min=1e-30), 0.0)
        use_n = (m_on & (g[..., 35] > 0.5))[..., None]
        normal = torch.where(use_n & (bump_k >= 1.0), n_dir,
                             torch.where(use_n & (0.0 < bump_k < 1.0), mixed, normal))
    return {
        "world": world,
        "view_dir": view_dir,
        "normal": normal,
        "base": srgb_to_linear_fast(texel[..., :3]),
        "roughness": roughness,
        "metallic": metallic,
        "emissive": emissive,
        "texel": texel,
        "fullbright": fullbright,
    }

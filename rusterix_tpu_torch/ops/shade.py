"""Deferred shading from the visibility winners (torch counterpart of
`rusterix_tpu/ops/shade.py`): the G-buffer, the BRDFs and `shade_pass`.

`gbuffer_pass` re-derives, per pixel, the world position, the shading
normal facing the viewer, the linear albedo and the material of the winning
candidate from the setup pass's attribute planes and the packed scene's
per-triangle fields, with vertex-blended batches mixed toward their second
texel and baked shaders' materials (the batch's constant roughness and
metallic, or the per-pixel M1 / M2 sidecar texels with the emissive and a
written normal), and the pack's runtime shaders run over the frame on
the pixel's registers (`shader_state`, `run_shaders`), their outputs
merged where the winner carries them. `light_radiance` evaluates every
light at every pixel. `shade_pass` is the split path's lighting (runtime
shaders force it, as in the JAX package): the hemisphere and batch
ambient, the sun and the light rows through `shade_fast_brdf` or
`shade_brdf_ggx`, shadow-map gates, the AO factor, sector occlusion,
emissive, the display transform and fog. On the CPU it is allclose to the
jitted JAX pass at 1e-6 and the frames are byte-equal on the tested
scenes: the light rows sum one after another, as XLA's reduction does.

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

from ..utils.color import linear_to_srgb_fast, srgb_to_linear_fast, tonemap_scenevm
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


def take_iso(table, idx, axis: int = 0):
    """table gathered at idx along `axis` (the JAX package's `take_iso`:
    jnp.take behind an optimization barrier, a TPU fusion hint with no
    counterpart here) -> shape table.shape[:axis] + idx.shape +
    table.shape[axis + 1:]. Indices are in range."""
    flat = table.index_select(axis, idx.reshape(-1).long())
    return flat.reshape(table.shape[:axis] + idx.shape + table.shape[axis + 1:])


def _r3(x):
    return torch.stack([x, x, x], dim=-1)


def shader_state(u, v, color, roughness, metallic, emissive, opacity, normal, hitpoint,
                 uniforms) -> dict:
    """The register state a runtime shader reads at every pixel (the JAX
    package's `state` dicts in gbuffer_pass, _shade_opacity and d2_pass):
    uv / 4, the pass's colour, material, normal and hit point, bump 0 and
    the frame's time, each (H, W, 3). Scalar fields (H, W) are spread over
    the three lanes."""
    zeros = torch.zeros_like(u)

    def lanes(x):
        return x if x.dim() == u.dim() + 1 else _r3(x)

    t = float(np.float32(uniforms["time"]))
    return {
        "uv": torch.stack([u / 4.0, v / 4.0, zeros], dim=-1),
        "color": lanes(color),
        "roughness": lanes(roughness),
        "metallic": lanes(metallic),
        "emissive": lanes(emissive),
        "opacity": lanes(opacity),
        "bump": _r3(zeros),
        "normal": lanes(normal),
        "hitpoint": lanes(hitpoint),
        "time": _r3(torch.full_like(u, t)),
    }


def run_shaders(shaders, shader_px, state_of, uniforms):
    """Evaluate each runtime shader of `shaders` (Programs with a shade
    function; None entries and programs without one are skipped) over its
    register state and yield (mask (H, W) where the pixel's winner carries
    that shader index, output registers broadcast to (H, W, 3)).
    `state_of()` builds a fresh state (the program mutates its copy)."""
    for si, prog in enumerate(shaders):
        if prog is None or not prog.shade_index:
            continue
        out = prog.shade(state_of(), uniforms.get("palette"))
        shape = shader_px.shape + (3,)
        yield shader_px == si, {k: torch.broadcast_to(v, shape) for k, v in out.items()}


def gbuffer_pass(z, idx, hit, attr_planes, tri_id, meta, atlas, uniforms,
                 width: int, height: int, sample_mode: int = 0,
                 has_blend: bool = False, has_material: bool = False,
                 has_matmap: bool = False, shaders: tuple = (), stride: int = 1,
                 y0: int = 0, full_height: int = None):
    """Per-pixel G-buffer from the winning candidates -> dict of (H, W)
    and (H, W, 3) fields: world, view_dir, normal, base, roughness,
    metallic, emissive, opacity, texel (RGBA 0..1), fullbright and the
    batch's ambient colour batch_ambient.

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
    JAX package's gbuffer_pass computes them. `shaders`: the pack's runtime
    shaders (PackedScene.runtime_shaders, index = the triangles' shader
    field); each runs over the frame on the registers above (colour = the
    linear albedo, hit point = world) and its colour, material, emissive,
    opacity and normal replace the pixel's where the winner carries its
    index, then roughness and metallic are clipped and normals
    renormalised."""
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
    shader_px = g[..., 22].to(torch.int32)
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
    base = srgb_to_linear_fast(texel[..., :3])
    opacity = texel[..., 3]
    if shaders:
        # per-batch rusteria shaders (rasterizer.rs:1224-1310): each program
        # runs over the whole frame and its registers merge where the
        # pixel's winner carries its index
        def state():
            return shader_state(u, v, base, roughness, metallic, emissive, opacity, normal,
                                world, uniforms)

        for m, out in run_shaders(shaders, shader_px, state, uniforms):
            m3 = m[..., None]
            base = torch.where(m3, out["color"], base)
            roughness = torch.where(m, out["roughness"][..., 0], roughness)
            metallic = torch.where(m, out["metallic"][..., 0], metallic)
            emissive = torch.where(m3, out["emissive"], emissive)
            opacity = torch.where(m, out["opacity"][..., 0], opacity)
            normal = torch.where(m3, out["normal"], normal)
        roughness = torch.clamp(roughness, 0.0, 1.0)
        metallic = torch.clamp(metallic, 0.0, 1.0)
        # the written normals renormalised (rasterizer.rs:1313), the length
        # as XLA fuses its dot
        nlen = _sqrt_f32(_dot(normal, normal))[..., None]
        normal = torch.where(nlen > 0, normal / torch.clamp(nlen, min=1e-30), normal)
    return {
        "world": world,
        "view_dir": view_dir,
        "normal": normal,
        "base": base,
        "roughness": roughness,
        "metallic": metallic,
        "emissive": emissive,
        "opacity": opacity,
        "texel": texel,
        "fullbright": fullbright,
        "batch_ambient": g[..., 27:30],
    }


def shade_fast_brdf(base, roughness, metallic, emissive, n, v, l, radiance,
                    static_shininess: int = None):
    """Blinn-Phong with Schlick Fresnel (reference rasterizer.rs:1906-1951;
    the JAX package's shade_fast_brdf). base / emissive / n / v / l /
    radiance carry a trailing 3-axis, roughness / metallic are scalar
    fields. `static_shininess`: the integer power that replaces the
    exp2(s * log2(x)) pair when the roughness is the constant default, as
    lax.integer_pow multiplies it out (x^6 = x^2 * (x^2 * x^2))."""
    n_dot_l = torch.clamp(_dot(n, l), min=0.0)
    m = metallic[..., None]
    f0 = 0.04 + (base - 0.04) * m
    kd = base * (1.0 - m)
    kd = kd * (1.0 - f0.amax(dim=-1, keepdim=True))
    h = _normalize(l + v)
    n_dot_h = torch.clamp(_dot(n, h), min=0.0)
    if static_shininess is not None:
        spec_b = _integer_pow(n_dot_h, int(static_shininess))
    else:
        a = torch.clamp(roughness * roughness, min=1e-4)
        shininess = torch.clamp(2.0 / a - 2.0, 1.0, 2048.0)
        # pow32_fast: exp2(y * log2(x)), 0 for x <= 0 (rasterizer.rs:1887-1894)
        spec_b = torch.where(
            n_dot_h > 0.0,
            torch.exp2(shininess * torch.log2(torch.clamp(n_dot_h, min=1e-38))), 0.0)
    n_dot_v = torch.clamp(_dot(n, v), min=0.0)
    x5 = _integer_pow(1.0 - torch.clamp(n_dot_v, 0.0, 1.0), 5)
    f = f0 + (1.0 - f0) * x5[..., None]
    diffuse = kd * n_dot_l[..., None]
    specular = f * (spec_b * n_dot_l)[..., None]
    lit = (diffuse + specular) * radiance + emissive
    return torch.where((n_dot_l <= 0.0)[..., None], emissive, lit)


def _integer_pow(x, y: int):
    """x**y for a positive integer y in lax.integer_pow's multiply order
    (square-and-multiply from the low bit)."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def shade_brdf_ggx(base, roughness, metallic, emissive, n, v, l, radiance,
                   spec_ndotl: bool = False):
    """GGX / Trowbridge-Reitz with height-correlated Smith G and Schlick
    Fresnel (reference rasterizer.rs:1954-2009 `_shade_brdf`; the JAX
    package's shade_brdf_ggx). Shapes as shade_fast_brdf. `spec_ndotl`
    weights the specular term by N.L too: the SceneVM form
    (3d_shader.wgsl:598,650) that `brdf="ggx"` shades with."""
    n = _normalize(n)
    v = _normalize(v)
    l = _normalize(l)
    h = _normalize(v + l)
    ndotl = torch.clamp(_dot(n, l), min=0.0)
    ndotv = torch.clamp(_dot(n, v), min=0.0)
    m = metallic[..., None]
    f0 = 0.04 + (base - 0.04) * m
    r = torch.clamp(roughness, 0.045, 1.0)
    a = r * r
    a2 = a * a
    ndoth = torch.clamp(_dot(n, h), min=0.0)
    denom_d = ndoth * ndoth * (a2 - 1.0) + 1.0
    dist = a2 / (np.float32(np.pi) * denom_d * denom_d + 1e-7)
    k = (r + 1.0) * (r + 1.0) * 0.125
    gv = ndotv / (ndotv * (1.0 - k) + k + 1e-7)
    gl = ndotl / (ndotl * (1.0 - k) + k + 1e-7)
    g = gv * gl
    x = 1.0 - torch.clamp(_dot(h, v), min=0.0)
    x5 = x * x * x * x * x
    f = f0 + (1.0 - f0) * x5[..., None]
    spec = f * ((dist * g) / (4.0 * ndotl * ndotv + 1e-7))[..., None]
    if spec_ndotl:
        spec = spec * ndotl[..., None]
    kd = (1.0 - f) * (1.0 - m)
    diffuse = kd * base * (ndotl / np.float32(np.pi))[..., None]
    lit = (diffuse + spec) * radiance + emissive
    return torch.where(((ndotl <= 0.0) | (ndotv <= 0.0))[..., None], emissive, lit)


def shade_pass(z, idx, hit, attr_planes, tri_id, meta, atlas, lights, uniforms,
               width: int, height: int, sample_mode: int = 0, y0: int = 0,
               full_height: int = None, shaders: tuple = (), has_fog: bool = False,
               has_blend: bool = False, has_material: bool = False, has_matmap: bool = False,
               shadow: tuple = None, ao=None, brdf_ggx: bool = False, tonemap: bool = False):
    """Shade every pixel from its winning candidate (the JAX package's
    shade_pass, the split path's lighting) -> (rgba (H, W, 4) f32 0..1,
    wrote (H, W) bool: hit and the alpha quantizes to 255, the reference's
    opaque write test, rasterizer.rs:1404-1409).

    The inputs as gbuffer_pass takes them (`y0` / `full_height`: a slab of
    rows of a taller frame); lights and uniforms are the Rasterizer's host
    dicts. Lighting (rasterizer.rs:1319-1398): the hemisphere ambient
    (scaled by `ao`, the (H, W) factor of ssao_pass, where given), the sun
    through the BRDF (gated by the sun's shadow map), the sector occlusion
    of uniforms' occ_box / occ_val, the batch ambient, the light rows
    through the BRDF (each cube-mapped light gated by its map), the
    emissive; then the display transform (the fast sRGB polynomial, or
    the SceneVM tonemap with `tonemap`), fullbright batches' raw texel, and
    distance fog with `has_fog`. `shadow`: (flat table, params (40,),
    spec) of shadow.bake_shadow_pack. `brdf_ggx`: the Cook-Torrance chain
    (with the SceneVM's N.L on the specular) instead of Blinn-Phong.

    The light rows are summed one after another in row order, as XLA's CPU
    reduction over the padded light axis sums them; rows that are not
    valid contribute exactly 0 there and are skipped here, so that each
    (H, W, 3) term is made and added in turn and nothing (H, W, L, 3) is
    held."""
    if has_matmap and not has_material:
        raise ValueError("shade_pass: has_matmap implies has_material")
    dev = z.device
    full_height = height if full_height is None else full_height
    g = gbuffer_pass(z, idx, hit, attr_planes, tri_id, meta, atlas, uniforms, width, height,
                     sample_mode, has_blend=has_blend, has_material=has_material,
                     has_matmap=has_matmap, shaders=shaders, y0=y0, full_height=full_height)
    world, view_dir, normal = g["world"], g["view_dir"], g["normal"]
    base, roughness, metallic = g["base"], g["roughness"], g["metallic"]
    zero3 = torch.zeros_like(base)

    # sector occlusion from the occluded boxes (mini.rs:57; gates sky and sun)
    occlusion = None
    if "occ_box" in uniforms:
        ob = _uniform(uniforms, "occ_box", dev)
        ov = _uniform(uniforms, "occ_val", dev)
        wx, wz = world[..., 0:1], world[..., 2:3]
        inside = (wx >= ob[:, 0]) & (wz >= ob[:, 1]) & (wx <= ob[:, 2]) & (wz <= ob[:, 3])
        occlusion = torch.where(inside, ov, 1.0).amin(dim=-1)

    hemi = 0.5 * (normal[..., 1] + 1.0)
    if ao is not None:
        # hemi is in exactly the two ambient terms: the reference's ambient * ao
        hemi = hemi * ao
    kd = base * (1.0 - metallic[..., None]) * (1.0 - 0.04)

    sun_factor, light_factors = None, {}
    if shadow is not None:
        from .shadow import shadow_factor

        sh_rows, sh_params, (sun_entry, cube_entries) = shadow
        nx, ny, nz = normal.unbind(-1)
        wx, wy, wz = world.unbind(-1)
        # the maps are read at covered pixels only (the others are not
        # written, and their world position is not finite)
        if sun_entry is not None:
            sun_factor = shadow_factor(sh_rows, sh_params, sun_entry, wx, wy, wz, nx, ny, nz,
                                       live=hit)
        for entry in cube_entries:
            light_factors[entry[0]] = shadow_factor(
                sh_rows, sh_params, entry, wx, wy, wz, nx, ny, nz,
                lpos=np.asarray(lights["position"][entry[0]], np.float32), live=hit)

    sky = _uniform(uniforms, "ambient", dev)[:3]
    has_ambient = float(np.float32(uniforms["has_ambient"]))
    lit = has_ambient * sky * kd * hemi[..., None]

    # roughness is the constant 0.5 unless shaders or materials are in play
    shin6 = 6 if not (shaders or has_material or has_matmap) else None

    def brdf(l_dir, radiance):
        if brdf_ggx:
            return shade_brdf_ggx(base, roughness, metallic, zero3, normal, view_dir, l_dir,
                                  radiance, spec_ndotl=True)
        return shade_fast_brdf(base, roughness, metallic, zero3, normal, view_dir, l_dir,
                               radiance, static_shininess=shin6)

    if float(np.float32(uniforms["has_sun"])) > 0.5:
        sun_c = np.asarray(uniforms.get("sun_color", np.ones(3, np.float32)), np.float32)
        sun_radiance = torch.from_numpy(np.float32(uniforms["day_factor"]) * sun_c).to(dev)
        if sun_factor is not None:
            sun_radiance = sun_radiance * sun_factor[..., None]
        sun_dir = _normalize(-_uniform(uniforms, "sun_dir", dev))
        lit = lit + brdf(sun_dir.expand_as(base), sun_radiance.expand_as(base))
    if occlusion is not None:
        lit = lit * occlusion[..., None]

    # batch ambient (rasterizer.rs:1368-1371)
    lit = lit + g["batch_ambient"] * kd * hemi[..., None]

    # the light rows, summed in row order
    lt = lights_to_torch(lights, dev)
    acc = None
    for i in range(lt["valid"].shape[0]):
        if not float(lights["valid"][i]) > 0.5:
            continue
        row = {k: v[i:i + 1] for k, v in lt.items()}
        radiance = light_radiance(row, world, normal)[..., 0, :]
        if i in light_factors:
            radiance = radiance * light_factors[i][..., None]
        ldir = _normalize(row["position"][0] - world)
        contrib = brdf(ldir, radiance)
        term = torch.where((radiance != 0.0).any(dim=-1, keepdim=True), contrib, 0.0)
        acc = term if acc is None else acc + term
    if acc is not None:
        lit = lit + acc
    lit = lit + g["emissive"]

    if tonemap:
        # the SceneVM display transform (Reinhard + gamma 2.2,
        # 3d_shader.wgsl:871-873)
        out_rgb = tonemap_scenevm(lit)
    else:
        out_rgb = linear_to_srgb_fast(lit)
    # fullbright batches bypass the lighting (their raw sRGB texel)
    out_rgb = torch.where(g["fullbright"][..., None], g["texel"][..., :3], out_rgb)
    if has_fog:
        from ..shapefx.render import fog_apply

        out_rgb = fog_apply(out_rgb, world, uniforms["camera_pos"], uniforms["fog_color"],
                            uniforms["fog_end"], uniforms["fog_fade"], uniforms["fog_mode"],
                            uniforms["fog_density"])
    opacity = g["opacity"]
    out = torch.cat([out_rgb, opacity[..., None]], dim=-1)
    # the u8 quantization decides the alpha == 255 write test (rasterizer.rs:1404)
    a_u8 = torch.floor(torch.clamp(opacity, 0.0, 1.0) * 255.0 + 0.5)
    return out, hit & (a_u8 >= 255.0)

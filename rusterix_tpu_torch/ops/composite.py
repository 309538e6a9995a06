"""Frame compositing (torch counterpart of `rusterix_tpu/ops/composite.py`):
the opacity layers' src-over blend, the render graph's procedural-sky miss
pass, the editor's brush preview, the ordered 2D pass (`d2_pass`: 2D
batches in painter's order, lit by the 2D lights with the map's walls
blocking them), `compose_opaque` and the final RGBA8 conversion.

The passes are plain torch over the whole frame, in the rounding the JAX
package's CPU build (XLA) gives the same expressions where a last bit
decides an outcome: the unprojections sum XLA's HIGHEST-precision einsum
pairwise (`shade._mat_vec_pairwise`), and products XLA fuses are written
out with `_fma`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..profiling import span, wait
from .arena import leaf
from .setup_pass import _fma
from .shade import (
    _div,
    _dot,
    _mat_vec_pairwise,
    _uniform,
    light_radiance,
    lights_to_torch,
    resolve_texel,
    shader_state,
    LT_AMBIENT,
    LT_AMBIENT_DAYLIGHT,
)


def compose_opaque(shaded, wrote, z, background):
    """Select shaded pixels over the background; z_eff = 1 where not
    written. background: (H, W, 4) f32 0..1."""
    frame = torch.where(wrote[..., None], shaded, background)
    z_eff = torch.where(wrote, z, 1.0)
    return frame, z_eff


def blend_opacity(frame, z_eff, op_color, op_z, preserve_transparency: bool = False):
    """Src-over blend of an opacity layer (reference rasterizer.rs:464-495).

    op_color: (H,W,4) f32 0..1 — the opacity-pass color; op_z its z buffer.
    A layer pixel blends where it is covered (op_z < 1) and nearer than the
    opaque frame (z_eff > op_z)."""
    do = (op_z < 1.0) & (z_eff > op_z)
    src_a = op_color[..., 3:4]
    inv_a = 1.0 - src_a
    out_rgb = _fma(op_color[..., :3], src_a, frame[..., :3] * inv_a)
    if preserve_transparency:
        out_a = torch.clamp(_fma(frame[..., 3:4], inv_a, src_a), 0.0, 1.0)
    else:
        out_a = torch.ones_like(src_a)
    blended = torch.cat([out_rgb, out_a], dim=-1)
    return torch.where(do[..., None], blended, frame)


def _screen_rays(uniforms, rows: int, width: int, height: int, device, y0: int = 0):
    """The screen ray of every pixel corner (x, y) (screen_ray,
    rasterizer.rs:1844-1871) -> (near (rows, W, 3), unit direction)."""
    px = torch.arange(width, dtype=torch.float32, device=device)[None, :].expand(rows, width)
    py = (torch.arange(rows, dtype=torch.float32, device=device)[:, None] + float(y0)).expand(
        rows, width)
    ndc_x = 2.0 * _div(px, float(width)) - 1.0
    ndc_y = 1.0 - 2.0 * _div(py, float(height))
    inv_proj = _uniform(uniforms, "inv_proj", device)
    inv_view = _uniform(uniforms, "inv_view", device)
    ones = torch.ones_like(ndc_x)

    def unproject(zv):
        view = _mat_vec_pairwise(inv_proj, [ndc_x, ndc_y, torch.full_like(ndc_x, zv), ones])
        view = [c / view[3] for c in view]
        return torch.stack(_mat_vec_pairwise(inv_view, view)[:3], dim=-1)

    near = unproject(-1.0)
    d = unproject(1.0) - near
    return near, d / torch.clamp(torch.sqrt(_dot(d, d)), min=1e-20)[..., None]


def sky_miss_pass(frame, z_eff, sky_pre, uniforms, width: int, height: int, y0: int = 0):
    """Procedural-sky miss pass: overwrite the pixels no opaque geometry
    wrote (z_eff >= 1) with the Sky node's color (reference
    rasterizer.rs:409-443). sky_pre: shapefx.render.sky_device_params."""
    from ..shapefx.render import sky_miss

    _near, d = _screen_rays(uniforms, frame.shape[0], width, height, frame.device, y0)
    color = sky_miss(sky_pre, d, uniforms["camera_pos"])
    miss = z_eff >= 1.0
    return torch.where(miss[..., None], torch.clamp(color, 0.0, 1.0), frame)


def brush_preview_pass(frame, z_eff, uniforms, width: int, height: int, y0: int = 0):
    """Editor brush-circle highlight on miss pixels (reference
    rasterizer.rs:434-457): intersect the screen ray with the y=0 plane and
    brighten inside the brush radius with the falloff fade."""
    dev = frame.device
    near, d = _screen_rays(uniforms, frame.shape[0], width, height, dev, y0)
    dy = d[..., 1]
    safe_dy = torch.where(dy.abs() > 1e-5, dy, 1e-5)
    t = -near[..., 1] / safe_dy
    world = _fma(d, t[..., None], near)
    off = world - _uniform(uniforms, "brush_pos", dev)
    dist = torch.sqrt(_dot(off, off))

    radius = _uniform(uniforms, "brush_radius", dev)
    falloff = torch.clamp(_uniform(uniforms, "brush_falloff", dev), 0.001, 1.0)
    fade = torch.clamp((1.0 - dist / radius) / falloff, 0.0, 1.0)
    blend = _fma(fade, 0.6, 0.2)

    hit_plane = (dy.abs() > 1e-5) & (t > 0.0) & (dist < radius)
    active = hit_plane & (z_eff >= 1.0)
    rgb = torch.clamp(_fma(frame[..., :3], 1.0 - blend[..., None], blend[..., None]), max=1.0)
    out_rgb = torch.where(active[..., None], rgb, frame[..., :3])
    return torch.cat([out_rgb, frame[..., 3:4]], dim=-1)


def frame_to_u8(frame):
    """f32 0..1 -> RGBA8 with the reference's rounding (src/lib.rs:63-68)."""
    return torch.floor(torch.clamp(frame, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def project2d(m, pos):
    """(T, 3, 2) vertices through the 2D matrix m (3, 3) -> (T, 3, 2): the
    JAX package's einsum at HIGHEST as XLA's CPU build rounds it,
    fma(m[i, 1], y, m[i, 0] * x) + m[i, 2]."""
    x, y = pos[..., 0], pos[..., 1]
    rows = [_fma(y, float(m[i, 1]), x * float(m[i, 0])) + float(m[i, 2]) for i in range(2)]
    return torch.stack(rows, dim=-1)


def _ccw(ax, ay, bx, by, cx, cy):
    return (cy - ay) * (bx - ax) > (by - ay) * (cx - ax)


#: wall segments a step of the 2D lights' visibility test takes (the JAX
#: package's chunk; the result does not depend on it)
SEG_CHUNK = 8


def _blocked_lights(world_x, world_y, lp2, uniforms):
    """(H, W, L) bool: the segment from the pixel to the light crosses a
    valid wall segment of uniforms' seg_a / seg_b / seg_valid
    (mapmini.is_visible, rasterizer.rs:841-860). Chunks whose segments are
    all padding are skipped (they block nothing)."""
    dev = world_x.device
    seg_valid = np.asarray(uniforms["seg_valid"]) > 0.5
    seg_a = _uniform(uniforms, "seg_a", dev)
    seg_b = _uniform(uniforms, "seg_b", dev)
    seg_valid_t = leaf(uniforms, "seg_valid", dev) > 0.5
    a_x, a_y = world_x[..., None, None], world_y[..., None, None]
    b_x, b_y = lp2[None, None, :, 0, None], lp2[None, None, :, 1, None]
    blocked = torch.zeros(world_x.shape + (lp2.shape[0],), dtype=torch.bool, device=dev)
    for s0 in range(0, seg_valid.shape[0], SEG_CHUNK):
        sv = seg_valid[s0:s0 + SEG_CHUNK]
        if not sv.any():
            continue
        c_x, c_y = seg_a[s0:s0 + SEG_CHUNK, 0], seg_a[s0:s0 + SEG_CHUNK, 1]
        d_x, d_y = seg_b[s0:s0 + SEG_CHUNK, 0], seg_b[s0:s0 + SEG_CHUNK, 1]
        cross = ((_ccw(a_x, a_y, c_x, c_y, d_x, d_y) != _ccw(b_x, b_y, c_x, c_y, d_x, d_y))
                 & (_ccw(a_x, a_y, b_x, b_y, c_x, c_y) != _ccw(a_x, a_y, b_x, b_y, d_x, d_y)))
        sv_t = seg_valid_t[s0:s0 + SEG_CHUNK]
        blocked = blocked | (cross & sv_t).any(dim=-1)
    return blocked


def _tri_constants(proj, tris):
    """Per-triangle constants of the 2D raster, for all triangles at once
    -> (T, 17) f32: the three edge functions' (x, y, c) coefficients, the
    vertices v0, v1, v2, 1/area and the coverage gate.
    The products XLA's CPU build fuses are fused as it fuses them."""
    v0, v1, v2 = proj[:, 0], proj[:, 1], proj[:, 2]

    def edge(a, b):
        return [b[:, 1] - a[:, 1], a[:, 0] - b[:, 0], _fma(b[:, 0], a[:, 1], -(b[:, 1] * a[:, 0]))]

    ac = v2 - v0
    ab = v1 - v0
    area = _fma(ac[:, 0], ab[:, 1], -(ac[:, 1] * ab[:, 0]))
    ok = area.abs() > 1e-20
    inv_area = torch.where(ok, torch.ones_like(area) / area, 0.0)
    gate = (ok & (tris["valid"] > 0.5)).float()
    cols = (edge(v0, v1) + edge(v1, v2) + edge(v2, v0)
            + [v0[:, 0], v0[:, 1], v1[:, 0], v1[:, 1], v2[:, 0], v2[:, 1], inv_area, gate])
    return torch.stack(cols, dim=1)


def _step_uv(k, uv, px, py):
    """One triangle's texture coordinates over the frame (k: its
    _tri_constants row, uv (3, 2)) -> (u, v): the barycentrics and their
    sums rounded as XLA's CPU build rounds the JAX package's expressions."""
    v0x, v0y, v1x, v1y, v2x, v2y, inv_area = (k[j] for j in range(9, 16))
    alpha = _fma(v2x - px, v1y - py, -((v2y - py) * (v1x - px))) * inv_area
    beta = ((v2x - v0x) * (py - v0y) - (v2y - v0y) * (px - v0x)) * inv_area
    gamma = (1.0 - alpha) - beta
    u = _fma(gamma, uv[2, 0], _fma(alpha, uv[0, 0], beta * uv[1, 0]))
    v = _fma(gamma, uv[2, 1], _fma(alpha, uv[0, 1], beta * uv[1, 1]))
    return u, v


def d2_lists(tris, shaders: tuple = ()) -> tuple:
    """The host lists d2_pass steps by, read from the 2D pack on its device
    in one copy (one host wait) -> (the live triangles' indices in order,
    each triangle's receives-light flag, each triangle's shader index, an
    empty list without runtime shaders)."""
    cols = [tris["valid"] > 0.5, tris["receives_light"] > 0.5]
    if shaders:
        cols.append(tris["shader"])
    rows = torch.stack([c.to(torch.int32) for c in cols])
    with wait("d2_lists"):
        rows = rows.tolist()
    return [i for i, v in enumerate(rows[0]) if v], rows[1], rows[2] if shaders else []


def d2_pass(frame, tris, atlas, lights, uniforms, width: int, height: int,
            sample_mode: int = 0, preserve_transparency: bool = False,
            has_lights: bool = False, has_ambient: bool = False, shaders: tuple = (),
            y0: int = 0, lists: tuple = None):
    """Ordered 2D rasterization (reference rasterizer.rs:584-899; the JAX
    package's `d2_pass`) -> the updated (H, W, 4) f32 0..1 frame.

    tris: the packed 2D triangles as tensors (pos, uv, valid, kind,
    tex_slot, rgba, repeat, receives_light, shader), drawn in order, each a
    step over the whole frame: coverage by three edge functions, the
    barycentric texel, the summed 2D lights in u8 space, the alpha blend.
    lights: the host SoA light dict; uniforms: the host dict with proj2d,
    translationd2, scaled2, ambient, anim_frame and, where walls block the
    lights, seg_a / seg_b / seg_valid. Padding triangles are skipped (they
    cover nothing). `y0` offsets the pixel rows (a slab of a row-sharded
    frame). `shaders`: the pack's runtime shaders (rasterizer.rs:763-805):
    at the step of a triangle whose shader index names one, the program
    runs on the step's registers (uv / 4, the sRGB texel as colour, its
    alpha as opacity, the grid-space world position as hit point) and its
    colour, opaque, replaces the texel. The JAX package's scan runs every
    program at every step and keeps the one the triangle names; here only
    that one runs, which gives the same bytes. `lists`: d2_lists(tris,
    shaders), when the caller has read them (a row-sharded frame reads them
    once for its slabs)."""
    live, lit, shader_of = lists or d2_lists(tris, shaders)
    if not live:
        return frame
    dev = frame.device
    proj = project2d(np.asarray(uniforms["proj2d"], np.float32), tris["pos"])
    consts = _tri_constants(proj, tris)

    px = (torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5).expand(
        height, width)
    py = (torch.arange(height, dtype=torch.float32, device=dev)[:, None] + float(y0)
          + 0.5).expand(height, width)
    # grid-space world position of the integer pixel (rasterizer.rs:664-670)
    trans = np.asarray(uniforms["translationd2"], np.float32)
    scale = float(np.float32(uniforms["scaled2"]))
    world_x = _div((px - 0.5) - float(trans[0]), scale)
    world_y = _div((py - 0.5) - float(trans[1]), scale)

    with span("d2.lights"):
        if has_lights:
            lt = lights_to_torch(lights, dev)
            world3 = torch.stack([world_x, torch.zeros_like(world_x), world_y], dim=-1)
            rad = light_radiance(lt, world3, None, d2=True)  # (H, W, L, 3)
            if "seg_a" in uniforms:
                lp2 = torch.stack([lt["position"][:, 0], lt["position"][:, 2]], dim=-1)
                needs_vis = ~((lt["type"] == LT_AMBIENT) | (lt["type"] == LT_AMBIENT_DAYLIGHT))
                blocked = _blocked_lights(world_x, world_y, lp2, uniforms)
                rad = torch.where((blocked & needs_vis)[..., None], 0.0, rad)
            # the sum over lights in order, as XLA's CPU reduction takes it
            acc_lights = rad[..., 0, :]
            for li in range(1, rad.shape[-2]):
                acc_lights = acc_lights + rad[..., li, :]
        else:
            acc_lights = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
        amb = _uniform(uniforms, "ambient", dev)[:3]
        if has_ambient:
            # with an ambient every 2D batch is lit (rasterizer.rs:799-803)
            acc = torch.clamp(acc_lights + amb, 0.0, 1.0)
        else:
            acc = torch.clamp(acc_lights, 0.0, 1.0)

    anim = uniforms["anim_frame"]
    with span("d2.steps"):
        for i in live:
            k = consts[i]
            e0 = (k[0] * px + k[1] * py) + k[2]
            e1 = (k[3] * px + k[4] * py) + k[5]
            e2 = (k[6] * px + k[7] * py) + k[8]
            cov = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (k[16] > 0.5)
            u, v = _step_uv(k, tris["uv"][i], px, py)
            # the triangle's fields as 1-element slices: a 0-d index tensor
            # would make each table lookup wait for the card
            one = slice(i, i + 1)
            texel = resolve_texel(tris["kind"][one], tris["tex_slot"][one], tris["rgba"][one],
                                  tris["repeat"][one], u, v, atlas, anim, sample_mode,
                                  default_alpha=0.0)
            si = int(shader_of[i]) if shaders else -1
            prog = shaders[si] if 0 <= si < len(shaders) else None
            if prog is not None and prog.shade_index:
                zeros = torch.zeros_like(u)
                state = shader_state(u, v, texel[..., :3], zeros + 0.5, zeros, zeros,
                                     texel[..., 3], zeros,
                                     torch.stack([world_x, world_y, zeros], dim=-1), uniforms)
                rgb_s = torch.broadcast_to(prog.shade(state, uniforms.get("palette"))["color"],
                                           texel[..., :3].shape)
                texel = torch.cat([rgb_s, torch.ones_like(texel[..., 3:4])], dim=-1)
            # u8-space light modulation with truncation (rasterizer.rs:871-876)
            if has_ambient or (has_lights and lit[i]):
                rgb = torch.floor(torch.floor(texel[..., :3] * 255.0 + 0.5) * acc) * (1.0 / 255.0)
            else:
                rgb = texel[..., :3]
            a = texel[..., 3:4]
            opaque = torch.floor(torch.clamp(a, 0.0, 1.0) * 255.0 + 0.5) >= 255.0
            blended_rgb = _fma(rgb, a, frame[..., :3] * (1.0 - a))
            blended_a = torch.maximum(frame[..., 3:4], a) if preserve_transparency else 1.0
            new = torch.cat([torch.where(opaque, rgb, blended_rgb),
                             torch.where(opaque, a, blended_a)], dim=-1)
            frame = torch.where(cov[..., None], new, frame)
    return frame

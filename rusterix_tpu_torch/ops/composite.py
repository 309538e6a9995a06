"""Frame compositing (torch counterpart of `rusterix_tpu/ops/composite.py`):
the opacity layers' src-over blend, the render graph's procedural-sky miss
pass, the editor's brush preview and the final RGBA8 conversion. The 2D
pass and `compose_opaque` belong to the split path, which is not ported.

The passes are plain torch over the whole frame, in the rounding the JAX
package's CPU build (XLA) gives the same expressions where a last bit
decides an outcome: the unprojections sum XLA's HIGHEST-precision einsum
pairwise (`shade._mat_vec_pairwise`), and products XLA fuses are written
out with `_fma`.
"""

from __future__ import annotations

import torch

from .setup_pass import _fma
from .shade import _div, _dot, _mat_vec_pairwise, _uniform


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

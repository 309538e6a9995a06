"""GGX importance-sampled reflections: a deferred ray pass over the frame
(torch counterpart of `rusterix_tpu/ops/reflect.py`).

After visibility, the pass rebuilds the G-buffer from the winning
candidates (`shade.gbuffer_pass`), draws `samples` GGX half-vectors per
covered pixel from the WGSL's own hash (`_hash33`), reflects the view ray,
traces it through the ray-intersect kernel (`rt_kernel.intersect_rays_pallas`,
B3), shades the hits with Cook-Torrance direct light plus the ambient
uniform (`_shade_reflection_hits`), and Fresnel-weights the sum.
`apply_reflections` composites the result onto the display-encoded frame.
`reflection_pass_scaled` with scale > 1 traces every scale-th pixel of each
axis and upsamples the result bilinearly, as `jax.image.resize` does
(`_resize_bilinear`). `sky_light_pass` casts one mirror ray per pixel
through the same kernel and adds sky-tinted ambient where it escapes.

With a shadow bake (`ops/shadow.py`), the hit shading looks up the same
maps as the frame: the sun's factor scales the sun, each casting light's
cube factor that light (the WGSL traces its shadow rays inside the
pbr_lighting of every reflection hit). `apply_reflections` decodes and
re-encodes with the frame's display transfer: the fast sRGB pair or the
SceneVM tonemap and its inverse. A transparency layer's reflections take
their G-buffer from the layer's own surfaces and trace and shade their rays
against the opaque pack (`scene_d3`).

The sampling math is written in the rounding XLA's CPU build gives the
JAX package's expressions (`_fma` where XLA fuses a product into a sum),
so that on the CPU the rays match the JAX package's bit for bit where the
transcendental functions agree; hits decide discrete outcomes (which
triangle, which texel), where one bit can show as a pixel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.color import (
    linear_to_srgb_fast,
    srgb_to_linear_fast,
    tonemap_scenevm,
    tonemap_scenevm_inverse,
)
from .rt_kernel import intersect_rays_pallas
from .shade import _div, _dot, _fma, _normalize, gbuffer_pass, resolve_texel
from .shadow import shadow_factor


def _hash33(px, py, pz):
    """WGSL hash33 (3d_shader.wgsl:35-39), component form -> two uniforms
    in [0, 1) per input point. The three-product sum rounds as XLA's fused
    chain, fma(hz, hz', fma(hy, hx', hx*hy'))."""
    hx = px * 0.1031
    hy = py * 0.1030
    hz = pz * 0.0973
    hx = hx - torch.floor(hx)
    hy = hy - torch.floor(hy)
    hz = hz - torch.floor(hz)
    d = _fma(hz, hz + 33.33, _fma(hy, hx + 33.33, hx * (hy + 33.33)))
    hx = hx + d
    hy = hy + d
    hz = hz + d
    o1 = (hx + hy) * hz
    o2 = (hx + hx) * hy
    return o1 - torch.floor(o1), o2 - torch.floor(o2)


def _f64_then_f32(fn, x):
    """fn in f64, rounded to f32: the same bits on the CPU and on the card
    (their f32 cos/sin/arccos differ in the last bit), and closer to XLA's
    CPU results than torch's f32 versions."""
    return fn(x.double()).float()


def _shade_reflection_hits(t, tri, ox, oy, oz, dx, dy, dz, d3, atlas, lights,
                           uniforms, sample_mode: int, sky_rgb, shadow=None):
    """Radiance arriving along each reflection ray -> (H, W, 3) linear.

    Hits shade as the WGSL's reflection branch (3d_shader.wgsl:797-815):
    fullbright surfaces return their raw texel, everything else gets
    Cook-Torrance direct light (sun and the light rows) plus the ambient
    uniform; misses return `sky_rgb` ((3,) tensor). d3: the packed d3
    tensors; lights and uniforms: the Rasterizer's host dicts. Light rows
    that are not valid contribute exactly 0 and are skipped; the type of
    each row is known on the host, so only its own branch is evaluated.
    shadow: (flat table, params (40,), spec) of shadow.bake_shadow_pack, or
    None; the maps are read at the hits only."""
    dev = t.device
    hit = tri >= 0
    ti = torch.clamp(tri, min=0).long()
    pos = d3["pos"].float()

    # one fused row gather: vertex A | e1 | e2 | uv a/b/c | nrm a/b/c |
    # has_n | kind | tex_slot | rgba | repeat | receives_light | rough | metal
    ax_, ay_, az_ = pos[:, 0, 0], pos[:, 0, 1], pos[:, 0, 2]
    uv, nrm = d3["uv"].float(), d3["nrm"].float()
    cols = [
        ax_, ay_, az_,
        pos[:, 1, 0] - ax_, pos[:, 1, 1] - ay_, pos[:, 1, 2] - az_,
        pos[:, 2, 0] - ax_, pos[:, 2, 1] - ay_, pos[:, 2, 2] - az_,
        uv[:, 0, 0], uv[:, 1, 0], uv[:, 2, 0],
        uv[:, 0, 1], uv[:, 1, 1], uv[:, 2, 1],
        nrm[:, 0, 0], nrm[:, 1, 0], nrm[:, 2, 0],
        nrm[:, 0, 1], nrm[:, 1, 1], nrm[:, 2, 1],
        nrm[:, 0, 2], nrm[:, 1, 2], nrm[:, 2, 2],
        d3["has_normals"].float(),
        d3["kind"].float(),
        d3["tex_slot"].float(),
        *d3["rgba"].float().unbind(1),
        d3["repeat"].float(),
        d3["receives_light"].float(),
        d3["rough"].float(), d3["metal"].float(),
    ]
    g = torch.stack(cols, dim=1)[ti]  # (H, W, 35)

    w_ax, w_ay, w_az = g[..., 0], g[..., 1], g[..., 2]
    w_e1x, w_e1y, w_e1z = g[..., 3], g[..., 4], g[..., 5]
    w_e2x, w_e2y, w_e2z = g[..., 6], g[..., 7], g[..., 8]

    # the winner's barycentrics: one Möller-Trumbore per ray
    whx = dy * w_e2z - dz * w_e2y
    why = dz * w_e2x - dx * w_e2z
    whz = dx * w_e2y - dy * w_e2x
    wdet = w_e1x * whx + w_e1y * why + w_e1z * whz
    wf = torch.where(wdet.abs() >= 1e-6, 1.0 / torch.where(wdet == 0.0, 1.0, wdet), 0.0)
    wsx, wsy, wsz = ox - w_ax, oy - w_ay, oz - w_az
    uu = wf * (wsx * whx + wsy * why + wsz * whz)
    wqx = wsy * w_e1z - wsz * w_e1y
    wqy = wsz * w_e1x - wsx * w_e1z
    wqz = wsx * w_e1y - wsy * w_e1x
    vv = wf * (dx * wqx + dy * wqy + dz * wqz)
    w0 = 1.0 - uu - vv

    uv_u = g[..., 9] * w0 + g[..., 10] * uu + g[..., 11] * vv
    uv_v = g[..., 12] * w0 + g[..., 13] * uu + g[..., 14] * vv

    # shading normal: interpolated when present, geometric otherwise;
    # facing the incoming ray
    has_n = g[..., 24] > 0.5
    nx = torch.where(has_n, g[..., 15] * w0 + g[..., 16] * uu + g[..., 17] * vv,
                     w_e1y * w_e2z - w_e1z * w_e2y)
    ny = torch.where(has_n, g[..., 18] * w0 + g[..., 19] * uu + g[..., 20] * vv,
                     w_e1z * w_e2x - w_e1x * w_e2z)
    nz = torch.where(has_n, g[..., 21] * w0 + g[..., 22] * uu + g[..., 23] * vv,
                     w_e1x * w_e2y - w_e1y * w_e2x)
    inv_nl = 1.0 / torch.clamp(torch.sqrt(nx * nx + ny * ny + nz * nz), min=1e-20)
    nx, ny, nz = nx * inv_nl, ny * inv_nl, nz * inv_nl
    flip = torch.where(nx * dx + ny * dy + nz * dz > 0.0, -1.0, 1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip

    texel = resolve_texel(
        g[..., 25].to(torch.int32), g[..., 26].to(torch.int32), g[..., 27:31],
        g[..., 31].to(torch.int32), uv_u, uv_v, atlas, uniforms["anim_frame"], sample_mode,
    )
    albedo = srgb_to_linear_fast(texel[..., :3])

    wxh = ox + dx * t
    wyh = oy + dy * t
    wzh = oz + dz * t
    vhx, vhy, vhz = -dx, -dy, -dz

    rough = torch.clamp(g[..., 33], 0.045, 1.0)
    metal = torch.clamp(g[..., 34], 0.0, 1.0)
    alb_r, alb_g, alb_b = albedo[..., 0], albedo[..., 1], albedo[..., 2]

    f0_r = 0.04 + (alb_r - 0.04) * metal
    f0_g = 0.04 + (alb_g - 0.04) * metal
    f0_b = 0.04 + (alb_b - 0.04) * metal
    a_h = rough * rough
    a2_h = a_h * a_h
    k_h = (rough + 1.0) * (rough + 1.0) * 0.125
    inv_pi = 0.31830988618379
    n_dot_v = torch.clamp(nx * vhx + ny * vhy + nz * vhz, min=0.0)
    gv = n_dot_v / (n_dot_v * (1.0 - k_h) + k_h + 1e-7)

    def ggx(ldx, ldy, ldz, rad_r, rad_g, rad_b, clamp_spec=False):
        # the megakernel's brdf_ggx chain with per-pixel roughness/metallic
        n_dot_l = torch.clamp(nx * ldx + ny * ldy + nz * ldz, min=0.0)
        hx = ldx + vhx
        hy = ldy + vhy
        hz = ldz + vhz
        hl = torch.sqrt(hx * hx + hy * hy + hz * hz)
        inv_hl = 1.0 / torch.clamp(hl, min=1e-30)
        n_dot_h = torch.clamp((nx * hx + ny * hy + nz * hz) * inv_hl, min=0.0)
        denom_d = n_dot_h * n_dot_h * (a2_h - 1.0) + 1.0
        dist = a2_h / (3.14159265358979 * denom_d * denom_d + 1e-7)
        gl = n_dot_l / (n_dot_l * (1.0 - k_h) + k_h + 1e-7)
        spec = dist * gv * gl / (4.0 * n_dot_l * n_dot_v + 1e-7)
        h_dot_v = torch.clamp((hx * vhx + hy * vhy + hz * vhz) * inv_hl, min=0.0)
        x1 = 1.0 - torch.clamp(h_dot_v, 0.0, 1.0)
        x2 = x1 * x1
        x5 = x2 * x2 * x1
        fr = f0_r + (1.0 - f0_r) * x5
        fg = f0_g + (1.0 - f0_g) * x5
        fb = f0_b + (1.0 - f0_b) * x5
        dd = (1.0 - metal) * n_dot_l * inv_pi
        # point lights clamp the Fresnel-weighted specular per component
        # (3d_shader.wgsl:652); the sun branch does not
        sp_r, sp_g, sp_b = fr * spec, fg * spec, fb * spec
        if clamp_spec:
            sp_r = torch.clamp(sp_r, max=1.0)
            sp_g = torch.clamp(sp_g, max=1.0)
            sp_b = torch.clamp(sp_b, max=1.0)
        dead = (n_dot_l <= 0.0) | (n_dot_v <= 0.0)
        return (
            torch.where(dead, 0.0, ((1.0 - fr) * dd * alb_r + sp_r * n_dot_l) * rad_r),
            torch.where(dead, 0.0, ((1.0 - fg) * dd * alb_g + sp_g * n_dot_l) * rad_g),
            torch.where(dead, 0.0, ((1.0 - fb) * dd * alb_b + sp_b * n_dot_l) * rad_b),
        )

    # per-light geometry shadows at the hit (3d_shader.wgsl:578-580 via the
    # hit shading at :846-852): one table element per shadowed light
    sun_f = 1.0
    cube_by_li = {}
    if shadow is not None:
        sh_rows, sh_params, (sun_entry, cube_entries) = shadow
        sh_params = torch.from_numpy(np.asarray(sh_params, np.float32)).to(dev)
        if sun_entry is not None:
            sun_f = shadow_factor(sh_rows, sh_params, sun_entry, wxh, wyh, wzh, nx, ny, nz,
                                  live=hit)
        cube_by_li = {e[0]: e for e in cube_entries}

    # sun (f32 scalars computed as the JAX package does on the device)
    sun_c = np.asarray(uniforms.get("sun_color", np.ones(3, np.float32)), np.float32)
    day = np.float32(uniforms["day_factor"]) * np.float32(uniforms["has_sun"])
    sd = _normalize(-torch.from_numpy(np.asarray(uniforms["sun_dir"], np.float32))).tolist()
    lit_r, lit_g, lit_b = ggx(sd[0], sd[1], sd[2], float(day * sun_c[0]) * sun_f,
                              float(day * sun_c[1]) * sun_f, float(day * sun_c[2]) * sun_f)

    # light rows (light_radiance semantics; the lambert factor rides the
    # radiance as in radiance_at, light.rs:504-533)
    for i in range(lights["valid"].shape[0]):
        if not lights["valid"][i] > 0.5:
            continue
        lt = int(lights["type"][i])
        start, end = np.float32(lights["start"][i]), np.float32(lights["end"][i])
        inten_raw = np.float32(lights["intensity"][i])
        inten = inten_raw * np.float32(lights["flicker_factor"][i])
        lp = [float(c) for c in np.asarray(lights["position"][i], np.float32)]
        tpx, tpy, tpz = wxh - lp[0], wyh - lp[1], wzh - lp[2]
        dist = torch.sqrt(tpx * tpx + tpy * tpy + tpz * tpz)
        inv_dist = 1.0 / torch.clamp(dist, min=1e-20)
        dpx, dpy, dpz = tpx * inv_dist, tpy * inv_dist, tpz * inv_dist
        if lt in (0, 4, 5):
            st = torch.clamp(_div(dist - float(end), float(start - end)), 0.0, 1.0)
            smooth_att = torch.where(dist <= float(start), 1.0, st * st * (3.0 - 2.0 * st))
        if lt in (4, 5):
            ln = [float(c) for c in np.asarray(lights["normal"][i], np.float32)]
            angle_att = torch.clamp(ln[0] * dpx + ln[1] * dpy + ln[2] * dpz, min=0.0)
        valid = None  # the range check, for every type but the ambients
        if lt == 0:
            scale = float(inten) * smooth_att
        elif lt in (1, 2):
            scale = torch.full_like(dist, float(inten))
        elif lt == 3:
            lin_att = torch.where(
                dist <= float(start), 1.0,
                1.0 - _div(dist - float(start), float(max(end - start, np.float32(1e-20)))),
            )
            ldir = [float(c) for c in np.asarray(lights["direction"][i], np.float32)]
            cosang = torch.clamp(ldir[0] * dpx + ldir[1] * dpy + ldir[2] * dpz, -1.0, 1.0)
            cone = float(np.float32(lights["cone_angle"][i]))
            spot_ok = _f64_then_f32(torch.arccos, cosang) <= cone
            scale = torch.where(spot_ok, float(inten) * lin_att, 0.0)
        elif lt == 4:
            area = np.float32(lights["width"][i]) * np.float32(lights["height"][i])
            if lights["from_linedef"][i] > 0.5:
                area_c = smooth_att * float(area) * float(inten_raw)
            else:
                area_c = angle_att * smooth_att * float(area) * float(inten_raw)
            scale = torch.where(dist < 0.1, 1.0, area_c)
        else:
            scale = angle_att * smooth_att * float(inten_raw)
        if lt not in (1, 2):
            valid = dist < float(end)
            if lt == 3:
                valid = valid & spot_ok
        if lt in (1, 2, 5):
            sc = scale
        else:
            lambert = torch.clamp(-(nx * dpx + ny * dpy + nz * dpz), min=0.0)
            sc = scale * lambert
        if valid is not None:
            sc = torch.where(valid, sc, 0.0)
        if i in cube_by_li:
            sc = sc * shadow_factor(sh_rows, sh_params, cube_by_li[i], wxh, wyh, wzh,
                                    nx, ny, nz, lpos=lights["position"][i], live=hit)
        col = [float(c) for c in np.asarray(lights["color"][i], np.float32)]
        cr, cg, cb = ggx(-dpx, -dpy, -dpz, col[0] * sc, col[1] * sc, col[2] * sc,
                         clamp_spec=True)
        lit_r = lit_r + cr
        lit_g = lit_g + cg
        lit_b = lit_b + cb

    # the ambient uniform on the hit (WGSL refl_ambient)
    amb = np.asarray(uniforms["ambient"], np.float32)[:3] * np.float32(uniforms["has_ambient"])
    lit_r = lit_r + float(amb[0]) * alb_r
    lit_g = lit_g + float(amb[1]) * alb_g
    lit_b = lit_b + float(amb[2]) * alb_b

    # fullbright hits: the raw texel (the reference's emissive-class shortcut)
    fullbright = g[..., 32] < 0.5
    lit = torch.stack([
        torch.where(fullbright, alb_r, lit_r),
        torch.where(fullbright, alb_g, lit_g),
        torch.where(fullbright, alb_b, lit_b),
    ], dim=-1)
    return torch.where(hit[..., None], lit, sky_rgb.to(dev)[None, None, :])


def reflection_rays(g, hit, width: int, height: int, sample: int = 0,
                    stride: int = 1, y0: int = 0) -> dict:
    """One GGX reflection ray per covered pixel (`hit`) from the G-buffer
    `g` (gbuffer_pass) -> dict of (H, W) fields: origin o_x, o_y, o_z (parked
    at 1e8 where the pixel casts no ray), direction d_x, d_y, d_z ((0, -1,
    0) where it casts none), ok (the ray is cast), vdh (V.H) and ndl (N.L).

    The sample hashes its own uniforms (WGSL hash33, seeded with the world
    position and the pixel coordinates), importance-samples the GGX half
    vector around the pixel normal (sample_ggx, 3d_shader.wgsl:61-74) and
    reflects the view ray about it. With `stride` > 1 the fields are every
    stride-th pixel of a full-resolution frame and the seeds use its pixel
    coordinates, so each ray equals the full-resolution pass's at the same
    pixel. `y0` offsets the rows (a slab of a row-sharded frame): the seeds
    take the frame's rows, so each ray equals the whole frame's."""
    dev = g["world"].device
    normal, vdir = g["normal"], g["view_dir"]
    rough = torch.clamp(g["roughness"], 0.045, 1.0)
    live = hit & (_dot(normal, normal) > 0.5) & ~g["fullbright"]
    nxg, nyg, nzg = normal.unbind(-1)
    vx, vy, vz = vdir.unbind(-1)
    wx, wy, wz = g["world"].unbind(-1)

    # an orthonormal basis around N (robust tangent pick); the three
    # components of a vector go through one `_fma` as an (H, W, 3) tensor
    picky = nyg.abs() < 0.9
    upx = torch.where(picky, 0.0, 1.0)
    upy = torch.where(picky, 1.0, 0.0)
    tx = upy * nzg
    ty = -upx * nzg
    tz = _fma(upx, nyg, -(upy * nxg))
    inv_tl = 1.0 / torch.clamp(torch.sqrt(_fma(tz, tz, _fma(ty, ty, tx * tx))), min=1e-20)
    t = torch.stack([tx, ty, tz], dim=-1) * inv_tl[..., None]
    yzx, zxy = [1, 2, 0], [2, 0, 1]
    # b = N x T: (ny tz - nz ty, nz tx - nx tz, nx ty - ny tx)
    b = _fma(normal[..., yzx], t[..., zxy], -(normal[..., zxy] * t[..., yzx]))
    a_r = rough * rough
    a2 = a_r * a_r

    # hash seeds in full-resolution pixel coordinates (f32(px) in the WGSL)
    xs = (torch.arange(width, dtype=torch.float32, device=dev) * stride)[None, :].expand(
        height, width)
    ys = ((torch.arange(height, dtype=torch.float32, device=dev) + float(y0)) * stride)[
        :, None].expand(height, width)
    u1, u2 = _hash33(wx + (xs * 0.5 + float(sample)), wy + ys * 0.5,
                     wz + float(np.float32(sample * 7.31)))
    phi = float(np.float32(2.0 * math.pi)) * u1
    cos_t = torch.sqrt((1.0 - u2) / _fma(a2 - 1.0, u2, 1.0))
    sin_t = torch.sqrt(torch.clamp(_fma(-cos_t, cos_t, 1.0), min=0.0))
    hx_t = _f64_then_f32(torch.cos, phi) * sin_t
    hy_t = _f64_then_f32(torch.sin, phi) * sin_t
    # H = N cos + B hy + T hx, each component fma(n, cos, fma(b, hy, t*hx))
    hh = _fma(normal, cos_t[..., None], _fma(b, hy_t[..., None], t * hx_t[..., None]))
    hhx, hhy, hhz = hh.unbind(-1)
    # L = reflect(-V, H) = 2 (V.H) H - V
    vdh = _fma(vz, hhz, _fma(vy, hhy, vx * hhx))
    lx, ly, lz = _fma(2.0 * vdh[..., None], hh, -vdir).unbind(-1)
    ndl = torch.clamp(_fma(nzg, lz, _fma(nyg, ly, nxg * lx)), min=0.0)
    ok = live & (ndl > 0.0)
    ox, oy, oz = _fma(normal, 0.01, g["world"]).unbind(-1)
    return {
        # parked dead rays: one far point with a down-facing ray
        "o_x": torch.where(live, ox, 1e8),
        "o_y": torch.where(live, oy, 1e8),
        "o_z": torch.where(live, oz, 1e8),
        "d_x": torch.where(ok, lx, 0.0),
        "d_y": torch.where(ok, ly, -1.0),
        "d_z": torch.where(ok, lz, 0.0),
        "ok": ok,
        "vdh": vdh,
        "ndl": ndl,
    }


def reflection_pass(z, idx, hit, attr_planes, tri_id, d3, atlas, lights, uniforms,
                    width: int, height: int, sample_mode: int = 0, samples: int = 1,
                    stride: int = 1, shadow=None, scene_d3=None, has_blend: bool = False,
                    has_material: bool = False, has_matmap: bool = False, y0: int = 0,
                    full_height: int = None, shaders: tuple = ()):
    """GGX reflection radiance for every covered pixel -> ((H, W, 3) linear,
    (H, W) applied mask; pixels whose samples all faced away keep 0).

    Each sample casts reflection_rays, traces them through the
    ray-intersect kernel against the whole packed scene, shades the hits
    and Fresnel-weights the sum (3d_shader.wgsl:764-826). The range cap is
    uniforms["refl_dist"] (max_sky_distance). With `stride` > 1 the inputs
    are every stride-th pixel of a full-resolution frame (its G-buffer and
    ray seeds at those pixels), and the result equals the full-resolution
    pass subsampled there. `shadow` shades the hits with a shadow bake (see
    _shade_reflection_hits). `scene_d3` is the pack the rays are traced and
    shaded against (default `d3`, the G-buffer's pack): a transparency
    layer takes its G-buffer from the opacity pack and its rays from the
    opaque one. `has_blend`: the G-buffer mixes vertex-blended batches'
    second texel in; `has_material` / `has_matmap`: it reads baked shaders'
    roughness, metallic and written normals (gbuffer_pass). `y0` and
    `full_height`: the inputs are the slab of rows [y0, y0 + height) of a
    row-sharded frame of that height (gbuffer_pass, reflection_rays).
    `shaders`: the pack's runtime shaders, which write the G-buffer's
    registers (gbuffer_pass); the hits shade from the pack alone, as in
    the JAX package."""
    dev = z.device
    sd3 = d3 if scene_d3 is None else scene_d3
    g = gbuffer_pass(z, idx, hit, attr_planes, tri_id, d3, atlas, uniforms,
                     width, height, sample_mode, has_blend=has_blend,
                     has_material=has_material, has_matmap=has_matmap, shaders=shaders,
                     stride=stride, y0=y0, full_height=full_height)
    f0 = 0.04 + (g["base"] - 0.04) * g["metallic"][..., None]
    max_dist = float(np.float32(uniforms["refl_dist"]))
    sky_rgb = torch.from_numpy(np.asarray(uniforms["refl_sky"], np.float32))

    accum = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    wsum = torch.zeros((height, width), dtype=torch.float32, device=dev)
    for s in range(samples):
        r = reflection_rays(g, hit, width, height, s, stride, y0)
        ray = (r["o_x"], r["o_y"], r["o_z"], r["d_x"], r["d_y"], r["d_z"])
        t, tri = intersect_rays_pallas(sd3["pos"], sd3["valid"], *ray, max_dist, height, width)
        tri = torch.where(r["ok"], tri, -1)
        color = _shade_reflection_hits(t, tri, *ray, sd3, atlas, lights, uniforms,
                                       sample_mode, sky_rgb, shadow)
        x = torch.clamp(1.0 - torch.clamp(r["vdh"], min=0.0), 0.0, 1.0)
        x5 = (x * x) * (x * x) * x
        fres = f0 + (1.0 - f0) * x5[..., None]
        w = torch.where(r["ok"], r["ndl"], 0.0)
        accum = accum + color * fres * w[..., None]
        wsum = wsum + w

    refl = torch.where((wsum > 0.0)[..., None],
                       accum / torch.clamp(wsum, min=1e-20)[..., None], 0.0)
    return refl, wsum > 0.0


def _bilinear_taps(m: int, n: int, device):
    """jax.image.resize's bilinear weights from m samples to n along one
    axis -> (j0, j1, w0, w1), each (n,): output i reads input j0 with weight
    w0 and j1 = j0 + 1 with w1. Half-pixel centres, the triangle kernel,
    weights renormalised over the taps inside the input (its edges), in the
    f32 rounding XLA gives jax's expressions."""
    inv = float(np.float32(1.0 / (n / m)))
    s = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    j0 = torch.floor(s)
    taps = []
    for j in (j0, j0 + 1.0):
        w = torch.clamp(1.0 - (s - j).abs(), min=0.0)
        taps.append(torch.where((j >= 0) & (j < m), w, 0.0))
    total = taps[0] + taps[1]
    keep = (total.abs() > float(np.float32(1000.0 * np.finfo(np.float32).eps))) & (
        s >= -0.5) & (s <= m - 0.5)
    total = torch.where(total != 0, total, 1.0)
    w0, w1 = (torch.where(keep, w / total, 0.0) for w in taps)
    j0 = j0.long()
    return torch.clamp(j0, 0, m - 1), torch.clamp(j0 + 1, 0, m - 1), w0, w1


def _contract(x, dim: int, taps):
    """The bilinear contraction along `dim`: fma(x[j1], w1, x[j0] * w0), the
    two nonzero terms of XLA's dot in its order."""
    j0, j1, w0, w1 = taps
    shape = [1] * x.dim()
    shape[dim] = -1
    a = x.index_select(dim, j0) * w0.reshape(shape)
    return _fma(x.index_select(dim, j1), w1.reshape(shape), a)


def _resize_bilinear(img, height: int, width: int):
    """(h, w) or (h, w, c) f32 -> (height, width[, c]) as
    jax.image.resize(img, ..., "bilinear") gives it when upsampling: one
    contraction per axis, the cheaper order first as jnp.einsum picks it
    (the width first on a landscape frame)."""
    h, w = img.shape[:2]
    dev = img.device
    t_h, t_w = _bilinear_taps(h, height, dev), _bilinear_taps(w, width, dev)
    height_first = h * w * height + w * height * width
    width_first = h * w * width + h * width * height
    if width_first <= height_first:
        return _contract(_contract(img, 1, t_w), 0, t_h)
    return _contract(_contract(img, 0, t_h), 1, t_w)


def reflection_pass_scaled(z, idx, hit, attr_planes, tri_id, d3, atlas, lights,
                           uniforms, width: int, height: int, sample_mode: int = 0,
                           samples: int = 1, scale: int = 1, shadow=None, scene_d3=None,
                           has_blend: bool = False, has_material: bool = False,
                           has_matmap: bool = False, y0: int = 0, full_height: int = None,
                           shaders: tuple = ()):
    """reflection_pass at 1/scale resolution, bilinearly upsampled.

    scale 1 is the full-resolution pass. With scale > 1 the pass traces
    every scale-th pixel of each axis ((height // scale) x (width // scale)
    rays per sample), the radiance (zero where no sample applied) and the
    applied mask are upsampled as jax.image.resize does, and a pixel takes
    the upsampled radiance where the upsampled mask exceeds 0.5 and the
    full-resolution pre-pass covers it. `shadow`, `scene_d3`, `has_blend`,
    `has_material`, `has_matmap`, `shaders`, `y0` and `full_height` as for
    reflection_pass; a slab of rows (y0 > 0 or a taller frame) takes scale
    1 only, as the JAX package's row-sharded frame does."""
    if scale <= 1:
        return reflection_pass(z, idx, hit, attr_planes, tri_id, d3, atlas, lights,
                               uniforms, width, height, sample_mode, samples, shadow=shadow,
                               scene_d3=scene_d3, has_blend=has_blend,
                               has_material=has_material, has_matmap=has_matmap, y0=y0,
                               full_height=full_height, shaders=shaders)
    if y0 or (full_height or height) != height:
        raise ValueError("reflection_pass_scaled: a slab of rows takes scale 1")
    hs, ws = height // scale, width // scale
    sl = (slice(0, hs * scale, scale), slice(0, ws * scale, scale))
    refl_lo, mask_lo = reflection_pass(
        z[sl], idx[sl], hit[sl], attr_planes, tri_id, d3, atlas, lights, uniforms,
        ws, hs, sample_mode, samples, stride=scale, shadow=shadow, scene_d3=scene_d3,
        has_blend=has_blend, has_material=has_material, has_matmap=has_matmap,
        shaders=shaders,
    )
    refl_lo = torch.where(mask_lo[..., None], refl_lo, 0.0)
    up = _resize_bilinear(refl_lo, height, width)
    mask_up = _resize_bilinear(mask_lo.float(), height, width) > 0.5
    return up, mask_up & hit


def sky_rays(g, hit) -> dict:
    """The sky-light ray of each covered pixel from the G-buffer `g` -> dict
    of (H, W) fields: origin o_x, o_y, o_z (parked at 1e8 where no ray is
    cast), direction d_x, d_y, d_z (the view ray mirrored about the normal;
    (0, -1, 0) where none), live (the ray is cast: a lit surface whose
    normal and mirror ray both point up) and sky_factor (max(N.y, 0)). The
    mirror ray and its origin offset round as reflection_rays' do."""
    normal = g["normal"]
    nxg, nyg, nzg = normal.unbind(-1)
    vx, vy, vz = g["view_dir"].unbind(-1)
    wx, wy, wz = g["world"].unbind(-1)
    sky_factor = torch.clamp(nyg, min=0.0)
    # r = reflect(-V, N) = 2 (N.V) N - V
    ndv = _fma(nzg, vz, _fma(nyg, vy, nxg * vx))
    rx = _fma(2.0 * ndv, nxg, -vx)
    ry = _fma(2.0 * ndv, nyg, -vy)
    rz = _fma(2.0 * ndv, nzg, -vz)
    live = (hit & ~g["fullbright"] & (_dot(normal, normal) > 0.5) & (sky_factor > 0.0)
            & (ry > 0.0))
    return {
        "o_x": torch.where(live, _fma(nxg, 0.01, wx), 1e8),
        "o_y": torch.where(live, _fma(nyg, 0.01, wy), 1e8),
        "o_z": torch.where(live, _fma(nzg, 0.01, wz), 1e8),
        "d_x": torch.where(live, rx, 0.0),
        "d_y": torch.where(live, ry, -1.0),
        "d_z": torch.where(live, rz, 0.0),
        "live": live,
        "sky_factor": sky_factor,
    }


def sky_light_pass(z, idx, hit, attr_planes, tri_id, d3, atlas, uniforms,
                   width: int, height: int, sample_mode: int = 0, has_blend: bool = False,
                   has_material: bool = False, has_matmap: bool = False, y0: int = 0,
                   full_height: int = None, shaders: tuple = ()):
    """Directional sky-bounce ambient (the WGSL `sky_contribution`,
    3d_shader.wgsl:744-758) -> (radiance (H, W, 3) linear, applied mask).

    Per covered pixel ONE mirror ray (sky_rays), range-capped by
    uniforms["refl_dist"], through the ray-intersect kernel (B3); where it
    escapes, the pixel gains refl_sky * max(N.y, 0) * albedo. The caller
    scales the term by the AO factor where AO is on. `has_blend`,
    `has_material`, `has_matmap`, `shaders`, `y0` and `full_height` as for
    reflection_pass."""
    g = gbuffer_pass(z, idx, hit, attr_planes, tri_id, d3, atlas, uniforms,
                     width, height, sample_mode, has_blend=has_blend,
                     has_material=has_material, has_matmap=has_matmap, shaders=shaders, y0=y0,
                     full_height=full_height)
    r = sky_rays(g, hit)
    ray = (r["o_x"], r["o_y"], r["o_z"], r["d_x"], r["d_y"], r["d_z"])
    max_dist = float(np.float32(uniforms["refl_dist"]))
    _t, tri = intersect_rays_pallas(d3["pos"], d3["valid"], *ray, max_dist, height, width)
    vis = r["live"] & (tri < 0)
    sky_rgb = torch.from_numpy(np.asarray(uniforms["refl_sky"], np.float32)).to(z.device)
    term = sky_rgb[None, None, :] * r["sky_factor"][..., None] * g["base"]
    return torch.where(vis[..., None], term, 0.0), vis


def apply_reflections(frame_rgba_f32, refl, rmask, tonemap: bool = False):
    """Composite reflection radiance onto the display-encoded f32 frame:
    decode with the frame's transfer (`tonemap` False: the fast sRGB pair;
    True: the SceneVM tonemap's numerical inverse), add the linear term,
    re-encode, on the pixels the pass touched only (the others keep their
    exact bytes)."""
    rgb = frame_rgba_f32[..., :3]
    if tonemap:
        new = torch.clamp(tonemap_scenevm(tonemap_scenevm_inverse(rgb) + refl), 0.0, 1.0)
    else:
        new = torch.clamp(linear_to_srgb_fast(srgb_to_linear_fast(rgb) + refl), 0.0, 1.0)
    out = torch.where(rmask[..., None], new, rgb)
    return torch.cat([out, frame_rgba_f32[..., 3:]], dim=-1)

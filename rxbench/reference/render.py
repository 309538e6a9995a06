"""The plain reference of a frame: a ray caster in plain torch.

It renders what `Rasterizer.rasterize` renders for the scenes the cells
use, by a different algorithm: one ray through each pixel centre, tested
against every triangle of the scene (no tiles, no sort, no grid), then the
lighting, the GGX reflection sample and the sRGB encode written out from
the reference renderer's equations (rasterizer.rs, light.rs and the
SceneVM 3d_shader.wgsl, as the port documents them).

It reads batch-like records, light rows and settings that the
configuration's reference module builds from the configuration's sizes
(map_grid.py for the map) and the traffic's specs, and the frame's camera
matrices: nothing the port made. It imports nothing of the port.

A pixel's outcome can hang on the last bit of a computation: which of two
coplanar walls wins the depth test (the map draws every inner wall once
from each room, with mirrored uvs), whether a pixel centre on a triangle's
edge is covered, which texel a texture coordinate on a texel boundary
rounds to. So `render` returns, besides the frame, each pixel's direct
colour under every such alternative (`check.py` accepts any of them), and
the reflection term of the reference's own sample: the port seeds the
sample's hash with its own world position, so the two samples of a pixel
are independent draws of one distribution, compared in the mean.

`render(..., dtype=torch.bfloat16)` computes the whole frame in bfloat16,
the precision below the float32 the port computes in (the port's passes
run no matmul, so TF32 does not touch them): the control of the
comparison. `render(..., shade_dtype=torch.bfloat16)` casts the rays in
float32 and computes the rest (the surfaces, the lighting, the reflection
rays' directions and their hits' shading, the blends) in bfloat16: the
second control, which keeps the geometry and tests the shading alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# intersection margins, in barycentric units and relative depth
EDGE_EPS = 2e-4
TIE_REL = 1e-4
# texel-coordinate margin (texture-coordinate units) for the rounding
# alternatives
UV_EPS = 1e-4
# reflection rays start this far off the surface and ignore nearer hits
RAY_OFFSET = 0.01
RAY_TMIN = 1e-4
# the surfaces a camera ray may show: the nearest hit, the nearest under
# the tightened and the loosened edge test, and up to N_TIES coplanar ties
N_TIES = 3
ALTERNATIVES = ("", "_in", "_out") + tuple(f"_tie{j}" for j in range(N_TIES))
# rays of one block of the intersection (times the triangle count)
BLOCK_ELEMS = 1 << 24


def _interp(w0, b1, b2, corners):
    """Barycentric interpolation of per-corner values (N, 3, k) -> (N, k)."""
    w = torch.stack([w0, b1, b2], 1)[:, None, :]
    return torch.bmm(w, corners.to(w.dtype))[:, 0, :]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(v):
    return v / torch.clamp(torch.sqrt(_dot(v, v)), min=1e-30)[..., None]


def srgb_to_linear(x):
    """The renderer's fast decode: (0.6975 x^2 + 0.3025) x."""
    return (0.6975 * x * x + 0.3025) * x


def linear_to_srgb(x):
    """The renderer's fast encode: 1.055 sqrt(x) - 0.055 x."""
    s = torch.sqrt(torch.clamp(x, min=0.0))
    return 1.055 * s - 0.055 * s * s


def to_u8(x):
    """Quantize 0..1 to 0..255, in float32 whatever x's precision (every
    whole number to 255 is exact in bfloat16, 255.5 is not)."""
    return torch.floor(torch.clamp(x.float(), 0.0, 1.0) * 255.0 + 0.5).to(x.dtype)


# ------------------------------------------------------------ scene tables

TEXTURE, PIXEL = 1, 2
POINT, AMBIENT, AMBIENT_DAYLIGHT, SPOT = 0, 1, 2, 3


def scene_tables(batches, device) -> dict:
    """Triangle tables of `batches` (batch-like records: vertices, indices,
    uvs, normals, transform_3d, texture (RGBA8 (H, W, 4)) or pixel (a flat
    RGBA8 colour), repeat_mode, receives_light, ambient_color, mode) ->
    dict of tensors."""
    pos, uv, nrm, has_n, batch_id, kind, tex_id, rgba, repeat, lit, amb, opac = (
        [] for _ in range(12))
    tex_list, tex_index = [], {}
    for b, batch in enumerate(batches):
        if int(batch.mode) != 0 or len(batch.indices) == 0:
            continue
        v = np.asarray(batch.vertices, np.float64)
        tf = np.asarray(batch.transform_3d, np.float64)
        v = (v @ tf.T)[:, :3] if not np.array_equal(tf, np.eye(4)) else v[:, :3]
        idx = np.asarray(batch.indices, np.int64)
        n_tri = len(idx)
        pos.append(v[idx])
        uv.append(np.asarray(batch.uvs, np.float64)[idx])
        normals = np.asarray(batch.normals, np.float64)
        ok_n = len(normals) == len(v) and len(normals) > 0
        nrm.append(normals[idx] if ok_n else np.zeros((n_tri, 3, 3)))
        has_n.append(np.full(n_tri, ok_n))
        batch_id.append(np.full(n_tri, b))
        tex = batch.texture
        if tex is None:
            kind.append(np.full(n_tri, PIXEL))
            tex_id.append(np.full(n_tri, -1))
            rgba.append(np.tile(np.asarray(batch.pixel, np.float64) / 255.0, (n_tri, 1)))
        else:
            key = id(tex)
            if key not in tex_index:
                tex_index[key] = len(tex_list)
                tex_list.append(np.asarray(tex, np.uint8))
            kind.append(np.full(n_tri, TEXTURE))
            tex_id.append(np.full(n_tri, tex_index[key]))
            rgba.append(np.zeros((n_tri, 4)))
        repeat.append(np.full(n_tri, int(batch.repeat_mode)))
        lit.append(np.full(n_tri, bool(batch.receives_light)))
        a = batch.ambient_color
        amb.append(np.tile(np.zeros(3) if a is None else np.asarray(a, np.float64)[:3], (n_tri, 1)))
        opac.append(np.full(n_tri, float(getattr(batch, "opacity", 1.0))))

    def t(parts, dtype=torch.float32):
        return torch.from_numpy(np.concatenate(parts)).to(device=device, dtype=dtype)

    out = {"pos": t(pos), "uv": t(uv), "nrm": t(nrm), "has_n": t(has_n, torch.bool),
           "batch": t(batch_id, torch.int64), "kind": t(kind, torch.int64),
           "tex": t(tex_id, torch.int64), "rgba": t(rgba), "repeat": t(repeat, torch.int64),
           "lit": t(lit, torch.bool), "amb": t(amb), "opacity": t(opac)}
    # the textures in one flat table: offset, width, height of each
    offs, sizes, flat = [], [], []
    o = 0
    for tex in tex_list:
        offs.append(o)
        sizes.append(tex.shape[:2])
        flat.append(tex.reshape(-1, 4))
        o += tex.shape[0] * tex.shape[1]
    out["texels"] = (torch.from_numpy(np.concatenate(flat)).to(device) if flat
                     else torch.zeros((1, 4), dtype=torch.uint8, device=device))
    out["tex_off"] = torch.tensor(offs or [0], dtype=torch.int64, device=device)
    out["tex_h"] = torch.tensor([s[0] for s in sizes] or [1], dtype=torch.int64, device=device)
    out["tex_w"] = torch.tensor([s[1] for s in sizes] or [1], dtype=torch.int64, device=device)
    out.update(_planes(out["pos"]))
    out["box_lo"] = out["pos"].amin(1)
    out["box_hi"] = out["pos"].amax(1)
    return out


def _planes(pos) -> dict:
    """The intersection rows of triangles (T, 3, 3): the plane (n, -n.a)
    and the barycentric duals (g, -g.a) with p - a = b1 e1 + b2 e2 for p
    on the plane."""
    a = pos[:, 0]
    e1 = pos[:, 1] - a
    e2 = pos[:, 2] - a
    n = _cross(e1, e2)
    nn = _dot(n, n)
    good = nn > 0
    inv = torch.where(good, 1.0 / torch.where(good, nn, 1.0), 0.0)[:, None]
    g1 = _cross(e2, n) * inv
    g2 = _cross(n, e1) * inv
    return {"plane": torch.cat([n, -_dot(n, a)[:, None]], 1),
            "g1": torch.cat([g1, -_dot(g1, a)[:, None]], 1),
            "g2": torch.cat([g2, -_dot(g2, a)[:, None]], 1),
            "good": good, "geo_n": n}


def view_tables(tab, view) -> dict:
    """The triangles moved into the camera's space by the view matrix (a
    matmul), for the camera rays."""
    pos = tab["pos"].reshape(-1, 3)
    pos4 = torch.cat([pos, torch.ones_like(pos[:, :1])], 1)
    v = (pos4 @ view.T)[:, :3].reshape(-1, 3, 3)
    return dict(_planes(v), batch=tab["batch"])


# ------------------------------------------------------------ intersection

def cast(tab, o, d, tmin, tmax, alternatives: bool = False,
         count_boxes: bool = False) -> dict:
    """Nearest hit of each ray (o + t d, t in (tmin, tmax)) among the
    triangles -> dict of (R,) tensors: "t", "tri" (-1: none), "b1", "b2".
    With `alternatives`, also the nearest hit under the edge margin
    tightened ("tri_in", covered beyond doubt) and loosened ("tri_out",
    covered by a hair), and "tri_tie0" to "tri_tie{N_TIES - 1}": triangles
    of other batches, one a batch, within TIE_REL of the nearest hit's
    depth (the nearest hit where there are fewer); each with its b1, b2
    and t. With
    `count_boxes`, "boxes": the triangle boxes each ray's segment up to
    its hit passes through."""
    n_ray, n_tri = o.shape[0], tab["plane"].shape[0]
    block = max(1, BLOCK_ELEMS // max(n_tri, 1))
    o4 = torch.cat([o, torch.ones_like(o[:, :1])], 1)
    keys = ["t", "tri", "b1", "b2"]
    if alternatives:
        keys += [f"{k}{s}" for s in ALTERNATIVES[1:] for k in ("t", "tri", "b1", "b2")]
    out = {k: [] for k in keys}
    boxes = []
    plane_t, g1_t, g2_t = tab["plane"].T, tab["g1"].T, tab["g2"].T
    batch = tab["batch"]
    for r0 in range(0, n_ray, block):
        ob, db, o4b = o[r0:r0 + block], d[r0:r0 + block], o4[r0:r0 + block]
        nd = db @ plane_t[:3]
        no = o4b @ plane_t
        ok = tab["good"][None, :] & (nd.abs() > 1e-12)
        t = -no / torch.where(ok, nd, 1.0)
        b1 = o4b @ g1_t + t * (db @ g1_t[:3])
        b2 = o4b @ g2_t + t * (db @ g2_t[:3])
        ok &= (t > tmin) & (t < tmax)

        def nearest(mask):
            tt = torch.where(mask, t, float("inf"))
            best, k = tt.min(1)
            hit = torch.isfinite(best)
            kk = k[:, None]
            return (best, torch.where(hit, k, -1), b1.gather(1, kk)[:, 0], b2.gather(1, kk)[:, 0])

        def covered(eps):
            return ok & (b1 >= eps) & (b2 >= eps) & (b1 + b2 <= 1.0 - eps)

        res = nearest(covered(0.0))
        for k, v in zip(("t", "tri", "b1", "b2"), res):
            out[k].append(v)
        if alternatives:
            loose = covered(-EDGE_EPS)
            for s, mask in (("_in", covered(EDGE_EPS)), ("_out", loose)):
                for k, v in zip(("t", "tri", "b1", "b2"), nearest(mask)):
                    out[f"{k}{s}"].append(v)
            t0, k0 = res[0], res[1]
            tie = loose & (k0[:, None] >= 0) & (t <= (t0 * (1.0 + TIE_REL))[:, None])
            taken = k0
            for j in range(N_TIES):
                tie = tie & (batch[None, :] != batch[taken.clamp(min=0)][:, None])
                found = nearest(tie)
                # no tie: the alternative is the nearest hit itself
                has = found[1] >= 0
                for k, v, v0 in zip(("t", "tri", "b1", "b2"), found, res):
                    out[f"{k}_tie{j}"].append(torch.where(has, v, v0))
                taken = torch.where(has, found[1], taken)
        if count_boxes:
            end = torch.where(res[1] >= 0, res[0], torch.full_like(res[0], tmax))
            inv = 1.0 / torch.where(db.abs() < 1e-20, torch.full_like(db, 1e-20), db)
            lo = (tab["box_lo"][None] - ob[:, None]) * inv[:, None]
            hi = (tab["box_hi"][None] - ob[:, None]) * inv[:, None]
            tn = torch.minimum(lo, hi).amax(-1)
            tf = torch.maximum(lo, hi).amin(-1)
            cross = (tf >= torch.clamp(tn, min=tmin)) & (tn <= end[:, None])
            boxes.append(cross.sum(1))
    res = {k: torch.cat(v) for k, v in out.items()}
    if count_boxes:
        res["boxes"] = torch.cat(boxes)
    return res


# ------------------------------------------------------------ shading

def _texel(tab, tex, u, v, repeat):
    """Nearest texel (round(u * (w - 1)) after the repeat mode) -> (N, 4)
    float 0..255."""
    ti = tex.clamp(min=0)
    w, h = tab["tex_w"][ti], tab["tex_h"][ti]
    wrap_u = (repeat == 1) | (repeat == 2)
    wrap_v = (repeat == 1) | (repeat == 3)
    uu = torch.where(wrap_u, u - torch.floor(u), torch.clamp(u, 0.0, 1.0))
    vv = torch.where(wrap_v, v - torch.floor(v), torch.clamp(v, 0.0, 1.0))
    tx = torch.floor(uu * (w - 1).to(uu.dtype) + 0.5).long().clamp(min=0)
    ty = torch.floor(vv * (h - 1).to(vv.dtype) + 0.5).long().clamp(min=0)
    tx = torch.minimum(tx, w - 1)
    ty = torch.minimum(ty, h - 1)
    return tab["texels"][tab["tex_off"][ti] + ty * w + tx].to(uu.dtype)


def surface(tab, hit, camera_pos):
    """The surface a camera ray hit -> dict: "ok", "world", "normal" (unit,
    flipped toward the camera; zero without vertex normals), "view",
    "u", "v" and the triangle's fields."""
    tri = hit["tri"]
    ok = tri >= 0
    i = tri.clamp(min=0)
    b1, b2 = hit["b1"], hit["b2"]
    w0 = 1.0 - b1 - b2
    u, v = _interp(w0, b1, b2, tab["uv"][i]).unbind(1)
    n = _unit(_interp(w0, b1, b2, tab["nrm"][i]))
    world = _interp(w0, b1, b2, tab["pos"][i])
    view = _unit(camera_pos[None, :] - world)
    n = torch.where((_dot(n, view) < 0.0)[:, None], -n, n)
    n = torch.where(tab["has_n"][i][:, None], n, 0.0)
    return {"ok": ok, "tri": i, "world": world, "normal": n, "view": view, "u": u, "v": v,
            "lit": tab["lit"][i], "t": hit["t"]}


def _ggx_terms(n, v, l, ndl_extra, clamp_spec: bool = False, rough: float = 0.5):
    """Cook-Torrance GGX at roughness `rough`, metallic 0 -> (diffuse
    factor on the albedo, specular) per pixel, both to be scaled by the
    radiance; `ndl_extra` multiplies both (the renderer's lambert)."""
    r = min(max(rough, 0.045), 1.0)
    a2 = (r * r) ** 2
    k = (r + 1.0) ** 2 / 8.0
    ndl = torch.clamp(_dot(n, l), min=0.0)
    ndv = torch.clamp(_dot(n, v), min=0.0)
    h = l + v
    inv_hl = 1.0 / torch.clamp(torch.sqrt(_dot(h, h)), min=1e-30)
    ndh = torch.clamp(_dot(n, h) * inv_hl, min=0.0)
    den = ndh * ndh * (a2 - 1.0) + 1.0
    dist = a2 / (math.pi * den * den + 1e-7)
    gv = ndv / (ndv * (1.0 - k) + k + 1e-7)
    gl = ndl / (ndl * (1.0 - k) + k + 1e-7)
    s = dist * gv * gl / (4.0 * ndl * ndv + 1e-7)
    x = 1.0 - torch.clamp(torch.clamp(_dot(h, v) * inv_hl, min=0.0), 0.0, 1.0)
    fr = 0.04 + 0.96 * x ** 5
    spec = fr * s
    if clamp_spec:
        spec = torch.clamp(spec, max=1.0)
    dead = (ndl <= 0.0) | (ndv <= 0.0)
    diff = torch.where(dead, 0.0, (1.0 - fr) * ndl / math.pi * ndl_extra)
    spec = torch.where(dead, 0.0, spec * ndl * ndl_extra)
    return diff, spec


def _light_scale(row, world, n, reflection_hit: bool):
    """One light row's radiance scale at each point (before the colour)
    and its direction toward the light."""
    lp = torch.tensor(row["pos"], dtype=world.dtype, device=world.device)
    tp = world - lp[None]
    dist = torch.sqrt(_dot(tp, tp))
    dp = tp / torch.clamp(dist, min=1e-20)[:, None]
    lt = row["type"]
    start, end, inten = row["start"], row["end"], row["intensity"]
    lambert = torch.clamp(-_dot(n, dp), min=0.0)
    if lt in (AMBIENT, AMBIENT_DAYLIGHT):
        scale = torch.full_like(dist, inten)
    elif lt == POINT:
        st = torch.clamp((dist - end) / (start - end), 0.0, 1.0)
        smooth = torch.where(dist <= start, 1.0, st * st * (3.0 - 2.0 * st))
        scale = torch.where(dist < end, inten * smooth * lambert, 0.0)
    else:
        lin = torch.where(dist <= start, 1.0, 1.0 - (dist - start) / max(end - start, 1e-20))
        ldir = torch.tensor(row["dir"], dtype=world.dtype, device=world.device)
        cosang = torch.clamp(_dot(dp, ldir[None]), -1.0, 1.0)
        if reflection_hit:
            inside = torch.arccos(cosang.double()).to(cosang.dtype) <= row["cone"]
        else:
            inside = cosang >= float(np.cos(np.float32(row["cone"])))
        scale = torch.where(inside & (dist < end), inten * lin * lambert, 0.0)
    return scale, -dp


def direct_light(s, tab, settings, lights):
    """The opaque frame's lighting at a surface -> (A, B), each (N, 3),
    with the linear colour = albedo * A + B (the megakernel's stage 4)."""
    n, v, world = s["normal"], s["view"], s["world"]
    dev, dt = world.device, world.dtype
    hemi = 0.5 * (n[:, 1] + 1.0)
    amb = torch.tensor(settings["ambient"][:3], dtype=dt, device=dev)
    A = 0.96 * (amb[None] + tab["amb"][s["tri"]]) * hemi[:, None]
    B = torch.zeros_like(A)
    if settings.get("sun_dir") is not None and settings.get("day_factor", 0.0) > 0:
        sd = _unit(-torch.tensor(settings["sun_dir"], dtype=dt, device=dev))
        rad = settings["day_factor"] * torch.tensor(settings["sun_color"], dtype=dt, device=dev)
        diff, spec = _ggx_terms(n, v, sd[None].expand_as(n), 1.0)
        A = A + diff[:, None] * rad[None]
        B = B + spec[:, None] * rad[None]
    for row in lights:
        scale, l = _light_scale(row, world, n, reflection_hit=False)
        col = torch.tensor(row["color"], dtype=dt, device=dev)
        diff, spec = _ggx_terms(n, v, l, scale)
        A = A + diff[:, None] * col[None]
        B = B + spec[:, None] * col[None]
    return A, B


def texel_options(tab, s):
    """The surface's texel (N, 4) 0..255 and its alternatives where the
    texture coordinate lies within UV_EPS of a rounding or wrap boundary:
    a list of (N, 4), the first the texel itself."""
    i = s["tri"]
    kind, rgba = tab["kind"][i], tab["rgba"][i] * 255.0
    out = []
    for du, dv in ((0.0, 0.0), (UV_EPS, UV_EPS), (UV_EPS, -UV_EPS), (-UV_EPS, UV_EPS),
                   (-UV_EPS, -UV_EPS)):
        tx = _texel(tab, tab["tex"][i], s["u"] + du, s["v"] + dv, tab["repeat"][i])
        out.append(torch.where((kind == TEXTURE)[:, None], tx, rgba))
    return out


def direct_colors(tab, s, settings, lights, background):
    """The opaque frame's RGBA8 (as float) at a surface, for each texel
    option -> list of (N, 4); pixels the ray missed take the background."""
    A, B = direct_light(s, tab, settings, lights)
    lit = tab["lit"][s["tri"]]
    out = []
    for texel in texel_options(tab, s):
        base = srgb_to_linear(texel[:, :3] / 255.0)
        rgb = to_u8(linear_to_srgb(base * A + B))
        rgb = torch.where(lit[:, None], rgb, texel[:, :3])
        alpha = to_u8(texel[:, 3:] / 255.0)
        col = torch.cat([rgb, alpha], 1)
        # a pixel is written where its texel is opaque
        col = torch.where((s["ok"] & (alpha[:, 0] >= 255))[:, None], col, background)
        out.append(col)
    return out


def _hash33(px, py, pz):
    """WGSL hash33 -> two uniforms in [0, 1)."""
    hx, hy, hz = px * 0.1031, py * 0.1030, pz * 0.0973
    hx, hy, hz = hx - torch.floor(hx), hy - torch.floor(hy), hz - torch.floor(hz)
    dd = hx * (hy + 33.33) + hy * (hx + 33.33) + hz * (hz + 33.33)
    hx, hy, hz = hx + dd, hy + dd, hz + dd
    o1 = (hx + hy) * hz
    o2 = (hx + hx) * hy
    return o1 - torch.floor(o1), o2 - torch.floor(o2)


def reflection(tab, s, px, py, settings, lights, count: bool = False, geo=None):
    """One GGX-sampled reflection ray per covered pixel of the surface `s`
    (sample 0), traced and shaded against the opaque triangles `tab` ->
    (linear radiance times the Fresnel weight (N, 3), applied mask (N,),
    work counts)."""
    n, v, world = s["normal"], s["view"], s["world"]
    dev = world.device
    rough = 0.5
    a2 = rough ** 4
    live = s["ok"] & (_dot(n, n) > 0.5) & s["lit"]
    up = torch.where((n[:, 1].abs() < 0.9)[:, None],
                     torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=dev),
                     torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=dev))
    t = _unit(_cross(up, n))
    b = _cross(n, t)
    u1, u2 = _hash33(world[:, 0] + px * 0.5, world[:, 1] + py * 0.5, world[:, 2])
    phi = 2.0 * math.pi * u1
    cos_t = torch.sqrt((1.0 - u2) / ((a2 - 1.0) * u2 + 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    h = (n * cos_t[:, None] + b * (sin_t * torch.sin(phi))[:, None]
         + t * (sin_t * torch.cos(phi))[:, None])
    vdh = _dot(v, h)
    l = 2.0 * vdh[:, None] * h - v
    ndl = torch.clamp(_dot(n, l), min=0.0)
    ok = live & (ndl > 0.0)
    o = world + RAY_OFFSET * n
    o = torch.where(ok[:, None], o, 1e8)
    l = torch.where(ok[:, None], l, torch.tensor([0.0, -1.0, 0.0], dtype=l.dtype, device=dev))
    geo = tab if geo is None else geo
    gdt = geo["plane"].dtype
    hit = _as(cast(geo, o.to(gdt), l.to(gdt), RAY_TMIN, float(settings["refl_dist"]),
                   count_boxes=count), o.dtype)
    hit["tri"] = torch.where(ok, hit["tri"], -1)
    color = shade_hits(tab, hit, o, l, settings, lights)
    x = torch.clamp(1.0 - torch.clamp(vdh, min=0.0), 0.0, 1.0)
    fres = 0.04 + 0.96 * x ** 5
    refl = torch.where(ok[:, None], color * fres[:, None], 0.0)
    work = {"rays": int(ok.sum())}
    if count:
        work["ray_boxes"] = int(torch.where(ok, hit["boxes"], 0).sum())
    return refl, ok, work


def shade_hits(tab, hit, o, d, settings, lights):
    """Radiance along each reflection ray: the hit's GGX direct light and
    the ambient uniform on its albedo, or the sky colour on a miss."""
    dev, dt = o.device, o.dtype
    tri = hit["tri"]
    ok = tri >= 0
    i = tri.clamp(min=0)
    b1, b2 = hit["b1"], hit["b2"]
    w0 = 1.0 - b1 - b2
    u, v = _interp(w0, b1, b2, tab["uv"][i]).unbind(1)
    n_interp = _interp(w0, b1, b2, tab["nrm"][i])
    n = torch.where(tab["has_n"][i][:, None], n_interp, tab["geo_n"][i])
    n = _unit(n)
    n = torch.where((_dot(n, d) > 0.0)[:, None], -n, n)
    world = o + hit["t"][:, None] * d
    view = -d
    kind, rgba = tab["kind"][i], tab["rgba"][i] * 255.0
    texel = torch.where((kind == TEXTURE)[:, None],
                        _texel(tab, tab["tex"][i], u, v, tab["repeat"][i]), rgba)
    albedo = srgb_to_linear(texel[:, :3] / 255.0)
    lit = torch.zeros_like(albedo)
    if settings.get("sun_dir") is not None and settings.get("day_factor", 0.0) > 0:
        sd = _unit(-torch.tensor(settings["sun_dir"], dtype=dt, device=dev))
        rad = settings["day_factor"] * torch.tensor(settings["sun_color"], dtype=dt, device=dev)
        diff, spec = _ggx_terms(n, view, sd[None].expand_as(n), 1.0)
        lit = lit + (diff[:, None] * albedo + spec[:, None]) * rad[None]
    for row in lights:
        scale, l = _light_scale(row, world, n, reflection_hit=True)
        col = torch.tensor(row["color"], dtype=dt, device=dev)
        diff, spec = _ggx_terms(n, view, l, 1.0, clamp_spec=True)
        lit = lit + (diff[:, None] * albedo + spec[:, None]) * (scale[:, None] * col[None])
    amb = torch.tensor(settings["ambient"][:3], dtype=dt, device=dev)
    lit = lit + amb[None] * albedo
    lit = torch.where(tab["lit"][i][:, None], lit, albedo)
    sky = torch.tensor(settings.get("sky_rgb", [0.0, 0.0, 0.0]), dtype=dt, device=dev)
    return torch.where(ok[:, None], lit, sky[None])


# ------------------------------------------------------------ the frame

def primary_rays(proj, width: int, height: int, y0: int, rows: int, device):
    """Camera rays through the pixel centres of rows [y0, y0 + rows), in
    the camera's space -> (origins, directions scaled to unit view depth,
    pixel x, pixel y, near, far)."""
    proj = np.asarray(proj, np.float64)
    near = proj[2, 3] / proj[2, 2]
    far = proj[2, 3] / (1.0 + proj[2, 2])
    ys, xs = torch.meshgrid(torch.arange(y0, y0 + rows, device=device, dtype=torch.float32),
                            torch.arange(width, device=device, dtype=torch.float32),
                            indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    x_ndc = 2.0 * (xs + 0.5) / width - 1.0
    y_ndc = 1.0 - 2.0 * (ys + 0.5) / height
    d = torch.stack([x_ndc / float(proj[0, 0]), y_ndc / float(proj[1, 1]),
                     -torch.ones_like(x_ndc)], 1)
    return torch.zeros_like(d), d, xs, ys, near, far


def layer_color(s, tab):
    """An opacity layer's colour at its surface: the texel through the fast
    sRGB round trip, unlit, its alpha times the batch's opacity -> (N, 4)
    0..1."""
    texel = texel_options(tab, s)[0] / 255.0
    rgb = linear_to_srgb(srgb_to_linear(texel[:, :3]))
    alpha = texel[:, 3:] * tab["opacity"][s["tri"]][:, None]
    return torch.cat([rgb, alpha], 1)


def round_trip(x):
    """(N, 4) 0..1 through the fast sRGB decode and encode, alpha kept."""
    rgb = torch.clamp(linear_to_srgb(srgb_to_linear(x[:, :3])), 0.0, 1.0)
    return torch.cat([rgb, x[:, 3:]], 1)


def blend(frame, color, mask):
    """Src-over blend of `color` (N, 4, 0..1) where `mask`; alpha -> 1."""
    a = color[:, 3:]
    out = torch.cat([color[:, :3] * a + frame[:, :3] * (1.0 - a), torch.ones_like(a)], 1)
    return torch.where(mask[:, None], out, frame)


def light_2d(xs, ys, lights, settings, walls):
    """The 2D pass's light at pixels (xs, ys): every light's radiance at
    the grid point (x, 0, y) (the 2D footprint, no lambert), walls blocking
    all but the ambients, plus the ambient uniform, clipped to [0, 1] ->
    (N, 3)."""
    dt = xs.dtype
    p = torch.stack([xs, torch.zeros_like(xs), ys], 1)
    acc = torch.zeros_like(p)
    for row in lights:
        lp = torch.tensor(row["pos"], dtype=dt, device=p.device)
        tp = p - lp[None]
        dist = torch.sqrt(_dot(tp, tp).double()).to(dt)
        start, end, inten = row["start"], row["end"], row["intensity"]
        if row["type"] in (AMBIENT, AMBIENT_DAYLIGHT):
            scale = torch.full_like(dist, inten)
        else:
            if row["type"] == POINT:
                st = torch.clamp((dist - end) / (start - end), 0.0, 1.0)
                scale = inten * torch.where(dist <= start, 1.0, st * st * (3.0 - 2.0 * st))
            else:
                lin = torch.where(dist <= start, 1.0,
                                  1.0 - (dist - start) / max(end - start, 1e-20))
                dp = tp / torch.clamp(dist, min=1e-20)[:, None]
                ldir = torch.tensor(row["dir"], dtype=dt, device=p.device)
                cosang = torch.clamp(_dot(dp, ldir[None]), -1.0, 1.0)
                inside = torch.arccos(cosang.double()).to(dt) <= row["cone"]
                scale = torch.where(inside, inten * lin, 0.0)
            scale = torch.where(dist < end, scale, 0.0)
            if walls is not None:
                scale = torch.where(_crosses(xs, ys, lp[0], lp[2], walls), 0.0, scale)
        acc = acc + scale[:, None] * torch.tensor(row["color"], dtype=dt, device=p.device)[None]
    amb = torch.tensor(settings["ambient"][:3], dtype=dt, device=p.device)
    return torch.clamp(acc + amb[None], 0.0, 1.0)


def _crosses(ax, ay, bx, by, walls):
    """Does the segment from each pixel (ax, ay) to (bx, by) cross one of
    the wall segments `walls` (S, 4)? -> (N,) bool."""
    def ccw(px, py, qx, qy, rx, ry):
        return (ry - py) * (qx - px) > (qy - py) * (rx - px)

    a_x, a_y = ax[:, None], ay[:, None]
    c_x, c_y, d_x, d_y = (walls[None, :, k] for k in range(4))
    cross = ((ccw(a_x, a_y, c_x, c_y, d_x, d_y) != ccw(bx, by, c_x, c_y, d_x, d_y))
             & (ccw(a_x, a_y, bx, by, c_x, c_y) != ccw(a_x, a_y, bx, by, d_x, d_y)))
    return cross.any(1)


def rect_blend(frames, xs, ys, rects, lights, settings, walls):
    """The 2D rectangles in order over each frame of `frames` (a list of
    (N, 4) 0..1): coverage of the pixel centre, the flat colour lit in u8
    space (truncated), the alpha blend -> the list blended."""
    for x, y, w, h, rgba in rects:
        cov = (xs + 0.5 > x) & (xs + 0.5 < x + w) & (ys + 0.5 > y) & (ys + 0.5 < y + h)
        if not bool(cov.any()):
            continue
        idx = cov.nonzero()[:, 0]
        acc = light_2d(xs[idx], ys[idx], lights, settings, walls)
        col = torch.tensor(rgba, dtype=xs.dtype, device=xs.device)
        rgb = torch.floor(col[None, :3] * acc) / 255.0
        a = col[3] / 255.0
        out = []
        for f in frames:
            g = f.clone()
            if float(a) >= 1.0:
                g[idx] = torch.cat([rgb, torch.ones_like(rgb[:, :1])], 1)
            else:
                g[idx] = torch.cat([rgb * a + f[idx, :3] * (1.0 - a),
                                    torch.ones_like(rgb[:, :1])], 1)
            out.append(g)
        frames = out
    return frames


def _as(hit: dict, dtype) -> dict:
    """A cast's floating results in `dtype`."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in hit.items()}


def render(tab, lights, settings, view, proj, width: int, height: int,
           dtype=torch.float32, rows_per_block: int = 64, count: bool = False,
           opacity=None, rects=(), walls=None, shade_dtype=None) -> dict:
    """The reference frame -> dict: "frame" (H, W, 4) float 0..255 (the
    frame with the reference's own reflection samples), "options" (K, H,
    W, 4) uint8 the frame without reflections under every alternative,
    "floors" (K, H, W, 4) uint8 the least each alternative can read with a
    reflection that adds nothing, "direct" (H, W, 4) the main alternative's,
    and with `count` the work
    counts of the frame's opaque pass ("pixels", "covered", "texels",
    "rays", "ray_boxes", "triangles", "lights", "light_types").
    `opacity`: the opacity batches' tables (one depth-peeled layer, with
    its own reflection sample); `rects`: the 2D rectangles (x, y, w, h,
    rgba) drawn last; `walls` (S, 4): the wall segments blocking the 2D
    lights. `dtype` is the precision of the whole frame; `shade_dtype`, where
    given, that of everything but the rays' intersection (the camera's and
    the reflections'), which stays in `dtype`."""
    gdt = dtype
    dt = dtype if shade_dtype is None else shade_dtype

    def cast_dt(t, to):
        return {k: v.to(to) if torch.is_tensor(v) and v.is_floating_point() else v
                for k, v in t.items()}

    gtab = cast_dt(tab, gdt)
    tab = cast_dt(tab, dt)
    dev = tab["pos"].device
    bg = torch.tensor(settings.get("background", [0, 0, 0, 0]), dtype=dt, device=dev)
    if walls is not None:
        walls = walls.to(device=dev, dtype=dt)
    frames, options, floors, directs = [], [], [], []
    work = {"pixels": width * height, "covered": 0, "rays": 0, "ray_boxes": 0}
    texel_ids = []
    view = torch.as_tensor(np.asarray(view, np.float32), device=dev)
    cam = -(view[:3, :3].T @ view[:3, 3]).to(dt)
    vtab = view_tables(gtab, view.to(gdt))
    if opacity is not None:
        votab = view_tables(cast_dt(opacity, gdt), view.to(gdt))
        opacity = cast_dt(opacity, dt)
    for y0 in range(0, height, rows_per_block):
        rows = min(rows_per_block, height - y0)
        o, d, xs, ys, near, far = (x.to(gdt) if torch.is_tensor(x) else x for x in
                                   primary_rays(proj, width, height, y0, rows, dev))
        hits = _as(cast(vtab, o, d, near, far, alternatives=True), dt)
        xs, ys = xs.to(dt), ys.to(dt)
        main = surface(tab, {k: hits[k] for k in ("t", "tri", "b1", "b2")}, cam)
        opts = []
        for alt in ALTERNATIVES:
            h = {k: hits[k + alt] for k in ("t", "tri", "b1", "b2")}
            s = main if not alt else surface(tab, h, cam)
            opts += direct_colors(tab, s, settings, lights, bg)
        opts = [x / 255.0 for x in opts]
        refl, ok, w = reflection(tab, main, xs, ys, settings, lights, count, geo=gtab)
        rgb = torch.clamp(linear_to_srgb(srgb_to_linear(opts[0][:, :3]) + refl), 0.0, 1.0)
        frame = torch.cat([torch.where(ok[:, None], rgb, opts[0][:, :3]), opts[0][:, 3:]], 1)
        # where a reflection ray is cast the port re-encodes the pixel through
        # the fast sRGB pair, whose round trip alone can darken it: the
        # floors of the dark test take the darker of the two
        lows = [torch.minimum(x, round_trip(x)) for x in opts]
        if opacity is not None:
            lh = _as(cast(votab, o, d, near, far, alternatives=True), dt)
            depth = torch.where(main["ok"], main["t"], float("inf"))
            layer = {}
            for alt in ("", "_in", "_out"):
                ls = surface(opacity, {k: lh[k + alt] for k in ("t", "tri", "b1", "b2")}, cam)
                layer[alt] = (ls, layer_color(ls, opacity), ls["ok"] & (ls["t"] < depth))
            ls, lcol, lmask = layer[""]
            lrefl, lok, lw = reflection(tab, ls, xs, ys, settings, lights, count, geo=gtab)
            if count:
                work["rays"] += lw["rays"]
                work["ray_boxes"] += lw["ray_boxes"]
            lrgb = torch.clamp(linear_to_srgb(srgb_to_linear(lcol[:, :3]) + lrefl), 0.0, 1.0)
            frame = blend(frame, torch.cat([torch.where(lok[:, None], lrgb, lcol[:, :3]),
                                            lcol[:, 3:]], 1), lmask)
            lcol_low = torch.minimum(lcol, round_trip(lcol))
            opts = ([blend(x, lcol, lmask) for x in opts]
                    + [blend(opts[0], layer[a][1], layer[a][2]) for a in ("_in", "_out")])
            lows = ([blend(x, lcol_low, lmask) for x in lows]
                    + [blend(lows[0], torch.minimum(layer[a][1], round_trip(layer[a][1])),
                             layer[a][2]) for a in ("_in", "_out")])
        if rects:
            frame, *both = rect_blend([frame] + opts + lows, xs, ys, rects, lights, settings,
                                      walls)
            opts, lows = both[:len(opts)], both[len(opts):]
        frames.append(to_u8(frame).float())
        options.append(torch.stack([to_u8(x) for x in opts]).to(torch.uint8))
        floors.append(torch.stack([to_u8(x) for x in lows]).to(torch.uint8))
        directs.append(options[-1][0].float())
        if count:
            work["covered"] += int(main["ok"].sum())
            work["rays"] += w["rays"]
            work["ray_boxes"] += w["ray_boxes"]
            i = main["tri"]
            tx = tab["kind"][i] == TEXTURE
            ti = tab["tex"][i].clamp(min=0)
            u, v = main["u"], main["v"]
            wrap = tab["repeat"][i]
            uu = torch.where((wrap == 1) | (wrap == 2), u - torch.floor(u), u.clamp(0, 1))
            vv = torch.where((wrap == 1) | (wrap == 3), v - torch.floor(v), v.clamp(0, 1))
            tw, th = tab["tex_w"][ti], tab["tex_h"][ti]
            px = torch.floor(uu * (tw - 1).to(dt) + 0.5).long().clamp(min=0).minimum(tw - 1)
            py = torch.floor(vv * (th - 1).to(dt) + 0.5).long().clamp(min=0).minimum(th - 1)
            texel_ids.append((tab["tex_off"][ti] + py * tw + px)[main["ok"] & tx])
    out = {"frame": torch.cat(frames).reshape(height, width, 4),
           "direct": torch.cat(directs).reshape(height, width, 4),
           "options": torch.cat(options, 1).reshape(-1, height, width, 4),
           "floors": torch.cat(floors, 1).reshape(-1, height, width, 4)}
    if count:
        work["texels"] = int(torch.unique(torch.cat(texel_ids)).numel()) if texel_ids else 0
        work["triangles"] = int(tab["good"].sum())
        work["lights"] = len(lights)
        work["light_types"] = [r["type"] for r in lights]
        # the reflection passes a frame casts: the opaque frame's and the layer's
        work["walk_passes"] = 1 + (opacity is not None)
        out["work"] = work
    return out

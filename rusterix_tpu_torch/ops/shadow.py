"""Shadow maps for the 3D pass: per-light geometry shadows (torch
counterpart of `rusterix_tpu/ops/shadow.py`).

The reference's SceneVM traces one shadow ray per pixel and light
(embedded/shader/3d_shader.wgsl:436-517 `trace_shadow`). Here each casting
light renders depth maps with the same setup and visibility passes as the
frame, and the shading looks one texel up per pixel and casting light:

- Point and spot lights get 6-face cube maps of the LINEAR distance along
  each face's major axis; the lookup is the analytic cube mapping
  (`cube_face_uv`, the exact inverse of `FACE_BASES`).
- The sun gets one pseudo-directional map: a perspective camera behind the
  scene along the sun direction at 2.2 times the scene radius.
- `max_shadow_distance` caps the occluder's distance from the receiver
  (trace_shadow's ray-length cap, 3d_shader.wgsl:463-476).
- With opacity batches, each map also bakes depth-peeled transparent layers
  (`_trans_face`), which the lookup composes as (1 - alpha) over the layers
  strictly between the light and the receiver.

Table layout: every map lies in ONE flat f32 tensor, at the same flat
offsets and with the same padding (to a multiple of 128, NO_OCCLUDER) as
the JAX package's `(S, 128)` rows, so the `spec` tuples are equal and the
tables compare element for element; the 128-lane row split is a TPU layout
and is not kept. Empty texels hold NO_OCCLUDER.

The bake is plain torch, as the JAX bake is XLA (it calls the XLA
`visibility_pass`, not the Pallas kernel): culling forced off (one-sided
walls occlude from either side), then `b / (z + a)`. Its result does not
depend on the visibility pass's chunk (the first candidate wins ties inside
a chunk and the strict `>` keeps it across chunks), so it takes a larger
chunk than the JAX package's 8 (`BAKE_CHUNK`: an eighth of the steps).

The lookup writes out the products XLA's CPU build fuses into FMAs where
they decide the texel or the depth compare (`_fma`): `bias + ma0*k` as
fma(ma0, k, bias), `p + n*offs` as fma(n, offs, p), the sun camera's
three-term dots `a*x + b*y + c*z` as fma(c, z, fma(a, x, b*y)) and
`q * half + half` as fma(q, half, half). B1's shadow variant
(`megakernel.mega_render_reference`, `csrc/megakernel.cu`) computes the
same expressions.
"""

from __future__ import annotations

import numpy as np
import torch

from .matrices import perspective_fov_rh_zo
from .setup_pass import _fma, setup_pass
from .visibility import visibility_pass

#: depth value meaning "no occluder along this texel"
NO_OCCLUDER = 1e30

#: near plane of every shadow camera — must match setup_pass.NEAR_PLANE
#: (the Sutherland-Hodgman clip is hard-coded to it)
SHADOW_NEAR = 0.1

#: (fwd, right, up) per cube face. The analytic face/uv selection
#: (`cube_face_uv` here; B1's `cube_shadow` in csrc/megakernel.cu mirrors
#: it) is the exact inverse of the view matrices these produce.
FACE_BASES = (
    ((1, 0, 0), (0, 0, -1), (0, 1, 0)),   # +X
    ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),   # -X
    ((0, 1, 0), (1, 0, 0), (0, 0, -1)),   # +Y
    ((0, -1, 0), (1, 0, 0), (0, 0, 1)),   # -Y
    ((0, 0, 1), (-1, 0, 0), (0, 1, 0)),   # +Z
    ((0, 0, -1), (1, 0, 0), (0, 1, 0)),   # -Z
)

#: candidates a step of the bake's visibility pass takes (the JAX package's
#: XLA pass takes 8); the result does not depend on it. 64 candidates of a
#: 256² sun map are 16 MB of f32 a step.
BAKE_CHUNK = 64


def face_view_matrix(light_pos, face: int) -> np.ndarray:
    """View matrix of cube `face` at `light_pos` (rows [right; up; -fwd],
    standard RH camera: view z is negative in front)."""
    fwd, right, up = (np.asarray(v, np.float32) for v in FACE_BASES[face])
    eye = np.asarray(light_pos, np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = right
    m[1, :3] = up
    m[2, :3] = -fwd
    m[0, 3] = -np.dot(right, eye)
    m[1, 3] = -np.dot(up, eye)
    m[2, 3] = np.dot(fwd, eye)
    return m


def depth_const(near: float, far: float):
    """(A, B) of the zo depth mapping: view distance d = B / (z_ndc + A)
    (perspective_fov_rh_zo rows m[2,2], m[2,3] with w = d)."""
    a = far / (near - far)
    b = -(far * near) / (far - near)
    return float(a), float(b)


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def _depth_face(pos, uv, nrm, valid, view, proj, a, b, res: int):
    """One shadow-camera depth render -> (res, res) linear view distance.

    Culling is forced OFF: one-sided walls must occlude from either side
    (the reference's shadow trace tests geometry regardless of facing,
    3d_shader.wgsl:436-460). view/proj: (4, 4) numpy; a, b: the depth
    constants, taken as f32 as the JAX package's jitted function takes
    them."""
    dev = pos.device
    cull = torch.zeros(pos.shape[0], dtype=torch.int32, device=dev)
    vis, _attr, _bbox, alive, _tid = setup_pass(
        pos, uv, nrm, valid, cull, torch.from_numpy(np.asarray(view, np.float32)).to(dev),
        torch.from_numpy(np.asarray(proj, np.float32)).to(dev), res, res,
    )
    z, _idx, hit = visibility_pass(vis, alive.float(), res, res, chunk=BAKE_CHUNK,
                                   plane_fma=True)
    return torch.where(hit, _f32(b, dev) / (z + _f32(a, dev)), NO_OCCLUDER)




#: transparent layers closer together than this (along the shadow camera's
#: depth metric) merge into one — the reference's stepper advances past
#: each hit by shadow_bias = 0.01 before tracing again
#: (3d_shader.wgsl:464,509), so coincident two-sided panes count ONCE
PEEL_MERGE_EPS = 0.01


def _trans_face(pos, uv, nrm, valid, opac_cols, view, proj, a, b, res: int,
                steps: int):
    """Depth-peeled transparent layers for one shadow camera ->
    (steps, 2, res, res) f32: [k, 0] = layer-k depth (linear view
    distance; NO_OCCLUDER where absent), [k, 1] = layer-k alpha.

    The reference's trace_shadow attenuates only through surfaces it steps
    THROUGH strictly between the receiver and the light
    (3d_shader.wgsl:479-515): the nearest `steps` transparent layers per
    texel, WITH their depths, let the lookup compose (1 - alpha) over
    exactly the layers in the light-to-receiver segment, and the peel's
    strict-beyond order plus PEEL_MERGE_EPS counts coincident two-sided
    panes once. alpha is the batch-constant opacity column (opac_cols, one
    value per packed triangle)."""
    dev = pos.device
    cull = torch.zeros(pos.shape[0], dtype=torch.int32, device=dev)
    vis, _attr, _bbox, alive, tri_id = setup_pass(
        pos, uv, nrm, valid, cull, torch.from_numpy(np.asarray(view, np.float32)).to(dev),
        torch.from_numpy(np.asarray(proj, np.float32)).to(dev), res, res,
    )
    alive_f = alive.float()
    alpha_tri = opac_cols.float()[tri_id.long()]
    a_t, b_t = _f32(a, dev), _f32(b, dev)
    outs = []
    ceil = None
    prev_d = None
    for _k in range(steps):
        z, idx, hit, invz = visibility_pass(vis, alive_f, res, res, chunk=BAKE_CHUNK,
                                            z_ceil=ceil, return_invz=True, plane_fma=True)
        d = torch.where(hit, b_t / (z + a_t), NO_OCCLUDER)
        al = torch.where(hit, alpha_tri[torch.clamp(idx, min=0).long()], 0.0)
        if prev_d is None:
            prev_d = d
        else:
            keep = d > prev_d + PEEL_MERGE_EPS
            al = torch.where(keep, al, 0.0)
            prev_d = torch.where(keep, d, prev_d)
        outs.append(torch.stack([d, al]))
        ceil = invz
    return torch.stack(outs)


def scene_bounds(pos: np.ndarray, valid: np.ndarray):
    """(center (3,), radius) of the valid packed triangles (host numpy)."""
    v = valid > 0.5
    if not v.any():
        return np.zeros(3, np.float32), 1.0
    p = pos[v][:, :, :3].reshape(-1, 3)
    lo = p.min(axis=0)
    hi = p.max(axis=0)
    center = (lo + hi) * 0.5
    radius = float(np.linalg.norm(hi - center))
    return center.astype(np.float32), max(radius, 1e-3)


def sun_camera(sun_dir, center, radius):
    """Pseudo-directional sun camera: perspective from 2.2*radius behind the
    scene along sun_dir. Returns (view, proj, params) with params =
    dict(pos, right, up, fwd, f, near, far)."""
    d = np.asarray(sun_dir, np.float32)
    d = d / max(np.linalg.norm(d), 1e-20)
    dist = 2.2 * radius
    eye = np.asarray(center, np.float32) - d * dist
    # basis around fwd = d
    up_pick = (
        np.array([0, 0, 1], np.float32)
        if abs(d[1]) > 0.999
        else np.array([0, 1, 0], np.float32)
    )
    right = np.cross(d, up_pick)
    right = right / max(np.linalg.norm(right), 1e-20)
    up = np.cross(right, d)
    near = max(0.25 * radius, SHADOW_NEAR)
    far = dist + 1.5 * radius
    # cover the bounding sphere from the eye, 5% margin
    half = np.arctan2(radius, max(dist - radius, 1e-3)) * 1.05
    fov = 2.0 * half
    view = np.eye(4, dtype=np.float32)
    view[0, :3] = right
    view[1, :3] = up
    view[2, :3] = -d
    view[0, 3] = -np.dot(right, eye)
    view[1, 3] = -np.dot(up, eye)
    view[2, 3] = np.dot(d, eye)
    proj = perspective_fov_rh_zo(fov, 1.0, 1.0, near, far)
    f = float(1.0 / np.tan(half))
    return view, proj, dict(
        pos=eye.astype(np.float32),
        right=right.astype(np.float32),
        up=up.astype(np.float32),
        fwd=d.astype(np.float32),
        f=f,
        near=float(near),
        far=float(far),
    )


def bake_shadow_pack(
    d3,
    d3_op,
    lights: dict,
    cast_rows,
    sun_dir=None,
    *,
    res: int = 128,
    sun_res: int = 256,
    with_trans: bool = False,
    trans_steps: int = 2,
    max_shadow_distance: float = 50.0,
    bias: float = 0.05,
    bounds=None,
):
    """Render every shadow map and pack them into one flat table.

    d3 / d3_op: packed static batch dicts of tensors (pos/uv/nrm/valid
    keys, d3_op also `opacity`) on the bake's device. lights: the host SoA
    dict from pack_lights. cast_rows: light rows that get cube maps
    (point/spot). sun_dir: world sun direction (None = no sun map).

    Returns (rows (N,) f32 tensor, N a multiple of 128, params (40,)
    np.float32, spec) with the JAX package's layout: spec is
    (sun_entry, cube_entries),
      sun_entry    = (base_texel, sun_res, trans_base|-1, trans_steps) or None
      cube_entries = ((light_row, base_texel, res, trans_base|-1,
                       trans_steps), ...)
    Bases are flat texel indices, multiples of 128 where a map's size is.
    A transmittance region holds `trans_steps` depth-peeled layers, k-major
    as [k0 depth, k0 alpha, k1 depth, k1 alpha, ...], one map-sized plane
    each (map size = sun_res² or 6*res²), face-major inside a plane, so
    `flat - base` indexes every plane. params: [0] max_shadow_distance,
    [1] bias, [2:5] sun camera position, [5:8] right, [8:11] up, [11:14]
    forward, [14] f, [15] near."""
    pos, uv, nrm, valid = d3["pos"], d3["uv"], d3["nrm"], d3["valid"]
    dev = pos.device
    has_op = with_trans and d3_op is not None and bool(d3_op["valid"].bool().any())

    if bounds is None:
        bounds = scene_bounds(pos.cpu().numpy(), valid.cpu().numpy())
    center, radius = bounds

    maps = []  # flat f32 tensors, each a multiple of res*res long
    offset = 0

    def push(flat):
        nonlocal offset
        base = offset
        maps.append(flat)
        offset += flat.shape[0]
        return base

    def trans(view, proj, a, b, r):
        return _trans_face(d3_op["pos"], d3_op["uv"], d3_op["nrm"], d3_op["valid"],
                           d3_op["opacity"], view, proj, a, b, r, trans_steps)

    positions = np.asarray(lights["position"])
    ends = np.asarray(lights["end"])

    sun_entry = None
    params = np.zeros(40, np.float32)
    params[0] = max_shadow_distance
    params[1] = bias
    if sun_dir is not None:
        view, proj, sp = sun_camera(sun_dir, center, radius)
        a, b = depth_const(sp["near"], sp["far"])
        depth = _depth_face(pos, uv, nrm, valid, view, proj, a, b, sun_res)
        sun_base = push(depth.reshape(-1))
        sun_trans_base = push(trans(view, proj, a, b, sun_res).reshape(-1)) if has_op else -1
        sun_entry = (sun_base, sun_res, sun_trans_base, trans_steps)
        params[2:5] = sp["pos"]
        params[5:8] = sp["right"]
        params[8:11] = sp["up"]
        params[11:14] = sp["fwd"]
        params[14] = sp["f"]
        params[15] = sp["near"]

    cube_entries = []
    for li in cast_rows:
        far = float(max(ends[li], SHADOW_NEAR * 2.0))
        a, b = depth_const(SHADOW_NEAR, far)
        proj = perspective_fov_rh_zo(np.pi / 2.0, 1.0, 1.0, SHADOW_NEAR, far)
        faces = []
        tfaces = []
        for face in range(6):
            view = face_view_matrix(positions[li], face)
            faces.append(_depth_face(pos, uv, nrm, valid, view, proj, a, b, res))
            if has_op:
                tfaces.append(trans(view, proj, a, b, res))
        base = push(torch.stack(faces).reshape(-1))
        # (steps, 2, 6, res, res): k-major, kind (depth/alpha), face
        tbase = push(torch.stack(tfaces, dim=2).reshape(-1)) if has_op else -1
        cube_entries.append((int(li), base, res, tbase, trans_steps))

    if not maps:
        return torch.full((128,), NO_OCCLUDER, device=dev), params, (None, ())

    flat = torch.cat(maps)
    pad = (-flat.shape[0]) % 128
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad), value=NO_OCCLUDER)
    return flat, params, (sun_entry, tuple(cube_entries))


def shadow_pack_from_numpy(rows, params, spec, device):
    """A bake made elsewhere (the JAX package's `(S, 128)` rows, its (40,)
    params and its spec, as numpy or anything np.asarray takes) -> the
    port's (flat (S*128,) f32 tensor on `device`, params (40,) np.float32,
    spec)."""
    flat = torch.from_numpy(np.array(rows, np.float32).reshape(-1))
    sun_entry, cube_entries = spec
    spec = (
        None if sun_entry is None else tuple(int(v) for v in sun_entry),
        tuple(tuple(int(v) for v in e) for e in cube_entries),
    )
    return flat.to(device), np.asarray(params, np.float32).copy(), spec


def bake_shadow_cams(lights, spec, sun_dir=None, bounds=None):
    """(n_entries, 8, 4, 4) f32 camera pack for the per-frame DYNAMIC
    caster composite (composite_dynamic_depth below), rebuilt from the
    same inputs bake_shadow_pack used, so the dynamic layer renders with
    the cameras of the cached static maps.

    Entry order follows the spec (sun first if present, then the cube
    entries). Sun rows: [view, proj, consts, 0...]; cube rows:
    [view0..view5, proj, consts]; consts[0, :2] = the (A, B) depth
    constants. Returns None when the spec is empty."""
    sun_entry, cube_entries = spec
    n = (1 if sun_entry is not None else 0) + len(cube_entries)
    if n == 0:
        return None
    cams = np.zeros((n, 8, 4, 4), np.float32)
    ei = 0
    if sun_entry is not None:
        center, radius = bounds
        view, proj, sp = sun_camera(sun_dir, center, radius)
        a, b = depth_const(sp["near"], sp["far"])
        cams[0, 0] = view
        cams[0, 1] = proj
        cams[0, 2, 0, 0] = a
        cams[0, 2, 0, 1] = b
        ei = 1
    positions = np.asarray(lights["position"])
    ends = np.asarray(lights["end"])
    for li, _base, _res, _tb, _st in cube_entries:
        far = float(max(ends[li], SHADOW_NEAR * 2.0))
        a, b = depth_const(SHADOW_NEAR, far)
        proj = perspective_fov_rh_zo(np.pi / 2.0, 1.0, 1.0, SHADOW_NEAR, far)
        for face in range(6):
            cams[ei, face] = face_view_matrix(positions[li], face)
        cams[ei, 6] = proj
        cams[ei, 7, 0, 0] = a
        cams[ei, 7, 0, 1] = b
        ei += 1
    return cams


def composite_dynamic_depth(rows_flat, spec, cams, pos, uv, nrm, valid):
    """Min-composite the DYNAMIC pack's depth into every baked map, so that
    dynamic geometry casts shadows like the static world (the reference's
    trace_shadow_unified -> trace_billboards, 3d_shader.wgsl:436-460,
    297-327): the static maps stay cached, the small dynamic pack renders
    through the same _depth_face with the cameras of bake_shadow_cams, and
    an elementwise min folds it in. Dead dynamic slots cover nothing.
    Dynamic transparent batches do not attenuate (the transmittance planes
    stay static-only).

    rows_flat: the flat table; pos/uv/nrm/valid: the dynamic d3 pack.
    Returns a new flat table."""
    sun_entry, cube_entries = spec
    out = rows_flat.clone()
    ei = 0
    if sun_entry is not None:
        base, res, _tb, _st = sun_entry
        d = _depth_face(pos, uv, nrm, valid, cams[0, 0], cams[0, 1],
                        float(cams[0, 2, 0, 0]), float(cams[0, 2, 0, 1]), res)
        out[base:base + res * res] = torch.minimum(out[base:base + res * res], d.reshape(-1))
        ei = 1
    for _li, base, res, _tb, _st in cube_entries:
        proj = cams[ei, 6]
        a, b = float(cams[ei, 7, 0, 0]), float(cams[ei, 7, 0, 1])
        for face in range(6):
            d = _depth_face(pos, uv, nrm, valid, cams[ei, face], proj, a, b, res)
            off = base + face * res * res
            out[off:off + res * res] = torch.minimum(out[off:off + res * res], d.reshape(-1))
        ei += 1
    return out


# ---------------------------------------------------------------- the lookup


def cube_face_uv(tpx, tpy, tpz):
    """Analytic cube mapping: (face i32, u_num, v_num, ma) for the
    direction tp = P - light_pos. Exact inverse of FACE_BASES (ties break
    x > y > z, positive before negative: a seam texel reads the
    neighbouring face's depth, which bounds the same occluders)."""
    ax, ay, az = tpx.abs(), tpy.abs(), tpz.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    ma = torch.maximum(ax, torch.maximum(ay, az))
    sgn_x = torch.where(tpx >= 0, 1.0, -1.0)
    sgn_y = torch.where(tpy >= 0, 1.0, -1.0)
    sgn_z = torch.where(tpz >= 0, 1.0, -1.0)
    u_num = torch.where(is_x, -sgn_x * tpz, torch.where(is_y, tpx, -sgn_z * tpx))
    v_num = torch.where(is_x, tpy, torch.where(is_y, -sgn_y * tpz, tpy))
    face = torch.where(
        is_x,
        torch.where(tpx < 0, 1, 0),
        torch.where(is_y, torch.where(tpy < 0, 3, 2), torch.where(tpz < 0, 5, 4)),
    ).to(torch.int32)
    return face, u_num, v_num, ma


def _texel_coord(num, den, half: float, res: int):
    """floor(num / den * half + half) clipped to [0, res-1], the product
    and sum fused as XLA fuses them."""
    return torch.clamp(torch.floor(_fma(num / den, half, half)), 0, res - 1)


def cube_shadow_texel(tpx, tpy, tpz, base: int, res: int):
    """Flat texel index (i32) + compare distance for a cube lookup."""
    face, u_num, v_num, ma = cube_face_uv(tpx, tpy, tpz)
    ma_safe = torch.clamp(ma, min=1e-20)
    half = res * 0.5
    sx = _texel_coord(u_num, ma_safe, half, res)
    sy = _texel_coord(-v_num, ma_safe, half, res)
    flat = base + face * (res * res) + sy.to(torch.int32) * res + sx.to(torch.int32)
    return flat, ma


def _dot3_xla(x, y, z, p, i: int):
    """x*p[i] + y*p[i+1] + z*p[i+2] as XLA's CPU build fuses the chain:
    fma(z, p[i+2], fma(x, p[i], y*p[i+1]))."""
    return _fma(z, p[i + 2], _fma(x, p[i], y * p[i + 1]))


def _params_on(params, device) -> torch.Tensor:
    if isinstance(params, torch.Tensor):
        return params.float().to(device)
    return torch.from_numpy(np.asarray(params, np.float32)).to(device)


def sun_shadow_texel(wx, wy, wz, params, base: int, res: int):
    """Flat texel index (i32) + compare distance + in-range mask for the
    sun map. params: the (40,) bake params (slots 2..15), numpy or a
    tensor."""
    p = _params_on(params, wx.device)
    dx = wx - p[2]
    dy = wy - p[3]
    dz = wz - p[4]
    vx = _dot3_xla(dx, dy, dz, p, 5)
    vy = _dot3_xla(dx, dy, dz, p, 8)
    vz = _dot3_xla(dx, dy, dz, p, 11)
    f = p[14]
    vz_safe = torch.clamp(vz, min=1e-20)
    half = res * 0.5
    sx = torch.floor(_fma(f * vx / vz_safe, half, half))
    sy = torch.floor(_fma(-f * vy / vz_safe, half, half))
    in_range = (vz > p[15]) & (sx >= 0) & (sx < res) & (sy >= 0) & (sy < res)
    sxc = torch.clamp(sx, 0, res - 1)
    syc = torch.clamp(sy, 0, res - 1)
    flat = base + syc.to(torch.int32) * res + sxc.to(torch.int32)
    return flat, vz, in_range


#: normal-offset strength in TEXELS of the shadow map: the receiver moves
#: along its shading normal by K * projected-texel-footprint before the
#: lookup, which kills self-shadow acne at grazing light angles (the
#: reference's ray tracer starts its shadow ray at hit + normal*0.01,
#: 3d_shader.wgsl:463; a rasterized map needs the footprint term)
NORMAL_OFFSET_TEXELS = 2.0


def _take(rows_flat, flat, live=None):
    """rows_flat[flat]; with `live`, parked (0) where not live, so that no
    index of a dead pixel reaches the table."""
    if live is None:
        return rows_flat[flat.long()]
    return torch.where(live, rows_flat[torch.where(live, flat, 0).long()], 0.0)


def shadow_factor(rows_flat, params, spec_entry, wx, wy, wz, nx, ny, nz, lpos=None,
                  live=None, return_reads: bool = False):
    """Shadow factor in [0, 1] for every point: the counterpart of
    `shadow_factor_xla`, in the rounding XLA gives it inside a jitted
    frame.

    rows_flat: the flat table; params: the (40,) bake params (numpy or a
    tensor). spec_entry: a cube entry (li, base, res, tbase, steps) with
    lpos = the light position ((3,) numpy f32), or the sun entry (base, res,
    tbase, steps) with lpos=None. nx/ny/nz: the shading normal (zeros: no
    offset). `live` (bool, optional) marks the points whose texels are
    read and that can be shadowed: elsewhere nothing is read and the factor
    is 1, as B1 parks dead pixels (the JAX function reads its clamped
    index everywhere). With `return_reads`, a second output marks the
    points whose depth texel is read: live and, for the sun, inside its
    map (the reads B1 makes).

    Transparency: the `steps` depth-peeled layers attenuate the factor by
    (1 - alpha), only the layers strictly between the light and the
    receiver and within the max_shadow_distance cap (trace_shadow's
    stepping, 3d_shader.wgsl:479-515)."""
    p = _params_on(params, wx.device)
    msd = p[0]
    bias = p[1]
    if lpos is None:
        base, res, tbase, steps = spec_entry
        # texel footprint at the receiver: depth * 2 / (f * res)
        dx = wx - p[2]
        dy = wy - p[3]
        dz = wz - p[4]
        vz0 = _dot3_xla(dx, dy, dz, p, 11)
        k = _f32(2.0 * NORMAL_OFFSET_TEXELS, wx.device) / (p[14] * res)
        offs = _fma(torch.clamp(vz0, min=0.0), k, bias)
        flat, d, in_range = sun_shadow_texel(
            _fma(nx, offs, wx), _fma(ny, offs, wy), _fma(nz, offs, wz), p, base, res
        )
        stored = _take(rows_flat, flat, live)
        blocked = in_range & (stored < d - bias) & (d - stored <= msd)
        in_map = in_range
        if live is not None:
            blocked, in_map = blocked & live, in_map & live
        msize = res * res
    else:
        _li, base, res, tbase, steps = spec_entry
        lp = lpos if isinstance(lpos, torch.Tensor) else [
            float(c) for c in np.asarray(lpos, np.float32)]
        tpx = wx - lp[0]
        tpy = wy - lp[1]
        tpz = wz - lp[2]
        # cube texel footprint: ma * 2 / res (f == 1 at 90° faces)
        ma0 = torch.maximum(tpx.abs(), torch.maximum(tpy.abs(), tpz.abs()))
        offs = _fma(ma0, float(np.float32(2.0 * NORMAL_OFFSET_TEXELS / res)), bias)
        flat, d = cube_shadow_texel(
            _fma(nx, offs, tpx), _fma(ny, offs, tpy), _fma(nz, offs, tpz), base, res
        )
        stored = _take(rows_flat, flat, live)
        blocked = (stored < d - bias) & (d - stored <= msd)
        in_map = torch.ones_like(blocked) if live is None else live
        if live is not None:
            blocked = blocked & live
        msize = 6 * res * res
    factor = torch.where(blocked, 0.0, 1.0)
    reads = in_map
    if tbase >= 0:
        rel = flat - base
        for k in range(steps):
            dk = _take(rows_flat, tbase + (2 * k) * msize + rel, live)
            ak = _take(rows_flat, tbase + (2 * k + 1) * msize + rel, live)
            between = in_map & (dk < d - bias) & (d - dk <= msd)
            factor = factor * torch.where(between, 1.0 - ak, 1.0)
    return (factor, reads) if return_reads else factor

"""Device setup pass: view transform, cull, near-plane clip, projection,
edge/interpolation-plane precompute (torch counterpart of
`rusterix_tpu/ops/setup_pass.py`).

Every input triangle maps to a fixed two output slots (a triangle clipped
by one plane yields at most 2 triangles), so the whole pass is batched
tensor code over the packed (T, ...) arrays; the batch dimension written
out replaces the JAX package's `vmap`.

Output: for each of the 2*T candidate triangles
  vis_planes : (2T, 12) f32 — 3 edge line equations (a,b,c each) in the
               reference's canonicalized winding plus the affine plane of
               interpolated 1/z_ndc. An impossible edge (0,0,-1) is stored
               for invalid/culled slots.
  attr_planes: (2T, 21) f32 — affine planes of 1/w, u/w, v/w, nx, ny, nz,
               b/w (vertex blend weight).
  bbox       : (2T, 4) f32 — screen bbox (min_x, min_y, max_x, max_y).
  alive      : (2T,) bool.
  tri_id     : (2T,) i32 — source triangle index (for meta gather).

Products are written out term by term instead of going through a matmul,
in the rounding the JAX package's CPU build (XLA) gives the same
expressions: XLA fuses `a*b + c` into FMAs and sums 4-term dots pairwise.
`_fma` computes the fused rounding, so the planes here are bit-equal to
the JAX package's on the CPU and the same on the GPU; the edge planes
decide coverage and z-tie winners, where one bit shows as a pixel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_table

NEAR_PLANE = 0.1  # reference batch3d.rs:566

CULL_OFF = 0
CULL_FRONT = 1
CULL_BACK = 2


def _fma(a, b, c):
    """f32 a*b + c rounded once, as a fused multiply-add (XLA's CPU build
    fuses the JAX package's `a*b + c`; B1's shadow lookup uses __fmaf_rn).
    Each operand is an f32 tensor or a number taken as the f32 constant JAX
    would use (at least one operand a tensor).

    The f32 product is exact in f64. Its f64 sum with c is made
    round-to-odd (an inexact sum with an even last bit steps one ulp toward
    the exact value, read from the TwoSum error), so that the final rounding
    to f32 is the single correct rounding: a plain f64 sum rounds twice and
    misses it where the sum lands on an f32 rounding tie."""

    def f32(x):
        return x if torch.is_tensor(x) else float(np.float32(x))

    a, b, c = f32(a), f32(b), f32(c)
    # one operand widened; the others are promoted inside each kernel
    if torch.is_tensor(a):
        p = a.double() * b
    elif torch.is_tensor(b):
        p = b.double() * a
    else:
        p = torch.tensor(a * b, dtype=torch.float64, device=c.device)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    # the neighbour toward the exact sum; NaN where the sum is exact (and
    # where it is not finite, which then keeps s)
    toward = torch.nextafter(s, err * float("inf"))
    odd = torch.where(((s.view(torch.int64) & 1) == 0) & (toward == toward), toward, s)
    return odd.float()


def _dot3(a, b):
    """3-term dot as a fused chain: fma(a2, b2, fma(a1, b1, a0*b0))."""
    acc = a[..., 0] * b[..., 0]
    acc = _fma(a[..., 1], b[..., 1], acc)
    return _fma(a[..., 2], b[..., 2], acc)


def _dot4(a, b):
    """4-term dot as a pairwise tree: (a0b0 + a1b1) + (a2b2 + a3b3)."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])


def _lambda_planes(p0, p1, p2):
    """Affine plane coefficients of the three barycentric weights for the
    screen triangles p0,p1,p2 (each (N, >=2)) -> lam (N, 3 weights, 3
    coeffs), degenerate (N,)."""
    ax, ay = p0[:, 0], p0[:, 1]
    bx, by = p1[:, 0], p1[:, 1]
    cx, cy = p2[:, 0], p2[:, 1]
    area = _fma(cx - ax, by - ay, -((cy - ay) * (bx - ax)))
    inv_area = torch.where(area.abs() > 1e-20, 1.0 / area, torch.zeros_like(area))
    a_n = [cy - by, bx - cx, _fma(cx, by, -(cy * bx))]
    a_a, a_b, a_c = (n * inv_area for n in a_n)
    b_a = (ay - cy) * inv_area
    b_b = (cx - ax) * inv_area
    b_c = _fma(cy, ax, -(cx * ay)) * inv_area
    # gamma = 1 - alpha - beta, with alpha's product fused into the sum
    g_a = -_fma(a_n[0], inv_area, b_a)
    g_b = -_fma(a_n[1], inv_area, b_b)
    g_c = 1.0 - _fma(a_n[2], inv_area, b_c)
    lam = torch.stack(
        [
            torch.stack([a_a, a_b, a_c], dim=-1),
            torch.stack([b_a, b_b, b_c], dim=-1),
            torch.stack([g_a, g_b, g_c], dim=-1),
        ],
        dim=1,
    )
    # the degenerate test sees the area with both products rounded, as the
    # JAX package's jitted pass evaluates it there: a sliver whose two
    # clipped vertices coincide has area exactly 0 and is dropped (the
    # fused area is the last product's rounding error, not 0)
    area_rounded = (cx - ax) * (by - ay) - (cy - ay) * (bx - ax)
    return lam, area_rounded.abs() <= 1e-20


def _edge_coeffs(v0, v1):
    """Line equations of edges v0->v1, (N, 2) each -> (N, 3)
    (reference src/edge.rs:12-24)."""
    a = v1[:, 1] - v0[:, 1]
    b = v0[:, 0] - v1[:, 0]
    c = _fma(v1[:, 0], v0[:, 1], -(v1[:, 1] * v0[:, 0]))
    return torch.stack([a, b, c], dim=-1)


def _clip_triangle(vv, uv, nn, bw):
    """Sutherland-Hodgman near-plane clip of view-space triangles.

    vv (N,3,4), uv (N,3,2), nn (N,3,3), bw (N,3) -> poly (N, 4, 10), count
    (N,). Emission order matches batch3d.rs:628-681 (current-inside emit,
    crossing emit)."""
    inside = vv[:, :, 2] < -NEAR_PLANE
    attrs = torch.cat([vv, uv, nn, bw[:, :, None]], dim=2)  # (N, 3, 10)
    flags, values = [], []
    for i in range(3):
        j = (i + 1) % 3
        cur, nxt = attrs[:, i], attrs[:, j]
        flags.append(inside[:, i])
        values.append(cur)
        dz = vv[:, j, 2] - vv[:, i, 2]
        t = torch.where(
            dz.abs() > 1e-30, (-NEAR_PLANE - vv[:, i, 2]) / dz, torch.zeros_like(dz)
        )[:, None]
        inter = _fma(t, nxt - cur, cur)
        # the reference normalizes the interpolated normal (batch3d.rs:651)
        n_lerp = _fma(nn[:, i], 1.0 - t, nn[:, j] * t)
        n_len = torch.sqrt(_dot3(n_lerp, n_lerp))[:, None]
        n_norm = torch.where(n_len > 0, n_lerp / torch.clamp(n_len, min=1e-30), n_lerp)
        inter = torch.cat([inter[:, :6], n_norm, inter[:, 9:]], dim=1)
        flags.append(inside[:, i] != inside[:, j])
        values.append(inter)
    flags = torch.stack(flags, dim=1)  # (N, 6)
    values = torch.stack(values, dim=1)  # (N, 6, 10)
    fi = flags.to(torch.int32)
    pos = torch.cumsum(fi, dim=1) - fi  # exclusive prefix sum
    slots = torch.arange(4, device=vv.device)
    sel = (pos[:, :, None] == slots) & flags[:, :, None]  # (N, 6, 4)
    poly = torch.where(sel[..., None], values[:, :, None, :], 0.0).sum(dim=1)
    return poly, fi.sum(dim=1)


def _project(v, proj, width, height):
    """Perspective divide + viewport map of (N, 3, 4) view-space vertices
    -> (N, 3, 4) [sx, sy, sz, w] (reference batch3d.rs:689-700)."""
    clip = [_dot4(v, proj[r]) for r in range(4)]
    w = clip[3]
    inv_w = 1.0 / w
    sx = (clip[0] * inv_w * 0.5 + 0.5) * width
    sy = (-clip[1] * inv_w * 0.5 + 0.5) * height
    sz = clip[2] * inv_w
    return torch.stack([sx, sy, sz, w], dim=-1)


def _slot_planes(tri10, slot_valid, cull, proj, width, height):
    """Vis/attr planes for one candidate slot of every triangle.

    tri10 (N, 3, 10) view-space vertex attrs [xyzw, uv, n, blend_w]."""
    p = _project(tri10[:, :, :4], proj, width, height)
    uv = tri10[:, :, 4:6]
    nn = tri10[:, :, 6:9]
    bw = tri10[:, :, 9]
    v0, v1, v2 = p[:, 0], p[:, 1], p[:, 2]

    # screen-space front-facing test (batch3d.rs:742-747)
    orient = _fma(
        v1[:, 0] - v0[:, 0],
        v2[:, 1] - v0[:, 1],
        -((v1[:, 1] - v0[:, 1]) * (v2[:, 0] - v0[:, 0])),
    )
    is_front = orient > 0.0
    # winding canonicalization per cull mode (batch3d.rs:713-731)
    swap = torch.where(cull == CULL_FRONT, torch.zeros_like(is_front), is_front)
    visible = torch.where(
        cull == CULL_OFF,
        torch.ones_like(is_front),
        torch.where(cull == CULL_BACK, is_front, ~is_front),
    )
    e1 = torch.where(swap[:, None], v2[:, :2], v1[:, :2])
    e2 = torch.where(swap[:, None], v1[:, :2], v2[:, :2])
    edge0 = _edge_coeffs(v0[:, :2], e1)
    edge1 = _edge_coeffs(e1, e2)
    edge2 = _edge_coeffs(e2, v0[:, :2])

    lam, degenerate = _lambda_planes(v0, v1, v2)

    inv_z = 1.0 / p[:, :, 2]  # 1/z_ndc per vertex (rasterizer.rs:1051-1053)
    inv_w = 1.0 / p[:, :, 3]

    # the eight planes sum_i f_i * lam_i at once (N, 8 planes, 3 coeffs):
    # 1/w, u/w, v/w, the normal, b/w, then 1/z
    fvals = torch.stack([inv_w, uv[:, :, 0] * inv_w, uv[:, :, 1] * inv_w, nn[:, :, 0],
                         nn[:, :, 1], nn[:, :, 2], bw * inv_w, inv_z], dim=1)
    planes = _dot3(fvals[:, :, None, :], lam.transpose(1, 2)[:, None])
    attr = planes[:, :7].reshape(-1, 21)
    ok = slot_valid & visible & ~degenerate
    dead_edge = device_table((0.0, 0.0, -1.0), torch.float32, p.device)
    edges = [torch.where(ok[:, None], e, dead_edge) for e in (edge0, edge1, edge2)]
    vis = torch.cat(edges + [planes[:, 7]], dim=1)
    bbox = torch.stack(
        [
            p[:, :, 0].amin(dim=1),
            p[:, :, 1].amin(dim=1),
            p[:, :, 0].amax(dim=1),
            p[:, :, 1].amax(dim=1),
        ],
        dim=1,
    )
    empty = device_table((1e9, 1e9, -1e9, -1e9), torch.float32, p.device)
    bbox = torch.where(ok[:, None], bbox, empty)
    return vis, attr, bbox, ok


def setup_pass(pos, uv, nrm, valid, cull, view, proj, width: int, height: int,
               bw=None):
    """Setup over all packed triangles.

    pos (T,3,4), uv (T,3,2), nrm (T,3,3), valid (T,), cull (T,), view and
    proj (4,4), bw (T,3) per-vertex blend weight (optional) ->
    vis_planes (2T,12), attr_planes (2T,21), bbox (2T,4), alive (2T,) bool,
    tri_id (2T,) i32."""
    t = pos.shape[0]
    if bw is None:
        bw = torch.zeros(pos.shape[:2], dtype=torch.float32, device=pos.device)
    vv = torch.stack([_dot4(pos, view[r]) for r in range(4)], dim=-1)  # (T,3,4)

    # early backface cull in view space (batch3d.rs:590-600)
    orient = _fma(
        vv[:, 1, 0] - vv[:, 0, 0],
        vv[:, 2, 1] - vv[:, 0, 1],
        -((vv[:, 1, 1] - vv[:, 0, 1]) * (vv[:, 2, 0] - vv[:, 0, 0])),
    )
    is_front = orient > 0.0
    early_culled = torch.where(
        cull == CULL_BACK,
        is_front,
        torch.where(cull == CULL_FRONT, ~is_front, torch.zeros_like(is_front)),
    )

    poly, count = _clip_triangle(vv, uv, nrm, bw)
    # slices, not list indices: a list index is a host tensor copied to the
    # device at every call
    tri0 = poly[:, 0:3]
    tri1 = torch.cat([poly[:, 0:1], poly[:, 2:4]], dim=1)
    # the view-space early cull only skips the CLIPPING work: early-culled
    # triangles still reach the screen-space test unclipped (batch3d.rs:592-600)
    unclipped = torch.cat([vv, uv, nrm, bw[:, :, None]], dim=2)
    tri0 = torch.where(early_culled[:, None, None], unclipped, tri0)

    alive = valid > 0.5
    ok0 = alive & torch.where(early_culled, torch.ones_like(alive), count >= 3)
    ok1 = alive & ~early_culled & (count == 4)

    # both candidate slots of every triangle in one pass (slot 0 rows, then
    # slot 1 rows), interleaved per triangle afterwards
    vis, attr, bbox, fin = _slot_planes(
        torch.cat([tri0, tri1]), torch.cat([ok0, ok1]), torch.cat([cull, cull]), proj,
        float(width), float(height))
    tri_id = torch.arange(t, dtype=torch.int32, device=pos.device).repeat_interleave(2)

    def interleave(x):
        return torch.stack([x[:t], x[t:]], dim=1).reshape(2 * t, *x.shape[1:])

    return interleave(vis), interleave(attr), interleave(bbox), interleave(fin), tri_id

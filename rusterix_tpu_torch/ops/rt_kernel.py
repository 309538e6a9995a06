"""Closest hit of secondary-ray fields against the packed scene through a
spatial index: the ray-intersect kernel (B3) and its preparation (torch
counterpart of `rusterix_tpu/ops/rt_kernel.py`).

Rays stay in their (H, W) screen layout and are cut into RT_BH x RT_BW
blocks; triangles are grouped into cells of RT_CELL consecutive pack slots
with world AABBs. The preparation (plain torch on the device) gives every
block a shortlist of cells ordered by the euclidean gap between the
block's origin box and the cell box, a lower bound on any of its rays' t
into the cell, with cells beyond the range cap or behind every ray's
direction culled to the tail. The kernel walks a block's shortlist while
the next entry's bound is below the block's bound (the max over its live
rays of min(best t, per-ray scene-exit cap)), slab-tests the cell box and,
when any ray enters, runs Möller-Trumbore on the cell's triangles.

`intersect_rays_pallas` launches the CUDA kernel (csrc/rt_kernel.cu) for
CUDA tensors and the plain version for CPU tensors;
`intersect_rays_pallas_reference` replays the kernel's walk in torch.
"""

from __future__ import annotations

import ctypes

import torch

#: pack slots per spatial cell
RT_CELL = 64
#: ray-block tile (rows x columns)
RT_BH = 8
RT_BW = 128
#: origins >= this are parked dead rays (the reflection pass parks at 1e8)
_PARKED = 1e7
_BIG = 3e37

#: launches of the CUDA kernel (one per intersect_rays_pallas call on CUDA
#: tensors)
launches = 0


def _cell_boxes(pos, valid, ncells: int, cell: int):
    """(x0, y0, z0, x1, y1, z1) world AABBs, each (ncells,), over `cell`-slot
    groups; dead slots collapse to an empty box (x0 > x1)."""
    alive = valid > 0.5
    out = []
    for lo in (True, False):
        for k in range(3):
            a, b, c = pos[:, 0, k], pos[:, 1, k], pos[:, 2, k]
            if lo:
                v = torch.where(alive, torch.minimum(torch.minimum(a, b), c), _BIG)
                out.append(v.reshape(ncells, cell).amin(dim=1))
            else:
                v = torch.where(alive, torch.maximum(torch.maximum(a, b), c), -_BIG)
                out.append(v.reshape(ncells, cell).amax(dim=1))
    return out


def _block_reduce(field, nby: int, nbx: int, lo: bool, neutral: float):
    v = field.reshape(nby, RT_BH, nbx, RT_BW)
    v = torch.where(torch.isnan(v), neutral, v)
    return v.amin(dim=(1, 3)) if lo else v.amax(dim=(1, 3))


def rt_prepare(pos, valid, ox, oy, oz, dx, dy, dz, t_cap, height: int, width: int) -> dict:
    """The walk's inputs, computed on the rays' device:

    tab (Tp, 16) f32: per slot [A | B - A | C - A], zero for dead slots;
    cbox (ncells, 8) f32: cell AABBs [x0 y0 z0 x1 y1 z1 0 0];
    tnear (nblocks, ncells) f32 and slist (nblocks, ncells) i32: each
    block's shortlist, keys ascending (culled cells at _BIG), ties in cell
    order; tcap (8,) f32: [t_cap | scene AABB of the live cells | 0];
    rays (6, hp, wp) f32: ox oy oz dx dy dz padded to whole blocks with
    parked rays; and the sizes."""
    dev = ox.device
    tcount = pos.shape[0]
    hp = -(-height // RT_BH) * RT_BH
    wp = -(-width // RT_BW) * RT_BW
    nby, nbx = hp // RT_BH, wp // RT_BW
    cell = -(-RT_CELL // 8) * 8
    ncells = -(-tcount // cell)
    tp = ncells * cell

    pos = pos[:, :, :3].float()
    valid = valid.float()
    a3 = pos[:, 0]
    tab = torch.cat([a3, pos[:, 1] - a3, pos[:, 2] - a3], dim=1)
    tab = torch.where((valid > 0.5)[:, None], tab, 0.0)
    tab = torch.nn.functional.pad(tab, (0, 7, 0, tp - tcount))

    cx0, cy0, cz0, cx1, cy1, cz1 = _cell_boxes(
        torch.nn.functional.pad(pos, (0, 0, 0, 0, 0, tp - tcount)),
        torch.nn.functional.pad(valid, (0, tp - tcount)), ncells, cell,
    )

    def padr(f, fill):
        return torch.nn.functional.pad(f.float(), (0, wp - width, 0, hp - height), value=fill)

    rays = torch.stack([padr(ox, 1e8), padr(oy, 1e8), padr(oz, 1e8),
                        padr(dx, 0.0), padr(dy, 0.0), padr(dz, 0.0)])
    live = rays[0] < _PARKED

    def box(f, lo):
        fill = _BIG if lo else -_BIG
        return _block_reduce(torch.where(live, f, fill), nby, nbx, lo, fill)

    ob0 = [box(rays[k], True) for k in range(3)]
    ob1 = [box(rays[k], False) for k in range(3)]
    db0 = [box(rays[3 + k], True) for k in range(3)]
    db1 = [box(rays[3 + k], False) for k in range(3)]

    # per-(block, cell) t lower bound: the gap between origin box and cell box
    def gap(c0, c1, b0, b1):
        return torch.clamp(
            torch.maximum(c0[None, None, :] - b1[:, :, None], b0[:, :, None] - c1[None, None, :]),
            min=0.0,
        )

    c0s, c1s = (cx0, cy0, cz0), (cx1, cy1, cz1)
    gx, gy, gz = (gap(c0s[k], c1s[k], ob0[k], ob1[k]) for k in range(3))
    dist = torch.sqrt(gx * gx + gy * gy + gz * gz)

    # direction cull per axis: a cell strictly on the + side of every origin
    # is out of reach when no live ray points +, and mirrored
    reach = torch.ones_like(dist, dtype=torch.bool)
    for k in range(3):
        pos_side = c0s[k][None, None, :] > ob1[k][:, :, None]
        neg_side = c1s[k][None, None, :] < ob0[k][:, :, None]
        reach &= ~((pos_side & (db1[k][:, :, None] <= 0.0))
                   | (neg_side & (db0[k][:, :, None] >= 0.0)))

    zeros = torch.zeros_like(cx0)
    cbox = torch.stack([cx0, cy0, cz0, cx1, cy1, cz1, zeros, zeros], dim=1)
    cell_alive = cx0 <= cx1
    t_cap = torch.as_tensor(t_cap, dtype=torch.float32, device=dev)
    key = torch.where(cell_alive[None, None, :] & reach & (dist < t_cap), dist, _BIG)
    # stable: keys tie at gap 0 and at _BIG, and the walk must visit tied
    # cells in cell order as the TPU kernel's stable sort does
    tnear, slist = torch.sort(key.reshape(nby * nbx, ncells), dim=1, stable=True)

    def live_min(v):
        return torch.where(cell_alive, v, _BIG).amin()

    def live_max(v):
        return torch.where(cell_alive, v, -_BIG).amax()

    tcap = torch.stack([
        t_cap, live_min(cx0), live_min(cy0), live_min(cz0),
        live_max(cx1), live_max(cy1), live_max(cz1), torch.zeros_like(t_cap),
    ])
    return {
        "tab": tab.contiguous(), "cbox": cbox.contiguous(),
        "tnear": tnear.contiguous(), "slist": slist.to(torch.int32).contiguous(),
        "tcap": tcap.contiguous(), "rays": rays.contiguous(),
        "cell": cell, "ncells": ncells, "nby": nby, "nbx": nbx,
        "height": height, "width": width,
    }


def _check_inputs(pos, valid, rays, height: int, width: int):
    dev = rays[0].device
    if pos.dim() != 3 or pos.shape[1] != 3 or pos.shape[2] < 3 or valid.shape != pos.shape[:1]:
        raise ValueError(f"pos must be (T, 3, >=3) and valid (T,), got {tuple(pos.shape)}, "
                         f"{tuple(valid.shape)}")
    for name, t in zip(("pos", "valid", "ox", "oy", "oz", "dx", "dy", "dz"), (pos, valid, *rays)):
        if t.device != dev:
            raise ValueError(f"intersect_rays_pallas: {name} is on {t.device}, the rays on {dev}")
    for t in rays:
        if tuple(t.shape) != (height, width):
            raise ValueError(f"ray fields must be ({height}, {width}), got {tuple(t.shape)}")


def intersect_rays_pallas(pos, valid, ox, oy, oz, dx, dy, dz, t_cap,
                          height: int, width: int):
    """Closest hit of (H, W) ray fields against the packed scene.

    pos (T, 3, >=3) world vertices (the d3 pack), valid (T,); ox..dz
    (H, W) f32, parked dead rays with origin >= 1e7; t_cap: the range cap,
    hits at or beyond it are misses. -> (t (H, W) f32, inf on a miss;
    idx (H, W) i32 slot, -1 on a miss).

    CUDA tensors launch the kernel (csrc/rt_kernel.cu); CPU tensors run
    intersect_rays_pallas_reference."""
    _check_inputs(pos, valid, (ox, oy, oz, dx, dy, dz), height, width)
    if ox.device.type != "cuda":
        return intersect_rays_pallas_reference(
            pos, valid, ox, oy, oz, dx, dy, dz, t_cap, height, width
        )
    prep = rt_prepare(pos, valid, ox, oy, oz, dx, dy, dz, t_cap, height, width)
    return _launch(prep)


def _launch(prep):
    global launches
    from .. import _cuda

    if prep["cell"] != 64:
        raise ValueError(f"the kernel stages cells of 64 triangles, not {prep['cell']}")
    dev = prep["rays"].device
    height, width = prep["height"], prep["width"]
    t = torch.empty((height, width), dtype=torch.float32, device=dev)
    idx = torch.empty((height, width), dtype=torch.int32, device=dev)
    ptr = ctypes.c_void_p
    err = _cuda.library().rx_rt_intersect(
        ptr(prep["tab"].data_ptr()), ptr(prep["cbox"].data_ptr()),
        ptr(prep["tnear"].data_ptr()), ptr(prep["slist"].data_ptr()),
        ptr(prep["tcap"].data_ptr()), ptr(prep["rays"].data_ptr()),
        ptr(t.data_ptr()), ptr(idx.data_ptr()),
        prep["ncells"], prep["nby"], prep["nbx"], height, width,
        ptr(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"ray-intersect kernel launch failed: CUDA error {err} "
                           f"({_cuda.error_string(err)})")
    launches += 1
    return t, idx


def intersect_rays_pallas_reference(pos, valid, ox, oy, oz, dx, dy, dz, t_cap,
                                    height: int, width: int, return_work: bool = False):
    """Plain torch version of intersect_rays_pallas: the kernel's walk
    replayed in lockstep over every block (step i visits slist[b, i] for
    each block b still walking), with the kernel's loop condition, slab
    gate, Möller-Trumbore expression order, strict `<` and bound refresh.

    With `return_work`, a third output counts the walk's work: "ray_box",
    the ray-cell slab tests (visited cells x rays per block), and
    "ray_triangle", the Möller-Trumbore tests (cells whose slab gate
    passed x rays per block x triangles per cell)."""
    return _walk(rt_prepare(pos, valid, ox, oy, oz, dx, dy, dz, t_cap, height, width),
                 return_work)


def _walk(prep, return_work: bool = False):
    tab, cbox, tnear, slist, tcap = (prep[k] for k in ("tab", "cbox", "tnear", "slist", "tcap"))
    cell, nc, nby, nbx = prep["cell"], prep["ncells"], prep["nby"], prep["nbx"]
    nb = nby * nbx
    # (6, hp, wp) -> (6, blocks, rays per block) in the kernel's block order
    rays = prep["rays"].reshape(6, nby, RT_BH, nbx, RT_BW).permute(0, 1, 3, 2, 4)
    ox, oy, oz, dx, dy, dz = rays.reshape(6, nb, RT_BH * RT_BW)
    live = ox < _PARKED

    def inv(d):
        return 1.0 / torch.where(d.abs() < 1e-20, 1e-20, d)

    inv_dx, inv_dy, inv_dz = inv(dx), inv(dy), inv(dz)
    cap = tcap[0]
    # per-ray scene-exit cap (torch.maximum/minimum propagate NaN as the
    # JAX kernel's jnp.maximum/minimum do)
    t_exit = torch.maximum((tcap[1] - ox) * inv_dx, (tcap[4] - ox) * inv_dx)
    t_exit = torch.minimum(t_exit, torch.maximum((tcap[2] - oy) * inv_dy, (tcap[5] - oy) * inv_dy))
    t_exit = torch.minimum(t_exit, torch.maximum((tcap[3] - oz) * inv_dz, (tcap[6] - oz) * inv_dz))
    tcap_v = torch.minimum(cap, torch.clamp(t_exit, min=0.0) + 1e-3)

    best = torch.full_like(ox, float("inf"))
    idx = torch.full(ox.shape, -1, dtype=torch.int32, device=ox.device)
    maxt = torch.where(live, tcap_v, 0.0).amax(dim=1)
    running = torch.ones(nb, dtype=torch.bool, device=ox.device)
    work = {"ray_box": 0, "ray_triangle": 0}
    for i in range(nc):
        running &= tnear[:, i] < maxt
        b = running.nonzero().squeeze(1)
        if b.numel() == 0:
            break
        c = slist[b, i].long()
        work["ray_box"] += int(b.numel()) * RT_BH * RT_BW
        cb = cbox[c]  # (n, 8)
        o = (ox[b], oy[b], oz[b])
        iv = (inv_dx[b], inv_dy[b], inv_dz[b])
        lo = [(cb[:, k, None] - o[k]) * iv[k] for k in range(3)]
        hi = [(cb[:, 3 + k, None] - o[k]) * iv[k] for k in range(3)]
        tn = torch.maximum(torch.maximum(torch.minimum(lo[0], hi[0]), torch.minimum(lo[1], hi[1])),
                           torch.minimum(lo[2], hi[2]))
        tf = torch.minimum(torch.minimum(torch.maximum(lo[0], hi[0]), torch.maximum(lo[1], hi[1])),
                           torch.maximum(lo[2], hi[2]))
        enters = (live[b] & (tf >= torch.clamp(tn, min=0.0))
                  & (tn < torch.minimum(best[b], tcap_v[b])))
        hit_blocks = enters.any(dim=1)
        sel = hit_blocks.nonzero().squeeze(1)
        if sel.numel():
            bb = b[sel]
            work["ray_triangle"] += int(sel.numel()) * RT_BH * RT_BW * cell
            bt, bi = _mt_cell(tab, c[sel] * cell, cell, ox[bb], oy[bb], oz[bb],
                              dx[bb], dy[bb], dz[bb], cap, best[bb], idx[bb])
            best[bb] = bt
            idx[bb] = bi
        # refresh the bound while entries remain
        more = tnear[b, min(i + 1, nc - 1)] < _BIG
        refreshed = torch.where(live[b], torch.minimum(best[b], tcap_v[b]), 0.0).amax(dim=1)
        maxt[b] = torch.where(more, refreshed, maxt[b])

    def unblock(v):
        v = v.reshape(nby, nbx, RT_BH, RT_BW).permute(0, 2, 1, 3).reshape(nby * RT_BH, nbx * RT_BW)
        return v[: prep["height"], : prep["width"]]

    out = (unblock(best), unblock(idx))
    return out + (work,) if return_work else out


def _mt_cell(tab, base, cell, ox, oy, oz, dx, dy, dz, cap, best, idx):
    """Möller-Trumbore of each selected block's rays (n, R) against the
    `cell` triangles from slot base (n,), in slot order with a strict `<`:
    the kernel's expression order, every op rounded on its own."""
    for k in range(cell):
        r = base + k
        t = tab[r.long()]  # (n, 16)
        ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = (t[:, j, None] for j in range(9))
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        det = e1x * hx + e1y * hy + e1z * hz
        okd = det.abs() >= 1e-6
        f = torch.where(okd, 1.0 / torch.where(okd, det, 1.0), 0.0)
        svx, svy, svz = ox - ax, oy - ay, oz - az
        uu = f * (svx * hx + svy * hy + svz * hz)
        ok = okd & (uu >= 0.0) & (uu <= 1.0)
        qx = svy * e1z - svz * e1y
        qy = svz * e1x - svx * e1z
        qz = svx * e1y - svy * e1x
        vv = f * (dx * qx + dy * qy + dz * qz)
        ok &= (vv >= 0.0) & (uu + vv <= 1.0)
        tt = f * (e2x * qx + e2y * qy + e2z * qz)
        ok &= (tt > 1e-4) & (tt < cap)
        better = ok & (tt < best)
        best = torch.where(better, tt, best)
        idx = torch.where(better, r[:, None].to(torch.int32), idx)
    return best, idx

"""Closest hit of secondary-ray fields against the packed scene through a
spatial index: the ray-intersect kernel (B3) and its preparation (torch
counterpart of `rusterix_tpu/ops/rt_kernel.py`).

Rays stay in their (H, W) screen layout and are cut into RT_BH x RT_BW
blocks; triangles are grouped into cells of RT_CELL consecutive pack slots
with world AABBs. The preparation gives every block a shortlist of cells
ordered by the euclidean gap between the block's origin box and the cell
box, a lower bound on any of its rays' t into the cell, with cells beyond
the range cap or behind every ray's direction culled to the tail. Its
scene side (the triangle table, the cell boxes, the scene box) is plain
torch; its ray side (the blocks' origin and direction boxes, the keys and
their stable sort) is one kernel launch on CUDA tensors (six on the global
route) and plain torch (`rt_prepare`, the plain version) on the CPU. On
CUDA tensors the size of the scene picks one of three routes
(`prepare_route`): up to
PREPARE_MAX_CELLS cells `rt_prepare_kernel` (a rank sort in a block's
shared memory), up to CLUSTER_MAX_CELLS `rt_prepare_cluster_kernel` (a
radix sort in a thread block cluster's shared memory), above it the global
route (a radix sort of each row by many blocks through a global scratch:
`rt_prepare_large_boxes`, `rt_prepare_large_count` and four passes of
`rt_prepare_large_kernel`). The kernel
walks a block's shortlist while the next entry's bound is below the
block's bound (the max over its live rays of min(best t, per-ray
scene-exit cap)), slab-tests the cell box and, when any ray enters, runs
Möller-Trumbore on the cell's triangles.

`intersect_rays_pallas` launches the CUDA kernels (csrc/rt_kernel.cu) for
CUDA tensors and the plain version for CPU tensors;
`intersect_rays_pallas_reference` replays the kernel's walk in torch.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..device import device_scalar
from ..profiling import count, span

#: the tuning knobs' defaults: pack slots per spatial cell, and the ray-block
#: tile (rows x columns)
DEFAULT_KNOBS = (64, 8, 128)


def rt_knobs(environ) -> tuple:
    """(RT_CELL, RT_BH, RT_BW) from RUSTERIX_TPU_RT_CELL, _RT_BH and _RT_BW
    in `environ` (the JAX package's knobs, read at import; unset: the
    defaults), refused with a ValueError where the CUDA kernels cannot take
    them: the walk runs one ray a thread (at most 1,024 threads a block),
    the preparation's box loops take a block's rays in whole rounds of 256
    and 512 threads, the walk stages a cell's rows of 16 floats with 4
    floats a thread (RT_CELL * 4 threads) in two static shared buffers of
    RT_CELL * 16 floats, and the plain version pads a cell to a multiple of
    8 slots. The preparation routes' limits count cells whatever their
    size."""
    cell, bh, bw = (int(environ.get(f"RUSTERIX_TPU_RT_{k}", str(d)))
                    for k, d in zip(("CELL", "BH", "BW"), DEFAULT_KNOBS))
    rays = bh * bw
    if rays > 1024:
        raise ValueError(f"RT_BH x RT_BW = {bh} x {bw} = {rays} rays a block: the walk runs "
                         "one ray a thread, at most 1024 threads a block")
    if rays % 512:
        raise ValueError(f"RT_BH x RT_BW = {rays} rays a block: the preparation takes a block's "
                         "rays in whole rounds of 256 and 512 threads (512 or 1024 rays)")
    if cell % 8 or not 8 <= cell <= 256 or 4 * cell > rays:
        raise ValueError(f"RT_CELL = {cell}: a multiple of 8 from 8 to 256, with RT_CELL * 4 "
                         f"<= {rays} (the threads that stage a cell's rows in the walk)")
    return cell, bh, bw


#: pack slots per spatial cell, and the ray-block tile (rows x columns)
RT_CELL, RT_BH, RT_BW = rt_knobs(os.environ)
#: origins >= this are parked dead rays (the reflection pass parks at 1e8)
_PARKED = 1e7
_BIG = 3e37

#: cells up to which rt_prepare_kernel takes a scene on CUDA tensors: its
#: rank sort is O(cells^2) a block, and above ~400 cells the cluster route
#: is faster (the sweep of chip_smoke.py, PERF.md); the kernel itself holds
#: up to RT_MAX_CELLS (28,672) keys of 8 bytes in a block's shared memory
PREPARE_MAX_CELLS = 384
#: cells a block of rt_prepare_cluster_kernel should hold: the route takes
#: the smallest cluster (1, 2, 4 or 8 blocks) whose blocks hold at most this
#: many cells, and 8 blocks of up to CLUSTER_SPAN_MAX above 8 of these
CLUSTER_SPAN = 4096
#: cells a block of rt_prepare_cluster_kernel holds at most (RT_SPAN_MAX in
#: csrc/rt_kernel.cu: 16 bytes a cell)
CLUSTER_SPAN_MAX = 13312
#: the static shared memory of a block of rt_prepare_cluster_kernel (its
#: ClusterShared)
CLUSTER_SMEM_STATIC = 19296
#: cells up to which rt_prepare_cluster_kernel takes a scene; a larger one
#: takes the global route, whose rows sort through a global scratch. The
#: cluster kernel holds up to 8 * CLUSTER_SPAN_MAX (106,496) cells, but above
#: 28,672 the global route is faster on 1080p rays (chip_smoke.py's sweep,
#: PERF.md)
CLUSTER_MAX_CELLS = 28672
#: the global route: pairs a block of a pass sorts (LG_TILE in
#: csrc/rt_kernel.cu), a row's counters (LG_ROW_WORDS: the digit counts of
#: each byte, the AND and OR of the keys, a ticket a pass) and look-back
#: words a tile (one a digit), u32 each, and the static shared memory of a
#: block of a pass (its LargeShared)
GLOBAL_TILE = 4096
GLOBAL_ROW_WORDS = 4 * 256 + 2 + 4
GLOBAL_LOOK_WORDS = 256
GLOBAL_SMEM_STATIC = 18560


def prepare_route(ncells: int, nblocks: int = 1) -> dict:
    """The preparation route that a scene of `ncells` cells takes on CUDA
    tensors, for `nblocks` ray blocks, by the module's limits as they stand:
    "route" ("rank", "cluster" or "global"), "cluster" (blocks a ray block),
    "span" (cells a block holds), "smem" (shared memory a block asks for,
    static and dynamic, in bytes) and "scratch" (bytes of global scratch the
    wrapper allocates: on the global route 8 bytes a (ray block, cell) for
    the pairs between passes, and a row's counters and look-back words;
    "tiles" gives the tiles of a row)."""
    if ncells <= PREPARE_MAX_CELLS:
        return {"route": "rank", "cluster": 1, "span": ncells, "smem": 8 * ncells + 432,
                "scratch": 0}
    if ncells <= min(CLUSTER_MAX_CELLS, 8 * CLUSTER_SPAN_MAX):
        cl = 1
        while cl < 8 and -(-ncells // cl) > CLUSTER_SPAN:
            cl *= 2
        span = -(-ncells // cl)
        return {"route": "cluster", "cluster": cl, "span": span,
                "smem": 16 * span + CLUSTER_SMEM_STATIC, "scratch": 0}
    tiles = -(-ncells // GLOBAL_TILE)
    return {"route": "global", "cluster": 1, "span": min(ncells, GLOBAL_TILE), "tiles": tiles,
            "smem": 8 * GLOBAL_TILE + GLOBAL_SMEM_STATIC,
            "scratch": 8 * ncells * nblocks
            + 4 * nblocks * (GLOBAL_ROW_WORDS + GLOBAL_LOOK_WORDS * tiles)}


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


def _sizes(tcount: int, height: int, width: int) -> dict:
    cell = -(-RT_CELL // 8) * 8
    return {
        "cell": cell, "ncells": -(-tcount // cell),
        "nby": -(-height // RT_BH), "nbx": -(-width // RT_BW),
        "height": height, "width": width,
    }


def scene_tables(pos, valid, t_cap, ncells: int, cell: int) -> dict:
    """The part of the preparation that depends on the pack and not on the
    rays: tab (Tp, 16) f32, per slot [A | B - A | C - A], zero for dead
    slots; cbox (ncells, 8) f32, cell AABBs [x0 y0 z0 x1 y1 z1 0 0]; tcap
    (8,) f32, [t_cap | scene AABB of the live cells | 0]; and the per-axis
    cell bounds (c0, c1) and cell_alive the keys are made from."""
    dev = pos.device
    tcount = pos.shape[0]
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
    zeros = torch.zeros_like(cx0)
    cbox = torch.stack([cx0, cy0, cz0, cx1, cy1, cz1, zeros, zeros], dim=1)
    cell_alive = cx0 <= cx1
    t_cap = (torch.as_tensor(t_cap, dtype=torch.float32, device=dev) if torch.is_tensor(t_cap)
             else device_scalar(t_cap, torch.float32, dev))

    def live_min(v):
        return torch.where(cell_alive, v, _BIG).amin()

    def live_max(v):
        return torch.where(cell_alive, v, -_BIG).amax()

    tcap = torch.stack([
        t_cap, live_min(cx0), live_min(cy0), live_min(cz0),
        live_max(cx1), live_max(cy1), live_max(cz1), torch.zeros_like(t_cap),
    ])
    return {
        "tab": tab.contiguous(), "cbox": cbox.contiguous(), "tcap": tcap.contiguous(),
        "c0": (cx0, cy0, cz0), "c1": (cx1, cy1, cz1), "cell_alive": cell_alive,
    }


def rt_prepare(pos, valid, ox, oy, oz, dx, dy, dz, t_cap, height: int, width: int) -> dict:
    """The walk's inputs, computed in plain torch on the rays' device (the
    plain version of the preparation):

    tab, cbox, tcap: see scene_tables; boxes (nblocks, 12) f32: each
    block's origin box and direction box over its live rays, [o min xyz |
    o max xyz | d min xyz | d max xyz], NaN values skipped; tnear (nblocks,
    ncells) f32 and slist (nblocks, ncells) i32: each block's shortlist,
    keys ascending (culled cells at _BIG), ties in cell order; rays (6, hp,
    wp) f32: ox oy oz dx dy dz padded to whole blocks with parked rays; and
    the sizes."""
    sizes = _sizes(pos.shape[0], height, width)
    ncells, nby, nbx = sizes["ncells"], sizes["nby"], sizes["nbx"]
    hp, wp = nby * RT_BH, nbx * RT_BW
    scene = scene_tables(pos, valid, t_cap, ncells, sizes["cell"])
    c0s, c1s, cell_alive = scene["c0"], scene["c1"], scene["cell_alive"]

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

    key = torch.where(cell_alive[None, None, :] & reach & (dist < scene["tcap"][0]), dist, _BIG)
    # stable: keys tie at gap 0 and at _BIG, and the walk must visit tied
    # cells in cell order as the TPU kernel's stable sort does
    tnear, slist = torch.sort(key.reshape(nby * nbx, ncells), dim=1, stable=True)
    boxes = torch.stack(ob0 + ob1 + db0 + db1, dim=-1).reshape(nby * nbx, 12)
    return {
        "tab": scene["tab"], "cbox": scene["cbox"], "tcap": scene["tcap"],
        "boxes": boxes.contiguous(),
        "tnear": tnear.contiguous(), "slist": slist.to(torch.int32).contiguous(),
        "rays": rays.contiguous(), **sizes,
    }


def rt_prepare_cuda(pos, valid, ox, oy, oz, dx, dy, dz, t_cap, height: int, width: int) -> dict:
    """rt_prepare for CUDA tensors: the scene tables in torch, the blocks'
    boxes, keys and stable sort in one kernel launch (csrc/rt_kernel.cu),
    which reads the six ray fields as they are. -> tab, cbox, tcap, boxes,
    tnear, slist as rt_prepare gives them (equal, bit for bit), and the
    sizes; no padded copy of the rays."""
    sizes = _sizes(pos.shape[0], height, width)
    scene = scene_tables(pos, valid, t_cap, sizes["ncells"], sizes["cell"])
    boxes, tnear, slist = prepare_launch(scene, _ray_fields(ox, oy, oz, dx, dy, dz), t_cap,
                                         sizes)()
    return {
        "tab": scene["tab"], "cbox": scene["cbox"], "tcap": scene["tcap"],
        "boxes": boxes, "tnear": tnear, "slist": slist, **sizes,
    }


def prepare_launch(scene: dict, fields: tuple, t_cap, sizes: dict):
    """The ray side of rt_prepare_cuda on prepared inputs (scene_tables'
    output, the six contiguous ray fields, the sizes) -> a function of no
    arguments that launches the preparation kernel of `prepare_route`'s
    route and returns (boxes, tnear, slist), the same three tensors at every
    call: rt_prepare_kernel, rt_prepare_cluster_kernel (no scratch: the row
    stays in a cluster's shared memory) or the global route's six launches
    (its scratch allocated here, `prepare_route`'s "scratch" bytes). Timing
    the returned function times the kernels alone."""
    from .. import _cuda

    ncells, nby, nbx = sizes["ncells"], sizes["nby"], sizes["nbx"]
    height, width = sizes["height"], sizes["width"]
    dev = fields[0].device
    boxes = torch.empty((nby * nbx, 12), dtype=torch.float32, device=dev)
    tnear = torch.empty((nby * nbx, ncells), dtype=torch.float32, device=dev)
    slist = torch.empty((nby * nbx, ncells), dtype=torch.int32, device=dev)
    route = prepare_route(ncells, nby * nbx)
    ptr = ctypes.c_void_p
    head = (*(ptr(f.data_ptr()) for f in fields), ptr(scene["cbox"].data_ptr()),
            ctypes.c_float(float(t_cap)), ptr(boxes.data_ptr()), ptr(tnear.data_ptr()),
            ptr(slist.data_ptr()))
    scratch = None
    if route["route"] == "rank":
        entry, args = "rx_rt_prepare", (*head, ncells)
    elif route["route"] == "cluster":
        entry, args = "rx_rt_prepare_cluster", (*head, ncells, route["cluster"])
    else:
        scratch = torch.empty(route["scratch"] // 4, dtype=torch.int32, device=dev)
        entry, args = "rx_rt_prepare_large", (*head, ptr(scratch.data_ptr()),
                                              ctypes.c_longlong(route["scratch"]), ncells)
    def launch():
        err = _cuda.on_device(dev, entry, *args, nby, nbx, height, width)
        if err != 0:
            raise RuntimeError(f"ray-intersect preparation kernel ({route['route']} route) "
                               f"launch failed: CUDA error {err} ({_cuda.error_string(err)})")
        # a call of the route's kernels: b3.prepare.rank, .cluster or .global
        count("b3.prepare." + route["route"])
        return boxes, tnear, slist

    launch.keep = (scene["cbox"], fields, scratch)  # alive while the closure is
    return launch


def _ray_fields(ox, oy, oz, dx, dy, dz) -> tuple:
    """The six (H, W) ray fields as contiguous f32 tensors, for the kernels."""
    return tuple(f.float().contiguous() for f in (ox, oy, oz, dx, dy, dz))


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

    CUDA tensors launch the kernels of csrc/rt_kernel.cu, the preparation
    (by `prepare_route`) and then the walk. CPU tensors run
    intersect_rays_pallas_reference."""
    _check_inputs(pos, valid, (ox, oy, oz, dx, dy, dz), height, width)
    if ox.device.type != "cuda":
        return intersect_rays_pallas_reference(
            pos, valid, ox, oy, oz, dx, dy, dz, t_cap, height, width
        )
    with span("b3.prepare"):
        prep = rt_prepare_cuda(pos, valid, ox, oy, oz, dx, dy, dz, t_cap, height, width)
    with span("b3.walk"):
        return _launch(prep, _ray_fields(ox, oy, oz, dx, dy, dz))


def _launch(prep, fields):
    """The walk kernel on a preparation (rt_prepare's or rt_prepare_cuda's)
    and the six contiguous (H, W) ray fields."""
    from .. import _cuda

    if prep["cell"] != RT_CELL:
        raise ValueError(f"the kernel stages cells of {RT_CELL} triangles, not {prep['cell']}")
    dev = fields[0].device
    height, width = prep["height"], prep["width"]
    t = torch.empty((height, width), dtype=torch.float32, device=dev)
    idx = torch.empty((height, width), dtype=torch.int32, device=dev)
    ptr = ctypes.c_void_p
    err = _cuda.on_device(
        dev, "rx_rt_intersect", ptr(prep["tab"].data_ptr()), ptr(prep["cbox"].data_ptr()),
        ptr(prep["tnear"].data_ptr()), ptr(prep["slist"].data_ptr()),
        ptr(prep["tcap"].data_ptr()), *(ptr(f.data_ptr()) for f in fields),
        ptr(t.data_ptr()), ptr(idx.data_ptr()),
        prep["ncells"], prep["nby"], prep["nbx"], height, width,
    )
    if err != 0:
        raise RuntimeError(f"ray-intersect kernel launch failed: CUDA error {err} "
                           f"({_cuda.error_string(err)})")
    count("b3.walk_launch")
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
    with span("b3.prepare"):
        prep = rt_prepare(pos, valid, ox, oy, oz, dx, dy, dz, t_cap, height, width)
    with span("b3.walk"):
        return _walk(prep, return_work)


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


#: triangles of a cell the plain walk tests at once (the result does not
#: depend on it: within a group the first of the smallest t wins, as the
#: kernel's strict `<` in slot order gives)
MT_GROUP = 16


def _mt_cell(tab, base, cell, ox, oy, oz, dx, dy, dz, cap, best, idx):
    """Möller-Trumbore of each selected block's rays (n, R) against the
    `cell` triangles from slot base (n,), in slot order with a strict `<`:
    the kernel's expression order, every op rounded on its own. MT_GROUP
    triangles at a time: the first of a group's smallest t replaces the
    running best only if it is strictly smaller, which is what testing them
    one by one with a strict `<` gives."""
    ox, oy, oz, dx, dy, dz = (v[:, None, :] for v in (ox, oy, oz, dx, dy, dz))
    for k0 in range(0, cell, MT_GROUP):
        r = base[:, None] + torch.arange(k0, min(k0 + MT_GROUP, cell), device=base.device)
        t = tab[r.long()]  # (n, G, 16)
        ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = (t[..., j, None] for j in range(9))
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
        g_best, g_k = torch.where(ok, tt, float("inf")).min(dim=1)  # first of the smallest
        better = g_best < best
        best = torch.where(better, g_best, best)
        idx = torch.where(better, torch.gather(r, 1, g_k).to(torch.int32), idx)
    return best, idx

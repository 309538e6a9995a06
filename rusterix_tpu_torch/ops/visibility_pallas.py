"""The tile visibility kernel (B2) and its host helpers (torch counterpart
of `rusterix_tpu/ops/visibility_pallas.py`).

`visibility_pass_pallas` is the visibility-only pass the reflection
G-buffer needs before shading: per 64x128 tile it walks the super-chunks
and chunks whose merged integer bbox meets the tile and keeps the closest
covering candidate (max 1/z, strict `>`, from 1/z = 1.0). CUDA tensors
launch the hand-written kernel `csrc/visibility.cu`; CPU tensors run the
plain version `visibility_pass_pallas_reference`. The tile and group
sizes, the group boxes and the Morton permutation are shared with the
megakernel's preparation.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import device_table
from ..profiling import count
from .visibility import DEAD_PLANE, visibility_pass

TILE_H = 64
TILE_W = 128
CHUNK = 4
SUPER = 32  # chunks per super
GROUP = CHUNK * SUPER  # candidate slots per super-chunk
EMPTY_BOX = (1e9, 1e9, -1e9, -1e9)


def _group_boxes(bbox, group: int):
    """Merged integer bboxes over groups of `group` rows of bbox (N, 4)
    -> (N // group, 4) i32 (floor of the mins, ceil of the maxes)."""
    bb = bbox.reshape(-1, group, 4)
    lo = torch.floor(bb[:, :, :2].amin(dim=1))
    hi = torch.ceil(bb[:, :, 2:].amax(dim=1))
    return torch.clamp(torch.cat([lo, hi], dim=1), -2e9, 2e9).to(torch.int32)


def _spread(v):
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_perm(bbox, alive, width: int, height: int):
    """Permutation sorting candidates along the Morton (Z-order) curve of
    their screen-bbox centers: dead slots to the end (all-ones code), ties
    break by slot index. One sort of packed code|slot keys, bit for bit the
    JAX package's order (it decides z-tie winners). The u32 arithmetic is
    carried in int64; the truncation matches `(cx*1023).astype(uint32)`."""
    cx = torch.clamp((bbox[:, 0] + bbox[:, 2]) * 0.5 / width, 0.0, 1.0)
    cy = torch.clamp((bbox[:, 1] + bbox[:, 3]) * 0.5 / height, 0.0, 1.0)
    xi = (cx * 1023).to(torch.int64)
    yi = (cy * 1023).to(torch.int64)
    code = (_spread(xi) << 1) | _spread(yi)
    t2 = bbox.shape[0]
    slot_bits = max((t2 - 1).bit_length(), 1)
    code_bits = 32 - slot_bits
    if code_bits < 20:
        # huge scenes: coarsen the curve so code|slot still fits 32 bits
        code = code >> (20 - code_bits)
    code = torch.where(alive > 0.5, code, (1 << code_bits) - 1)
    slots = torch.arange(t2, dtype=torch.int64, device=bbox.device)
    key = (code << slot_bits) | slots
    return (torch.sort(key).values & ((1 << slot_bits) - 1)).to(torch.int32)


def morton_sort(vis_planes, bbox, alive, slot_id, width: int, height: int):
    """Candidates reordered along the Morton curve of their bbox centres
    (morton_perm: dead slots last, ties by slot index) -> (vis_planes,
    bbox, alive, slot_id) permuted, through one row gather of the combined
    columns, as the JAX package's morton_sort (the split path's order for
    B2; B2 keeps the first candidate of a bit-equal 1/z tie, so the order
    decides such winners). slot_id (T2,) i32 rides the gather as f32, as
    in the JAX package (exact below 2^24 slots)."""
    perm = morton_perm(bbox, alive, width, height).long()
    combined = torch.cat([vis_planes, bbox, alive[:, None], slot_id.float()[:, None]],
                         dim=1)[perm]
    nv = vis_planes.shape[1]
    return (combined[:, :nv], combined[:, nv:nv + 4], combined[:, nv + 4],
            combined[:, nv + 5].to(slot_id.dtype))


def prepare_visibility(vis_planes, alive, bbox):
    """The tile kernels' candidate preparation: dead candidates take
    impossible planes and empty boxes (so they never cover a pixel and
    never widen a group box) -> (planes (T2, 12) f32, super boxes
    (T2 // GROUP, 4) i32, chunk boxes (T2 // CHUNK, 4) i32). T2 must be a
    multiple of GROUP."""
    if vis_planes.shape[0] % GROUP:
        raise ValueError(
            f"candidates must be padded to {GROUP}-row groups (got {vis_planes.shape[0]})"
        )
    live = (alive > 0.5)[:, None]
    dev = vis_planes.device
    planes = torch.where(live, vis_planes, device_table(DEAD_PLANE, torch.float32, dev))
    bbox = torch.where(live, bbox, device_table(EMPTY_BOX, torch.float32, dev))
    return (
        planes.float().contiguous(),
        _group_boxes(bbox, GROUP).contiguous(),
        _group_boxes(bbox, CHUNK).contiguous(),
    )


def tile_box_hits(boxes, n_th: int, n_tw: int, y0: int = 0):
    """(n, 4) i32 merged boxes -> (n_th, n_tw, n) bool: which boxes meet
    which 64x128 tile of an n_th x n_tw grid whose first row is the
    frame's row y0 (the kernels' gate test)."""
    dev = boxes.device
    tx0 = torch.arange(n_tw, device=dev, dtype=torch.int32) * TILE_W
    ty0 = torch.arange(n_th, device=dev, dtype=torch.int32) * TILE_H + int(y0)
    hx = (boxes[None, :, 0] < tx0[:, None] + TILE_W) & (boxes[None, :, 2] > tx0[:, None])
    hy = (boxes[None, :, 1] < ty0[:, None] + TILE_H) & (boxes[None, :, 3] > ty0[:, None])
    return hy[:, None, :] & hx[None, :, :]


def scan_work(vis_planes, alive, bbox, width: int, height: int, y0: int = 0) -> int:
    """Pixel-candidate tests the tile kernel performs on these inputs: every
    (tile, slot) pair whose super and chunk boxes meet the tile, times the
    tile's TILE_H x TILE_W pixels (padding included, as the kernel scans it).
    Each test evaluates three edge planes and the 1/z plane."""
    _planes, sboxes, cboxes = prepare_visibility(*_pad_to_groups(vis_planes, alive.float(), bbox))
    n_th, n_tw = -(-height // TILE_H), -(-width // TILE_W)
    gate = (tile_box_hits(sboxes, n_th, n_tw, y0).repeat_interleave(GROUP, dim=2)
            & tile_box_hits(cboxes, n_th, n_tw, y0).repeat_interleave(CHUNK, dim=2))
    return int(gate.sum()) * TILE_H * TILE_W


def _pad_to_groups(vis_planes, alive, bbox):
    pad = (-vis_planes.shape[0]) % GROUP
    if pad:
        vis_planes = torch.nn.functional.pad(vis_planes, (0, 0, 0, pad))
        alive = torch.nn.functional.pad(alive, (0, pad))
        bbox = torch.nn.functional.pad(bbox, (0, 0, 0, pad))
    return vis_planes, alive, bbox


def visibility_pass_pallas(vis_planes, alive, bbox, width: int, height: int, y0: int = 0):
    """vis_planes (T2, 12), alive (T2,), bbox (T2, 4) f32 -> (z (H, W) f32,
    idx (H, W) i32, hit (H, W) bool): per pixel the closest covering
    candidate, z = 1 / its 1/z (1.0 and idx -1 where none covers). `y0`:
    the outputs are rows [y0, y0 + H) of the frame (a slab of a row-sharded
    frame; the planes and boxes stay in the frame's coordinates).

    CUDA tensors launch the tile kernel (csrc/visibility.cu); CPU tensors
    run visibility_pass_pallas_reference."""
    _check(vis_planes, alive, bbox)
    if vis_planes.device.type != "cuda":
        return visibility_pass_pallas_reference(vis_planes, alive, bbox, width, height, y0)
    z, idx = prepare_launch(vis_planes, alive, bbox, width, height, y0)()
    return z, idx, idx >= 0


def _check(vis_planes, alive, bbox):
    t2 = vis_planes.shape[0]
    if vis_planes.shape != (t2, 12) or alive.shape != (t2,) or bbox.shape != (t2, 4):
        raise ValueError(f"visibility_pass_pallas takes (T2, 12), (T2,), (T2, 4), got "
                         f"{tuple(vis_planes.shape)}, {tuple(alive.shape)}, {tuple(bbox.shape)}")
    if alive.device != vis_planes.device or bbox.device != vis_planes.device:
        raise ValueError("visibility_pass_pallas: inputs on different devices")


def prepare_launch(vis_planes, alive, bbox, width: int, height: int, y0: int = 0):
    """Prepare visibility_pass_pallas's inputs for the CUDA kernel (the
    padding, the dead candidates' planes, the group boxes) -> a function of
    no arguments that launches the kernel on them and returns (z, idx), the
    same two tensors at every call. visibility_pass_pallas is one such
    call; timing the returned function alone times the kernel without the
    preparation."""
    from .. import _cuda

    _check(vis_planes, alive, bbox)
    planes, sboxes, cboxes = prepare_visibility(*_pad_to_groups(vis_planes, alive.float(), bbox))
    dev = planes.device
    z = torch.empty((height, width), dtype=torch.float32, device=dev)
    idx = torch.empty((height, width), dtype=torch.int32, device=dev)
    ptr = ctypes.c_void_p
    call_args = (ptr(planes.data_ptr()), ptr(sboxes.data_ptr()), ptr(cboxes.data_ptr()),
                 ptr(z.data_ptr()), ptr(idx.data_ptr()), sboxes.shape[0], height, width, int(y0))
    keep = (planes, sboxes, cboxes)  # alive while the closure is

    def launch():
        err = _cuda.on_device(dev, "rx_visibility", *call_args)
        if err != 0:
            raise RuntimeError(
                f"visibility kernel launch failed: CUDA error {err} ({_cuda.error_string(err)})")
        count("b2.launch")
        return z, idx

    launch.keep = keep
    return launch


def visibility_pass_pallas_reference(vis_planes, alive, bbox, width: int, height: int,
                                     y0: int = 0):
    """Plain torch version of visibility_pass_pallas: the same candidates
    (padded, dead slots on impossible planes) scanned in slot order with a
    strict `>` from 1/z = 1.0. The kernel's group-box gating skips only
    candidates whose box misses the tile, which cannot cover its pixels,
    so the result is the kernel's."""
    planes, _s, _c = prepare_visibility(*_pad_to_groups(vis_planes, alive.float(), bbox))
    ones = torch.ones(planes.shape[0], device=planes.device)
    return visibility_pass(planes, ones, width, height, y0=y0)

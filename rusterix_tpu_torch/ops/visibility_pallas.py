"""Host helpers of the tile visibility kernel (torch counterpart of
`rusterix_tpu/ops/visibility_pallas.py`).

Only the constants and the helpers the megakernel's preparation needs are
here: the tile and group sizes, the merged group boxes and the Morton
permutation. The visibility-only kernel itself (the JAX package's
`visibility_pass_pallas`) is not on the opaque frame's path and is not
ported yet.
"""

from __future__ import annotations

import torch

TILE_H = 64
TILE_W = 128
CHUNK = 4
SUPER = 32  # chunks per super


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

"""Visibility (depth) pass — plain torch formulation (counterpart of
`rusterix_tpu/ops/visibility.py`).

For every pixel the closest covering candidate wins: max 1/z with a strict
`>`, so the first candidate in scan order keeps a tie. Coverage is three
edge half-plane tests; every plane evaluates as `(a*xs + c) + b*ys`, the
expression order all the kernels share, so edge decisions agree bit for
bit across paths.

`scan_candidates` is the one step both this pass and the megakernel's
plain version (`megakernel.mega_render_reference`) run: a block of
candidates against a block of pixels at once, resolved exactly as the
sequential strict-`>` scan would resolve it.

`plane_fma=True` evaluates every plane as `fma(a, xs, c) + b*ys`, the
rounding XLA's CPU build gives the JAX package's XLA visibility pass (it
fuses the row term, not the broadcast add). The shadow bake takes it: the
JAX bake runs that XLA pass, and its depth maps are then equal texel for
texel. The kernels' plain versions keep the unfused order the kernels use.
"""

from __future__ import annotations

import torch

from .setup_pass import _fma

DEAD_PLANE = (0.0, 0.0, -1.0) * 3 + (0.0, 0.0, 1.0)


def scan_candidates(planes, xs, ys, best, idx, base: int, gate=None,
                    z_ceil=None, plane_fma: bool = False):
    """Fold K candidates into the running per-pixel winner.

    planes (K, 12); xs and ys broadcast to the pixel block with a trailing
    candidate axis of size 1 (e.g. xs (..., W, 1), ys (..., H, 1, 1));
    best (pixels) f32 in the max-1/z domain; idx (pixels) i32; base: slot of
    planes[0]; gate (pixels..., K) bool or None restricts which candidates
    each pixel may take; z_ceil (pixels) keeps only candidates strictly
    farther than the bound (invz < z_ceil); plane_fma: see the module
    docstring.

    Equivalent to visiting the K candidates in order with
    `if cov and invz > best: best, idx = invz, slot`: the winner is the
    largest covering invz above `best`, the lowest slot among equals."""
    p = [planes[:, i] for i in range(12)]

    def ev(a, b, c):
        row = _fma(p[a], xs, p[c]) if plane_fma else p[a] * xs + p[c]
        return row + p[b] * ys

    e0, e1, e2 = ev(0, 1, 2), ev(3, 4, 5), ev(6, 7, 8)
    invz = ev(9, 10, 11)
    # min-chain == all three >= 0; NaN edges and NaN invz never win
    ok = (torch.minimum(torch.minimum(e0, e1), e2) >= 0) & (invz == invz)
    if gate is not None:
        ok = ok & gate
    if z_ceil is not None:
        ok = ok & (invz < z_ceil[..., None])
    cand = torch.where(ok, invz, float("-inf"))
    top = cand.amax(dim=-1)
    first = torch.argmax((cand == top[..., None]).to(torch.uint8), dim=-1)
    better = top > best
    return (
        torch.where(better, top, best),
        torch.where(better, first.to(torch.int32) + base, idx),
    )


def visibility_pass(vis_planes, alive, width: int, height: int, chunk: int = 8,
                    y0=0, z_ceil=None, return_invz: bool = False,
                    plane_fma: bool = False):
    """vis_planes (T2, 12), alive (T2,) -> (z (H,W), idx (H,W) i32, hit).

    z starts at 1.0 (reference z_buffer init); idx = -1 where no triangle
    won. `y0` offsets the pixel rows. `z_ceil` (H,W) in 1/z space keeps only
    candidates strictly farther than the bound (depth peeling); with
    `return_invz` the raw winning 1/z comes back as a fourth output;
    `plane_fma`: see the module docstring."""
    dev = vis_planes.device
    dead = torch.tensor(DEAD_PLANE, dtype=torch.float32, device=dev)
    planes = torch.where((alive > 0.5)[:, None], vis_planes, dead)
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[:, None]
    ys = (
        torch.arange(height, dtype=torch.float32, device=dev) + float(y0) + 0.5
    )[:, None, None]
    best = torch.ones((height, width), dtype=torch.float32, device=dev)
    idx = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    for base in range(0, planes.shape[0], chunk):
        best, idx = scan_candidates(
            planes[base : base + chunk], xs, ys, best, idx, base, z_ceil=z_ceil,
            plane_fma=plane_fma,
        )
    hit = idx >= 0
    if return_invz:
        return 1.0 / best, idx, hit, best
    return 1.0 / best, idx, hit

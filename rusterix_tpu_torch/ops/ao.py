"""Screen-space ambient occlusion (torch counterpart of
`rusterix_tpu/ops/ao.py`; the JAX package computes this pass in XLA, so
plain torch is its port).

A fixed spiral of pixel-offset taps reads the visibility pre-pass's view
depth around each pixel; a tap occludes when its surface is closer to the
camera than the pixel's own tangent plane by more than a bias and its 3D
distance is inside `ao_radius`, weighted by the reference's `1 - t/radius`
falloff (SceneVM `compute_ao`, 3d_shader.wgsl:519-560). The (H, W) factor
multiplies only the ambient terms (the megakernel's `ao_img` input, and the
sky light).

The arithmetic is written in the rounding XLA's CPU build gives the JAX
package's expressions, because the tap decisions (`dc > bias`,
`dist < radius`, the renormalisation's reach test) ride on the last bit:
the plane prediction `dx*gx + dy*gy` and `lam*lam + delta*delta` are fused
products there (`_fma`), the square root is correctly rounded, and every
scalar is an f32 device value (a division by a Python number would become
a multiply by its reciprocal on CUDA).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .shade import _fma

#: height above the tangent plane (as a fraction of ao_radius) before a tap
#: counts as an occluder
_BIAS = 0.05

_GOLDEN = math.pi * (3.0 - math.sqrt(5.0))


def tap_offsets(samples: int, max_px: int = 24) -> tuple:
    """Deterministic spiral of `samples` (dx, dy) pixel offsets, radii
    sqrt-spaced from 1.5 (contact occlusion) to `max_px`."""
    samples = max(1, min(int(samples), 32))
    out = []
    for i in range(samples):
        ang = _GOLDEN * i
        f = math.sqrt(i / (samples - 1)) if samples > 1 else 0.0
        r = 1.5 + (max_px - 1.5) * f
        out.append((int(round(r * math.cos(ang))), int(round(r * math.sin(ang)))))
    return tuple(out)


def _shift_edge(img, dy: int, dx: int):
    """out[y, x] = img[clamp(y - dy), clamp(x - dx)]: a shift whose edge
    rows and columns repeat (no wraparound)."""
    h, w = img.shape
    dev = img.device
    rows = torch.clamp(torch.arange(h, device=dev) - dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=dev) - dx, 0, w - 1)
    return img.index_select(0, rows).index_select(1, cols)


def _scalar(x, device):
    """An f32 scalar as a 0-d tensor on `device`."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.tensor(float(np.float32(x)), dtype=torch.float32, device=device)


def ssao_pass(z_ndc, hit, depth_a, depth_b, radius, px_scale, taps: tuple):
    """(H, W) ambient-occlusion factor in [0, 1].

    z_ndc, hit: the visibility pre-pass's depth and coverage. depth_a,
    depth_b: the projection's depth constants (view depth d = depth_b /
    (z_ndc + depth_a)). radius: ao_radius in world units. px_scale: world
    units per pixel per unit depth, 2 / (proj[1,1] * height). The four
    scalars are f32 values (numbers or 0-d tensors). taps: tap_offsets().

    Misses never occlude and read 1. The depth gradients are the
    min-magnitude one-sided differences per axis (clamped to +-radius, 0
    where not finite); a tap's plane-relative height decides occluder-ness
    and its distance ~sqrt(lam^2 + delta^2) the falloff; the sum is
    renormalised by the taps whose lateral reach at the pixel's depth is
    inside the radius."""
    dev = z_ndc.device
    depth_a, depth_b = _scalar(depth_a, dev), _scalar(depth_b, dev)
    radius, px_scale = _scalar(radius, dev), _scalar(px_scale, dev)
    d = depth_b / (z_ndc + depth_a)
    d = torch.where(hit, d, torch.inf)

    def minmag(a, b):
        g = torch.where(a.abs() < b.abs(), a, b)
        g = torch.where(torch.isfinite(g), g, 0.0)
        return torch.minimum(torch.maximum(g, -radius), radius)

    gx = minmag(_shift_edge(d, 0, -1) - d, d - _shift_edge(d, 0, 1))
    gy = minmag(_shift_edge(d, -1, 0) - d, d - _shift_edge(d, 1, 0))

    bias = _scalar(_BIAS, dev) * radius
    r_fall = torch.maximum(radius, _scalar(1e-6, dev))
    occ = torch.zeros_like(d)
    n_eff = torch.zeros_like(d)
    for dx, dy in taps:
        reach = _scalar(math.hypot(dx, dy), dev) * px_scale
        d_tap = _shift_edge(d, dy, dx)
        delta = d - d_tap
        lam = reach * torch.minimum(d, d_tap)
        dc = delta - _fma(dx, gx, dy * gy)
        # the square root in f64, rounded once: correctly rounded on the
        # card and on the CPU (torch's f32 CPU sqrt is not, in the last bit)
        dist = torch.sqrt(_fma(delta, delta, lam * lam).double()).float()
        near = (dc > bias) & (dist < radius)
        fall = torch.clamp(1.0 - dist / r_fall, min=0.0)
        occ = occ + torch.where(near, fall, 0.0)
        n_eff = n_eff + (reach * d < radius).float()

    ao = 1.0 - occ / torch.clamp(n_eff, min=1.0)
    return torch.where(hit, torch.clamp(ao, 0.0, 1.0), 1.0)

"""The comparison that decides `correct`: the port's frames against the
plain reference's (render.py).

Three numbers, each over the frames compared:

- `coverage_share`: the largest share, over the frames, of pixels whose
  alpha (255 where the frame shows a surface, the background's 0 where
  not) is that of no alternative the reference allows there. Alpha is
  exact: no reflection, tie or texel touches it.
- `dark_share`: the largest share, over the frames, of pixels that no
  alternative of the reference explains: some channel of the port's pixel
  lies more than DARK_TOL below that channel of every alternative's floor
  (coplanar ties, edge coverage, texel rounding; the floor is the frame
  without reflections, or its fast-sRGB round trip where that is darker).
  A reflection only adds light, so this holds whatever the port's
  reflection sample was. It catches wrong or missing geometry, texels,
  lighting that is too dark, a stale frame.
- `refl_gap`: |E_port - E_ref| / E_ref, where E is the mean linear
  radiance a frame adds over its frame without reflections, summed over
  the frames: for the port, over the reference's alternative that
  explains each pixel (the brightest whose floor the pixel does not fall
  below); for the reference, its own frame over its own main alternative.
  The two reflection samples of a pixel are independent draws of one
  distribution (each side seeds its hash with its own world position), so
  their means agree over a frame. It catches a reflection pass left out,
  doubled or mis-weighted, and lighting that is too bright or too dark.
"""

from __future__ import annotations

import torch

from .render import srgb_to_linear

DARK_TOL = 2.0


def frame_numbers(port_u8, ref: dict) -> dict:
    """One frame's comparison -> {"coverage", "dark": shares, "e_port",
    "e_ref": means}. port_u8: (H, W, 4) uint8 (numpy or tensor); ref:
    render()'s output. The alternatives are visited one at a time."""
    opts, floors = ref["options"], ref["floors"]
    p = torch.as_tensor(port_u8, device=opts.device).float()
    dark = torch.ones(p.shape[:2], dtype=torch.bool, device=p.device)
    uncovered = torch.ones_like(dark)
    best_score = torch.full(p.shape[:2], -float("inf"), device=p.device)
    chosen = torch.zeros_like(p)
    for k in range(opts.shape[0]):
        opt, low = opts[k].float(), floors[k].float()
        below = (p < low - DARK_TOL).any(-1)
        dark &= below
        uncovered &= opt[..., 3] != p[..., 3]
        # the brightest alternative the pixel does not fall below; where
        # every one is, the least violated
        score = torch.where(below, -1e9 - torch.clamp(low - p, min=0.0).sum(-1),
                            opt[..., :3].sum(-1))
        better = score > best_score
        best_score = torch.where(better, score, best_score)
        chosen = torch.where(better[..., None], opt, chosen)

    def added(frame, base):
        return (srgb_to_linear(frame[..., :3] / 255.0)
                - srgb_to_linear(base[..., :3] / 255.0)).sum(-1).mean()

    return {"coverage": float(uncovered.float().mean()), "dark": float(dark.float().mean()),
            "e_port": float(added(p, chosen)),
            "e_ref": float(added(ref["frame"], ref["direct"]))}


def numbers(per_frame: list) -> dict:
    """The run's compared numbers from frame_numbers' results."""
    e_port = sum(f["e_port"] for f in per_frame)
    e_ref = sum(f["e_ref"] for f in per_frame)
    return {"coverage_share": max(f["coverage"] for f in per_frame),
            "dark_share": max(f["dark"] for f in per_frame),
            "refl_gap": abs(e_port - e_ref) / max(abs(e_ref), 1e-12)}

"""Frame compositing (torch counterpart of `rusterix_tpu/ops/composite.py`;
only the final RGBA8 conversion is ported)."""

from __future__ import annotations

import torch


def frame_to_u8(frame):
    """f32 0..1 -> RGBA8 with the reference's rounding (src/lib.rs:63-68)."""
    return torch.floor(torch.clamp(frame, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

"""Device resolution and the port's numeric settings.

The caller names the device. Nothing here picks the CPU on its own: asking
for CUDA on a machine without it raises instead of rendering somewhere
else.
"""

from __future__ import annotations

import torch

# the port is f32 throughout; the edge tests need full-precision products
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """`device` (str, torch.device or None for "cuda") -> torch.device.

    Raises RuntimeError when CUDA is asked for and not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for, but torch.cuda.is_available() is "
            "False (pass device='cpu' explicitly to run the plain versions)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

"""Device resolution and the port's numeric settings.

The caller names the device. Nothing here picks the CPU on its own: asking
for CUDA on a machine without it raises instead of rendering somewhere
else.
"""

from __future__ import annotations

import numpy as np
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


#: (bytes, dtype, shape, device) -> tensor; cleared wholesale when it grows
_CONSTS: dict = {}


def device_const(a, device) -> torch.Tensor:
    """A small numpy constant on `device`, uploaded once per value (keyed on
    its bytes, so -0.0 and 0.0 stay apart): the per-call numbers and camera
    matrices the passes read. Read only."""
    a = np.asarray(a)
    key = (a.tobytes(), a.dtype.str, a.shape, str(device))
    t = _CONSTS.get(key)
    if t is None:
        if len(_CONSTS) > 4096:
            _CONSTS.clear()
        # a copy: on the CPU the tensor would otherwise share the caller's array
        t = torch.from_numpy(a.copy()).to(device)
        _CONSTS[key] = t
    return t


#: torch dtype -> numpy dtype of the constants and leaves the port uploads
NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32, torch.int64: np.int64}


def device_scalar(value, dtype, device) -> torch.Tensor:
    """A 0-d constant of `dtype` on `device` (device_const)."""
    return device_const(np.asarray(value, NP_DTYPES[dtype]), device)


def device_table(rows, dtype, device) -> torch.Tensor:
    """A small constant table (a tuple of numbers or of rows) of `dtype` on
    `device` (device_const), so that a launch makes no host-to-device copy
    in steady state."""
    return device_const(np.asarray(rows, NP_DTYPES[dtype]), device)

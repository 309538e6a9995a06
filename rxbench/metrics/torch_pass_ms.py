"""torch_pass_ms: device ms a frame of everything but the port's CUDA
kernels (the __global__ functions of rusterix_tpu_torch/csrc) and the
copies and fills: the plain torch passes (ops/reflect.py, the opacity
layers, composite.d2_pass, ops/shadow.py, the setup pass and the packs),
from the profiled frames."""

from rxbench.lib.trace import COPY_NAMES, is_kernel


def read(rd):
    if rd.prof is None:
        return None
    own = rd.port_kernels
    us = sum(e - s for n, s, e in rd.prof["events"]
             if not n.startswith(COPY_NAMES) and not any(is_kernel(n, k) for k in own))
    return us / 1e3 / rd.prof["calls"]

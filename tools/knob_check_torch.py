"""Path B (the GGX reflection map) at 480x270 on the card and on the CPU
with this process's B3 knobs (RUSTERIX_TPU_RT_CELL, _RT_BH, _RT_BW, read
when the port is imported): prints the pixels in which the two frames
differ, which shows that the kernels built with these knobs agree with
their plain versions at the same knobs.

Usage: RUSTERIX_TPU_RT_CELL=32 python tools/knob_check_torch.py
"""

import os
import sys


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np

    from rusterix_tpu_torch.ops import rt_kernel
    from rusterix_tpu_torch.scenes import build_map_refl_scene

    frames = []
    for dev in ("cuda", "cpu"):
        rast, scene, assets = build_map_refl_scene(480, 270, device=dev)
        frames.append(rast.rasterize(scene, 480, 270, 40, assets).astype(int))
    d = np.abs(frames[0] - frames[1]).max(-1)
    print(f"knobs {(rt_kernel.RT_CELL, rt_kernel.RT_BH, rt_kernel.RT_BW)}: CUDA vs CPU path B "
          f"at 480x270, {int((d > 0).sum())} px differ, max {int(d.max())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

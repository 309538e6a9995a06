"""frame_p95_ms: the 95th percentile (linear) of every window frame's
host time, from the frame call to the frame in host memory."""

import numpy as np


def read(rd):
    return float(np.percentile(np.asarray(rd.times) * 1e3, 95)) if rd.times else None

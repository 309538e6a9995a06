"""The cost of the port's tracing on a benchmark cell: one timed run of the
cell (rxbench's run_cell, `--trace 0`) with the port's spans on or off,
printing the result line's end-to-end metrics.

    python tools/span_cost_torch.py --tracing 1 --seed 7 [--seconds 51]
        [--workload map_refl_1080p.entities]

With `--tracing 1` every frame call runs under profiling.enable(True) (the
spans record into the capped buffer, emptied after each frame); with 0
the call is the benchmark's own. Run on and off in turns (off, on, on,
off) on one card to compare. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tracing", type=int, choices=(0, 1), required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--workload", default="map_refl_1080p.entities")
    args = ap.parse_args()

    from rusterix_tpu_torch import profiling
    from rxbench import run
    from rxbench.lib import manifest as mf

    def traced(call, _ctx):
        def frame(i, readback=True):
            profiling.enable(True)
            try:
                return call(i, readback)
            finally:
                profiling.enable(False)
                profiling.take()

        return frame

    man = mf.load()
    res = run.run_cell(mf.cell(man, args.workload), man, args.seed, args.seconds, False,
                       "cuda", wrap=traced if args.tracing else None)
    print(json.dumps({"tracing": args.tracing, "seed": args.seed, "correct": res["correct"],
                      "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                      "device": res["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

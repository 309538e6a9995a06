"""The readings the limits of a cell's comparison are set from.

    python3 rxbench/tools/control.py --workload <cell> --seeds <n> [--first <seed>]
        [--seconds <s>] [--control-seeds <k>] [--size WxH] [--device cpu]

For each seed it runs the cell through the harness (run.run_cell) with a
short window: once as it stands (the port's frames: the lower reading),
and on the first `--control-seeds` seeds once more with each control put
in the port's place (the upper readings): "control", the plain reference
computed in bfloat16, and "control_shade", the reference with its rays
cast in float32 and the rest computed in bfloat16. It prints each run's
compared numbers as a JSON line. On the card, run it at the cell's own
size; `--size` and `--device cpu` are for a rehearsal."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def reference_in_place(dtype=None, shade_dtype=None):
    """A run_cell `wrap` that renders each frame with the configuration's
    plain reference instead of the port: in bfloat16 by default, or with
    `shade_dtype` in its shading alone."""
    import torch

    from rxbench.lib import manifest as mf

    if dtype is None and shade_dtype is None:
        dtype = torch.bfloat16

    def wrap(_call, ctx):
        ref = mf.module("reference", ctx["config"]).Reference(ctx["cfg"], ctx["device"])

        def call(i, readback=True):
            out = ref.frame(ctx["traffic"].frame(i), dtype or torch.float32,
                            shade_dtype=shade_dtype)
            frame = out["frame"].to(torch.uint8)
            return frame.cpu().numpy() if readback else frame

        return call

    return wrap


def controls():
    """The controls by name -> run_cell `wrap`s."""
    import torch

    return {"control": reference_in_place(),
            "control_shade": reference_in_place(shade_dtype=torch.bfloat16)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=1_000_003)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--size", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--control-seeds", type=int, default=3,
                   help="the controls run on the first this many seeds")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from rxbench import run
    from rxbench.lib import manifest as mf

    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
    man = mf.load(ROOT)
    cell = mf.cell(man, args.workload)
    size = tuple(int(x) for x in args.size.split("x")) if args.size else None
    sides = {"port": None, **controls()}
    for k in range(args.seeds):
        seed = args.first + 7919 * k
        for side, wrap in sides.items():
            if side != "port" and k >= args.control_seeds:
                continue
            res = run.run_cell(cell, man, seed, args.seconds, False, args.device, size=size,
                               wrap=wrap)
            print(json.dumps({"seed": seed, "side": side, "correct": res["correct"],
                              "attempted": res["attempted"],
                              **{k2: v["value"] for k2, v in res["checks"].items()}}),
                  flush=True)


if __name__ == "__main__":
    main()

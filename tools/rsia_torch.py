#!/usr/bin/env python
"""rsia on the PyTorch / CUDA port — the shader CLI (reference
rsia/src/main.rs:18-69; the port's form of tools/rsia.py).

Parses and compiles a .rusteria file, evaluates its fn shade() over a WxH
uv grid with the port's `Rusteria.shade_image` on the device asked for
(`-d cuda`, the default, or `-d cpu`), saves a PNG and prints the compile
and render times (the render synchronised: the image comes back to the
host).

Usage: python tools/rsia_torch.py input.rusteria [-o out.png] [-s WxH] [-t time] [-d cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default="out.png")
    ap.add_argument("-s", "--size", default="512x512")
    ap.add_argument("-t", "--time", type=float, default=0.0)
    ap.add_argument("-d", "--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    width, height = (int(x) for x in args.size.lower().split("x"))
    with open(args.input) as f:
        src = f.read()

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from rusterix_tpu_torch.models.assets import default_palette
    from rusterix_tpu_torch.shader import Program, Rusteria

    t0 = time.perf_counter()
    program = Program(Rusteria.parse_str(src))
    t_compile = (time.perf_counter() - t0) * 1000
    if not program.shade_index:
        print("error: no `fn shade()` in input", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    img = Rusteria.shade_image(program, width, height, default_palette(), args.time,
                               device=args.device)
    t_render = (time.perf_counter() - t0) * 1000

    import numpy as np
    from PIL import Image

    u8 = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    Image.fromarray(u8, "RGB").save(args.output)
    print(f"compiled in {t_compile:.1f} ms, rendered {width}x{height} on {args.device} in "
          f"{t_render:.1f} ms -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The plain reference of map_refl_1080p's frames and their comparison.

The static scene (map_grid.py), its lights and settings come from the
configuration's sizes; a frame's camera and dynamic batches from the
traffic's spec of the frame (traffic/kinds/*.py `reference`). Nothing here
imports the port or reads what it made."""

from __future__ import annotations

import numpy as np
import torch

from rxbench.lib.traffic import camera, dynamic_parts

from rxbench.reference import check, map_grid, render


def settings(cfg: dict) -> dict:
    """The settings the reference renders with."""
    return {"ambient": cfg["ambient"][:3], "sun_dir": cfg["sun_dir"],
            "sun_color": cfg["sun_color"], "day_factor": cfg["day_factor"],
            "refl_dist": cfg["refl_dist"], "background": [0, 0, 0, 0],
            "sky_rgb": [0.0, 0.0, 0.0]}


class Reference:
    """The configuration's static scene read once; each frame's dynamic
    batches from its spec."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, device
        self.settings = settings(cfg)
        self.lights = map_grid.light_rows(cfg)
        self.static = map_grid.wall_records(cfg)
        self.walls = torch.from_numpy(map_grid.segments(cfg))
        self.sun = cfg["sun_dir"] is not None and cfg["day_factor"] > 0

    def frame(self, fr: dict, dtype=torch.float32, count: bool = False,
              shade_dtype=None) -> dict:
        """render.render's output for the frame spec `fr`."""
        view, proj = camera(fr, self.cfg)
        dyn = dynamic_parts(fr["dynamic"], "reference")
        tab = render.scene_tables(self.static + dyn["opaque"], self.device)
        op_tab = render.scene_tables(dyn["opacity"], self.device) if dyn["opacity"] else None
        return render.render(tab, self.lights, self.settings, view, proj, self.cfg["width"],
                             self.cfg["height"], dtype, count=count, opacity=op_tab,
                             rects=dyn["d2"], walls=self.walls if dyn["d2"] else None,
                             shade_dtype=shade_dtype)

    def numbers(self, frames: list) -> dict:
        """The compared numbers of the port's frames [(RGBA8 (H, W, 4),
        frame spec)]."""
        return check.numbers([check.frame_numbers(np.asarray(out), self.frame(fr))
                              for out, fr in frames])

    def work(self, fr: dict) -> dict:
        """The frame's work counts (render.render(count=True)) for the
        kernels' rooflines, with "sun"."""
        return dict(self.frame(fr, count=True)["work"], sun=self.sun)

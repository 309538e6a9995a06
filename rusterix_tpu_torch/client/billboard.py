"""Client-side door/gate billboard animation.

Behavioral port of the reference's scene handler billboard flow
(src/scene_handler.rs:580-731): each surface-profile billboard is re-emitted
every frame as dynamic geometry; its open/close pose is driven by the
visibility of the controlling map item (matched by host_sector /
profile_sector attributes), with per-item overrides for animation kind,
duration and clock. Fading doors route to the transparent batch list with a
whole-batch opacity multiplier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..map.surface import BillboardAnimation
from ..models.batch import Batch3D, PixelSource

#: scene_handler.rs:581
BILLBOARD_ANIMATION_DURATION_S = 0.35

CLOCK_RENDER = 0
CLOCK_GAME_TICK = 1


@dataclass
class BillboardAnimState:
    """Per-billboard transition state (scene_handler.rs:661-677)."""

    start_open: float
    target_open: float
    start_frame: int

    def open_amount(self, clock_frame: int, fps: float, duration_s: float) -> float:
        dur_frames = max(duration_s * max(fps, 1e-6), 1e-6)
        t = min(max((clock_frame - self.start_frame) / dur_frames, 0.0), 1.0)
        return self.start_open + (self.target_open - self.start_open) * t


def find_item_by_profile_attrs(map_, host: int, profile: Optional[int]):
    """Controlling item for a door billboard: matched by host_sector /
    profile_sector attributes (scene_handler.rs:589-594)."""
    for item in map_.items:
        if item.attributes.get_int_default("host_sector", -1) != host:
            continue
        if profile is not None and item.attributes.get_int_default(
            "profile_sector", -1
        ) not in (-1, profile):
            continue
        return item
    return None


def animate_billboards(
    scene,
    map_,
    assets,
    anim_states: Dict[Tuple[int, Optional[int]], BillboardAnimState],
    frame_counter: int,
    game_tick: int,
    render_fps: float = 30.0,
    game_tick_fps: float = 30.0,
) -> Tuple[List[Batch3D], List[Batch3D]]:
    """-> (opaque_batches, transparent_batches) for this frame's pose of every
    chunk billboard. Also prunes stale animation states."""
    live_keys = set()
    opaque: List[Batch3D] = []
    transparent: List[Batch3D] = []

    for chunk in scene.chunks.values():
        for bb in getattr(chunk, "billboards", []):
            if not hasattr(bb, "animation"):
                continue  # entity BillboardMetadata, not a door billboard
            key = tuple(bb.geo_id)
            live_keys.add(key)

            item = find_item_by_profile_attrs(map_, bb.geo_id[0], bb.geo_id[1])
            is_visible = True
            animation = bb.animation
            duration_s = BILLBOARD_ANIMATION_DURATION_S
            clock = CLOCK_RENDER
            tile_id = bb.tile_id
            if item is not None:
                is_visible = item.attributes.get_bool_default("visible", True)
                code = item.attributes.get_int_default("billboard_animation", -1)
                if 1 <= code <= 5:
                    animation = BillboardAnimation(code)
                duration_s = item.attributes.get_float_default(
                    "animation_duration", BILLBOARD_ANIMATION_DURATION_S
                )
                cs = item.attributes.get_str_default("animation_clock", "").lower()
                if cs in ("frame", "tick", "game"):
                    clock = CLOCK_GAME_TICK
                iv = item.attributes.get("source")
                if iv is not None and iv.data is not None and hasattr(iv.data, "kind"):
                    src_tile = getattr(iv.data, "uuid", None)
                    if src_tile:
                        tile_id = src_tile

            clock_frame = frame_counter if clock == CLOCK_RENDER else game_tick
            clock_fps = render_fps if clock == CLOCK_RENDER else game_tick_fps

            # opening scrolls the door away: open 1.0 == fully open/invisible
            desired_open = 0.0 if is_visible else 1.0
            state = anim_states.get(key)
            if state is None:
                state = BillboardAnimState(desired_open, desired_open, clock_frame)
                anim_states[key] = state
            if abs(desired_open - state.target_open) > 1e-9:
                current = state.open_amount(clock_frame, clock_fps, duration_s)
                state = BillboardAnimState(current, desired_open, clock_frame)
                anim_states[key] = state

            open_amount = state.open_amount(clock_frame, clock_fps, duration_s)
            if open_amount >= 0.999 and desired_open > 0.5:
                continue  # fully open -> nothing to draw

            center = np.asarray(bb.center, np.float32).copy()
            opacity = 1.0
            if animation == BillboardAnimation.OpenUp:
                center += bb.right * (open_amount * bb.size)
            elif animation == BillboardAnimation.OpenDown:
                center -= bb.right * (open_amount * bb.size)
            elif animation == BillboardAnimation.OpenRight:
                center += bb.up * (open_amount * bb.size)
            elif animation == BillboardAnimation.OpenLeft:
                center -= bb.up * (open_amount * bb.size)
            elif animation == BillboardAnimation.Fade:
                opacity = 1.0 - open_amount
            else:  # Nothing: hard show/hide
                if not is_visible:
                    continue

            if bb.size <= 1e-9:
                continue

            src = None
            if tile_id is not None and assets is not None:
                idx = assets.tile_index(tile_id)
                if idx is not None:
                    src = PixelSource.static_tile_index(idx)
            if src is None:
                src = PixelSource.pixel((120, 80, 40, 255))

            batch = Batch3D()
            batch.add_vertex_billboard(center, bb.right, bb.up, bb.size)
            batch.set_source(src)
            batch.profile_id = bb.geo_id[0]
            if opacity < 1.0:
                batch.opacity = opacity
                transparent.append(batch)
            else:
                opaque.append(batch)

    # drop states for billboards that vanished with chunk rebuilds
    # (scene_handler.rs:584-585)
    for key in list(anim_states.keys()):
        if key not in live_keys:
            del anim_states[key]

    return opaque, transparent

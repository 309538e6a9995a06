"""Soft-rig vertex animation (reference src/map/softrig.rs:8-153).

Named vertex keyforms blended over time by SoftRigAnimator; `Map.tick`
applies the blended offsets to map vertices each frame
(reference src/map/mod.rs:416)."""

from __future__ import annotations

import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .value import ValueContainer


@dataclass
class Keyform:
    vertex_positions: List[Tuple[int, Tuple[float, float]]] = field(default_factory=list)


@dataclass
class SoftRig:
    name: str = ""
    id: str = field(default_factory=lambda: str(uuid_mod.uuid4()))
    keyforms: List[Keyform] = field(default_factory=list)
    in_editor_playlist: bool = True
    values: ValueContainer = field(default_factory=ValueContainer)


def blend_softrigs(rig_a: "SoftRig", rig_b: "SoftRig", t: float) -> "SoftRig":
    """Blend two rigs' first keyforms into a new rig (reference
    SoftRigAnimator::blend_softrigs, consumed by the tile builder's
    animation-frame generation — shapestack/tilebuilder.rs:228)."""
    pos_a = dict(rig_a.keyforms[0].vertex_positions) if rig_a.keyforms else {}
    pos_b = dict(rig_b.keyforms[0].vertex_positions) if rig_b.keyforms else {}
    blended = []
    for vid in sorted(set(pos_a) | set(pos_b)):
        pa = pos_a.get(vid)
        pb = pos_b.get(vid)
        if pa is None:
            blended.append((vid, pb))
        elif pb is None:
            blended.append((vid, pa))
        else:
            blended.append(
                (vid, (pa[0] + (pb[0] - pa[0]) * t, pa[1] + (pb[1] - pa[1]) * t))
            )
    return SoftRig(
        name=f"{rig_a.name}->{rig_b.name}@{t:.2f}",
        keyforms=[Keyform(vertex_positions=blended)],
    )


@dataclass
class SoftRigAnimator:
    """softrig.rs:34-153: keyframe playlist + normalized progress."""

    keyframes: List[str] = field(default_factory=list)  # rig ids
    total_duration: float = 1.0
    progress: float = 0.0
    playing: bool = True
    loop_playback: bool = True

    def set_progress(self, value: float) -> None:
        self.progress = min(1.0, max(0.0, value))

    def tick(self, delta_time: float) -> None:
        if not self.playing or len(self.keyframes) < 2 or self.total_duration <= 0.0:
            return
        self.progress += delta_time / self.total_duration
        if self.progress >= 1.0:
            if self.loop_playback:
                self.progress %= 1.0
            else:
                self.progress = 1.0
                self.playing = False

    def update(self, delta_time: float) -> None:
        self.tick(delta_time)

    def blended_positions(self, rigs: Dict[str, SoftRig]) -> Dict[int, Tuple[float, float]]:
        """Blend between the two active keyframes' first keyforms."""
        if len(self.keyframes) < 2:
            return {}
        segs = len(self.keyframes) - 1
        f = self.progress * segs
        i = min(int(f), segs - 1)
        t = f - i
        a = rigs.get(self.keyframes[i])
        b = rigs.get(self.keyframes[i + 1])
        if a is None or b is None or not a.keyforms or not b.keyforms:
            return {}
        pos_a = dict(a.keyforms[0].vertex_positions)
        pos_b = dict(b.keyforms[0].vertex_positions)
        out = {}
        for vid in set(pos_a) | set(pos_b):
            pa = pos_a.get(vid)
            pb = pos_b.get(vid)
            if pa is None:
                out[vid] = pb
            elif pb is None:
                out[vid] = pa
            else:
                out[vid] = (
                    pa[0] + (pb[0] - pa[0]) * t,
                    pa[1] + (pb[1] - pa[1]) * t,
                )
        return out

    def apply_to_map(self, map_) -> None:
        """Write blended vertex positions into the map (Map::tick)."""
        blended = self.blended_positions(map_.softrigs)
        for vid, (x, y) in blended.items():
            v = map_.get_vertex(vid)
            if v is not None:
                v.x = x
                v.y = y

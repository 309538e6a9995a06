"""Wavefront OBJ parsing (reference src/wavefront.rs behavior).

Parses v / vt / vn / f records and triangulates polygon faces as fans,
emitting a Batch3D with denormalized per-corner vertices when the OBJ uses
separate position/uv/normal indexing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Wavefront:
    positions: list = field(default_factory=list)
    uvs: list = field(default_factory=list)
    normals: list = field(default_factory=list)
    faces: list = field(default_factory=list)  # list of [(vi, ti, ni), ...]

    @staticmethod
    def parse_string(text: str) -> "Wavefront":
        w = Wavefront()
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v" and len(parts) >= 4:
                w.positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt" and len(parts) >= 3:
                w.uvs.append([float(parts[1]), float(parts[2])])
            elif tag == "vn" and len(parts) >= 4:
                w.normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "f" and len(parts) >= 4:
                corners = []
                for p in parts[1:]:
                    bits = p.split("/")
                    vi = int(bits[0])
                    ti = int(bits[1]) if len(bits) > 1 and bits[1] else 0
                    ni = int(bits[2]) if len(bits) > 2 and bits[2] else 0
                    corners.append((vi, ti, ni))
                w.faces.append(corners)
        return w

    def to_batch(self):
        from .batch import Batch3D

        verts, uvs, normals, indices = [], [], [], []

        def resolve(idx: int, n: int) -> int:
            # OBJ indices are 1-based; negative = relative from end
            return idx - 1 if idx > 0 else n + idx

        has_any_normal = len(self.normals) > 0
        for face in self.faces:
            base = len(verts)
            for vi, ti, ni in face:
                p = self.positions[resolve(vi, len(self.positions))]
                verts.append([p[0], p[1], p[2], 1.0])
                if ti != 0 and self.uvs:
                    uvs.append(self.uvs[resolve(ti, len(self.uvs))])
                else:
                    # no texture coords: planar default uv = vertex (x, y)
                    # (reference src/wavefront.rs:92-98)
                    uvs.append([p[0], p[1]])
                if ni != 0 and self.normals:
                    normals.append(self.normals[resolve(ni, len(self.normals))])
                elif has_any_normal:
                    normals.append([0.0, 0.0, 0.0])
            # Fan triangulation
            for k in range(1, len(face) - 1):
                indices.append((base, base + k, base + k + 1))

        batch = Batch3D.new(verts, indices, uvs)
        if has_any_normal:
            batch.normals = np.asarray(normals, np.float32).reshape(-1, 3)
        return batch

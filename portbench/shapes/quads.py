"""Planar quads, one mesh a quad, split into the triangles (0, 1, 2) and
(0, 2, 3) of its corners, with corner uvs (0, 0), (1, 0), (1, 1), (0, 1).

spec: {"kind": "quads", "material": <name>, "emission": [r, g, b]
(optional), "mirror_x": x0 (optional: every corner's x becomes x0 - x),
"quads": [{"name": ..., "corners": [[x, y, z] * 4]}, ...]}.
"""
from __future__ import annotations

import numpy as np

from ..scene import Mesh

_IDX = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
_UV = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)


def build(spec: dict, material_ids: dict):
    emission = np.asarray(spec.get("emission", (0, 0, 0)), np.float32)
    out = []
    for q in spec["quads"]:
        c = np.asarray(q["corners"], np.float64)
        if "mirror_x" in spec:
            c[:, 0] = float(spec["mirror_x"]) - c[:, 0]
        out.append(Mesh(vertices=c.astype(np.float32), indices=_IDX.copy(),
                        material=material_ids[spec["material"]],
                        emission=emission.copy(), uvs=_UV.copy(),
                        name=q.get("name", "")))
    return out

"""A configuration's scene as plain arrays, built from its JSON file.

`portbench/configs/<name>.json` names its materials, its camera and a list
of shapes; each shape's `kind` is a module `portbench/shapes/<kind>.py`
whose `build(spec, material_ids)` returns meshes, and each material's
`kind` a module of portbench/materials/ (the renderer's side) and of
portbench/reference/materials/ (the reference's). Both sides of the
comparison start from the same `SceneArrays`: the renderer through its
Scene API (portbench/port.py), the reference through
portbench/reference/scene.py.
"""
from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent


@dataclass
class Mesh:
    vertices: np.ndarray            # [v, 3] float32
    indices: np.ndarray             # [t, 3] int32
    material: int
    emission: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    normals: Optional[np.ndarray] = None   # [v, 3] float32
    uvs: Optional[np.ndarray] = None       # [v, 2] float32
    name: str = ""


@dataclass
class SceneArrays:
    materials: List[dict]           # {"kind": <kind>, <its parameters>}
    meshes: List[Mesh]
    camera: dict                    # origin, target, up, fov, fov_axis

    @property
    def n_triangles(self) -> int:
        return sum(m.indices.shape[0] for m in self.meshes)


def load_config(name: str) -> dict:
    with open(ROOT / "configs" / f"{name}.json") as f:
        return json.load(f)


def build_arrays(cfg: dict) -> SceneArrays:
    names = list(cfg["materials"])
    ids = {k: i for i, k in enumerate(names)}
    meshes: List[Mesh] = []
    for spec in cfg["shapes"]:
        mod = importlib.import_module(f"portbench.shapes.{spec['kind']}")
        meshes.extend(mod.build(spec, ids))
    return SceneArrays(
        materials=[dict(cfg["materials"][k]) for k in names],
        meshes=meshes, camera=dict(cfg["camera"]))

"""A cubic grid of tessellated unit spheres as one mesh: the grid's side is
the least g with g^3 spheres of 2 n_theta (n_theta - 1) triangles reaching
`n_tris`, sphere (i, j, k) centred at spacing * (i, j, k), each a UV sphere
of n_theta rings and n_theta segments, flat-shaded (the mesh carries no
corner normals or uvs, as models/presets.py:sphere_grid_mesh builds it).

spec: {"kind": "sphere_grid", "n_tris": ..., "n_theta": ..., "spacing":
..., "material": <name>}.
"""
from __future__ import annotations

import numpy as np

from ..scene import Mesh


def uv_sphere(n_theta: int, n_phi: int):
    """(vertices, indices) of a unit UV sphere at the origin, rings from the
    +z pole, the poles' degenerate triangles left out."""
    verts = []
    for th in np.linspace(0, np.pi, n_theta + 1):
        for ph in np.linspace(0, 2 * np.pi, n_phi + 1):
            verts.append(np.array([np.sin(th) * np.cos(ph),
                                   np.sin(th) * np.sin(ph), np.cos(th)],
                                  np.float32))
    idx = []
    stride = n_phi + 1
    for it in range(n_theta):
        for ip in range(n_phi):
            a = it * stride + ip
            b, c = a + 1, a + stride
            if it > 0:
                idx.append([a, c, b])
            if it < n_theta - 1:
                idx.append([b, c, c + 1])
    return np.asarray(verts, np.float32), np.asarray(idx, np.int32)


def build(spec: dict, material_ids: dict):
    v, idx = uv_sphere(int(spec["n_theta"]), int(spec["n_theta"]))
    g = int(np.ceil((int(spec["n_tris"]) / idx.shape[0]) ** (1 / 3)))
    step = np.float32(spec["spacing"])
    cells = np.stack(np.meshgrid(np.arange(g), np.arange(g), np.arange(g),
                                 indexing="ij"), -1).reshape(-1, 3)
    offs = cells.astype(np.float32) * step
    verts = (v[None] + offs[:, None]).reshape(-1, 3)
    indices = (idx[None] + (np.arange(len(cells)) * v.shape[0])[:, None,
                                                                 None])
    return [Mesh(vertices=verts.astype(np.float32),
                 indices=indices.reshape(-1, 3).astype(np.int32),
                 material=material_ids[spec["material"]])]

"""Large-scene benchmark presets; port of the sphere grid of
rustlight_tpu/models/presets.py."""
from __future__ import annotations

import numpy as np

from ..bsdfs import diffuse
from ..scene import Scene, TriMesh, look_at, make_camera, make_quad, make_sphere


def sphere_grid_mesh(n_tris: int, n_theta: int = 10, spacing: float = 3.0,
                     material: int = 0):
    """A cubic grid of unit UV spheres as one TriMesh of about n_tris
    triangles. Returns (mesh, gs) with the grid spanning [0, gs*spacing]^3."""
    base = make_sphere((0, 0, 0), 1.0, n_theta=n_theta, n_phi=n_theta)
    nt = base.indices.shape[0]
    gs = int(np.ceil((n_tris / nt) ** (1 / 3)))
    vs, idxs, off = [], [], 0
    for i in range(gs):
        for j in range(gs):
            for k in range(gs):
                vs.append(base.vertices + np.array([i, j, k],
                                                   np.float32) * spacing)
                idxs.append(base.indices + off)
                off += base.vertices.shape[0]
    mesh = TriMesh(vertices=np.concatenate(vs).astype(np.float32),
                   indices=np.concatenate(idxs).astype(np.int32),
                   material=material)
    return mesh, gs


def sphere_grid(n_tris=122_000, width=256, height=256) -> Scene:
    """A cubic grid of UV spheres (about n_tris triangles) under one
    overhead area light, the camera outside looking in: the large-scene
    benchmark, whose rays all go through the tile walk."""
    sc = Scene()
    m = sc.add_material(diffuse((0.6, 0.55, 0.5)))
    mesh, gs = sphere_grid_mesh(n_tris, n_theta=10, material=m)
    sc.add_mesh(mesh)
    lm = sc.add_material(diffuse((0, 0, 0)))
    ext = gs * 3.0
    sc.add_mesh(make_quad((0, ext + 4, 0), (ext, ext + 4, 0),
                          (ext, ext + 4, ext), (0, ext + 4, ext),
                          material=lm, emission=(40, 40, 40)))
    sc.camera = make_camera(width, height, fov=55.0,
                            to_world=look_at((ext / 2, ext / 2, -0.35 * ext),
                                             (ext / 2, ext / 2, ext / 2),
                                             (0, 1, 0)))
    return sc

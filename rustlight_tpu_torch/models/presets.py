"""Analytic test scenes and benchmark presets; port of
rustlight_tpu/models/presets.py."""
from __future__ import annotations

import numpy as np

from ..bsdfs import diffuse
from ..scene import Scene, TriMesh, look_at, make_camera, make_quad, make_sphere


def simple_sphere_scene(width=64, height=64, albedo=(0.5, 0.5, 0.5)) -> Scene:
    """Diffuse sphere on a ground plane under a constant environment."""
    sc = Scene()
    m = sc.add_material(diffuse(albedo))
    sc.add_mesh(make_sphere((0, 1, 0), 1.0, material=m))
    sc.add_mesh(make_quad((-20, 0, -20), (20, 0, -20), (20, 0, 20),
                          (-20, 0, 20), material=m))
    sc.env_constant = np.asarray([1.0, 1.0, 1.0], np.float32)
    sc.camera = make_camera(width, height, fov=60.0,
                            to_world=look_at((0, 1.5, -5), (0, 1, 0), (0, 1, 0)))
    return sc


def furnace_scene(width=32, height=32, albedo=0.5) -> Scene:
    """White furnace: a diffuse sphere (8,064 triangles) inside a uniform
    unit-radiance environment. Any point on the sphere sends 1/(1 - albedo)
    toward the camera when multiple scattering converges; with a max_depth
    cutoff D, the partial sum over k = 0..D of albedo^k."""
    sc = Scene()
    m = sc.add_material(diffuse((albedo, albedo, albedo)))
    sc.add_mesh(make_sphere((0, 0, 0), 1.0, material=m, n_theta=64, n_phi=64))
    sc.env_constant = np.asarray([1.0, 1.0, 1.0], np.float32)
    sc.camera = make_camera(width, height, fov=40.0,
                            to_world=look_at((0, 0, -4), (0, 0, 0), (0, 1, 0)))
    return sc


def door_box(width=40, height=30) -> Scene:
    """Hard-visibility scene: two rooms joined by a narrow doorway, the only
    light in the far room, the camera looking at a dark wall of the near
    room, so that every visible pixel's radiance arrives indirectly through
    the door."""
    sc = Scene()
    white = sc.add_material(diffuse((0.7, 0.7, 0.7)))
    lm = sc.add_material(diffuse((0.0, 0.0, 0.0)))

    def quad(p0, p1, p2, p3, mat=white, emis=(0, 0, 0)):
        sc.add_mesh(make_quad(p0, p1, p2, p3, material=mat, emission=emis))

    # room A (camera) x in [0,4], room B (light) x in [4,8]; y up to 3, z to 4
    quad((0, 0, 0), (8, 0, 0), (8, 0, 4), (0, 0, 4))            # floor
    quad((0, 3, 0), (0, 3, 4), (8, 3, 4), (8, 3, 0))            # ceiling
    quad((0, 0, 0), (0, 0, 4), (0, 3, 4), (0, 3, 0))            # x = 0
    quad((8, 0, 0), (8, 3, 0), (8, 3, 4), (8, 0, 4))            # x = 8
    quad((0, 0, 0), (0, 3, 0), (8, 3, 0), (8, 0, 0))            # z = 0
    quad((0, 0, 4), (8, 0, 4), (8, 3, 4), (0, 3, 4))            # z = 4
    # dividing wall with a 0.8-wide, 2-high doorway
    quad((4, 0, 0), (4, 3, 0), (4, 3, 1.6), (4, 0, 1.6))
    quad((4, 0, 2.4), (4, 3, 2.4), (4, 3, 4), (4, 0, 4))
    quad((4, 2, 1.6), (4, 3, 1.6), (4, 3, 2.4), (4, 2, 2.4))
    quad((7.99, 1, 1.5), (7.99, 2, 1.5), (7.99, 2, 2.5), (7.99, 1, 2.5),
         mat=lm, emis=(60, 60, 60))
    sc.camera = make_camera(width, height, fov=60.0,
                            to_world=look_at((2.0, 1.5, 3.6),
                                             (0.5, 1.5, 0.2), (0, 1, 0)))
    return sc


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

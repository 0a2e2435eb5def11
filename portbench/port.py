"""The system under test: the configuration's arrays handed to
rustlight_tpu_torch through its Scene API, and one pass of a traffic mix
through its normal entry, `integrators.common.render`, the film returned on
the host. With portbench/integrators/ and portbench/materials/, whose
modules it finds by the names the configuration and the mix give, the only
code of the harness that drives the renderer; the trace readers take its
counters and kernel names (portbench/trace.py).
"""
from __future__ import annotations

import importlib

import numpy as np

from rustlight_tpu_torch.integrators.common import render
from rustlight_tpu_torch.scene import Scene, TriMesh, look_at, make_camera


def _module(sub: str, name: str):
    return importlib.import_module(f"{__package__}.{sub}.{name}")


def port_scene(arrays, width: int, height: int) -> Scene:
    """The renderer's host scene of the configuration's arrays."""
    sc = Scene()
    for spec in arrays.materials:
        sc.add_material(_module("materials", spec["kind"]).make(spec))
    for m in arrays.meshes:
        sc.add_mesh(TriMesh(vertices=m.vertices, indices=m.indices,
                            normals=m.normals, uvs=m.uvs,
                            material=m.material, emission=m.emission,
                            name=m.name))
    cam = arrays.camera
    sc.camera = make_camera(
        width, height, fov=float(cam["fov"]),
        to_world=look_at(cam["origin"], cam["target"], cam["up"]),
        fov_axis=cam.get("fov_axis", "x"))
    return sc


def compile_scene(arrays, width: int, height: int, device):
    """Scene.compile on `device`: the tables, the walk's tables on scenes
    over the dense tier's size, uploaded."""
    return port_scene(arrays, width, height).compile(device)


def make_integrator(name: str, params: dict):
    """(the integrator's module, the renderer's integrator)."""
    mod = _module("integrators", name)
    return mod, mod.make(params)


def render_pass(sd, integ, spp: int, seed: int, route: str) -> np.ndarray:
    """One pass of `make_integrator`'s integrator on `route`: the film
    [h, w, 3] float32 on the host."""
    mod, integrator = integ
    return mod.render(sd, integrator, spp, seed, route)


def film(sd, integrator, spp: int, seed: int, route: str) -> np.ndarray:
    """One pass through `render`, the persistent route where `route` is
    "persistent": the film's primal [h, w, 3] float32 on the host."""
    return render(sd, integrator, spp=spp, seed=seed,
                  persistent=route == "persistent").buffers["primal"]

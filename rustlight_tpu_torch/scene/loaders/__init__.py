"""Scene loader registry; port of rustlight_tpu/scene/loaders/__init__.py.

Reference: SceneLoaderManager (src/scene_loader.rs:18-58), an extension ->
loader registry (pbrt and xml registered there; obj added as a
convenience, with a default camera framing the bounds and no lights).
"""
from __future__ import annotations

from pathlib import Path

from ..scene import Scene


def _load_obj_scene(path) -> Scene:
    import numpy as np
    from ..camera import make_camera, look_at
    from ..geometry import scene_bounds
    from .obj import load_obj

    scene = Scene()
    meshes, mats, _tex = load_obj(path)
    base = len(scene.materials)
    for m in mats:
        scene.add_material(m)
    for mesh in meshes:
        mesh.material += base
        scene.add_mesh(mesh)
    # default camera framing the bounds
    _, _, center, radius = scene_bounds(scene.meshes)
    eye = center + np.asarray([0, 0, -3.0 * radius])
    scene.camera = make_camera(512, 512, fov=45.0,
                               to_world=look_at(eye, center, (0, 1, 0)))
    return scene


def _load_pbrt(path) -> Scene:
    from .pbrt import load_pbrt
    return load_pbrt(path)


def _load_mitsuba(path) -> Scene:
    from .mitsuba import load_mitsuba
    return load_mitsuba(path)


LOADERS = {".pbrt": _load_pbrt, ".xml": _load_mitsuba, ".obj": _load_obj_scene}


def load_scene(path) -> Scene:
    """Load a scene file by extension (SceneLoaderManager::load)."""
    ext = Path(path).suffix.lower()
    if ext not in LOADERS:
        raise ValueError(f"no scene loader registered for '{ext}' "
                         f"(available: {sorted(LOADERS)})")
    return LOADERS[ext](path)


def register_loader(ext: str, fn) -> None:
    LOADERS[ext.lower()] = fn

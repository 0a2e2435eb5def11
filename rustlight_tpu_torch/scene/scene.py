"""Scene container: host-side description -> device tables; port of
rustlight_tpu/scene/scene.py.

`Scene.compile(device)` builds the numpy tables exactly as the reference
does (kept as `SceneData.host`), then `from_numpy_scene` uploads them to
`device`. `from_numpy_scene` also takes the JAX package's compiled numpy
scene (`sd.host.data`), read by attribute, so both packages can render the
very same tables, the homogeneous medium, the point, directional,
point-normal and environment lights, uv-dependent emission and the ATS
light tree (`use_ats`) included.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..bsdfs.table import MaterialDesc, build_material_table, material_table_to
from ..utils.frame import make_frame, to_local
from ..utils.vec import dot
from .ats import ats_to, build_ats
from .camera import Camera, camera_to
from .emitters import build_emitter_tables, emitters_to
from .geometry import TriMesh, build_geometry_tables, geometry_to, scene_bounds
from .volume import HomogeneousVolume, volume_to


class SceneData(NamedTuple):
    camera: Camera
    geom: Any
    materials: Any
    emitters: Any
    host: Optional[Any] = None       # the numpy SceneData this was built from
    use_shading_normals: bool = True
    volume: Optional[HomogeneousVolume] = None   # infinite medium, on device
    ats: Optional[Any] = None        # ats.AtsTables when built with use_ats

    @property
    def device(self) -> torch.device:
        return self.geom.inter_rows.device


@dataclass
class Scene:
    """Host-side scene under construction."""
    camera: Camera = None
    meshes: List[TriMesh] = field(default_factory=list)
    materials: List[MaterialDesc] = field(default_factory=list)
    point_lights: List[Tuple] = field(default_factory=list)  # (pos, intensity)
    directional_lights: List[Tuple] = field(default_factory=list)  # (dir, I)
    point_normal_lights: List[Tuple] = field(default_factory=list)  # (p, n, I)
    env_constant: Optional[np.ndarray] = None
    env_image: Optional[np.ndarray] = None     # [h, w, 3] lat-long map
    textures: Optional[np.ndarray] = None   # [k, th, tw, 3] bitmap atlas
    volume: Optional[HomogeneousVolume] = None   # numpy (make_volume)

    def add_material(self, desc: MaterialDesc) -> int:
        self.materials.append(desc)
        return len(self.materials) - 1

    def add_mesh(self, mesh: TriMesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def compile(self, device, use_shading_normals: bool = True,
                walk_options=None, use_ats: bool = False) -> SceneData:
        """Build the numpy tables and upload them to `device`.
        `walk_options` (accel/walk.py: WalkOptions) picks the walk's
        schedule for scenes that carry walk tables; `use_ats` builds the
        ATS light tree (scene/ats.py), which NEE then samples."""
        materials = self.materials or [MaterialDesc()]
        mesh_emitter_id, next_id = [], 0
        for m in self.meshes:
            if m.is_light:
                mesh_emitter_id.append(next_id)
                next_id += 1
            else:
                mesh_emitter_id.append(-1)

        geom = build_geometry_tables(self.meshes, mesh_emitter_id)
        _, _, center, radius = scene_bounds(self.meshes)
        # the reference includes the camera position in the scene bounds
        if self.camera is not None:
            cam_p = np.asarray(self.camera.position)
            radius = max(radius, float(np.linalg.norm(cam_p - center)))
        emitters = build_emitter_tables(
            self.meshes, mesh_emitter_id, geom.n_pad,
            points=self.point_lights, directionals=self.directional_lights,
            point_normals=self.point_normal_lights,
            env_constant=self.env_constant, env_image=self.env_image,
            bsphere_center=center, bsphere_radius=radius,
            textures=self.textures)
        ats = None
        if use_ats:
            ats = build_ats(geom, emitters)
        host_sd = SceneData(camera=self.camera, geom=geom,
                            materials=build_material_table(
                                materials, textures=self.textures),
                            emitters=emitters,
                            use_shading_normals=use_shading_normals,
                            volume=self.volume, ats=ats)
        return from_numpy_scene(host_sd, device, walk_options)


def from_numpy_scene(host_sd, device, walk_options=None) -> SceneData:
    """Upload a compiled numpy scene to `device`.

    `host_sd` is this package's host SceneData or the JAX package's
    `sd.host.data`; it is read by attribute only. The material table comes
    with its texture atlas. Walk tables come along
    (the JAX package's converted to this package's layout); the JAX
    package's clustered tables are ignored. The emitter tables come whole:
    every atom kind, the environment's image and CDF, the uv-dependent
    emission columns. The medium's sigmas and phase g are read as plain
    numbers. The ATS light tree comes where the host scene has one.
    `walk_options` sets the walk's schedule (accel/walk.py: WalkOptions)."""
    device = torch.device(device)
    ats = getattr(host_sd, "ats", None)
    if ats is not None:
        ats = ats_to(ats, device)
    return SceneData(
        camera=camera_to(host_sd.camera, device),
        geom=geometry_to(host_sd.geom, device, walk_options),
        materials=material_table_to(host_sd.materials, device),
        emitters=emitters_to(host_sd.emitters, device),
        host=host_sd,
        use_shading_normals=bool(host_sd.use_shading_normals),
        volume=(None if getattr(host_sd, "volume", None) is None
                else volume_to(host_sd.volume, device)),
        ats=ats,
    )


class Hit(NamedTuple):
    """Wavefront intersection record, SoA over lanes."""
    valid: Any   # [n] bool
    t: Any       # [n]
    tri: Any     # [n] triangle id (-1 on a miss)
    p: Any       # [n, 3]
    n_g: Any     # [n, 3] geometric normal (possibly flipped two-sided)
    n_s: Any     # [n, 3] shading normal
    uv: Any      # [n, 2]
    frame: Any   # (t, b, n) shading frame
    wi: Any      # [n, 3] local incoming (toward previous vertex)
    mat: Any     # [n] material id
    is_light: Any  # [n] bool


def fill_hit(scene: SceneData, o, d, rh,
             use_shading_normals: Optional[bool] = None) -> Hit:
    """Build the full intersection record from a RayHit: barycentric
    normal/uv interpolation, shading-normal alignment with n_g, two-sided
    flip for non-light two-sided materials."""
    g = scene.geom
    if use_shading_normals is None:
        use_shading_normals = scene.use_shading_normals
    tri = torch.clamp(rh.tri, min=0)
    u, v = rh.u, rh.v
    b0 = 1.0 - u - v
    n_g = g.n_g[tri]
    vn = g.vn[tri]
    has_n = g.has_normals[tri] & use_shading_normals
    n_s_raw = (vn[:, 0] * b0[:, None] + vn[:, 1] * u[:, None]
               + vn[:, 2] * v[:, None])
    flip_g = dot(n_g, n_s_raw) < 0.0
    n_g = torch.where((has_n & flip_g)[:, None], -n_g, n_g)
    l2 = dot(n_s_raw, n_s_raw)[:, None]
    n_s = torch.where(l2 > 0.0,
                      n_s_raw / torch.sqrt(torch.clamp(l2, min=1e-30)), n_g)
    n_s = torch.where(has_n[:, None], n_s, n_g)

    vuv = g.vuv[tri]
    mat = g.mat_id[tri]
    is_light = g.emitter_id[tri] >= 0
    uv = (vuv[:, 0] * b0[:, None] + vuv[:, 1] * u[:, None]
          + vuv[:, 2] * v[:, None])
    two_sided = scene.materials.two_sided[mat]
    backface = dot(d, n_s) > 0.0
    do_flip = (two_sided & (~is_light) & backface)[:, None]
    n_s = torch.where(do_flip, -n_s, n_s)
    n_g = torch.where(do_flip, -n_g, n_g)

    p = o + d * rh.t[:, None]
    frame = make_frame(n_s)
    wi = to_local(frame, -d)
    return Hit(valid=rh.hit, t=rh.t, tri=rh.tri, p=p, n_g=n_g, n_s=n_s, uv=uv,
               frame=frame, wi=wi, mat=mat, is_light=is_light)


def offset_ray_origin(p, n_g, d):
    """Self-intersection-safe ray origin: offset p along +-n_g by a
    magnitude-relative epsilon."""
    scale = torch.amax(torch.abs(p), dim=-1)
    eps = (1e-4 + 2e-5 * scale)[..., None]
    sign = torch.where(dot(n_g, d) >= 0.0, 1.0, -1.0)[..., None]
    return p + n_g * eps * sign

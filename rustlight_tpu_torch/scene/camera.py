"""Perspective pinhole camera; port of rustlight_tpu/scene/camera.py.

Matrices are built host-side in numpy exactly as the reference builds them;
`camera_to` uploads them. `generate_rays` and its adjoint `sample_direct`
(world point -> pixel and importance, for the light tracer's splats) are
batched torch.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch


def _perspective(fov_rad: float, near: float, far: float) -> np.ndarray:
    """OpenGL-style perspective matrix with aspect 1 (cgmath `perspective`)."""
    f = 1.0 / np.tan(fov_rad / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2.0 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m


def _scale(x, y, z) -> np.ndarray:
    return np.diag([x, y, z, 1.0]).astype(np.float32)


def _translate(x, y, z) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [x, y, z]
    return m


def look_at(origin, target, up) -> np.ndarray:
    """Camera-to-world matrix; the camera looks down +z in its local frame."""
    origin = np.asarray(origin, np.float32)
    d = np.asarray(target, np.float32) - origin
    d = d / np.linalg.norm(d)
    up = np.asarray(up, np.float32)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return m


class Camera(NamedTuple):
    """Camera tables: numpy as built, torch tensors after `camera_to`."""
    width: int
    height: int
    sample_to_camera: Any  # [4,4]
    camera_to_sample: Any  # [4,4]
    to_world: Any          # [4,4]
    to_local: Any          # [4,4]
    image_rect_min: Any    # [2]
    image_rect_max: Any    # [2]
    fov: float = 45.0
    fov_axis: str = "x"
    flip: bool = False

    @property
    def position(self):
        return self.to_world[:3, 3]


def make_camera(width: int, height: int, fov: float, to_world: np.ndarray,
                fov_axis: str = "x", flip: bool = False) -> Camera:
    """fov in degrees; `fov_axis`/`flip` mirror the reference Fov::X/Y + flip."""
    aspect = width / height
    fov_rad = np.deg2rad(fov) if fov_axis == "x" else np.deg2rad(fov * aspect)
    x_v = 1.0 if flip else -1.0
    camera_to_sample = (
        _scale(-0.5, -0.5 * aspect, 1.0)
        @ _translate(-1.0, -1.0 / aspect, 0.0)
        @ _perspective(fov_rad, 1e-2, 1000.0)
        @ _scale(x_v, 1.0, -1.0)
    )
    sample_to_camera = np.linalg.inv(camera_to_sample)

    def _xform_pt(m, p):
        q = m @ np.array([p[0], p[1], p[2], 1.0], np.float32)
        return q[:3] / q[3]

    p0 = _xform_pt(sample_to_camera, (0.0, 0.0, 0.0))
    p1 = _xform_pt(sample_to_camera, (1.0, 1.0, 0.0))
    zmin = min(p0[2], p1[2])
    rect_min = np.array([min(p0[0], p1[0]), min(p0[1], p1[1])], np.float32) / zmin
    rect_max = (np.array([max(p0[0], p1[0]), max(p0[1], p1[1])], np.float32)
                / max(p0[2], p1[2]))
    to_world = np.asarray(to_world, np.float32)
    return Camera(
        width=width, height=height,
        sample_to_camera=sample_to_camera.astype(np.float32),
        camera_to_sample=camera_to_sample.astype(np.float32),
        to_world=to_world,
        to_local=np.linalg.inv(to_world).astype(np.float32),
        image_rect_min=rect_min,
        image_rect_max=rect_max,
        fov=float(fov), fov_axis=fov_axis, flip=flip,
    )


def resize_camera(cam: Camera, width: int, height: int) -> Camera:
    """The camera re-derived for a new film size from its construction
    parameters, so that the projection follows the new aspect ratio
    (replacing width and height alone would keep the old one)."""
    return make_camera(width, height, cam.fov, np.asarray(cam.to_world),
                       fov_axis=cam.fov_axis, flip=cam.flip)


def camera_to(cam, device) -> Camera:
    """Upload a numpy camera (this module's or the JAX package's, read by
    attribute) to `device`."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return Camera(
        width=int(cam.width), height=int(cam.height),
        sample_to_camera=t(cam.sample_to_camera),
        camera_to_sample=t(cam.camera_to_sample),
        to_world=t(cam.to_world), to_local=t(cam.to_local),
        image_rect_min=t(cam.image_rect_min),
        image_rect_max=t(cam.image_rect_max),
        fov=float(cam.fov), fov_axis=cam.fov_axis, flip=bool(cam.flip))


def _transform_point(m, p):
    """Row vectors through a 4x4 matrix, each output a sum in column
    order (p0*m[i,0] + p1*m[i,1]) + p2*m[i,2], plus the translation."""
    def row(i):
        return (p[..., 0] * m[i, 0] + p[..., 1] * m[i, 1]
                + p[..., 2] * m[i, 2]) + m[i, 3]
    w = row(3)
    return torch.stack([row(0), row(1), row(2)], dim=-1) / w[..., None]


def _transform_vector(m, v):
    def row(i):
        return v[..., 0] * m[i, 0] + v[..., 1] * m[i, 1] + v[..., 2] * m[i, 2]
    return torch.stack([row(0), row(1), row(2)], dim=-1)


def generate_rays(cam: Camera, px) -> Tuple[Any, Any]:
    """px [..., 2] continuous pixel coords -> (origins [..., 3], dirs [..., 3])."""
    s = torch.stack([px[..., 0] / cam.width, px[..., 1] / cam.height,
                     torch.zeros_like(px[..., 0])], dim=-1)
    near_p = _transform_point(cam.sample_to_camera, s)
    nrm = torch.sqrt(near_p[..., 0] * near_p[..., 0]
                     + near_p[..., 1] * near_p[..., 1]
                     + near_p[..., 2] * near_p[..., 2])
    d = near_p / nrm[..., None]
    d_world = _transform_vector(cam.to_world, d)
    o = cam.position.expand(d_world.shape)
    return o, d_world


def sample_direct(cam: Camera, p):
    """Splat world points p [n, 3] onto the image plane (the adjoint of
    `generate_rays`). Returns (importance [n]: W_e / dist^2, 0 off screen or
    behind; pixel [n, 2]: continuous coordinates)."""
    ref_p = _transform_point(cam.to_local, p)
    z_ok = ref_p[..., 2] > 0.0

    screen = _transform_point(cam.camera_to_sample, ref_p)
    sx, sy = screen[..., 0], screen[..., 1]
    on_screen = (sx >= 0.0) & (sx <= 1.0) & (sy >= 0.0) & (sy <= 1.0)
    pixel = torch.stack([sx * cam.width, sy * cam.height], dim=-1)

    dist = torch.sqrt(ref_p[..., 0] * ref_p[..., 0]
                      + ref_p[..., 1] * ref_p[..., 1]
                      + ref_p[..., 2] * ref_p[..., 2])
    inv_dist = 1.0 / torch.clamp(dist, min=1e-20)
    local_d = ref_p * inv_dist[..., None]

    cos_theta = local_d[..., 2]
    inv_ct = 1.0 / torch.clamp(cos_theta, min=1e-20)
    px_plane = local_d[..., 0] * inv_ct
    py_plane = local_d[..., 1] * inv_ct
    rmin, rmax = cam.image_rect_min, cam.image_rect_max
    in_rect = ((px_plane >= rmin[0]) & (px_plane <= rmax[0])
               & (py_plane >= rmin[1]) & (py_plane <= rmax[1]))
    area = (rmax[0] - rmin[0]) * (rmax[1] - rmin[1])
    importance = (1.0 / area) * inv_ct ** 3
    valid = z_ok & on_screen & in_rect & (cos_theta > 0.0)
    w = torch.where(valid, importance * inv_dist * inv_dist, 0.0)
    return w, pixel

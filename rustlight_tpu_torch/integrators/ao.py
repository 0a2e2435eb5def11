"""Ambient occlusion integrator; port of rustlight_tpu/integrators/ao.py
(reference src/integrators/ao.rs:4-71).

One sample a call: a camera ray through a jittered pixel position, then one
cosine-distributed occlusion ray from its hit with range (EPSILON,
max_distance). The pixel value is 1 where the hit faces the camera and the
occlusion ray is free, else 0. It draws its uniforms in the reference's
order and shapes (u_pix (n, 2), then the direction's (n, 2)), so the two
packages render sample for sample alike.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import EPSILON
from ..accel import intersect_rays, occluded_rays
from ..scene import fill_hit, generate_rays
from ..scene.scene import offset_ray_origin
from ..utils.frame import to_world
from ..utils.rng import stream_next2d
from ..utils.tracing import spanned
from ..utils.warps import cosine_sample_hemisphere


class IntegratorAO:
    def __init__(self, max_distance: Optional[float] = None,
                 normal_correction: bool = False):
        self.max_distance = max_distance
        self.normal_correction = normal_correction

    @spanned("loop.sample")
    def compute_pixel(self, scene, pix, stream):
        """One AO sample of every pixel in pix [n, 2]: [n, 3] in {0, 1}."""
        n = pix.shape[0]
        dev = pix.device
        u_pix, stream = stream_next2d(stream, (n,))
        o, d = generate_rays(scene.camera, pix.to(torch.float32) + u_pix)
        rh = intersect_rays(scene.geom, o, d)
        hit = fill_hit(scene, o, d, rh)

        cos_theta = hit.wi[..., 2]
        if self.normal_correction:
            flip = cos_theta <= 0.0
            alive = hit.valid
        else:
            flip = torch.zeros(n, dtype=torch.bool, device=dev)
            alive = hit.valid & (cos_theta > 0.0)

        u, stream = stream_next2d(stream, (n,))
        d_local = cosine_sample_hemisphere(u)
        d_local = torch.where(flip[:, None], -d_local, d_local)
        d_world = to_world(hit.frame, d_local)

        tnear = torch.full((n,), EPSILON, dtype=torch.float32, device=dev)
        tfar = torch.full((n,), float("inf") if self.max_distance is None
                          else float(self.max_distance),
                          dtype=torch.float32, device=dev)
        o_ao = offset_ray_origin(hit.p, hit.n_g, d_world)
        occ = occluded_rays(scene.geom, o_ao, d_world, tnear, tfar)
        visible = alive & ~occ
        return torch.where(visible[:, None], 1.0, 0.0).expand(n, 3)

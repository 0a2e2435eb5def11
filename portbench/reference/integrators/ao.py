"""Ambient occlusion, replayed pixel by pixel (see path.py for the replay):
sample s draws from the stream folded with s, u_pix (2D) and one
cosine-weighted direction (2D)."""
from __future__ import annotations

import math

import torch

from ..rng import Stream, fold_in, seed_key
from ..scene import (EPSILON, RefScene, camera_rays, closest,
                     cosine_hemisphere, occluded, offset_origin, pixel_coords,
                     shade, to_world)


def values(sc: RefScene, seed: int, lanes: torch.Tensor, spp: int,
           params: dict, route: str) -> torch.Tensor:
    """The share of samples whose first hit faces the camera and whose
    cosine-weighted ray is free up to `max_distance`, [p, 3]."""
    if route != "per_pass":
        raise ValueError("ambient occlusion takes the per-pass route only")
    max_distance = params["max_distance"]
    dt, dev = sc.dtype, lanes.device
    n = lanes.shape[0]
    pixf = pixel_coords(sc, lanes)
    total = torch.zeros((n, 3), dtype=dt, device=dev)
    for s in range(spp):
        st = Stream(fold_in(seed_key(seed), s), lanes, dt)
        o, d = camera_rays(sc, pixf + st.next2())
        inf = torch.full((n,), math.inf, dtype=dt, device=dev)
        t, tri, u, v, valid = closest(sc, o, d, torch.full_like(inf, EPSILON),
                                      inf)
        hit = shade(sc, o, d, t, tri, u, v, valid)
        alive = valid & (hit.wi[:, 2] > 0.0)
        dw = to_world(hit.frame, cosine_hemisphere(st.next2()))
        oa = offset_origin(hit.p, hit.n_g, dw)
        free = torch.ones_like(alive)
        idx = torch.nonzero(alive).squeeze(1)
        if idx.numel():
            free[idx] = ~occluded(sc, oa[idx], dw[idx],
                                  torch.full((idx.numel(),), EPSILON,
                                             dtype=dt, device=dev),
                                  torch.full((idx.numel(),), max_distance,
                                             dtype=dt, device=dev))
        total = total + (alive & free).to(dt)[:, None].expand(n, 3)
    return total / spp

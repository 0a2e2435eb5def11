"""Dense ray-triangle intersection; port of rustlight_tpu/accel/dense.py.

Every ray is tested against every triangle's Baldwin-Weber rows
(scene/geometry.py). The work is done by the dense kernels of
ops/dense_trace.py (hand-written CUDA on the card, their plain versions on
the CPU); this module only shapes the calls. Scenes above the dense tier's
1024 triangles carry walk tables (`geom.walk`), and their rays go to the
tile walk of accel/walk.py instead, or, for tables whose option is `pair`,
to the pair walk of accel/pair_walk.py.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import EPSILON
from ..ops.dense_trace import dense_anyhit, dense_closest
from ..utils.vec import length


class RayHit(NamedTuple):
    t: Any       # [n] hit distance (inf if miss)
    tri: Any     # [n] int32 triangle id (-1 if miss)
    u: Any       # [n] barycentric of e1
    v: Any       # [n] barycentric of e2
    hit: Any     # [n] bool


def intersect_rays(geom, o, d, tnear=None, tfar=None) -> RayHit:
    """Closest hit for a ray wavefront. o, d [n, 3]."""
    n = o.shape[0]
    if tnear is None:
        tnear = torch.full((n,), EPSILON, dtype=torch.float32, device=o.device)
    if tfar is None:
        tfar = torch.full((n,), float("inf"), dtype=torch.float32,
                          device=o.device)
    if getattr(geom, "walk", None) is not None:
        if geom.walk.options.pair:
            from .pair_walk import _pairs_impl
            return _pairs_impl(geom.walk, o, d, tnear, tfar, False)
        from .walk import _walk_impl
        return _walk_impl(geom.walk, o, d, tnear, tfar, False)
    t, idx, u, v = dense_closest(geom.inter_rows, o.contiguous(),
                                 d.contiguous(), tnear, tfar)
    return RayHit(t=t, tri=idx, u=u, v=v, hit=torch.isfinite(t))


def occluded_rays(geom, o, d, tnear, tfar):
    """Any-hit (shadow ray) test; True = blocked."""
    if getattr(geom, "walk", None) is not None:
        if geom.walk.options.pair:
            from .pair_walk import _pairs_impl
            return _pairs_impl(geom.walk, o, d, tnear, tfar, True)
        from .walk import _walk_impl
        return _walk_impl(geom.walk, o, d, tnear, tfar, True)
    return dense_anyhit(geom.inter_rows, o.contiguous(), d.contiguous(),
                        tnear, tfar)


def visible(geom, p0, p1, mask=None):
    """Mutual visibility p0 <-> p1 with the reference's shadow epsilons
    (tnear = EPSILON, tfar slightly short of the target).

    mask [n] bool (optional): lanes whose result the caller will not use get
    tfar = 0, an inert ray that cannot hit anything (the kernel skips it,
    and on the walk it widens no tile's cluster union).
    Masked lanes return True (unoccluded); callers gate on their own mask."""
    delta = p1 - p0
    dist = length(delta)
    d = delta / torch.clamp(dist, min=1e-20)[:, None]
    tnear = torch.full(dist.shape, EPSILON, dtype=torch.float32,
                       device=dist.device)
    tfar = dist * (1.0 - 1e-3)
    if mask is not None:
        tfar = torch.where(mask, tfar, 0.0)
    return ~occluded_rays(geom, p0, d, tnear, tfar)

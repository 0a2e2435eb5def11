"""Flattened SAH BVH: host build and stackless device traversal; port of
rustlight_tpu/accel/bvh.py.

The builder is the reference's C++ source, carried into the port as
csrc/bvh_builder.cpp, compiled with g++ at first use (ops/native.py) and
called through ctypes. A different builder gives a different tree and so
different walk tables, so a failed compile raises; there is no fallback.

`intersect_bvh` is the reference's skip-link closest-hit walk
(bvh.py:182-260). The reference computes it in XLA, outside any Pallas
kernel, as a vmapped while loop; here it is plain PyTorch on the tensors'
device: all rays step together, each lane carrying its node and its best
hit, until no lane has a node left. A tool for tests and the laboratory, not
a render path: the slowest lane sets the step count.
"""
from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import EPSILON
from ..ops.native import CSRC, build_host
from ..ops.walk_trace import _slab_inv, _test_clusters
from .dense import RayHit

# traversal steps between two host checks of "any lane still walking";
# lanes past their last node are inert, so extra steps change nothing
CHECK_EVERY = 8

_LIB = None


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_host(CSRC / "bvh_builder.cpp")))
        sig = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
               ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
        for fn in (lib.rl_build_bvh, lib.rl_build_bvh_sweep):
            fn.restype = ctypes.c_int
            fn.argtypes = sig
        _LIB = lib
    return _LIB


class BvhTables(NamedTuple):
    """Preorder nodes with skip links (numpy); leaves index `prim_index`."""
    n_nodes: int
    leaf_size: int
    bbox_lo: Any      # [m, 3] f32
    bbox_hi: Any      # [m, 3] f32
    skip: Any         # [m] int32, -1 = end of traversal
    prim_start: Any   # [m] int32
    prim_count: Any   # [m] int32, 0 for internal nodes
    inter_rows: Any   # [t + leaf_size, 3, 4] rows in leaf order, zero-padded
    prim_index: Any   # [t] int32 original triangle ids in leaf order


def build_bvh(geom, max_leaf: int = 8, builder: str = "binned") -> BvhTables:
    """Build over the real (unpadded) triangles of numpy geometry tables.

    builder: "binned" (16-bin SAH, the default) or "sweep" (full SAH
    sweep)."""
    if builder not in ("binned", "sweep"):
        raise ValueError(f"unknown BVH builder {builder!r}")
    v0 = np.asarray(geom.v0[: geom.n_tris])
    p1 = v0 + np.asarray(geom.e1[: geom.n_tris])
    p2 = v0 + np.asarray(geom.e2[: geom.n_tris])
    lo = np.minimum(np.minimum(v0, p1), p2)
    hi = np.maximum(np.maximum(v0, p1), p2)
    aabbs = np.ascontiguousarray(np.concatenate([lo, hi], -1), np.float32)
    n = aabbs.shape[0]

    lib = _load()
    nodes_buf = np.zeros((2 * n, 9), np.float32)
    order = np.zeros(n, np.int32)
    entry = lib.rl_build_bvh_sweep if builder == "sweep" else lib.rl_build_bvh
    cnt = entry(aabbs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
                max_leaf,
                nodes_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    nodes = nodes_buf[:cnt]
    ints = nodes[:, 6:9].view(np.int32)
    rows = np.asarray(geom.inter_rows[: geom.n_tris])[order]
    # pad so a leaf's fixed-width slice of max_leaf rows never runs past
    rows = np.concatenate([rows, np.zeros((max_leaf, 3, 4), np.float32)], 0)
    return BvhTables(
        n_nodes=nodes.shape[0], leaf_size=max_leaf,
        bbox_lo=nodes[:, :3].copy(), bbox_hi=nodes[:, 3:6].copy(),
        skip=ints[:, 0].copy(), prim_start=ints[:, 1].copy(),
        prim_count=ints[:, 2].copy(), inter_rows=rows, prim_index=order)


def bvh_tables_to(bvh: BvhTables, device) -> BvhTables:
    """Upload numpy BVH tables."""
    return bvh._replace(**{
        f: torch.as_tensor(np.ascontiguousarray(getattr(bvh, f)),
                           device=device)
        for f in ("bbox_lo", "bbox_hi", "skip", "prim_start", "prim_count",
                  "inter_rows", "prim_index")})


def intersect_bvh(bvh: BvhTables, o, d, tnear=None, tfar=None,
                  check_every: int = CHECK_EVERY, stats: dict = None) -> RayHit:
    """Closest hit of rays (o, d) [n, 3] by the stackless skip-link walk
    over device BVH tables (bvh_tables_to). A node whose box the ray enters
    below its best t is descended (node + 1) or, a leaf, tested: its
    leaf_size rows through the dense tier's _dot4-ordered test within
    (tnear, tfar), counted where in the leaf and t < best t, the first
    minimum winning; every other node is left by its skip link. `stats`, if
    given, receives the number of steps taken."""
    n = o.shape[0]
    dev = o.device
    if tnear is None:
        tnear = torch.full((n,), EPSILON, dtype=torch.float32, device=dev)
    if tfar is None:
        tfar = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    k = int(bvh.leaf_size)
    inv_d = _slab_inv(d)
    kiota = torch.arange(k, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    best_t = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    skip = bvh.skip.long()
    start_of, count_of = bvh.prim_start.long(), bvh.prim_count.long()
    steps = 0
    while n and bool((node >= 0).any()):
        for _ in range(check_every):
            walking = node >= 0
            at = torch.clamp(node, min=0)
            t0 = (bvh.bbox_lo[at] - o) * inv_d
            t1 = (bvh.bbox_hi[at] - o) * inv_d
            tmin = torch.minimum(t0, t1).amax(dim=1)
            tmax = torch.maximum(t0, t1).amin(dim=1)
            hit_box = ((tmax >= torch.maximum(tmin, tnear))
                       & (tmin <= torch.minimum(best_t, tfar)))
            cnt = count_of[at]
            is_leaf = cnt > 0
            start = start_of[at]
            rows = bvh.inter_rows[start[:, None] + kiota]      # [n, k, 3, 4]
            t, u, v, valid = (x[:, 0] for x in _test_clusters(
                rows, o[:, None], d[:, None], tnear[:, None], tfar[:, None]))
            valid = valid & (kiota < cnt[:, None]) & (t < best_t[:, None])
            t_m = torch.where(valid, t, float("inf"))
            j = torch.argmin(t_m, dim=1, keepdim=True)
            t_j = t_m.gather(1, j)[:, 0]
            better = walking & hit_box & is_leaf & (t_j < best_t)
            best_t = torch.where(better, t_j, best_t)
            best_i = torch.where(better, start + j[:, 0], best_i)
            best_u = torch.where(better, u.gather(1, j)[:, 0], best_u)
            best_v = torch.where(better, v.gather(1, j)[:, 0], best_v)
            nxt = torch.where(hit_box & ~is_leaf, at + 1, skip[at])
            node = torch.where(walking, nxt, node)
        steps += check_every
    if stats is not None:
        stats["steps"] = steps
    hit = torch.isfinite(best_t)
    last = bvh.prim_index.shape[0] - 1
    tri = torch.where(hit, bvh.prim_index[torch.clamp(best_i, 0, last)].int(),
                      -1)
    return RayHit(t=best_t, tri=tri, u=best_u, v=best_v, hit=hit)

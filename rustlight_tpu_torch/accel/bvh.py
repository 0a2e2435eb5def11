"""Flattened SAH BVH, host build; port of the build half of
rustlight_tpu/accel/bvh.py.

The builder is the reference's C++ source, carried into the port as
csrc/bvh_builder.cpp, compiled with g++ at first use (ops/native.py) and
called through ctypes. A different builder gives a different tree and so
different walk tables, so a failed compile raises; there is no fallback.
The device traversal (`intersect_bvh`) is not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import numpy as np

from ..ops.native import CSRC, build_host

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

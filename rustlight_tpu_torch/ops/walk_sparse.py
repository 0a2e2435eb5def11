"""Sparse-visit tile-walk closest-hit and any-hit kernels (K7): wrappers
and plain PyTorch versions.

The CUDA kernels (csrc/walk_sparse.cu) replace the TPU kernels
rustlight_tpu/accel/pallas_walk.py:_closest_kernel_sparse and
:_anyhit_kernel_sparse, with :_compact_rays and :_test_rows_cols. They are
built by ops/native.py and called through ctypes on PyTorch's current
stream.

They take what the one-level walk (ops/walk_trace.py) takes, whole 64-ray
tiles in the caller's order, over walk tables of at most MAX_VMEM_CLUSTERS
clusters, and keep its one heap and its pop order. The entry pass also
keeps, per cluster, which of the tile's rays enter it (each ray's own slab
test, capped by its tfar). A visit tests only those rays when they are at
most SPARSE_CAP = 16, else the whole tile; a tested ray's cap is its
current best t and only a strictly nearer hit is written back. The plain
versions run that walk for all tiles at once in batched torch ops, with the
same arithmetic and the same branch as the kernels, so the kernels are
bit-identical to them; they also return the visits, the visits that took
the sparse branch, the rays tested and the rays flagged. The wrappers use them only for
tensors on the CPU; a CUDA tensor launches the kernel or raises.

Each wrapper adds one to `LAUNCHES[name]` where it launches its kernel, and
adds the lanes it was handed with tfar > 0 to `counting_rays()`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .native import count_rays, load_cuda
from .walk_sub import check_resident
from .walk_trace import _check_arrays, _walk_ref

# a visit with at most this many flagged rays tests only those: the
# reference's SPARSE_CAP (pallas_walk.py:106)
SPARSE_CAP = 16

LAUNCHES = {"walk_sparse_closest": 0, "walk_sparse_anyhit": 0}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _load():
    global _LIB
    if _LIB is None:
        lib = load_cuda()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rl_walk_sparse_closest.argtypes = [p, p, i, i, p, p, p, p, p, p,
                                               i, i, p, p, p, p, p]
        lib.rl_walk_sparse_closest.restype = i
        lib.rl_walk_sparse_anyhit.argtypes = [p, p, i, i, p, p, p, p, p, i,
                                              i, p, p]
        lib.rl_walk_sparse_anyhit.restype = i
        _LIB = lib
    return _LIB


def _check(wt, o, d, tnear, tfar) -> None:
    check_resident(wt, "the sparse-visit walk")
    _check_arrays(wt, o, d, tnear, tfar)


# ------------------------------------------------------------ plain versions

def walk_sparse_closest_ref(wt, o, d, tnear, tfar):
    """Plain version of the sparse-visit closest-hit walk: (t, tri, u, v,
    visits, visits that tested only flagged rays, rays tested, rays
    flagged)."""
    (t, tri, u, v), *counts = _walk_ref(wt, o, d, tnear, tfar, False,
                                        sparse_cap=SPARSE_CAP)
    return (t, tri, u, v, *(int(c.sum()) for c in counts))


def walk_sparse_anyhit_ref(wt, o, d, tnear, tfar):
    """Plain version of the sparse-visit any-hit walk: (occ, visits, visits
    that tested only flagged rays, rays tested, rays flagged)."""
    (occ,), *counts = _walk_ref(wt, o, d, tnear, tfar, True,
                                sparse_cap=SPARSE_CAP)
    return (occ, *(int(c.sum()) for c in counts))


# ------------------------------------------------------------------ wrappers

def walk_sparse_closest(wt, o, d, tnear, tfar) -> Tuple[torch.Tensor, ...]:
    """Closest hit of whole 64-ray tiles (o, d [n, 3], tnear, tfar [n]) over
    walk tables `wt`, sparse visits: (t, tri, u, v), each [n]."""
    _check(wt, o, d, tnear, tfar)
    count_rays(tfar)
    if o.device.type == "cpu":
        return walk_sparse_closest_ref(wt, o, d, tnear, tfar)[:4]
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        with torch.cuda.device(o.device):
            err = _load().rl_walk_sparse_closest(
                wt.lo.data_ptr(), wt.hi.data_ptr(), int(wt.n_clusters),
                int(wt.n_real), wt.rows.data_ptr(), wt.ids.data_ptr(),
                o.data_ptr(), d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(),
                n, SPARSE_CAP, t.data_ptr(), tri.data_ptr(), u.data_ptr(),
                v.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"walk_sparse_closest launch failed: CUDA error {err}")
        LAUNCHES["walk_sparse_closest"] += 1
    return t, tri, u, v


def walk_sparse_anyhit(wt, o, d, tnear, tfar) -> torch.Tensor:
    """Any hit of whole 64-ray tiles over walk tables, sparse visits: True =
    occluded."""
    _check(wt, o, d, tnear, tfar)
    count_rays(tfar)
    if o.device.type == "cpu":
        return walk_sparse_anyhit_ref(wt, o, d, tnear, tfar)[0]
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        with torch.cuda.device(o.device):
            err = _load().rl_walk_sparse_anyhit(
                wt.lo.data_ptr(), wt.hi.data_ptr(), int(wt.n_clusters),
                int(wt.n_real), wt.rows.data_ptr(), o.data_ptr(),
                d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(), n,
                SPARSE_CAP, occ.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"walk_sparse_anyhit launch failed: CUDA error {err}")
        LAUNCHES["walk_sparse_anyhit"] += 1
    return occ

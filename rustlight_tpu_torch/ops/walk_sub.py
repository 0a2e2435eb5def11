"""Sub-tiled tile-walk closest-hit and any-hit kernels (K6): wrappers and
plain PyTorch versions.

The CUDA kernels (csrc/walk_sub.cu) replace the TPU kernels
rustlight_tpu/accel/pallas_walk.py:_closest_kernel_sub and
:_anyhit_kernel_sub. They are built by ops/native.py and called through
ctypes on PyTorch's current stream.

They take what the one-level walk (ops/walk_trace.py) takes, whole 64-ray
tiles in the caller's order, over walk tables of at most MAX_VMEM_CLUSTERS
clusters. Each tile is split into `sub` (2, 4 or 8) contiguous groups of
64 / sub rays; the entry pass gives each group its own packed entries, the
minimum over the group's rays only, and each group pops, visits (two a
check) and stops on its own threshold, the largest best t among its rays.
A group is thus a tile of 64 / sub rays, and the plain version is the
one-level walk's at that tile size, with the same arithmetic as the
kernels, so the kernels are bit-identical to it; it also returns the
cluster visits per group. The wrappers use it only for tensors on the CPU;
a CUDA tensor launches the kernel or raises.

With `mxu=True` a visit takes the tensor-core form of the triangle test
(ops/walk_trace.py, csrc/tri_test_mma.cuh), each group against its own
cluster inside a warp's scan; these kernels count as `<name>_mma`, and
their plain version forms the products with torch.matmul.

Each wrapper adds one to `LAUNCHES[name]` where it launches its kernel, and
adds the lanes it was handed with tfar > 0 to `counting_rays()`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .native import count_rays, load_cuda
from .walk_trace import RAY_TILE, _check_arrays, _walk_ref

# the largest table these schedules take: the reference's bound on tables
# resident in VMEM (pallas_walk.py:70), kept with its value
MAX_VMEM_CLUSTERS = 640
SUBS = (2, 4, 8)

LAUNCHES = {"walk_sub_closest": 0, "walk_sub_anyhit": 0,
            "walk_sub_closest_mma": 0, "walk_sub_anyhit_mma": 0}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _load():
    global _LIB
    if _LIB is None:
        lib = load_cuda()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rl_walk_sub_closest.argtypes = [i, p, p, i, i, p, p, p, p, p, p,
                                            i, i, p, p, p, p, p]
        lib.rl_walk_sub_closest.restype = i
        lib.rl_walk_sub_anyhit.argtypes = [i, p, p, i, i, p, p, p, p, p, i,
                                           i, p, p]
        lib.rl_walk_sub_anyhit.restype = i
        _LIB = lib
    return _LIB


def check_resident(wt, what: str) -> None:
    """Raises unless the tables fit the schedules that take resident tables
    only."""
    cp = int(wt.n_clusters)
    if not 0 < int(wt.n_real) <= cp <= MAX_VMEM_CLUSTERS:
        raise ValueError(
            f"{what} takes tables of at most {MAX_VMEM_CLUSTERS} clusters "
            f"(the reference's resident tables); these have {cp}")


def _check(wt, o, d, tnear, tfar, sub: int) -> None:
    if sub not in SUBS:
        raise ValueError(f"sub must be one of {SUBS} (groups of whole "
                         f"8-ray rows of a {RAY_TILE}-ray tile), got {sub}")
    check_resident(wt, f"the sub-tiled walk (sub={sub})")
    _check_arrays(wt, o, d, tnear, tfar)


# ------------------------------------------------------------ plain versions

def walk_sub_closest_ref(wt, o, d, tnear, tfar, sub: int, mxu: bool = False):
    """Plain version of the sub-tiled closest-hit walk: (t, tri, u, v,
    visits), the visits summed over the groups."""
    (t, tri, u, v), visits = _walk_ref(wt, o, d, tnear, tfar, False,
                                       tile=RAY_TILE // sub, mxu=mxu)
    return t, tri, u, v, int(visits.sum())


def walk_sub_anyhit_ref(wt, o, d, tnear, tfar, sub: int, mxu: bool = False):
    """Plain version of the sub-tiled any-hit walk: (occ, visits)."""
    (occ,), visits = _walk_ref(wt, o, d, tnear, tfar, True,
                               tile=RAY_TILE // sub, mxu=mxu)
    return occ, int(visits.sum())


# ------------------------------------------------------------------ wrappers

def walk_sub_closest(wt, o, d, tnear, tfar, sub: int,
                     mxu: bool = False) -> Tuple[torch.Tensor, ...]:
    """Closest hit of whole 64-ray tiles (o, d [n, 3], tnear, tfar [n]),
    each walked as `sub` groups, over walk tables `wt`: (t, tri, u, v).
    `mxu` takes the tensor-core form of the triangle test."""
    _check(wt, o, d, tnear, tfar, sub)
    count_rays(tfar)
    if o.device.type == "cpu":
        return walk_sub_closest_ref(wt, o, d, tnear, tfar, sub, mxu)[:4]
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        with torch.cuda.device(o.device):
            err = _load().rl_walk_sub_closest(
                sub, wt.lo.data_ptr(), wt.hi.data_ptr(), int(wt.n_clusters),
                int(wt.n_real), wt.rows.data_ptr(), wt.ids.data_ptr(),
                o.data_ptr(), d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(),
                n, int(mxu), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
                v.data_ptr(), torch.cuda.current_stream().cuda_stream)
        name = "walk_sub_closest" + ("_mma" if mxu else "")
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        LAUNCHES[name] += 1
    return t, tri, u, v


def walk_sub_anyhit(wt, o, d, tnear, tfar, sub: int,
                    mxu: bool = False) -> torch.Tensor:
    """Any hit of whole 64-ray tiles, each walked as `sub` groups: True =
    occluded. `mxu` as in walk_sub_closest."""
    _check(wt, o, d, tnear, tfar, sub)
    count_rays(tfar)
    if o.device.type == "cpu":
        return walk_sub_anyhit_ref(wt, o, d, tnear, tfar, sub, mxu)[0]
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        with torch.cuda.device(o.device):
            err = _load().rl_walk_sub_anyhit(
                sub, wt.lo.data_ptr(), wt.hi.data_ptr(), int(wt.n_clusters),
                int(wt.n_real), wt.rows.data_ptr(), o.data_ptr(),
                d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(), n, int(mxu),
                occ.data_ptr(), torch.cuda.current_stream().cuda_stream)
        name = "walk_sub_anyhit" + ("_mma" if mxu else "")
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        LAUNCHES[name] += 1
    return occ

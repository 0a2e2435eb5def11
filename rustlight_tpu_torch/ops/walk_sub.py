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

The kernels run in a split form by default: P threads a ray (each testing
every P-th column of a visit, as K3/K4's split form), a group's pop and
threshold reduced over its 64 / sub x P threads, its rows read through L1
or staged in a slot of its own. `PRODUCTION_FORMS` names each kernel's
form (P threads a ray, staged) per sub, `launch_geometry` its threads and
dynamic shared memory. The wrappers' private `_form=ONE_THREAD_FORM`
launches the one-thread-a-ray kernel instead, for
chip_smoke.py's side-by-side timing and the `cuda` test only.

With `mxu=True` a visit takes the tensor-core form of the triangle test
(ops/walk_trace.py, csrc/tri_test_mma.cuh); these kernels count as
`<name>_mma`, and their plain version forms the products with
torch.matmul. Its split forms (`MMA_FORMS`) split the test over the warps
of a group by column blocks, bit for bit the one-thread tensor-core kernel,
in which each group scans its own cluster inside a warp's scan.

Each wrapper adds one to `LAUNCHES[name]` where it launches its kernel, and
adds the lanes it was handed with tfar > 0 to `counting_rays()`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .native import check_lib_k, count_k, count_rays, load_cuda
from .walk_trace import (_MAX_SMEM, K, ONE_THREAD_FORM, RAY_TILE,
                         _check_arrays, _walk_ref, form_args,
                         mma_scratch_bytes, slot_bytes, table_k)

# the largest table these schedules take: the reference's bound on tables
# resident in VMEM (pallas_walk.py:70), kept with its value
MAX_VMEM_CLUSTERS = 640
SUBS = (2, 4, 8)
# threads a ray of a split form
SPLIT_PS = (2, 4, 8)

# a kernel's form per sub: (threads a ray, rows staged); the forms csrc/
# builds beside the one-thread kernel (walk_sub.cu: CLOSEST_FORMS,
# ANYHIT_FORMS, CLOSEST_MMA_FORMS, ANYHIT_MMA_FORMS), the fastest on an
# H100 on grid122k's spread wavefront (tools/perf/sub_forms.py; PERF.md
# section 6)
PRODUCTION_FORMS = {
    "walk_sub_closest": {2: (8, True), 4: (8, True), 8: (8, False)},
    "walk_sub_anyhit": {2: (8, True), 4: (8, True), 8: (8, False)}}
MMA_FORMS = {
    "walk_sub_closest": {2: (4, True), 4: (4, True), 8: (8, True)},
    "walk_sub_anyhit": {2: (4, True), 4: (4, True), 8: (8, True)}}
# static shared memory: the tile's rays, then two sets of a group's
# partials for each group (csrc/walk_sub.cu: SubShared)
_RAYS_BYTES = 2048

LAUNCHES = {"walk_sub_closest": 0, "walk_sub_anyhit": 0,
            "walk_sub_closest_mma": 0, "walk_sub_anyhit_mma": 0}

_LIBS = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind(lib):
    """Sets the K6 entry points' argument types on a loaded library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rl_walk_sub_closest.argtypes = [i, p, p, i, i, p, p, p, p, p, p,
                                        i, i, i, i, i, p, p, p, p, p]
    lib.rl_walk_sub_closest.restype = i
    lib.rl_walk_sub_anyhit.argtypes = [i, p, p, i, i, p, p, p, p, p, i,
                                       i, i, i, i, p, p]
    lib.rl_walk_sub_anyhit.restype = i
    return lib


def _load(k: int = K):
    if k not in _LIBS:
        _LIBS[k] = bind(load_cuda(k))
    return _LIBS[k]


def static_smem(sub: int, form) -> int:
    """ptxas's static shared memory of K6 at `sub` in `form`, bytes."""
    p = int(form[0])
    return _RAYS_BYTES + 4 * 2 * sub * max(1, RAY_TILE // sub * p // 32)


def launch_geometry(sub: int, form, cp: int, mxu: bool = False, *,
                    k: int = K) -> Tuple[int, int]:
    """(threads a block, dynamic shared-memory bytes) of K6 at `sub` in
    `form` (threads a ray, staged) over tables of cp clusters, with the
    tensor-core test if `mxu`: the slots when staged, the split tensor-core
    visit's scratch, the heaps, at K = k. Raises ValueError for a form that
    is no form of this kernel (the split tensor-core visit needs a warp to
    lie in one group) or past the card's 232,448 B a block."""
    p, stage = int(form[0]), bool(form[1])
    if (p, stage) != ONE_THREAD_FORM and (
            p not in SPLIT_PS or (mxu and RAY_TILE // sub * p < 32)):
        raise ValueError(f"K6 at sub {sub} has no form {tuple(form)}"
                         f"{' with mxu' if mxu else ''}")
    dyn = ((sub * slot_bytes(k) if stage else 0)
           + (mma_scratch_bytes(p) if mxu and p > 1 else 0) + 4 * sub * cp)
    if static_smem(sub, form) + dyn > _MAX_SMEM:
        raise ValueError(f"K6 at sub {sub} in form {tuple(form)} needs "
                         f"{static_smem(sub, form)} + {dyn} B of shared "
                         f"memory, past {_MAX_SMEM}")
    return p * RAY_TILE, dyn


def _resolve_form(name: str, sub: int, form, mxu: bool):
    """The form a launch takes: the production one for its test and sub, or
    the one-thread-a-ray kernel where the private `form` asks for it
    (ONE_THREAD_FORM, the only value it takes)."""
    if form is not None and tuple(form) != ONE_THREAD_FORM:
        raise ValueError(f"_form takes only {ONE_THREAD_FORM}, got {form}")
    if form is not None:
        return ONE_THREAD_FORM
    return (MMA_FORMS if mxu else PRODUCTION_FORMS)[name][sub]


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


class PlantedTables(NamedTuple):
    """Walk tables as the wrappers read them (accel/walk.py:WalkTables)."""
    n_clusters: int
    n_real: int
    lo: torch.Tensor
    hi: torch.Tensor
    rows: torch.Tensor
    ids: torch.Tensor


PLANTED_CLUSTERS = 6


def planted_tiles(device="cpu", tiles: int = 4, seed: int = 0):
    """Tiles whose groups stop far apart, for the split form's per-group
    barriers: PLANTED_CLUSTERS clusters in slabs z in [2c, 2c + 0.2] of
    small triangles over [-1, 0]^2, each with one more at (0.95, 0.95) that
    stretches its box to [-1, 1]^2; in every tile the first 32 rays aim at
    cluster 0's triangles (each group of them stops after one pair of
    visits) and the last 32 run along z through every box between the
    triangles (visiting every cluster). Returns (tables, [o, d, tnear,
    tfar])."""
    from .dense_trace import _bw_rows
    rng = np.random.default_rng(seed)
    nc = PLANTED_CLUSTERS
    c = np.concatenate([
        np.stack([rng.uniform(-0.95, -0.05, K), rng.uniform(-0.95, -0.05, K),
                  np.full(K, 2.0 * s + 0.1)], 1)
        for s in range(nc)]).astype(np.float32)
    c[::K, :2] = 0.95
    p = [c + rng.uniform(-0.04, 0.04, c.shape).astype(np.float32)
         for _ in range(3)]
    pts = np.stack(p).reshape(3, nc, K, 3)
    n = tiles * RAY_TILE
    near = (np.arange(n) % RAY_TILE) < RAY_TILE // 2
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = -3.0
    o[~near, :2] = rng.uniform(0.3, 0.6, ((~near).sum(), 2))
    o[near, :2] = rng.uniform(-0.6, -0.4, (near.sum(), 2))
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    d[near] = (sum(p) / 3)[rng.integers(1, K, near.sum())] - o[near]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tt = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)
    wt = PlantedTables(nc, nc, tt(pts.min(axis=(0, 2)).T),
                       tt(pts.max(axis=(0, 2)).T),
                       tt(_bw_rows(*p).astype(np.float32)),
                       tt(np.arange(nc * K, dtype=np.int32)))
    return wt, [tt(x) for x in (o, d.astype(np.float32),
                                np.full(n, 1e-4, np.float32),
                                np.full(n, np.inf, np.float32))]


# ------------------------------------------------------------------ wrappers

def launch_closest(lib, wt, o, d, tnear, tfar, sub: int, mxu: bool, form):
    """Launches K6's closest hit on checked CUDA tensors in `form` through
    library `lib` (bound by `bind`, built for the tables' K): (t, tri, u,
    v)."""
    check_lib_k(lib, table_k(wt), "walk_sub_closest")
    smem = launch_geometry(sub, form, wt.n_clusters, mxu, k=table_k(wt))[1]
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        with torch.cuda.device(o.device):
            err = lib.rl_walk_sub_closest(
                sub, wt.lo.data_ptr(), wt.hi.data_ptr(), int(wt.n_clusters),
                int(wt.n_real), wt.rows.data_ptr(), wt.ids.data_ptr(),
                o.data_ptr(), d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(),
                n, int(mxu), *form_args(form, smem), t.data_ptr(),
                tri.data_ptr(), u.data_ptr(), v.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        name = "walk_sub_closest" + ("_mma" if mxu else "")
        if err:
            raise RuntimeError(f"{name} in form {tuple(form)} launch failed: "
                               f"CUDA error {err}")
        LAUNCHES[name] += 1
        count_k(name, table_k(wt))
    return t, tri, u, v


def launch_anyhit(lib, wt, o, d, tnear, tfar, sub: int, mxu: bool, form):
    """The same for K6's any hit: occ."""
    check_lib_k(lib, table_k(wt), "walk_sub_anyhit")
    smem = launch_geometry(sub, form, wt.n_clusters, mxu, k=table_k(wt))[1]
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        with torch.cuda.device(o.device):
            err = lib.rl_walk_sub_anyhit(
                sub, wt.lo.data_ptr(), wt.hi.data_ptr(), int(wt.n_clusters),
                int(wt.n_real), wt.rows.data_ptr(), o.data_ptr(),
                d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(), n, int(mxu),
                *form_args(form, smem), occ.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        name = "walk_sub_anyhit" + ("_mma" if mxu else "")
        if err:
            raise RuntimeError(f"{name} in form {tuple(form)} launch failed: "
                               f"CUDA error {err}")
        LAUNCHES[name] += 1
        count_k(name, table_k(wt))
    return occ


def walk_sub_closest(wt, o, d, tnear, tfar, sub: int, mxu: bool = False, *,
                     _form=None) -> Tuple[torch.Tensor, ...]:
    """Closest hit of whole 64-ray tiles (o, d [n, 3], tnear, tfar [n]),
    each walked as `sub` groups, over walk tables `wt`: (t, tri, u, v).
    `mxu` takes the tensor-core form of the triangle test."""
    _check(wt, o, d, tnear, tfar, sub)
    form = _resolve_form("walk_sub_closest", sub, _form, mxu)
    launch_geometry(sub, form, wt.n_clusters, mxu, k=table_k(wt))
    count_rays(tfar)
    if o.device.type == "cpu":
        return walk_sub_closest_ref(wt, o, d, tnear, tfar, sub, mxu)[:4]
    return launch_closest(_load(table_k(wt)), wt, o, d, tnear, tfar, sub,
                         mxu, form)


def walk_sub_anyhit(wt, o, d, tnear, tfar, sub: int, mxu: bool = False, *,
                    _form=None) -> torch.Tensor:
    """Any hit of whole 64-ray tiles, each walked as `sub` groups: True =
    occluded. `mxu` as in walk_sub_closest."""
    _check(wt, o, d, tnear, tfar, sub)
    form = _resolve_form("walk_sub_anyhit", sub, _form, mxu)
    launch_geometry(sub, form, wt.n_clusters, mxu, k=table_k(wt))
    count_rays(tfar)
    if o.device.type == "cpu":
        return walk_sub_anyhit_ref(wt, o, d, tnear, tfar, sub, mxu)[0]
    return launch_anyhit(_load(table_k(wt)), wt, o, d, tnear, tfar, sub,
                         mxu, form)

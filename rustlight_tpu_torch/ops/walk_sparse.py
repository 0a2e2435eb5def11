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
the sparse branch, the rays tested and the rays flagged. The wrappers use
them only for tensors on the CPU; a CUDA tensor launches the kernel or
raises.

The kernels run in a split form by default (csrc/walk_sparse.cu): P
threads a ray, K3's split visit for a dense visit, and for a sparse one the
block's threads as SLOTS slots of P x 64 / SLOTS lanes, slot k taking the
k-th flagged ray, each lane every (P x 64 / SLOTS)-th column, merged by (t,
column); the closest hit stages its rows at the visit and the any hit
takes the ring. `PRODUCTION_FORMS` names each kernel's form,
`launch_geometry` its threads and dynamic shared memory;
`_visit_closest_sparse_split` models the closest hit's visit in torch
(tests only; the any hit's ballot is an OR of the lanes' hits, which the
serial visit's `any` is already), and `planted_tiles` makes tiles whose
visits flag exactly 16 and 17 rays (the branch's edge). The wrappers' private
`_form=ONE_THREAD_FORM` launches the one-thread-a-ray kernel instead, for
chip_smoke.py's side-by-side timing and the `cuda` tests only.

Each wrapper adds one to `LAUNCHES[name]` where it launches its kernel, and
adds the lanes it was handed with tfar > 0 to `counting_rays()`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .native import check_lib_k, count_k, count_rays, load_cuda
from .walk_sub import PlantedTables, check_resident
from .walk_trace import (_MAX_SMEM, _ROWS_STATIC_OTHERS, K, ONE_THREAD_FORM,
                         RAY_TILE, _check_arrays, _split_scan, _test_clusters,
                         _walk_ref, form_args, slot_bytes, table_k)

# a visit with at most this many flagged rays tests only those: the
# reference's SPARSE_CAP (pallas_walk.py:106); a sparse visit's slots
SPARSE_CAP = SLOTS = 16

# the split form of each kernel, (threads a ray, ring of cluster rows), the
# only one csrc/ builds beside the one-thread kernel (walk_sparse.cu:
# SPARSE_CLOSEST_P, SPARSE_CLOSEST_RING, SPARSE_ANYHIT_P,
# SPARSE_ANYHIT_RING); chosen on an H100 on grid122k's spread wavefront
# (tools/perf/split_forms.py; PERF.md section 6)
PRODUCTION_FORMS = {"walk_sparse_closest": (8, False),
                    "walk_sparse_anyhit": (8, True)}
# static shared memory as ptxas reports it: one thread a ray, the staged
# rows (walk_trace.slot_bytes(k)), the tile's rays, directions, caps, the
# slots' results and the partials (walk_trace._ROWS_STATIC_OTHERS); split,
# the same without the rows, with the ring's mbarriers and P x 2 partials
_SPLIT_STATIC_BASE = 3344

LAUNCHES = {"walk_sparse_closest": 0, "walk_sparse_anyhit": 0}

_LIBS = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind(lib):
    """Sets K7's entry points' argument types on a loaded library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rl_walk_sparse_closest.argtypes = [p, p, i, i, p, p, p, p, p, p, i,
                                           i, i, i, i, p, p, p, p, p]
    lib.rl_walk_sparse_closest.restype = i
    lib.rl_walk_sparse_anyhit.argtypes = [p, p, i, i, p, p, p, p, p, i, i,
                                          i, i, i, p, p]
    lib.rl_walk_sparse_anyhit.restype = i
    return lib


def _load(k: int = K):
    if k not in _LIBS:
        _LIBS[k] = bind(load_cuda(k))
    return _LIBS[k]


def static_smem(form, k: int = K) -> int:
    """ptxas's static shared memory of K7 in `form` at K = k, bytes."""
    p = int(form[0])
    return (slot_bytes(k) + _ROWS_STATIC_OTHERS["walk_sparse_closest"]
            if tuple(form) == ONE_THREAD_FORM else _SPLIT_STATIC_BASE + 8 * p)


def launch_geometry(name: str, form, cp: int, *, lab: bool = False,
                    k: int = K) -> Tuple[int, int]:
    """(threads a block, dynamic shared-memory bytes) of K7's kernel `name`
    in `form` (threads a ray, ring) over tables of cp clusters: the slots
    (one staged, two for the ring; none one thread a ray), then a 64-bit ray
    mask and a 4-byte entry a cluster, at K = k. Raises ValueError for a
    form not built (`lab`: any a library built with RL_LAB_FORMS holds, P =
    4 or 8) or past the card's 232,448 B a block."""
    form = (int(form[0]), bool(form[1]))
    if form not in (ONE_THREAD_FORM, PRODUCTION_FORMS[name]) and not (
            lab and form[0] in (4, 8)):
        raise ValueError(f"{name} in form {form} is not built (built: "
                         f"{ONE_THREAD_FORM}, {PRODUCTION_FORMS[name]})")
    p, ring = form
    dyn = (0 if form == ONE_THREAD_FORM else (2 if ring else 1)
           * slot_bytes(k)) + 12 * int(cp)
    if static_smem(form, k) + dyn > _MAX_SMEM:
        raise ValueError(f"{name} in form {form} needs "
                         f"{static_smem(form, k)} + {dyn} B of shared "
                         f"memory, past {_MAX_SMEM}")
    return p * RAY_TILE, dyn


def _resolve_form(name: str, form):
    """The production form, or the one-thread kernel where the private
    `form` asks for it (ONE_THREAD_FORM, the only value it takes)."""
    if form is not None and tuple(form) != ONE_THREAD_FORM:
        raise ValueError(f"_form takes only {ONE_THREAD_FORM}, got {form}")
    return ONE_THREAD_FORM if form is not None else PRODUCTION_FORMS[name]


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


def _slot_lanes(p: int) -> int:
    """A sparse visit's lanes a slot at p threads a ray."""
    return p * RAY_TILE // SLOTS


def _visit_closest_sparse_split(rows, ids, csel, o, d, tnear, best, tested,
                                p: int):
    """walk_trace._visit_closest with `tested` [A, R] as the split form
    computes it (tests only): a tile testing at most SLOTS rays (a sparse
    visit) scans each with _slot_lanes(p) lanes, lane q the columns q, q +
    lanes, ..., a tile testing all its rays (a dense one) with p lanes; then
    the (t, column) butterfly over the lanes (ops/walk_trace.py:
    _split_scan). Only tested rays take a hit."""
    bt, bi, bu, bv = best
    t, u, v, valid = _test_clusters(rows[csel], o, d, tnear,
                                    torch.full_like(bt, float("inf")))
    sparse = tested.sum(dim=1) <= SLOTS
    j = torch.where(sparse[:, None], _split_scan(t, valid, bt,
                                                 _slot_lanes(p))[1],
                    _split_scan(t, valid, bt, p)[1])
    k = rows.shape[1]
    better = (j < k) & tested
    jc = torch.clamp(j, max=k - 1)
    tri = ids[csel[:, None], jc]
    tj = t.gather(-1, jc[..., None])[..., 0]
    uj = u.gather(-1, jc[..., None])[..., 0] + 0.0
    vj = v.gather(-1, jc[..., None])[..., 0] + 0.0
    return (torch.where(better, tj, bt), torch.where(better, tri, bi),
            torch.where(better, uj, bu), torch.where(better, vj, bv))


PLANTED_BANDS = (16, 17, 31)


def planted_tiles(device="cpu", tiles: int = 4, seed: int = 0):
    """Tiles whose visits flag exactly 16 and 17 rays, the sparse branch's
    edge: three clusters of K small triangles side by side in x (bands of
    width 0.5, one box each, z in [1, 1.3]), each with ties planted (a
    triangle copied to a column in another lane at P = 4 and 8, and a quad
    cut along its diagonal). Every tile's rays run along +z, the first 16
    inside cluster 0's band, the next 17 inside cluster 1's and the last 31
    inside cluster 2's, each aimed at a triangle of its band (a planted tie
    for a third of them), so that a visit of cluster 0 is sparse with 16
    flagged rays and one of cluster 1 dense with 17. From the second tile
    on, some of the last band's rays are inert (tfar = 0), empty (tnear >=
    tfar) or bounded. Returns (tables, [o, d, tnear, tfar])."""
    from .dense_trace import _bw_rows
    rng = np.random.default_rng(seed)
    nc = len(PLANTED_BANDS)
    x0 = np.array([-0.9, -0.2, 0.5], np.float32)
    cen = np.stack([rng.uniform(0.05, 0.45, (nc, K)) + x0[:, None],
                    rng.uniform(-0.2, 0.2, (nc, K)),
                    rng.uniform(1.0, 1.3, (nc, K))], -1).astype(np.float32)
    off = [rng.uniform(-0.04, 0.04, cen.shape).astype(np.float32)
           for _ in range(3)]
    p = [cen + x for x in off]
    aims = [[] for _ in range(nc)]
    for c in range(nc):
        for a, b in ((3, 4), (10, 12), (20, 24), (40, 48), (101, 357),
                     (7, 40)):
            for q in p:
                q[c, b] = q[c, a]
            aims[c].append(sum(q[c, a] for q in p) / 3)
        # a quad at z = 1.15 cut along its diagonal, columns 200 and 201
        mx, my = x0[c] + 0.25, 0.0
        quad = np.array([[mx - .03, my - .03, 1.15],
                         [mx + .03, my - .03, 1.15],
                         [mx + .03, my + .03, 1.15],
                         [mx - .03, my + .03, 1.15]], np.float32)
        for q, (i0, i1) in zip(p, ((0, 0), (1, 2), (2, 3))):
            q[c, 200], q[c, 201] = quad[i0], quad[i1]
        aims[c].append((quad[0] + quad[2]) / 2)
    n = tiles * RAY_TILE
    lane = np.arange(n) % RAY_TILE
    band = np.searchsorted(np.cumsum(PLANTED_BANDS), lane, side="right")
    target = np.empty((n, 3), np.float32)
    for i in range(n):
        c = band[i]
        if i % 3 == 0:
            target[i] = aims[c][rng.integers(0, len(aims[c]))]
        else:
            j = rng.integers(0, K)
            target[i] = sum(q[c, j] for q in p) / 3
    o = target.copy()
    o[:, 2] = -2.0
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    tnear = np.full(n, 1e-4, np.float32)
    tfar = np.full(n, np.inf, np.float32)
    tile = np.arange(n) // RAY_TILE
    last = (band == nc - 1) & (tile > 0)
    tfar[last & (lane % 7 == 1)] = 0.0
    tnear[last & (lane % 7 == 3)], tfar[last & (lane % 7 == 3)] = 5.0, 4.0
    tfar[last & (lane % 7 == 5)] = rng.uniform(3.0, 3.2, (
        last & (lane % 7 == 5)).sum())
    pts = np.stack(p)                                    # [3, nc, K, 3]
    tt = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=device)
    wt = PlantedTables(nc, nc, tt(pts.min(axis=(0, 2)).T),
                       tt(pts.max(axis=(0, 2)).T),
                       tt(_bw_rows(*(q.reshape(-1, 3) for q in p))
                          .astype(np.float32)),
                       tt(np.arange(nc * K, dtype=np.int32)))
    return wt, [tt(x) for x in (o, d, tnear, tfar)]


# ------------------------------------------------------------------ wrappers

def launch_closest(lib, wt, o, d, tnear, tfar, form, lab: bool = False):
    """Launches K7's closest hit on checked CUDA tensors in `form` through
    library `lib` (bound by `bind`; `lab` a form only a library built with
    RL_LAB_FORMS holds; built for the tables' K): (t, tri, u, v)."""
    check_lib_k(lib, table_k(wt), "walk_sparse_closest")
    smem = launch_geometry("walk_sparse_closest", form, wt.n_clusters,
                           lab=lab, k=table_k(wt))[1]
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        with torch.cuda.device(o.device):
            err = lib.rl_walk_sparse_closest(
                wt.lo.data_ptr(), wt.hi.data_ptr(), int(wt.n_clusters),
                int(wt.n_real), wt.rows.data_ptr(), wt.ids.data_ptr(),
                o.data_ptr(), d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(),
                n, SPARSE_CAP, *form_args(form, smem), t.data_ptr(),
                tri.data_ptr(), u.data_ptr(), v.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"walk_sparse_closest in form {tuple(form)} "
                               f"launch failed: CUDA error {err}")
        if not lab:
            LAUNCHES["walk_sparse_closest"] += 1
            count_k("walk_sparse_closest", table_k(wt))
    return t, tri, u, v


def launch_anyhit(lib, wt, o, d, tnear, tfar, form, lab: bool = False):
    """The same for K7's any hit: occ."""
    check_lib_k(lib, table_k(wt), "walk_sparse_anyhit")
    smem = launch_geometry("walk_sparse_anyhit", form, wt.n_clusters,
                           lab=lab, k=table_k(wt))[1]
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        with torch.cuda.device(o.device):
            err = lib.rl_walk_sparse_anyhit(
                wt.lo.data_ptr(), wt.hi.data_ptr(), int(wt.n_clusters),
                int(wt.n_real), wt.rows.data_ptr(), o.data_ptr(),
                d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(), n,
                SPARSE_CAP, *form_args(form, smem), occ.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"walk_sparse_anyhit in form {tuple(form)} "
                               f"launch failed: CUDA error {err}")
        if not lab:
            LAUNCHES["walk_sparse_anyhit"] += 1
            count_k("walk_sparse_anyhit", table_k(wt))
    return occ


def walk_sparse_closest(wt, o, d, tnear, tfar, *,
                        _form=None) -> Tuple[torch.Tensor, ...]:
    """Closest hit of whole 64-ray tiles (o, d [n, 3], tnear, tfar [n]) over
    walk tables `wt`, sparse visits: (t, tri, u, v), each [n]."""
    _check(wt, o, d, tnear, tfar)
    form = _resolve_form("walk_sparse_closest", _form)
    launch_geometry("walk_sparse_closest", form, wt.n_clusters,
                    k=table_k(wt))
    count_rays(tfar)
    if o.device.type == "cpu":
        return walk_sparse_closest_ref(wt, o, d, tnear, tfar)[:4]
    return launch_closest(_load(table_k(wt)), wt, o, d, tnear, tfar, form)


def walk_sparse_anyhit(wt, o, d, tnear, tfar, *, _form=None) -> torch.Tensor:
    """Any hit of whole 64-ray tiles over walk tables, sparse visits: True =
    occluded."""
    _check(wt, o, d, tnear, tfar)
    form = _resolve_form("walk_sparse_anyhit", _form)
    launch_geometry("walk_sparse_anyhit", form, wt.n_clusters,
                    k=table_k(wt))
    count_rays(tfar)
    if o.device.type == "cpu":
        return walk_sparse_anyhit_ref(wt, o, d, tnear, tfar)[0]
    return launch_anyhit(_load(table_k(wt)), wt, o, d, tnear, tfar, form)

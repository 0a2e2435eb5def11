"""Ray-cluster pair closest-hit and any-hit kernels (K8): wrappers and plain
PyTorch versions.

The CUDA kernels (csrc/pair_trace.cu) replace the TPU kernels
rustlight_tpu/accel/pair_walk.py:_pair_closest_kernel and
:_pair_anyhit_kernel. They are built by ops/native.py and called through
ctypes on PyTorch's current stream.

A pair is one ray and one cluster id: the kernels give each pair the ray's
closest hit (or whether it has any hit) among that cluster's K (wt.k)
triangles, with t in (tnear, tcap); the lowest column wins among equal t.
Pairs whose id lies outside [0, n_real) are inert and report a miss. The
shortlist that makes the pairs, the per-ray reduce and the re-trace of
overflowing rays are accel/pair_walk.py. The plain versions test every
live pair against its gathered cluster in batched torch ops, with the same
arithmetic as the kernels, so the kernels are bit-identical to them; they
also return the number of live pairs. The wrappers use them only for
tensors on the CPU; a CUDA tensor launches the kernel or raises.

The kernels run in a split form (`PRODUCTION_FORM`: P threads a pair): the
wrapper sorts the live pairs by cluster id on the device and lays them out
in runs of RUN = 64 of one cluster (`_cluster_runs`); a block takes a run,
stages its cluster's rows once and tests them with P threads a pair, and
writes each pair's result in its own place; the inert pairs keep the miss
the wrapper filled in. `launch_geometry` gives a form's threads and
dynamic shared memory; `pair_split_model` models the form's order of work
in torch (tests only). The laboratory forms (`LAB_FORMS`, `LAB_MMA_FORMS`,
built only with RL_LAB_FORMS: tools/perf/split_forms.py) are reached
through `launch_split`.

With `mxu=True` the test takes the tensor-core form (ops/walk_trace.py,
csrc/tri_test_mma.cuh) in the same layout, split over the P warps of each
32-pair set by column blocks (`MMA_FORM`). These kernels count as
`<name>_mma`; their plain version forms the products with torch.matmul.

The wrappers' private `_form=ONE_THREAD_FORM` launches the parent's
kernels instead, the yardstick of chip_smoke.py's side-by-side timing and
of the `cuda` tests: the `_dot4` test a warp a pair in the pairs' own
order, and the tensor-core test one thread a pair over runs of 32 (a warp
a run). No path of the package passes it.

Each wrapper adds one to `LAUNCHES[name]` where it launches its kernel,
and to `P1_LAUNCHES[name]` too where that is a parent's kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .native import check_lib_k, count_k, load_cuda
from .walk_sub import check_resident
from .walk_trace import (K, ONE_THREAD_FORM, _test_clusters,
                         _visit_anyhit_split, _visit_closest_split, load_for,
                         mma_scratch_bytes, slot_bytes, table_k)

PAIR_TILE = 64
_PAIR_CHUNK = 4096     # live pairs per [chunk, K, 3, 4] gather of rows

LAUNCHES = {"pair_closest": 0, "pair_anyhit": 0,
            "pair_closest_mma": 0, "pair_anyhit_mma": 0}
P1_LAUNCHES = dict(LAUNCHES)
RUN = 64               # pairs of one cluster a block of the split form takes
_RUN = 32              # pairs of one cluster the parent's TC warp scans
# a split form: (threads a pair, runs a block, ring of rows). The ones this
# library builds (csrc/pair_trace.cu: PAIR_P for the _dot4 test, PAIR_MMA_P
# for the tensor-core one: P warps a 32-pair set; one run a block, the rows
# staged), and the laboratory's: for the _dot4 test P = 4; 4 runs a block,
# copying only when the cluster changes; the same with a two-slot ring that
# copies the next run's cluster during the current one; for the
# tensor-core test P = 8, 4, 2, 1
PRODUCTION_FORM = (8, 1, False)
MMA_FORM = (2, 1, False)
LAB_FORMS = ((4, 1, False), (8, 4, False), (8, 4, True))
LAB_MMA_FORMS = tuple((p, 1, False) for p in (8, 4, 2, 1)
                      if (p, 1, False) != MMA_FORM)
# ptxas's static shared memory of every split form: two mbarriers
SPLIT_STATIC = 16

_LIBS = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        P1_LAUNCHES[k] = 0


def bind(lib):
    """Sets the pair kernels' entry points' argument types on a loaded
    library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rl_pair_closest.argtypes = [i, p, p, p, p, p, p, p, i, p, p, p, p, p]
    lib.rl_pair_closest.restype = i
    lib.rl_pair_anyhit.argtypes = [i, p, p, p, p, p, p, i, p, p]
    lib.rl_pair_anyhit.restype = i
    lib.rl_pair_mma.argtypes = [i, p, p, p, p, p, p, p, p, i, p, p, p, p, p,
                                p]
    lib.rl_pair_mma.restype = i
    lib.rl_pair_split.argtypes = [i, i, i, i, i, i, p, p, p, p, p, p, p, p,
                                  i, p, p, p, p, p, p]
    lib.rl_pair_split.restype = i
    return lib


def _load(k: int = K):
    if k not in _LIBS:
        _LIBS[k] = bind(load_cuda(k))
    return _LIBS[k]


def launch_geometry(form, mxu: bool = False, *, lab: bool = False,
                    k: int = K):
    """(threads a block, dynamic shared-memory bytes) of the split form
    `form` (threads a pair, runs a block, ring): the rows' slots (two with
    the ring) at K = k, with `mxu` the split tensor-core visit's scratch.
    Raises
    ValueError for a form not built: PRODUCTION_FORM, or MMA_FORM with
    `mxu`, and with `lab` the LAB_FORMS (or LAB_MMA_FORMS) that a library
    built with RL_LAB_FORMS holds."""
    form = tuple(form)
    built = ((MMA_FORM,) + (LAB_MMA_FORMS if lab else ()) if mxu
             else (PRODUCTION_FORM,) + (LAB_FORMS if lab else ()))
    if form not in built:
        raise ValueError(f"the pair kernels in form {form}"
                         f"{' with mxu' if mxu else ''} are not built "
                         f"(built: {', '.join(map(str, built))})")
    p, _, ring = form
    return p * RUN, ((2 if ring else 1) * slot_bytes(k)
                     + (mma_scratch_bytes(p) if mxu else 0))


def _resolve_form(form, mxu: bool = False):
    """The form a launch takes: the parent's kernels where the private
    `form` asks for them (ONE_THREAD_FORM, the only value it takes), else
    PRODUCTION_FORM, or MMA_FORM with `mxu`."""
    if form is None:
        return MMA_FORM if mxu else PRODUCTION_FORM
    if tuple(form) != ONE_THREAD_FORM:
        raise ValueError(f"_form takes only {ONE_THREAD_FORM}, got {form}")
    return ONE_THREAD_FORM


def _check(wt, o, d, tnear, tcap, cid) -> None:
    check_resident(wt, "the pair walk")
    cp, k = int(wt.n_clusters), table_k(wt)
    m = o.shape[0]
    if m % PAIR_TILE:
        raise ValueError(f"{m} pairs: the kernels take whole {PAIR_TILE}-pair "
                         "tiles")
    dev = o.device
    for name, x, shape, dtype in (
            ("rows", wt.rows, (cp * k, 3, 4), torch.float32),
            ("ids", wt.ids, (cp * k,), torch.int32),
            ("o", o, (m, 3), torch.float32), ("d", d, (m, 3), torch.float32),
            ("tnear", tnear, (m,), torch.float32),
            ("tcap", tcap, (m,), torch.float32),
            ("cid", cid, (m,), torch.int32)):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, o on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and wt.rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")


# ------------------------------------------------------------ plain versions

def _pair_chunks(wt, o, d, tnear, tcap, cid, mxu=False):
    """Yields (pair indices, (t, u, v, valid) [A, K]) over the live pairs
    in chunks."""
    rows = wt.rows.view(int(wt.n_clusters), table_k(wt), 3, 4)
    live = torch.nonzero((cid >= 0) & (cid < int(wt.n_real)))[:, 0]
    for s in range(0, live.numel(), _PAIR_CHUNK):
        k = live[s:s + _PAIR_CHUNK]
        t, u, v, valid = _test_clusters(rows[cid[k].long()], o[k, None],
                                        d[k, None], tnear[k, None],
                                        tcap[k, None], mxu)
        yield k, (t[:, 0], u[:, 0], v[:, 0], valid[:, 0])


def pair_closest_ref(wt, o, d, tnear, tcap, cid, mxu: bool = False):
    """Plain version of the pair closest hit: (t, tri, u, v, live pairs);
    t = inf and tri = -1 (u = v = 0) on a miss."""
    m = o.shape[0]
    bt = torch.full((m,), float("inf"), device=o.device)
    bi = torch.full((m,), -1, dtype=torch.int32, device=o.device)
    bu = torch.zeros(m, device=o.device)
    bv = torch.zeros(m, device=o.device)
    nk = table_k(wt)
    ids = wt.ids.view(int(wt.n_clusters), nk)
    kiota = torch.arange(nk, device=o.device)
    n_live = 0
    for k, (t, u, v, valid) in _pair_chunks(wt, o, d, tnear, tcap, cid, mxu):
        n_live += k.numel()
        tm = torch.where(valid, t, float("inf"))
        ct = tm.amin(dim=1)
        j = torch.clamp(torch.where(tm == ct[:, None], kiota, nk).amin(dim=1),
                        max=nk - 1)
        hit = ct < tcap[k]
        bt[k] = torch.where(hit, ct, float("inf"))
        bi[k] = torch.where(hit, ids[cid[k].long(), j], -1)
        # + 0 maps a -0 barycentric to +0, as the kernel's output does
        bu[k] = torch.where(hit, u.gather(1, j[:, None])[:, 0] + 0.0, 0.0)
        bv[k] = torch.where(hit, v.gather(1, j[:, None])[:, 0] + 0.0, 0.0)
    return bt, bi, bu, bv, n_live


def pair_anyhit_ref(wt, o, d, tnear, tfar, cid, mxu: bool = False):
    """Plain version of the pair any hit: (occ, live pairs)."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    n_live = 0
    for k, (_, _, _, valid) in _pair_chunks(wt, o, d, tnear, tfar, cid, mxu):
        n_live += k.numel()
        occ[k] = valid.any(dim=1)
    return occ, n_live


# ------------------------------------------------------------------ wrappers

def _cluster_runs(n_real: int, cid, run: int = _RUN):
    """The layout of the split and tensor-core kernels: the live pairs
    sorted by cluster id (stable), each cluster's pairs padded to whole runs
    of `run` slots (RUN for the split form, _RUN for the parent's
    tensor-core kernel): perm [S] int32, the pair in each slot or -1. S is
    the bound m + (run - 1) * n_real rounded up to whole tiles, so that no
    size is read back to the host. Few launches: the wrappers call it on
    every launch."""
    m, dev = cid.shape[0], cid.device
    n_slots = -(-(m + (run - 1) * n_real) // PAIR_TILE) * PAIR_TILE
    # as unsigned, inert ids (negative, or n_real and past) sort after the
    # real ones
    ks, order = torch.sort(cid.long() & 0xFFFFFFFF, stable=True)
    # start[c]: the first sorted pair of cluster c; start[n_real]: the live
    # pairs
    start = torch.searchsorted(ks, torch.arange(n_real + 1, device=dev))
    counts = start.diff()
    pad = (counts + run - 1) // run * run - counts
    # a live pair's slot: its sorted place plus the pads of the clusters
    # before its own
    shift = torch.cumsum(pad, 0) - pad
    slot = torch.arange(m, device=dev) + shift[ks.clamp(max=n_real - 1)]
    # inert pairs go to one slot past the end, which is dropped
    slot = torch.where(ks < n_real, slot, n_slots)
    perm = torch.full((n_slots + 1,), -1, dtype=torch.int32, device=dev)
    perm[slot] = order.int()
    return perm[:n_slots]


def _miss(m, dev):
    """Outputs that report a miss on every pair: (t, tri, u, v), occ."""
    return ((torch.full((m,), float("inf"), device=dev),
             torch.full((m,), -1, dtype=torch.int32, device=dev),
             torch.zeros(m, device=dev), torch.zeros(m, device=dev)),
            torch.zeros(m, dtype=torch.bool, device=dev))


def _raise(err, name, form):
    if err:
        raise RuntimeError(f"{name} in form {tuple(form)} launch failed: "
                           f"CUDA error {err}")


def launch_split(lib, any_hit: bool, wt, o, d, tnear, tcap, cid, form,
                 mxu: bool = False, lab: bool = False, perm=None):
    """The split kernels in `form` on checked CUDA tensors through library
    `lib` (bound by `bind`, built for the tables' K): (t, tri, u, v) or
    occ. `lab`: a form only a
    library built with RL_LAB_FORMS holds (tools/perf/split_forms.py), not
    counted; `perm`: the layout in runs of RUN, if made already (the lab's
    timing of the kernel alone)."""
    m, dev = o.shape[0], o.device
    (t, tri, u, v), occ = _miss(m, dev)
    name = ("pair_anyhit" if any_hit else "pair_closest") + (
        "_mma" if mxu else "")
    check_lib_k(lib, table_k(wt), name)
    _, smem = launch_geometry(form, mxu, lab=lab, k=table_k(wt))
    if m:
        with torch.cuda.device(dev):
            if perm is None:
                perm = _cluster_runs(int(wt.n_real), cid, RUN)
            p, runs, ring = form
            err = lib.rl_pair_split(
                int(any_hit), int(mxu), p, runs, int(ring), smem,
                wt.rows.data_ptr(), wt.ids.data_ptr(), o.data_ptr(),
                d.data_ptr(), tnear.data_ptr(), tcap.data_ptr(),
                cid.data_ptr(), perm.data_ptr(), perm.shape[0], t.data_ptr(),
                tri.data_ptr(), u.data_ptr(), v.data_ptr(), occ.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        _raise(err, name, form)
        if not lab:
            LAUNCHES[name] += 1
            count_k(name, table_k(wt))
    return occ if any_hit else (t, tri, u, v)


def _pair_mma_parent(wt, o, d, tnear, tcap, cid, any_hit: bool, perm=None):
    """The parent's tensor-core kernel (a thread a pair over runs of _RUN):
    (t, tri, u, v) or occ; `perm` as in launch_split, in runs of _RUN."""
    m, dev = o.shape[0], o.device
    (t, tri, u, v), occ = _miss(m, dev)
    name = ("pair_anyhit" if any_hit else "pair_closest") + "_mma"
    if not m:
        return occ if any_hit else (t, tri, u, v)
    with torch.cuda.device(dev):
        if perm is None:
            perm = _cluster_runs(int(wt.n_real), cid)
        err = load_for(wt, name, _load).rl_pair_mma(
            int(any_hit), wt.rows.data_ptr(), wt.ids.data_ptr(), o.data_ptr(),
            d.data_ptr(), tnear.data_ptr(), tcap.data_ptr(), cid.data_ptr(),
            perm.data_ptr(), perm.shape[0], t.data_ptr(), tri.data_ptr(),
            u.data_ptr(), v.data_ptr(), occ.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise(err, name, ONE_THREAD_FORM)
    LAUNCHES[name] += 1
    P1_LAUNCHES[name] += 1
    count_k(name, table_k(wt))
    return occ if any_hit else (t, tri, u, v)


def _pair_dot4_parent(wt, o, d, tnear, tcap, cid, any_hit: bool):
    """The parent's _dot4 kernels (a warp a pair, in the pairs' order):
    (t, tri, u, v) or occ."""
    m, dev = o.shape[0], o.device
    name = "pair_anyhit" if any_hit else "pair_closest"
    if any_hit:
        outs = (torch.empty(m, dtype=torch.bool, device=dev),)
    else:
        outs = (torch.empty(m, device=dev),
                torch.empty(m, dtype=torch.int32, device=dev),
                torch.empty(m, device=dev), torch.empty(m, device=dev))
    if m:
        lib = load_for(wt, name, _load)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            if any_hit:
                err = lib.rl_pair_anyhit(
                    int(wt.n_real), wt.rows.data_ptr(), o.data_ptr(),
                    d.data_ptr(), tnear.data_ptr(), tcap.data_ptr(),
                    cid.data_ptr(), m, outs[0].data_ptr(), stream)
            else:
                err = lib.rl_pair_closest(
                    int(wt.n_real), wt.rows.data_ptr(), wt.ids.data_ptr(),
                    o.data_ptr(), d.data_ptr(), tnear.data_ptr(),
                    tcap.data_ptr(), cid.data_ptr(), m,
                    *(x.data_ptr() for x in outs), stream)
        _raise(err, name, ONE_THREAD_FORM)
        LAUNCHES[name] += 1
        P1_LAUNCHES[name] += 1
        count_k(name, table_k(wt))
    return outs[0] if any_hit else outs


def _pair_launch(wt, o, d, tnear, tcap, cid, any_hit, mxu, form):
    if form == ONE_THREAD_FORM:
        parent = _pair_mma_parent if mxu else _pair_dot4_parent
        return parent(wt, o, d, tnear, tcap, cid, any_hit)
    return launch_split(_load(table_k(wt)), any_hit, wt, o, d, tnear, tcap,
                        cid, form, mxu)


def pair_closest(wt, o, d, tnear, tcap, cid, mxu: bool = False, *,
                 _form=None) -> Tuple[torch.Tensor, ...]:
    """Closest hit of each pair (o, d [m, 3]; tnear, tcap [m]; cid [m]
    int32) inside its cluster of walk tables `wt`: (t, tri, u, v). `mxu`
    takes the tensor-core form of the triangle test."""
    _check(wt, o, d, tnear, tcap, cid)
    form = _resolve_form(_form, mxu)
    if o.device.type == "cpu":
        return pair_closest_ref(wt, o, d, tnear, tcap, cid, mxu)[:4]
    return _pair_launch(wt, o, d, tnear, tcap, cid, False, mxu, form)


def pair_anyhit(wt, o, d, tnear, tfar, cid, mxu: bool = False, *,
                _form=None) -> torch.Tensor:
    """Any hit of each pair inside its cluster: True = occluded. `mxu` as
    in pair_closest."""
    _check(wt, o, d, tnear, tfar, cid)
    form = _resolve_form(_form, mxu)
    if o.device.type == "cpu":
        return pair_anyhit_ref(wt, o, d, tnear, tfar, cid, mxu)[0]
    return _pair_launch(wt, o, d, tnear, tfar, cid, True, mxu, form)


# ------------------------------------------------------- split order of work

def pair_split_model(wt, o, d, tnear, tcap, cid, p: int, any_hit: bool):
    """The split form's order of work in torch (tests only): the layout of
    _cluster_runs in runs of RUN, each run's pairs tested against its one
    cluster by the split visit at p threads a pair
    (ops/walk_trace.py:_visit_closest_split, _visit_anyhit_split; a pad
    slot takes the run's first pair's ray with no cap), each result written
    to its own pair and a miss everywhere else: (t, tri, u, v) or occ, as
    pair_closest / pair_anyhit."""
    m, dev = o.shape[0], o.device
    (t, tri, u, v), occ = _miss(m, dev)
    cp, nk = int(wt.n_clusters), table_k(wt)
    runs = _cluster_runs(int(wt.n_real), cid, RUN).view(-1, RUN)
    runs = runs[runs[:, 0] >= 0].long()
    lead = runs[:, :1]
    slot = torch.where(runs >= 0, runs, lead)
    csel = cid[lead[:, 0]].long()
    ro, rd, rn = o[slot], d[slot], tnear[slot]
    cap = torch.where(runs >= 0, tcap[slot], float("-inf"))
    rows = wt.rows.view(cp, nk, 3, 4)
    real = runs >= 0
    if any_hit:
        hit = _visit_anyhit_split(rows, csel, ro, rd, rn, cap,
                                  torch.zeros_like(real), p)
        occ[runs[real]] = hit[real]
        return occ
    best = (cap, torch.full(cap.shape, -1, dtype=torch.int32, device=dev),
            torch.zeros_like(cap), torch.zeros_like(cap))
    bt, bi, bu, bv = _visit_closest_split(rows, wt.ids.view(cp, nk), csel,
                                          ro, rd, rn, best, p)
    k = runs[real]
    hit = bi[real] >= 0
    t[k] = torch.where(hit, bt[real], float("inf"))
    tri[k] = bi[real]
    # + 0 maps a -0 barycentric to +0, as the kernel's output does
    u[k] = bu[real] + 0.0
    v[k] = bv[real] + 0.0
    return t, tri, u, v

"""Two-level tile-walk closest-hit and any-hit kernels (K5): wrappers and
plain PyTorch versions.

The CUDA kernels (csrc/walk_hier.cu) replace the TPU kernels
rustlight_tpu/accel/pallas_walk.py:_closest_kernel_hbm_hier and
:_anyhit_kernel_hbm_hier, with :_child_entries. They are built by
ops/native.py and called through ctypes on PyTorch's current stream.

They take what the one-level walk (ops/walk_trace.py) takes, whole 64-ray
tiles in the caller's order, over walk tables that also carry the super
tables (accel/walk.py: WalkTables): SUP = 128 consecutive clusters per
super. Per tile: packed super entries from a slab pass over the supers;
each popped super opens lazily, its 128 child entries capped per ray by the
ray's current best t (any hit: by tfar, or 0 once occluded) and packed with
7 id bits; its children are popped front to back, two visits per
termination check; then the next super. The plain versions run that walk
for all tiles at once in batched torch ops, with the same arithmetic as the
kernels, so the kernels are bit-identical to them; they also return the
supers opened and the clusters visited per tile. The wrappers use them only
for tensors on the CPU; a CUDA tensor launches the kernel or raises.

With `mxu=True` a visit takes the tensor-core form of the triangle test (see
ops/walk_trace.py), not bit-identical; those kernels count as `<name>_mma`.
The default kernels run in a split form of ops/walk_trace.py (P threads a
ray, the rows staged at the visit: PRODUCTION_FORMS), with either test (the
tensor-core visit split over the P warps of each 32-ray set by column
blocks); the private `_form=ONE_THREAD_FORM` launches the one-thread-a-ray
kernel, for chip_smoke.py's side-by-side timing and the `cuda` tests only.

Each wrapper adds one to `LAUNCHES[name]` where it launches its kernel, and
to `P1_LAUNCHES[name]` too where that is the one-thread kernel, and adds
the lanes it was handed with tfar > 0 to `counting_rays()`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .native import count_k, count_rays, load_cuda
from .walk_trace import (K, _ID_BITS, _ID_MASK, _check_arrays, _min_entry,
                         _pack_entries, _pop_min, _resolve_form, _slab_inv,
                         _sortable_max, _tile_entries, _tiled, _visit_anyhit,
                         _visit_closest, ONE_THREAD_FORM, form_args,
                         launch_geometry, load_for, table_k)

# clusters per super and the child-id bits of a packed child entry: the
# reference's SUP and _CHILD_BITS (pallas_walk.py:74-75)
SUP = 128
_CHILD_BITS = 7
_CHILD_MASK = (1 << _CHILD_BITS) - 1
MAX_CLUSTERS = 1 << 17

LAUNCHES = {"walk_hier_closest": 0, "walk_hier_anyhit": 0,
            "walk_hier_closest_mma": 0, "walk_hier_anyhit_mma": 0}
P1_LAUNCHES = dict(LAUNCHES)

_LIBS = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        P1_LAUNCHES[k] = 0


def _count(name: str, form, wt) -> None:
    LAUNCHES[name] += 1
    count_k(name, table_k(wt))
    if tuple(form) == ONE_THREAD_FORM:
        P1_LAUNCHES[name] += 1


def _load(k: int = K):
    if k not in _LIBS:
        lib = load_cuda(k)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rl_walk_hier_closest.argtypes = [p, p, i, i, p, p, i, i, p, p, p,
                                             p, p, p, i, i, i, i, i, p, p, p,
                                             p, p]
        lib.rl_walk_hier_closest.restype = i
        lib.rl_walk_hier_anyhit.argtypes = [p, p, i, i, p, p, i, i, p, p, p,
                                            p, p, i, i, i, i, i, p, p]
        lib.rl_walk_hier_anyhit.restype = i
        _LIBS[k] = lib
    return _LIBS[k]


def _check(wt, o, d, tnear, tfar) -> None:
    cp, c = int(wt.n_clusters), int(wt.n_real)
    ns, sp = int(wt.n_sup), int(wt.n_sup_pad)
    if not 0 < c <= cp <= MAX_CLUSTERS:
        raise ValueError(f"walk tables with {c} real of {cp} clusters (the "
                         f"two-level walk takes at most {MAX_CLUSTERS})")
    if ns != -(-c // SUP) or sp % 128 or not ns <= sp <= 1 << _ID_BITS:
        raise ValueError(f"{ns} real of {sp} supers do not fit {c} clusters "
                         f"in groups of {SUP}")
    _check_arrays(wt, o, d, tnear, tfar,
                  extra=(("slo", wt.slo, (3, sp), torch.float32),
                         ("shi", wt.shi, (3, sp), torch.float32)))


# ------------------------------------------------------------ plain versions

def _child_entries(wt, base, o, inv, tnear, cap):
    """Packed entries [A, SUP] of the children base + l of the supers that
    A tiles open (o, inv [A, R, 3]; tnear, cap [A, R]): each ray's slab
    entry counted where it is below its cap, the local child id in the low
    _CHILD_BITS, _INF_BITS for pads and children no ray enters."""
    gid = base[:, None] + torch.arange(SUP, device=o.device)      # [A, SUP]
    idx = torch.clamp(gid, max=int(wt.n_clusters) - 1)
    lo = wt.lo[:, idx][:, :, None, :]                             # [3, A, 1, SUP]
    hi = wt.hi[:, idx][:, :, None, :]
    ent = _min_entry(lo, hi, o, inv, tnear, cap)
    return _pack_entries(ent, gid < int(wt.n_real), _CHILD_MASK)


def _thresh(best, tfar, any_hit):
    """Block max of best-t bits; any hit: of (occ ? 0 : tfar) bits."""
    if any_hit:
        return _sortable_max(torch.where(best[0], 0.0, tfar))
    return _sortable_max(best[0])


def _walk_hier_chunk(wt, rows, ids, o, d, tnear, tfar, any_hit, mxu=False):
    g = o.shape[0]
    dev = o.device
    sp, n_real = int(wt.n_sup_pad), int(wt.n_real)
    inv = _slab_inv(d)
    sent = _tile_entries(wt.slo, wt.shi, wt.n_sup, o, d, tnear, tfar)
    semin, ssel, sent = _pop_min(sent)
    if any_hit:
        best = (torch.zeros(tfar.shape, dtype=torch.bool, device=dev),)
    else:
        best = (tfar.clone(),
                torch.full(tfar.shape, -1, dtype=torch.int32, device=dev),
                torch.zeros_like(tfar), torch.zeros_like(tfar))
    thresh = _thresh(best, tfar, any_hit)
    opened = torch.zeros(g, dtype=torch.int64, device=dev)
    pairs = torch.zeros(g, dtype=torch.int64, device=dev)

    def visit(csel, o, d, tnear, tfar, best):
        if any_hit:
            return (_visit_anyhit(rows, csel, o, d, tnear, tfar, best[0],
                                  mxu=mxu),)
        return _visit_closest(rows, ids, csel, o, d, tnear, best, mxu=mxu)

    while True:
        act = torch.nonzero(((semin & ~_ID_MASK) < thresh)
                            & (opened < sp))[:, 0]
        if act.numel() == 0:
            break
        a_o, a_d, a_tn, a_tf = o[act], d[act], tnear[act], tfar[act]
        a_best = tuple(x[act] for x in best)
        # open the popped supers: child entries capped by the current best
        base = ssel[act] * SUP
        cap = torch.where(a_best[0], 0.0, a_tf) if any_hit else a_best[0]
        cent = _child_entries(wt, base, a_o, inv[act], a_tn, cap)
        cemin, lsel, cent = _pop_min(cent, _CHILD_MASK)
        csel = torch.clamp(base + lsel, max=n_real - 1)
        th = thresh[act]
        ni = torch.zeros(act.numel(), dtype=torch.int64, device=dev)
        while True:
            cact = torch.nonzero(((cemin & ~_CHILD_MASK) < th)
                                 & (ni < SUP))[:, 0]
            if cact.numel() == 0:
                break
            c_o, c_d, c_tn, c_tf = a_o[cact], a_d[cact], a_tn[cact], a_tf[cact]
            c_best = tuple(x[cact] for x in a_best)
            c_ent, c_emin, c_csel = cent[cact], cemin[cact], csel[cact]
            c_base = base[cact]
            for _ in range(2):
                c_best = visit(c_csel, c_o, c_d, c_tn, c_tf, c_best)
                c_emin, c_lsel, c_ent = _pop_min(c_ent, _CHILD_MASK)
                # an exhausted heap re-tests child `base`, as the reference
                c_csel = torch.clamp(c_base + c_lsel, max=n_real - 1)
            cent[cact], cemin[cact], csel[cact] = c_ent, c_emin, c_csel
            for x, y in zip(a_best, c_best):
                x[cact] = y
            ni[cact] += 1
            th[cact] = _thresh(c_best, c_tf, any_hit)
        for x, y in zip(best, a_best):
            x[act] = y
        pairs[act] += ni
        opened[act] += 1
        semin[act], ssel[act], sent[act] = _pop_min(sent[act])
        thresh[act] = _thresh(a_best, a_tf, any_hit)
    if any_hit:
        return best, opened, 2 * pairs
    best_t, best_i, best_u, best_v = best
    hit = best_i >= 0
    return ((torch.where(hit, best_t, float("inf")), best_i, best_u, best_v),
            opened, 2 * pairs)


def _walk_hier_ref(wt, o, d, tnear, tfar, any_hit: bool, mxu: bool = False):
    """The two-level walk of the kernels for every tile at once, chunked
    over tiles. Returns ((t, tri, u, v) or (occ,), supers opened per tile,
    cluster visits per tile)."""
    cp, k = int(wt.n_clusters), table_k(wt)
    rows = wt.rows.view(cp, k, 3, 4)
    ids = wt.ids.view(cp, k)
    return _tiled(lambda *r: _walk_hier_chunk(wt, rows, ids, *r, any_hit, mxu),
                  max(int(wt.n_sup_pad), k), o, d, tnear, tfar)


def walk_hier_closest_ref(wt, o, d, tnear, tfar, mxu: bool = False):
    """Plain version of the two-level closest-hit walk: (t, tri, u, v,
    supers opened, cluster visits); t = inf and tri = -1 (u = v = 0) on a
    miss."""
    (t, tri, u, v), opened, visits = _walk_hier_ref(wt, o, d, tnear, tfar,
                                                    False, mxu)
    return t, tri, u, v, int(opened.sum()), int(visits.sum())


def walk_hier_anyhit_ref(wt, o, d, tnear, tfar, mxu: bool = False):
    """Plain version of the two-level any-hit walk: (occ, supers opened,
    cluster visits)."""
    (occ,), opened, visits = _walk_hier_ref(wt, o, d, tnear, tfar, True, mxu)
    return occ, int(opened.sum()), int(visits.sum())


# ------------------------------------------------------------------ wrappers

def _form_geometry(name: str, wt, form, mxu: bool):
    form = _resolve_form(name, form, mxu)
    return form, launch_geometry(name, form, wt.n_sup_pad, mxu,
                                 k=table_k(wt))[1]


def walk_hier_closest(wt, o, d, tnear, tfar, mxu: bool = False, *,
                      _form=None) -> Tuple[torch.Tensor, ...]:
    """Closest hit of whole 64-ray tiles (o, d [n, 3], tnear, tfar [n]) over
    walk tables `wt` with super tables: (t, tri, u, v), each [n]. `mxu`
    takes the tensor-core form of the triangle test."""
    _check(wt, o, d, tnear, tfar)
    form, smem = _form_geometry("walk_hier_closest", wt, _form, mxu)
    count_rays(tfar)
    if o.device.type == "cpu":
        return walk_hier_closest_ref(wt, o, d, tnear, tfar, mxu)[:4]
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        lib = load_for(wt, "walk_hier_closest", _load)
        with torch.cuda.device(o.device):
            err = lib.rl_walk_hier_closest(
                wt.slo.data_ptr(), wt.shi.data_ptr(), int(wt.n_sup_pad),
                int(wt.n_sup), wt.lo.data_ptr(), wt.hi.data_ptr(),
                int(wt.n_clusters), int(wt.n_real), wt.rows.data_ptr(),
                wt.ids.data_ptr(), o.data_ptr(), d.data_ptr(),
                tnear.data_ptr(), tfar.data_ptr(), n, int(mxu),
                *form_args(form, smem), t.data_ptr(),
                tri.data_ptr(), u.data_ptr(), v.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"walk_hier_closest launch failed: CUDA error {err}")
        _count("walk_hier_closest" + ("_mma" if mxu else ""), form, wt)
    return t, tri, u, v


def walk_hier_anyhit(wt, o, d, tnear, tfar, mxu: bool = False, *,
                     _form=None) -> torch.Tensor:
    """Any hit of whole 64-ray tiles over walk tables with super tables:
    True = occluded. `mxu` as in walk_hier_closest."""
    _check(wt, o, d, tnear, tfar)
    form, smem = _form_geometry("walk_hier_anyhit", wt, _form, mxu)
    count_rays(tfar)
    if o.device.type == "cpu":
        return walk_hier_anyhit_ref(wt, o, d, tnear, tfar, mxu)[0]
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        lib = load_for(wt, "walk_hier_anyhit", _load)
        with torch.cuda.device(o.device):
            err = lib.rl_walk_hier_anyhit(
                wt.slo.data_ptr(), wt.shi.data_ptr(), int(wt.n_sup_pad),
                int(wt.n_sup), wt.lo.data_ptr(), wt.hi.data_ptr(),
                int(wt.n_clusters), int(wt.n_real), wt.rows.data_ptr(),
                o.data_ptr(), d.data_ptr(), tnear.data_ptr(),
                tfar.data_ptr(), n, int(mxu),
                *form_args(form, smem), occ.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"walk_hier_anyhit launch failed: CUDA error {err}")
        _count("walk_hier_anyhit" + ("_mma" if mxu else ""), form, wt)
    return occ

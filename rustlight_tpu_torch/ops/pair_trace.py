"""Ray-cluster pair closest-hit and any-hit kernels (K8): wrappers and plain
PyTorch versions.

The CUDA kernels (csrc/pair_trace.cu) replace the TPU kernels
rustlight_tpu/accel/pair_walk.py:_pair_closest_kernel and
:_pair_anyhit_kernel. They are built by ops/native.py and called through
ctypes on PyTorch's current stream.

A pair is one ray and one cluster id: the kernels give each pair the ray's
closest hit (or whether it has any hit) among that cluster's K = 384
triangles, with t in (tnear, tcap); the lowest column wins among equal t.
Pairs whose id lies outside [0, n_real) are inert and report a miss. The
shortlist that makes the pairs, the per-ray reduce and the re-trace of
overflowing rays are accel/pair_walk.py. The plain versions test every
live pair against its gathered cluster in batched torch ops, with the same
arithmetic as the kernels, so the kernels are bit-identical to them; they
also return the number of live pairs. The wrappers use them only for
tensors on the CPU; a CUDA tensor launches the kernel or raises.

With `mxu=True` the test takes the tensor-core form (ops/walk_trace.py,
csrc/tri_test_mma.cuh), whose warp scans one cluster for its 32 rays: the
wrapper sorts the live pairs by cluster id on the device and lays them out
in runs of 32 of one cluster (`_cluster_runs`), the kernel scans each run
against its cluster and writes each pair's result in its own place, and
the inert pairs keep the miss the wrapper filled in. These kernels count as
`<name>_mma`; their plain version forms the products with torch.matmul.

Each wrapper adds one to `LAUNCHES[name]` where it launches its kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .native import load_cuda
from .walk_sub import check_resident
from .walk_trace import K, _test_clusters

PAIR_TILE = 64
_PAIR_CHUNK = 4096     # live pairs per [chunk, K, 3, 4] gather of rows

LAUNCHES = {"pair_closest": 0, "pair_anyhit": 0,
            "pair_closest_mma": 0, "pair_anyhit_mma": 0}
_RUN = 32              # pairs of one cluster a warp scans

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _load():
    global _LIB
    if _LIB is None:
        lib = load_cuda()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rl_pair_closest.argtypes = [i, p, p, p, p, p, p, p, i, p, p, p,
                                        p, p]
        lib.rl_pair_closest.restype = i
        lib.rl_pair_anyhit.argtypes = [i, p, p, p, p, p, p, i, p, p]
        lib.rl_pair_anyhit.restype = i
        lib.rl_pair_mma.argtypes = [i, p, p, p, p, p, p, p, p, i, p, p, p, p,
                                    p, p]
        lib.rl_pair_mma.restype = i
        _LIB = lib
    return _LIB


def _check(wt, o, d, tnear, tcap, cid) -> None:
    check_resident(wt, "the pair walk")
    cp = int(wt.n_clusters)
    m = o.shape[0]
    if m % PAIR_TILE:
        raise ValueError(f"{m} pairs: the kernels take whole {PAIR_TILE}-pair "
                         "tiles")
    dev = o.device
    for name, x, shape, dtype in (
            ("rows", wt.rows, (cp * K, 3, 4), torch.float32),
            ("ids", wt.ids, (cp * K,), torch.int32),
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
    rows = wt.rows.view(int(wt.n_clusters), K, 3, 4)
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
    ids = wt.ids.view(int(wt.n_clusters), K)
    kiota = torch.arange(K, device=o.device)
    n_live = 0
    for k, (t, u, v, valid) in _pair_chunks(wt, o, d, tnear, tcap, cid, mxu):
        n_live += k.numel()
        tm = torch.where(valid, t, float("inf"))
        ct = tm.amin(dim=1)
        j = torch.clamp(torch.where(tm == ct[:, None], kiota, K).amin(dim=1),
                        max=K - 1)
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

def _cluster_runs(n_real: int, cid):
    """The layout of the tensor-core kernels: the live pairs sorted by
    cluster id (stable), each cluster's run padded to whole runs of _RUN
    slots: perm [S] int32, the pair in each slot or -1. S is the bound
    m + (_RUN - 1) * n_real rounded up to whole tiles, so that no size
    is read back to the host."""
    m, dev = cid.shape[0], cid.device
    live = (cid >= 0) & (cid < n_real)
    key = torch.where(live, cid, n_real).long()
    order = torch.sort(key, stable=True).indices
    counts = torch.zeros(n_real + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, key, torch.ones_like(key))
    counts = counts[:n_real]
    padded = (counts + _RUN - 1) // _RUN * _RUN
    start = torch.cumsum(counts, 0) - counts      # first sorted pair of c
    first = torch.cumsum(padded, 0) - padded      # first slot of c
    n_slots = -(-(m + (_RUN - 1) * n_real) // PAIR_TILE) * PAIR_TILE
    ks = key[order]
    c = torch.clamp(ks, max=n_real - 1)
    slot = first[c] + torch.arange(m, device=dev) - start[c]
    # inert pairs go to one slot past the end, which is dropped
    slot = torch.where(ks < n_real, slot, n_slots)
    perm = torch.full((n_slots + 1,), -1, dtype=torch.int32, device=dev)
    perm[slot] = order.int()
    return perm[:n_slots].contiguous()


def _pair_mma(wt, o, d, tnear, tcap, cid, any_hit: bool):
    """The tensor-core kernels on a card: (t, tri, u, v) or occ."""
    m, dev = o.shape[0], o.device
    t = torch.full((m,), float("inf"), device=dev)
    tri = torch.full((m,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(m, device=dev)
    v = torch.zeros(m, device=dev)
    occ = torch.zeros(m, dtype=torch.bool, device=dev)
    name = ("pair_anyhit" if any_hit else "pair_closest") + "_mma"
    if not m:
        return occ if any_hit else (t, tri, u, v)
    with torch.cuda.device(dev):
        perm = _cluster_runs(int(wt.n_real), cid)
        err = _load().rl_pair_mma(
            int(any_hit), wt.rows.data_ptr(), wt.ids.data_ptr(), o.data_ptr(),
            d.data_ptr(), tnear.data_ptr(), tcap.data_ptr(), cid.data_ptr(),
            perm.data_ptr(), perm.shape[0], t.data_ptr(), tri.data_ptr(),
            u.data_ptr(), v.data_ptr(), occ.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return occ if any_hit else (t, tri, u, v)


def pair_closest(wt, o, d, tnear, tcap, cid,
                 mxu: bool = False) -> Tuple[torch.Tensor, ...]:
    """Closest hit of each pair (o, d [m, 3]; tnear, tcap [m]; cid [m]
    int32) inside its cluster of walk tables `wt`: (t, tri, u, v). `mxu`
    takes the tensor-core form of the triangle test."""
    _check(wt, o, d, tnear, tcap, cid)
    if o.device.type == "cpu":
        return pair_closest_ref(wt, o, d, tnear, tcap, cid, mxu)[:4]
    if mxu:
        return _pair_mma(wt, o, d, tnear, tcap, cid, False)
    m = o.shape[0]
    t = torch.empty(m, dtype=torch.float32, device=o.device)
    tri = torch.empty(m, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if m:
        with torch.cuda.device(o.device):
            err = _load().rl_pair_closest(
                int(wt.n_real), wt.rows.data_ptr(), wt.ids.data_ptr(),
                o.data_ptr(), d.data_ptr(), tnear.data_ptr(), tcap.data_ptr(),
                cid.data_ptr(), m, t.data_ptr(), tri.data_ptr(), u.data_ptr(),
                v.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pair_closest launch failed: CUDA error {err}")
        LAUNCHES["pair_closest"] += 1
    return t, tri, u, v


def pair_anyhit(wt, o, d, tnear, tfar, cid, mxu: bool = False) -> torch.Tensor:
    """Any hit of each pair inside its cluster: True = occluded. `mxu` as
    in pair_closest."""
    _check(wt, o, d, tnear, tfar, cid)
    if o.device.type == "cpu":
        return pair_anyhit_ref(wt, o, d, tnear, tfar, cid, mxu)[0]
    if mxu:
        return _pair_mma(wt, o, d, tnear, tfar, cid, True)
    m = o.shape[0]
    occ = torch.empty(m, dtype=torch.bool, device=o.device)
    if m:
        with torch.cuda.device(o.device):
            err = _load().rl_pair_anyhit(
                int(wt.n_real), wt.rows.data_ptr(), o.data_ptr(),
                d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(),
                cid.data_ptr(), m, occ.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pair_anyhit launch failed: CUDA error {err}")
        LAUNCHES["pair_anyhit"] += 1
    return occ

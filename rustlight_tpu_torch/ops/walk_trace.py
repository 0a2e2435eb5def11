"""Tile-walk closest-hit and any-hit kernels: wrappers and plain PyTorch
versions.

The CUDA kernels (csrc/walk_trace.cu) replace the TPU kernels
rustlight_tpu/accel/pallas_walk.py:_closest_kernel/_anyhit_kernel (K3) and
:_closest_kernel_hbm/_anyhit_kernel_hbm (K4): one kernel pair stands for
both, since the card has no VMEM/HBM split. They are built by ops/native.py
and called through ctypes on PyTorch's current stream.

Both walk 64-ray tiles in the order they are given (the caller sorts and
pads, accel/walk.py:_walk_impl) over walk tables (accel/walk.py:
WalkTables, read by attribute): per tile, packed cluster entries from a slab
pass, pops front to back, two visits per termination check. The plain
versions run that walk for all tiles at once in batched torch ops, with the
same arithmetic, so the kernels are bit-identical to them; they also return
the number of cluster visits. The wrappers use them only for tensors on the
CPU; a CUDA tensor launches the kernel or raises.

With `wide=True` the wrappers take the wide pop (K3w: the same TPU kernels
with wide=True, tables past 2^14 clusters that do not take the two-level
walk, up to MAX_WIDE_CLUSTERS): entries are the plain bits of the entry
distance, a pop takes the lowest column among the smallest entries and
clears that one slot, and the per-tile heaps live in shared memory or,
past _WIDE_SHARED_MAX entries, in a device buffer allocated for the launch.
The wide kernels count as `walk_closest_wide` / `walk_anyhit_wide` and run
in K3's split form too (PRODUCTION_FORMS), a block walking several tiles;
`_pop_min_wide_threads` models their pop over NT threads (tests only).

With `mxu=True` a visit takes the tensor-core form of the triangle test
(the reference's MXU_TRITEST, pallas_walk.py:591-597; csrc/tri_test_mma.cuh):
ao = [o, 1] . rows and ad = [d, 0] . rows as matrix products at f32 accuracy.
The plain versions form them with one f32 torch.matmul per product
(`_test_clusters`). This form is not bit-identical to the default one, nor
the kernel to its plain version: hits agree save near ties and edge grazes,
t within rtol 1e-5. These kernels count as `<name>_mma`.

The default kernels (K3/K4 and K3w here, K5 in ops/walk_hier.py) run in a
split form: P threads a ray, each testing every P-th column of a visit's
cluster, and for the any hit of K3/K4 and K3w a two-slot ring of cluster
rows filled a visit ahead by Hopper's bulk copy (csrc/walk_common.cuh).
`PRODUCTION_FORMS` names each kernel's form. With `mxu=True` K3/K4, K3w and
K5 take the same form, whose visit then splits the tensor-core test over
the P warps of each 32-ray set by column blocks, bit for bit the one-thread
tensor-core kernel (`_resolve_form`; the lab's walks keep the one-thread
tensor-core visit). `launch_geometry` gives a form's threads and dynamic
shared memory. `_visit_closest_split` / `_visit_anyhit_split` model the
split visit in torch, and `_merge_parts` the tensor-core visit's merge over
column slices, for the tests only. The wrappers' private
`_form=ONE_THREAD_FORM` launches the one-thread-a-ray kernel instead, for
chip_smoke.py's side-by-side timing and the `cuda` test only; no path of
the package passes it.

Each wrapper adds one to `LAUNCHES[name]` where it launches its kernel, and
adds the lanes it was handed with tfar > 0 to `counting_rays()`.

The cluster size K (triangles per cluster) is a property of the walk
tables (`wt.k`, 384 by default): the plain versions take it from the
tables, and the wrappers launch the library built for it
(native.load_cuda(k)), which refuses tables of another K. `check_k` says
which K the kernels can take: a multiple of 128 whose static shared memory
stays within 48 KB in every walk kernel (`static_smem(kernel, form, k)`).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .native import check_lib_k, count_k, count_rays, load_cuda

# triangles per cluster (the default; the tables' own K rules a walk), rays
# per tile, and cluster-id bits of a packed entry: the reference's K,
# RAY_TILE and _ID_BITS (pallas_walk.py)
K = 384
RAY_TILE = 64
_ID_BITS = 14
_ID_MASK = (1 << _ID_BITS) - 1
_INF_BITS = 0x7F800000

# the wide pop's ceiling (the reference's _MAX_CLUSTERS), and the blocks a
# wide launch starts at most: each walks several tiles, so the heaps in
# device memory stay at _WIDE_BLOCKS x Cp x 4 B
MAX_WIDE_CLUSTERS = 1 << 17
_WIDE_BLOCKS = 1024
# the card's opt-in limit of shared memory a block, and the limit of its
# static shared memory
_MAX_SMEM, _STATIC_MAX = 227 * 1024, 48 * 1024
# the largest heap a wide launch keeps in shared memory unless told to (16
# KB): in the one-thread form a larger heap left too few tiles in flight (at
# 18,816 clusters 1.4-1.65x as long as with the heaps in device memory); the
# split forms took 0.98-1.03x as long with the heaps in shared memory as in
# device memory at 18,816 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section
# 6), so the same rule holds for them
_WIDE_SHARED_MAX = 4096

# a kernel's form: (threads a ray, ring of cluster rows); ONE_THREAD_FORM is
# the one-thread-a-ray kernel
ONE_THREAD_FORM = (1, False)
# the split form of each kernel, the only one csrc/ builds beside the
# one-thread kernel (walk_flat.cuh: CLOSEST_P, CLOSEST_RING, ANYHIT_P,
# ANYHIT_RING; walk_hier.cu: HIER_CLOSEST_P, HIER_ANYHIT_P): the faster on an
# H100 on the wavefronts its main path hands it (PERF.md section 6). The
# counted and floor walks of ops/walk_lab.py take walk_closest's.
PRODUCTION_FORMS = {"walk_closest": (8, False), "walk_anyhit": (8, True),
                    "walk_hier_closest": (4, False),
                    "walk_hier_anyhit": (8, False),
                    "walk_closest_wide": (8, False),
                    "walk_anyhit_wide": (8, True)}
# the kernels whose split form also takes the tensor-core visit
_MMA_SPLIT = ("walk_closest", "walk_anyhit", "walk_closest_wide",
              "walk_anyhit_wide", "walk_hier_closest", "walk_hier_anyhit")
_WIDE = ("walk_closest_wide", "walk_anyhit_wide")
# the split tensor-core visit's shared memory: a cap a ray and a partial
# (t, u, v, column) a thread (csrc/walk_common.cuh: mma_scratch_f4)
_MMA_CAP_BYTES, _MMA_PART_BYTES = RAY_TILE * 4, 16
# static shared memory, bytes, as ptxas reports it (chip_smoke.py holds the
# two to each other at every K it builds), of each kernel (a
# PRODUCTION_FORMS name, or the floor) in its one-thread form: the staged
# rows (slot_bytes(k)), then the tile's rays and the partials (K5 also the
# caps and the children), padded to 16 B, given here ...
_ONE_THREAD_STATIC = {"walk_closest": 2064, "walk_anyhit": 2064,
                      "walk_hier_closest": 2832, "walk_hier_anyhit": 2832,
                      "walk_floor": 0, "walk_closest_wide": 2064,
                      "walk_anyhit_wide": 2064}
# ... as of the other kernels that stage a cluster's rows in static shared
# memory: K7's one-thread form (ops/walk_sparse.py) and the laboratory's
# tensor-core probes (ops/walk_lab.py; built at every K, launched at 384)
_ROWS_STATIC_OTHERS = {"walk_sparse_closest": 3344,
                       "walk_sparse_anyhit": 3344, "mma_products": 0,
                       "mma_form_visits": 0}
# ... and in its split form: the tile's rays, the ring's two mbarriers and
# the partials of P x 2 warps (K5 the caps and the children, no
# mbarriers; K3w 64-bit partials); the floor's slots are all dynamic
_SPLIT_STATIC = {"walk_closest": 2128, "walk_anyhit": 2128,
                 "walk_hier_closest": 2848, "walk_hier_anyhit": 2880,
                 "walk_floor": 0, "walk_closest_wide": 2192,
                 "walk_anyhit_wide": 2192}


def slot_bytes(k: int = K) -> int:
    """A visit's rows at K = k: k triangles of three float4, bytes."""
    return int(k) * 3 * 16


def static_smem(kernel: str, form, k: int = K) -> int:
    """ptxas's static shared memory of `kernel` (as in launch_geometry) in
    `form` at K = k, bytes."""
    if tuple(form) == ONE_THREAD_FORM:
        return slot_bytes(k) + _ONE_THREAD_STATIC[kernel]
    return _SPLIT_STATIC[kernel]


def check_k(k) -> int:
    """k if the walk kernels can be built for clusters of k triangles, else
    ValueError: k must be a positive multiple of 128 (the reference's rule,
    pallas_walk.py:57-58; it keeps whole the split forms' columns a thread
    and the tensor-core visit's column blocks a warp), and every kernel
    that stages a cluster's rows in static shared memory must stay within
    its 48 KB (the message names the one that needs the most)."""
    if isinstance(k, bool) or int(k) != k or k <= 0 or k % 128:
        raise ValueError(f"K = {k}: the walk takes a positive multiple of "
                         "128 triangles per cluster")
    k = int(k)
    kernel, rest = max({**_ONE_THREAD_STATIC, **_ROWS_STATIC_OTHERS}.items(),
                       key=lambda kv: kv[1])
    if slot_bytes(k) + rest > _STATIC_MAX:
        raise ValueError(f"K = {k}: {kernel} needs {slot_bytes(k) + rest} B "
                         f"of static shared memory, past {_STATIC_MAX}")
    return k


def mma_scratch_bytes(p: int) -> int:
    """The split tensor-core visit's dynamic shared memory at p threads a
    ray: the caps and the partials of p x 64 threads."""
    return _MMA_CAP_BYTES + _MMA_PART_BYTES * p * RAY_TILE


def launch_geometry(kernel: str, form, n_heap: int, mxu: bool = False, *,
                    lab: bool = False, k: int = K) -> Tuple[int, int]:
    """(threads a block, dynamic shared-memory bytes) of `kernel` (a
    PRODUCTION_FORMS name, the counted walk taking "walk_closest", or
    "walk_floor") in `form` (threads a ray, ring) over a heap of n_heap
    4-byte entries in shared memory (Cp, or Sp for K5; the floor has none;
    K3w's heaps in device memory take 0), with
    the tensor-core test if `mxu` (the split visit's scratch before the
    heap), at K = k; raises ValueError for a form not built or past the
    card's 232,448 B a block. `lab` takes any split form a library built
    with RL_LAB_FORMS may hold (tools/perf/)."""
    if kernel not in _ONE_THREAD_STATIC:
        raise ValueError(f"unknown kernel {kernel!r}")
    form = tuple(form)
    split = PRODUCTION_FORMS["walk_closest" if kernel == "walk_floor"
                             else kernel]
    if (form not in (ONE_THREAD_FORM, split) and not (
            lab and form[0] in (2, 4, 8))) or (
            mxu and form != ONE_THREAD_FORM and kernel not in _MMA_SPLIT):
        raise ValueError(f"{kernel} in form {form} is not built (built: "
                         f"{ONE_THREAD_FORM}, {split}"
                         f"{'' if kernel in _MMA_SPLIT else ' without mxu'})")
    p, ring = form
    heap = 0 if kernel == "walk_floor" else 4 * int(n_heap)
    dyn = heap if form == ONE_THREAD_FORM else (
        (2 if ring else 1) * slot_bytes(k)
        + (mma_scratch_bytes(p) if mxu else 0) + heap)
    static = static_smem(kernel, form, k)
    if static + dyn > _MAX_SMEM:
        raise ValueError(f"{kernel} in form {form} needs {static} + {dyn} B "
                         f"of shared memory, past {_MAX_SMEM}")
    return p * RAY_TILE, dyn


def _resolve_form(name: str, form, mxu: bool = False):
    """The form a launch of kernel `name` takes: the production one, with
    either test for K3/K4, K3w and K5 (`mxu`: the tensor-core visit split
    over warps by columns); the one-thread-a-ray kernel for the tensor-core
    visit of the lab's walks, or where the private `form` asks for it
    (ONE_THREAD_FORM, the only value it takes)."""
    if form is not None and tuple(form) != ONE_THREAD_FORM:
        raise ValueError(f"_form takes only {ONE_THREAD_FORM}, got {form}")
    if form is not None or (mxu and name not in _MMA_SPLIT):
        return ONE_THREAD_FORM
    return PRODUCTION_FORMS[name]


def form_args(form, smem: int):
    """The form's arguments of an entry point: (p, ring, smem)."""
    return form[0], int(form[1]), smem


LAUNCHES = {"walk_closest": 0, "walk_anyhit": 0,
            "walk_closest_wide": 0, "walk_anyhit_wide": 0,
            "walk_closest_mma": 0, "walk_anyhit_mma": 0,
            "walk_closest_wide_mma": 0, "walk_anyhit_wide_mma": 0}

_LIBS = {}
# elements per [tiles, 64, max(Cp, K)] tensor of a plain version, on the
# CPU and on a card (whose plain runs are bound by launches, not memory)
_REF_ELEMS = {"cpu": 1 << 24, "cuda": 1 << 27}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bind(lib):
    """Sets the tile walk's entry points' argument types on a loaded
    library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rl_walk_closest.argtypes = [p, p, i, i, p, p, p, p, p, p, i, i,
                                    i, i, i, p, p, p, p, p]
    lib.rl_walk_closest.restype = i
    lib.rl_walk_anyhit.argtypes = [p, p, i, i, p, p, p, p, p, i, i, i, i,
                                   i, p, p]
    lib.rl_walk_anyhit.restype = i
    lib.rl_walk_closest_wide.argtypes = [p, p, i, i, p, p, p, p, p, p, i,
                                         i, i, i, i, p, i, p, p, p, p, p]
    lib.rl_walk_closest_wide.restype = i
    lib.rl_walk_anyhit_wide.argtypes = [p, p, i, i, p, p, p, p, p, i, i, i,
                                        i, i, p, i, p, p]
    lib.rl_walk_anyhit_wide.restype = i
    return lib


def _load(k: int = K):
    """The library of the walk kernels at K = k, bound (one a K)."""
    if k not in _LIBS:
        _LIBS[k] = bind(load_cuda(k))
    return _LIBS[k]


def table_k(wt) -> int:
    """The walk tables' K (triangles per cluster); tables read by
    attribute without a `k` are of the default K."""
    return int(getattr(wt, "k", K))


def load_for(wt, what: str, load=None):
    """The library of the tables' K (`load(k)`, this module's `_load` by
    default), held to it: a launch never walks tables of another K than
    its library's (native.check_lib_k raises ValueError)."""
    lib = (load or _load)(table_k(wt))
    check_lib_k(lib, table_k(wt), what)
    return lib


def _check(wt, o, d, tnear, tfar, wide: bool = False, heap=None) -> None:
    cp = int(wt.n_clusters)
    if heap not in (None, "shared", "global") or (heap and not wide):
        raise ValueError("heap is 'shared' or 'global', and goes with wide; "
                         f"got {heap!r}")
    if wide:
        if not 0 < int(wt.n_real) <= cp <= MAX_WIDE_CLUSTERS:
            raise ValueError(f"walk tables with {wt.n_real} real of {cp} "
                             "clusters (the wide pop takes at most "
                             f"{MAX_WIDE_CLUSTERS})")
    elif not 0 < int(wt.n_real) <= cp <= 1 << _ID_BITS:
        raise ValueError(f"walk tables with {wt.n_real} real of {cp} clusters"
                         f" (the packed entries take at most 2^{_ID_BITS})")
    _check_arrays(wt, o, d, tnear, tfar)


def _check_arrays(wt, o, d, tnear, tfar, extra=()) -> None:
    """Shapes, types, devices and layout of the walk's tables and rays, and
    of `extra` (name, tensor, shape, dtype) entries."""
    cp, k = int(wt.n_clusters), table_k(wt)
    n = o.shape[0]
    if n % RAY_TILE:
        raise ValueError(f"{n} rays: the walk takes whole {RAY_TILE}-ray tiles")
    dev = o.device
    for name, x, shape, dtype in (
            ("lo", wt.lo, (3, cp), torch.float32),
            ("hi", wt.hi, (3, cp), torch.float32),
            ("rows", wt.rows, (cp * k, 3, 4), torch.float32),
            ("ids", wt.ids, (cp * k,), torch.int32),
            ("o", o, (n, 3), torch.float32), ("d", d, (n, 3), torch.float32),
            ("tnear", tnear, (n,), torch.float32),
            ("tfar", tfar, (n,), torch.float32), *extra):
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

def _slab_inv(d):
    return 1.0 / torch.where(d.abs() > 1e-12, d,
                             torch.where(d >= 0.0, 1e-12, -1e-12))


def _ray_entries(lo, hi, o, inv, tnear, cap):
    """Each ray's slab entry into boxes lo/hi ([3, C], or [3, G, 1, C] per
    tile) for rays o, inv [G, R, 3], tnear, cap [G, R], counted where
    tmax >= entry and entry < cap: [G, R, C], inf for no entry."""
    tmin = tmax = None
    for ax in range(3):
        t0 = (lo[ax] - o[..., ax:ax + 1]) * inv[..., ax:ax + 1]
        t1 = (hi[ax] - o[..., ax:ax + 1]) * inv[..., ax:ax + 1]
        lo_t, hi_t = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tmin = lo_t if tmin is None else torch.maximum(tmin, lo_t)
        tmax = hi_t if tmax is None else torch.minimum(tmax, hi_t)
    entry = torch.maximum(tmin, tnear[..., None])
    ok = (tmax >= entry) & (entry < cap[..., None])
    return torch.where(ok, entry, float("inf"))


def _min_entry(lo, hi, o, inv, tnear, cap):
    """Min over each tile's rays of `_ray_entries`: [G, C]."""
    return _ray_entries(lo, hi, o, inv, tnear, cap).amin(dim=1)


def _pack_entries(ent, real, mask: int):
    """Entries [G, C] packed with the column index in the low bits of
    `mask` (0: the plain bits, the wide pop's entries); _INF_BITS where not
    finite or not `real` [C] or [G, C]."""
    cid = torch.arange(ent.shape[1], dtype=torch.int32, device=ent.device)
    fin = real & torch.isfinite(ent)
    # + 0 maps a -0 entry to +0, so its bits sort as the smallest
    z = torch.clamp(torch.where(fin, ent, 0.0), min=0.0) + 0.0
    packed = (z.view(torch.int32) & ~mask) | (cid & mask)
    return torch.where(fin, packed, _INF_BITS)


def _tile_entries(lo, hi, n_real, o, d, tnear, tfar, mask: int = _ID_MASK,
                  with_rays: bool = False):
    """Packed entries [G, C] int32 of G tiles (o, d [G, R, 3]; tnear, tfar
    [G, R]) into the boxes lo/hi [3, C], the first n_real real: the bits of
    min over the tile's rays of the slab entry, the box id in the low bits
    of `mask`, _INF_BITS where no ray enters. `with_rays` also returns which
    rays enter which real box, [G, R, C] bool."""
    per_ray = _ray_entries(lo, hi, o, _slab_inv(d), tnear, tfar)    # [G, R, C]
    real = torch.arange(per_ray.shape[2], device=o.device) < int(n_real)
    ent = _pack_entries(per_ray.amin(dim=1), real, mask)
    if with_rays:
        return ent, (per_ray < float("inf")) & real
    return ent


def _pop_min(ent, mask: int = _ID_MASK):
    """Pops each row's smallest entry: (bits [G], id [G] int64, entries),
    the id being the bits under `mask` clamped to the last column;
    all-popped rows give id 0, as the reference's pop does. mask = 0 is the
    wide pop over plain bits: the id is the lowest column among the
    smallest entries, and only that column is cleared."""
    bmin = ent.amin(dim=1)
    if mask == 0:
        cp = ent.shape[1]
        col = torch.arange(cp, device=ent.device)
        csel = torch.clamp(torch.where(ent == bmin[:, None], col, cp)
                           .amin(dim=1), max=cp - 1)
        return bmin, csel, ent.scatter(
            1, csel[:, None], torch.full_like(bmin, _INF_BITS)[:, None])
    ent = torch.where(ent == bmin[:, None], _INF_BITS, ent)
    csel = torch.clamp(bmin & mask, max=ent.shape[1] - 1).long()
    return bmin, csel, ent


def _pop_min_wide_threads(ent, nt: int):
    """The split wide pop's order of work (csrc/walk_trace.cu:
    pop_min_wide<NT, true>) on heaps ent [G, C]: thread q of nt takes the
    least (bits << 32 | column) over its columns c = q (mod nt), then the
    least over the threads; an empty heap gives column 0. Returns (bits
    [G], column [G] int64, entries with that slot cleared), as _pop_min(ent,
    0) (tests only)."""
    g, cp = ent.shape
    col = torch.arange(cp, device=ent.device)
    key = (ent.long() << 32) | col
    pad = -cp % nt
    inf_key = torch.full((g, pad), _INF_BITS << 32, dtype=torch.int64,
                         device=ent.device)
    per = torch.cat([key, inf_key], 1).reshape(g, -1, nt).amin(dim=1)
    m = torch.minimum(per.amin(dim=1), torch.full_like(per[:, 0],
                                                       _INF_BITS << 32))
    csel = m & 0xFFFFFFFF
    return (m >> 32).to(torch.int32), csel, ent.scatter(
        1, csel[:, None], torch.full((g, 1), _INF_BITS, dtype=ent.dtype,
                                     device=ent.device))


def _dot4(x4, r):
    """x4 [G, R, 4] . r [G, K, 4] -> [G, R, K] in the reference's _dot4
    order, ((x0*r0 + x1*r1) + x2*r2) + x3*r3."""
    return (x4[..., 0:1] * r[:, None, :, 0] + x4[..., 1:2] * r[:, None, :, 1]
            + x4[..., 2:3] * r[:, None, :, 2] + x4[..., 3:4] * r[:, None, :, 3])


def _matmul_products(rows, o4, d4):
    """The tensor-core form's two products: ao = o4 . rows and ad = d4 . rows
    as one f32 torch.matmul each, [G, R, 4] x [G, 4, 3K] with the columns in
    blocks N | U | V; each [G, R, 3K]. On a card the product must run in
    full f32: TF32 keeps about three digits and must not decide a hit."""
    if rows.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the mxu triangle test needs torch.backends.cuda."
                           "matmul.allow_tf32 = False")
    g, k = rows.shape[:2]
    p = rows.permute(0, 3, 2, 1).reshape(g, 4, 3 * k)
    return torch.matmul(o4, p), torch.matmul(d4, p)


def _test_clusters(rows, o, d, tnear, tcap, mxu: bool = False):
    """Rays [G, R] against each tile's cluster rows [G, K, 3, 4]:
    (t, u, v, valid), each [G, R, K]. `mxu` forms the dot products as two
    matrix products (the tensor-core form) instead of in _dot4 order."""
    one = torch.ones_like(o[..., :1])
    o4 = torch.cat([o, one], dim=-1)
    d4 = torch.cat([d, torch.zeros_like(one)], dim=-1)
    if mxu:
        k = rows.shape[1]
        ao, ad = _matmul_products(rows, o4, d4)
        nd = ad[..., :k]
        live = nd.abs() > 1e-20
        t = -ao[..., :k] / torch.where(live, nd, 1.0)
        u = ao[..., k:2 * k] + t * ad[..., k:2 * k]
        v = ao[..., 2 * k:] + t * ad[..., 2 * k:]
    else:
        nd = _dot4(d4, rows[:, :, 0])
        live = nd.abs() > 1e-20
        t = -_dot4(o4, rows[:, :, 0]) / torch.where(live, nd, 1.0)
        u = _dot4(o4, rows[:, :, 1]) + t * _dot4(d4, rows[:, :, 1])
        v = _dot4(o4, rows[:, :, 2]) + t * _dot4(d4, rows[:, :, 2])
    valid = (live & (t > tnear[..., None]) & (t < tcap[..., None])
             & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
    return t, u, v, valid


def _visit_closest(rows, ids, csel, o, d, tnear, best, tested=None,
                   mxu: bool = False):
    """One closest-hit visit of cluster csel [A] by A tiles: best = (t, tri,
    u, v) [A, R], updated where a hit is strictly nearer (and the ray is
    among `tested` [A, R], if given); the lowest column wins inside the
    cluster."""
    bt, bi, bu, bv = best
    t, u, v, valid = _test_clusters(rows[csel], o, d, tnear, bt, mxu)
    k = rows.shape[1]
    tm = torch.where(valid, t, float("inf"))
    ct = tm.amin(dim=-1)
    kiota = torch.arange(k, device=o.device)
    j = torch.where(tm == ct[..., None], kiota, k).amin(dim=-1)
    j = torch.clamp(j, max=k - 1)
    better = ct < bt
    if tested is not None:
        better = better & tested
    tri = ids[csel[:, None], j]
    # + 0 maps a -0 barycentric to +0, as the kernel's output does
    uj = u.gather(-1, j[..., None])[..., 0] + 0.0
    vj = v.gather(-1, j[..., None])[..., 0] + 0.0
    return (torch.where(better, ct, bt), torch.where(better, tri, bi),
            torch.where(better, uj, bu), torch.where(better, vj, bv))


def _visit_anyhit(rows, csel, o, d, tnear, tfar, occ, tested=None,
                  mxu: bool = False):
    """One any-hit visit of cluster csel [A]: occ [A, R] | a hit in range
    (of a ray among `tested` [A, R], if given)."""
    hit = _test_clusters(rows[csel], o, d, tnear, tfar, mxu)[3].any(dim=-1)
    return occ | (hit if tested is None else hit & tested)


def _split_scan(t, ok, cap, p: int):
    """The split visit's per-lane scans and their butterfly
    (csrc/walk_common.cuh:split_closest): lane q of each ray scans the
    columns j = q, q + p, ... in order, taking a hit that is valid (`ok`)
    with t strictly below its running cap (starting at `cap` [A, R]); then
    for off = p/2, ..., 1 each lane takes its partner q ^ off's (t, j) when
    that is less (t smaller, or t equal and j lower). Returns each ray's
    (t, j) [A, R]; j = K where no lane found a hit."""
    a, r, k = t.shape
    tq = t.reshape(a, r, k // p, p)
    okq = ok.reshape(a, r, k // p, p)
    bt = cap[..., None].expand(a, r, p).clone()
    bj = torch.full((a, r, p), k, dtype=torch.int64, device=t.device)
    lane = torch.arange(p, device=t.device)
    for m in range(k // p):
        take = okq[:, :, m] & (tq[:, :, m] < bt)
        bt = torch.where(take, tq[:, :, m], bt)
        bj = torch.where(take, m * p + lane, bj)
    off = p // 2
    while off:
        ot, oj = bt[..., lane ^ off], bj[..., lane ^ off]
        take = (ot < bt) | ((ot == bt) & (oj < bj))
        bt, bj = torch.where(take, ot, bt), torch.where(take, oj, bj)
        off //= 2
    return bt[..., 0], bj[..., 0]


def _merge_parts(t, ok, cap, w: int):
    """The split tensor-core visit's merge (csrc/walk_common.cuh:split_mma)
    for rays [A, R] over K columns: slice s of w takes the columns
    [s K / w, (s + 1) K / w) and keeps its (t, column) minimum among the
    valid (`ok`) t strictly below `cap` [A, R]; the slices then merge in
    order, taking a partial whose t is smaller, or equal with a lower
    column. Returns (t, j) [A, R]; j = K where no column hits (tests
    only)."""
    k = t.shape[-1]
    tm = torch.where(ok & (t < cap[..., None]), t, float("inf"))
    col = torch.arange(k, device=t.device)
    bt = torch.full(cap.shape, float("inf"), device=t.device)
    bj = torch.full(cap.shape, k, dtype=torch.int64, device=t.device)
    for s in range(w):
        lo, hi = s * k // w, (s + 1) * k // w
        st = tm[..., lo:hi].amin(dim=-1)
        sj = torch.where((tm[..., lo:hi] == st[..., None])
                         & torch.isfinite(st)[..., None], col[lo:hi],
                         k).amin(dim=-1)
        take = (st < bt) | ((st == bt) & (sj < bj))
        bt, bj = torch.where(take, st, bt), torch.where(take, sj, bj)
    return bt, bj


def _visit_closest_split(rows, ids, csel, o, d, tnear, best, p: int):
    """_visit_closest as the split kernels compute it, with p threads a ray
    (tests only: no path runs it). The triangle test is _test_clusters' with
    no cap; the cap is the scan's."""
    bt, bi, bu, bv = best
    t, u, v, valid = _test_clusters(rows[csel], o, d, tnear,
                                    torch.full_like(bt, float("inf")))
    _, j = _split_scan(t, valid, bt, p)
    k = rows.shape[1]
    better = j < k
    jc = torch.clamp(j, max=k - 1)
    tri = ids[csel[:, None], jc]
    tj = t.gather(-1, jc[..., None])[..., 0]
    uj = u.gather(-1, jc[..., None])[..., 0] + 0.0
    vj = v.gather(-1, jc[..., None])[..., 0] + 0.0
    return (torch.where(better, tj, bt), torch.where(better, tri, bi),
            torch.where(better, uj, bu), torch.where(better, vj, bv))


def _visit_anyhit_split(rows, csel, o, d, tnear, tfar, occ, p: int):
    """_visit_anyhit as the split kernels compute it: an OR over the p
    lanes' scans of their columns (tests only)."""
    valid = _test_clusters(rows[csel], o, d, tnear, tfar)[3]
    a, r, k = valid.shape
    lanes = valid.reshape(a, r, k // p, p).any(dim=2)        # [A, R, p]
    hit = torch.zeros((a, r), dtype=torch.bool, device=o.device)
    for q in range(p):
        hit = hit | lanes[..., q]
    return occ | hit


def _tiled(fn, width, o, d, tnear, tfar, tile: int = RAY_TILE):
    """fn(o, d, tnear, tfar) on [G, tile, ...] tiles, G chosen so that a
    [G, tile, width] tensor stays near _REF_ELEMS elements; returns fn's
    (outputs, *per-tile counts), concatenated over the chunks."""
    n = o.shape[0]
    per = max(1, _REF_ELEMS[o.device.type] // (tile * width)) * tile
    parts = [fn(*(x[s:s + per].reshape(-1, tile, *x.shape[1:])
                  for x in (o, d, tnear, tfar)))
             for s in range(0, max(n, 1), per)]
    outs = tuple(torch.cat(xs).reshape(-1) for xs in zip(*(p[0] for p in parts)))
    return (outs, *(torch.cat(c) for c in zip(*(p[1:] for p in parts))))


def _walk_ref(wt, o, d, tnear, tfar, any_hit: bool, wide: bool = False,
              tile: int = RAY_TILE, sparse_cap: int = None,
              mxu: bool = False):
    """The tile walk of the kernels for every tile at once, chunked over
    tiles of `tile` rays. Returns ((t, tri, u, v) or (occ,), cluster visits
    per tile), and with `sparse_cap` also the visits that tested only the
    flagged rays, the rays tested and the rays flagged, per tile."""
    cp, k = int(wt.n_clusters), table_k(wt)
    rows = wt.rows.view(cp, k, 3, 4)
    ids = wt.ids.view(cp, k)
    return _tiled(lambda *r: _walk_chunk(wt, rows, ids, *r, any_hit, wide,
                                         sparse_cap, mxu),
                  max(cp, k), o, d, tnear, tfar, tile)


def _sortable_max(x):
    """max over the last dim of a non-negative f32 tensor, as int32 bits."""
    return x.view(torch.int32).amax(dim=-1)


def _walk_chunk(wt, rows, ids, o, d, tnear, tfar, any_hit, wide=False,
                sparse_cap=None, mxu=False):
    """The walk of G tiles [G, R]: packed pops, or the wide pop over plain
    entries. With `sparse_cap` (the sparse-visit schedule) a visit tests
    only the rays that enter the popped cluster when they are at most
    sparse_cap, else the whole tile."""
    g, r = tfar.shape
    cp = rows.shape[0]
    mask = 0 if wide else _ID_MASK
    sparse = sparse_cap is not None
    ent = _tile_entries(wt.lo, wt.hi, wt.n_real, o, d, tnear, tfar, mask,
                        with_rays=sparse)
    if sparse:
        ent, flags = ent                                 # flags [G, R, C]
        n_sparse, n_tested, n_flagged = (
            torch.zeros(g, dtype=torch.int64, device=o.device)
            for _ in range(3))
    emin, csel, ent = _pop_min(ent, mask)
    if any_hit:
        occ = torch.zeros(tfar.shape, dtype=torch.bool, device=o.device)
        thresh = _sortable_max(tfar)
    else:
        best_t = tfar.clone()
        best_i = torch.full(tfar.shape, -1, dtype=torch.int32, device=o.device)
        best_u = torch.zeros_like(tfar)
        best_v = torch.zeros_like(tfar)
        thresh = _sortable_max(best_t)
    nv = torch.zeros(g, dtype=torch.int64, device=o.device)   # visit pairs
    while True:
        act = torch.nonzero(((emin & ~mask) < thresh) & (nv < cp))[:, 0]
        if act.numel() == 0:
            break
        a_o, a_d, a_tn, a_tf = o[act], d[act], tnear[act], tfar[act]
        a_ent, a_emin, a_csel = ent[act], emin[act], csel[act]
        if any_hit:
            a_occ = occ[act]
        else:
            bt, bi, bu, bv = best_t[act], best_i[act], best_u[act], best_v[act]
        for _ in range(2):
            tested = None
            if sparse:
                tested = flags[act, :, a_csel]                       # [A, R]
                count = tested.sum(dim=1)
                few = count <= sparse_cap
                tested = tested | ~few[:, None]
                n_sparse[act] += few
                n_tested[act] += tested.sum(dim=1)
                n_flagged[act] += count
            if any_hit:
                a_occ = _visit_anyhit(rows, a_csel, a_o, a_d, a_tn, a_tf,
                                      a_occ, tested, mxu)
            else:
                bt, bi, bu, bv = _visit_closest(rows, ids, a_csel, a_o, a_d,
                                                a_tn, (bt, bi, bu, bv), tested,
                                                mxu)
            a_emin, a_csel, a_ent = _pop_min(a_ent, mask)
        ent[act], emin[act], csel[act] = a_ent, a_emin, a_csel
        nv[act] += 1
        if any_hit:
            occ[act] = a_occ
            thresh[act] = _sortable_max(torch.where(a_occ, 0.0, a_tf))
        else:
            best_t[act], best_i[act], best_u[act], best_v[act] = bt, bi, bu, bv
            thresh[act] = _sortable_max(bt)
    counts = ((2 * nv, n_sparse, n_tested, n_flagged) if sparse
              else (2 * nv,))
    if any_hit:
        return ((occ,), *counts)
    hit = best_i >= 0
    return ((torch.where(hit, best_t, float("inf")), best_i, best_u,
             best_v), *counts)


def walk_closest_ref(wt, o, d, tnear, tfar, wide: bool = False,
                     mxu: bool = False):
    """Plain version of the closest-hit walk: (t, tri, u, v, visits); t = inf
    and tri = -1 (u = v = 0) on a miss."""
    (t, tri, u, v), visits = _walk_ref(wt, o, d, tnear, tfar, False, wide,
                                       mxu=mxu)
    return t, tri, u, v, int(visits.sum())


def walk_anyhit_ref(wt, o, d, tnear, tfar, wide: bool = False,
                    mxu: bool = False):
    """Plain version of the any-hit walk: (occ, visits)."""
    (occ,), visits = _walk_ref(wt, o, d, tnear, tfar, True, wide, mxu=mxu)
    return occ, int(visits.sum())


# ------------------------------------------------------------------ wrappers

def _wide_heap(name: str, form, mxu: bool, cp: int, n: int, heap,
               lab: bool = False, k: int = K):
    """Where a wide launch keeps its per-tile heaps of Cp x 4 B: (blocks,
    whether in a device buffer, dynamic shared-memory bytes). In shared
    memory up to _WIDE_SHARED_MAX entries, or with heap = "shared"
    (ValueError where it does not fit); else, or with heap = "global", in a
    slice per block of a device buffer allocated for the launch. A launch
    starts at most _WIDE_BLOCKS blocks and each walks several tiles, which
    bounds that buffer."""
    blocks = min(n // RAY_TILE, _WIDE_BLOCKS)
    shared = heap == "shared" or (heap is None and cp <= _WIDE_SHARED_MAX)
    smem = launch_geometry(name, form, cp if shared else 0, mxu,
                           lab=lab, k=k)[1]
    return blocks, not shared, smem


def _kernel_name(base: str, wide: bool, mxu: bool) -> str:
    return base + ("_wide" if wide else "") + ("_mma" if mxu else "")


def launch_wide(lib, any_hit: bool, wt, o, d, tnear, tfar, form,
                mxu: bool = False, heap: str = None, lab: bool = False):
    """Launches the wide pop's closest hit (t, tri, u, v) or any hit (occ)
    on checked CUDA tensors in `form` through library `lib` (bound by
    `bind`); `lab`: a form only a library built with RL_LAB_FORMS holds
    (tools/perf/split_forms.py), not counted. ValueError where `lib` was
    built for another K than the tables'."""
    name = "walk_anyhit_wide" if any_hit else "walk_closest_wide"
    check_lib_k(lib, table_k(wt), name)
    cp, n = int(wt.n_clusters), o.shape[0]
    blocks, glob, smem = _wide_heap(name, form, mxu, cp, n, heap, lab=lab,
                                    k=table_k(wt))
    if any_hit:
        outs = (torch.empty(n, dtype=torch.bool, device=o.device),)
    else:
        outs = (torch.empty(n, dtype=torch.float32, device=o.device),
                torch.empty(n, dtype=torch.int32, device=o.device),
                torch.empty(n, dtype=torch.float32, device=o.device),
                torch.empty(n, dtype=torch.float32, device=o.device))
    if not n:
        return outs[0] if any_hit else outs
    scratch = (torch.empty(blocks * cp, dtype=torch.int32, device=o.device)
               if glob else None)
    head = (wt.lo.data_ptr(), wt.hi.data_ptr(), cp, int(wt.n_real),
            wt.rows.data_ptr())
    rays = (o.data_ptr(), d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(), n,
            int(mxu), *form_args(form, smem),
            None if scratch is None else scratch.data_ptr(), blocks,
            *(x.data_ptr() for x in outs))
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        if any_hit:
            err = lib.rl_walk_anyhit_wide(*head, *rays, stream)
        else:
            err = lib.rl_walk_closest_wide(*head, wt.ids.data_ptr(), *rays,
                                           stream)
    name = _kernel_name(name[:-5], True, mxu)
    if err:
        raise RuntimeError(f"{name} in form {tuple(form)} launch failed: CUDA "
                           f"error {err}")
    if not lab:
        LAUNCHES[name] += 1
        count_k(name, table_k(wt))
    return outs[0] if any_hit else outs


def walk_closest(wt, o, d, tnear, tfar, wide: bool = False,
                 heap: str = None, mxu: bool = False, *, _form=None
                 ) -> Tuple[torch.Tensor, ...]:
    """Closest hit of whole 64-ray tiles (o, d [n, 3], tnear, tfar [n]) over
    walk tables `wt`: (t, tri, u, v), each [n]. `wide` takes the wide pop
    (plain entries, any Cp up to MAX_WIDE_CLUSTERS); `heap` forces where its
    heaps live (see _wide_heap); `mxu` takes the tensor-core form of the
    triangle test."""
    _check(wt, o, d, tnear, tfar, wide, heap)
    name = _kernel_name("walk_closest", wide, False)
    form = _resolve_form(name, _form, mxu)
    k = table_k(wt)
    if wide:
        _wide_heap(name, form, mxu, int(wt.n_clusters), o.shape[0], heap,
                   k=k)
    else:
        smem = launch_geometry(name, form, wt.n_clusters, mxu, k=k)[1]
    count_rays(tfar, "closest")
    if o.device.type == "cpu":
        return walk_closest_ref(wt, o, d, tnear, tfar, wide, mxu)[:4]
    if wide:
        return launch_wide(_load(k), False, wt, o, d, tnear, tfar, form, mxu,
                           heap)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if not n:
        return t, tri, u, v
    name = _kernel_name("walk_closest", False, mxu)
    tables = (wt.lo.data_ptr(), wt.hi.data_ptr(), int(wt.n_clusters),
              int(wt.n_real), wt.rows.data_ptr(), wt.ids.data_ptr(),
              o.data_ptr(), d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(), n,
              int(mxu))
    outs = (t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr())
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = load_for(wt, name).rl_walk_closest(
            *tables, *form_args(form, smem), *outs, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    count_k(name, k)
    return t, tri, u, v


def walk_anyhit(wt, o, d, tnear, tfar, wide: bool = False,
                heap: str = None, mxu: bool = False, *, _form=None
                ) -> torch.Tensor:
    """Any hit of whole 64-ray tiles over walk tables: True = occluded.
    `wide`, `heap` and `mxu` as in walk_closest."""
    _check(wt, o, d, tnear, tfar, wide, heap)
    name = _kernel_name("walk_anyhit", wide, False)
    form = _resolve_form(name, _form, mxu)
    k = table_k(wt)
    if wide:
        _wide_heap(name, form, mxu, int(wt.n_clusters), o.shape[0], heap,
                   k=k)
    else:
        smem = launch_geometry(name, form, wt.n_clusters, mxu, k=k)[1]
    count_rays(tfar, "anyhit")
    if o.device.type == "cpu":
        return walk_anyhit_ref(wt, o, d, tnear, tfar, wide, mxu)[0]
    if wide:
        return launch_wide(_load(k), True, wt, o, d, tnear, tfar, form, mxu,
                           heap)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if not n:
        return occ
    name = _kernel_name("walk_anyhit", False, mxu)
    tables = (wt.lo.data_ptr(), wt.hi.data_ptr(), int(wt.n_clusters),
              int(wt.n_real), wt.rows.data_ptr(), o.data_ptr(), d.data_ptr(),
              tnear.data_ptr(), tfar.data_ptr(), n, int(mxu))
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = load_for(wt, name).rl_walk_anyhit(
            *tables, *form_args(form, smem), occ.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    count_k(name, k)
    return occ

"""Tile-walk intersector for large scenes; port of the host and XLA side of
rustlight_tpu/accel/pallas_walk.py.

Host build: the SAH BVH's preorder primitive array is cut into treelets of
at most K triangles (`_treelet_cut`), neighbours are re-packed greedily
up to K per cluster, and each cluster gets the tight bounds of its
triangles (`build_walk_tables`). K is the tables' own (`WalkTables.k`, 384
by default; `build_walk_tables(geom, k=...)` takes any K that
ops/walk_trace.py:check_k allows), and every walk reads it from the
tables: the plain versions, and the kernels, which launch the library
built for that K. The port keeps one table layout for every
cluster count: rows [Cp*K, 3, 4] f32 (cluster-major, each triangle as the
dense kernels' rows), ids [Cp*K] int32 (-1 in pad slots), bounds lo/hi
[3, Cp] f32, with Cp the real count padded to a multiple of 128. The
two-level walk's super tables group SUP = 128 consecutive clusters: slo/shi
[3, Sp] f32, the union of each super's real clusters, n_sup real supers
padded to Sp, a multiple of 128. `walk_tables_from_numpy` turns the JAX
package's tables (its resident or its HBM layout) into this one.

Per wavefront (`_walk_impl`): NaN and negative ranges are sanitized, the
rays are sorted stably by a coherence key, padded to whole RAY_TILE-ray
tiles, walked by the kernels of ops/walk_trace.py (CUDA on the card, their
plain versions on the CPU), and put back in lane order. The key is chosen
per wavefront as the reference does: the incidence key for spread-origin
wavefronts, the morton key for point-origin ones; in eager torch that
choice costs one host read per call. The incidence key is one CUDA kernel
on the card (ops/coherence_key.py). Past _INC_SORT_MAX_C clusters every
wavefront takes the morton key (the incidence key's slab pass is linear in
the cluster count), with no host read. Under a profiler (utils/tracing.py)
a call is three device spans, `walk.prepare` (its host read a `walk.sync`
span), `walk.kernel` and `walk.unsort`, and a sorted call counts its key
in `walk.key.incidence` or `walk.key.morton`.

Tables of up to 2^14 clusters take the one-level walk (K3/K4,
ops/walk_trace.py); larger ones, up to MAX_CLUSTERS = 2^17, the two-level
walk (K5, ops/walk_hier.py), as the reference chooses. Past that, building
raises.

The walk's other schedules are asked for explicitly, through `WalkOptions`
on the tables (set by Scene.compile(walk_options=...)) or the same names as
keyword arguments of `_walk_impl`: `hier=False` sends tables past 2^14
clusters through the wide pop of the one-level walk; `sub` in (2, 4, 8)
takes the sub-tiled walk (K6, ops/walk_sub.py); `sparse` the sparse-visit
walk (K7, ops/walk_sparse.py); `pair` the pair walk (K8,
accel/pair_walk.py, dispatched by accel/dense.py); `compact_inert` and
`inc_sort` change the sort key; `mxu_tritest` takes the tensor-core form of
the visit's triangle test (in CUDA for the default, wide, two-level and
sub-tiled walks and the pair walk; the sparse-visit walk refuses it, as the
reference does). Where the reference
silently drops an option that cannot apply, `_walk_impl` raises ValueError:
an explicit request never runs another kernel.

`build_walk_tables` also takes the laboratory's build variants: a caller's
BVH, the builder ("binned" or "sweep") and a tightness-aware re-pack
(`repack_alpha`), as arguments only.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import EPSILON
from ..ops.coherence_key import _morton, _octant, _quantize, incidence_key
from ..ops.walk_hier import (MAX_CLUSTERS, SUP, walk_hier_anyhit,
                             walk_hier_closest)
from ..ops.walk_sparse import walk_sparse_anyhit, walk_sparse_closest
from ..ops.walk_sub import (MAX_VMEM_CLUSTERS, SUBS, walk_sub_anyhit,
                            walk_sub_closest)
from ..ops.walk_trace import (K, RAY_TILE, _ID_BITS, check_k, walk_anyhit,
                              walk_closest)
from ..utils.tracing import count, span
from .bvh import build_bvh
from .dense import RayHit

_BIG = 1e30                        # bounds of pad clusters: distant points
# tables past this many clusters take the two-level walk: the one-level
# walk's packed entries carry the cluster id in _ID_BITS mantissa bits
FLAT_MAX_CLUSTERS = 1 << _ID_BITS
# the incidence key's [N, C] slab pass is linear in C; past this many
# clusters every wavefront takes the morton key (pallas_walk.py:102)
_INC_SORT_MAX_C = 32768


class WalkOptions(NamedTuple):
    """The walk's schedule, with the reference's names and defaults (there
    environment variables read at import, pallas_walk.py:83-106, :475)."""
    sub: int = 1                  # > 1: the sub-tiled walk, K6
    sparse: bool = False          # the sparse-visit walk, K7
    pair: bool = False            # the pair walk, K8
    km: int = 8                   # the pair walk's shortlist length
    wide: bool = None             # None: past 2^14 clusters unless hier
    hier: bool = None             # None: past 2^14 clusters
    compact_inert: bool = False   # the morton key sorts inert lanes last
    mxu_tritest: bool = False     # the tensor-core form of the triangle test
    inc_sort: bool = True         # spread-origin wavefronts: incidence key


class WalkTables(NamedTuple):
    n_tris: int
    n_clusters: int   # Cp: the real clusters padded to a multiple of 128
    n_real: int       # real clusters (treelets), the first n_real of Cp
    n_sup: int        # real supers: ceil(n_real / SUP)
    n_sup_pad: int    # Sp: the super count padded to a multiple of 128
    rows: Any         # [Cp*K, 3, 4] f32 Baldwin-Weber rows, cluster-major
    ids: Any          # [Cp*K] int32 triangle ids, -1 in pad slots
    lo: Any           # [3, Cp] f32 cluster bounds (pads: _BIG)
    hi: Any           # [3, Cp] f32
    slo: Any          # [3, Sp] f32 super bounds: union of real children
    shi: Any          # [3, Sp] f32 (pads: _BIG)
    world_lo: Any     # [3] f32 scene bounds (the morton grid of the sort key)
    world_hi: Any     # [3] f32
    options: WalkOptions = WalkOptions()
    k: int = K        # triangles per cluster


def _check_clusters(cp: int) -> None:
    if cp > MAX_CLUSTERS:
        raise NotImplementedError(
            f"{cp} walk clusters exceed the ceiling of {MAX_CLUSTERS} of "
            "the two-level walk (K5), as in the reference")


def _super_tables(lo, hi, c: int):
    """Super tables of cluster bounds lo/hi [3, Cp] with c real clusters in
    groups of SUP (a divisor of 128), as the reference builds them
    (pallas_walk.py:274-285): (n_sup, Sp, slo, shi), each super the union
    of its real children; pad supers stay _BIG."""
    cp = lo.shape[1]
    ns = -(-c // SUP)                                    # real supers
    ncol = cp // SUP
    sp = ((ncol + 127) // 128) * 128
    slo = np.full((3, sp), _BIG, np.float32)
    shi = np.full((3, sp), _BIG, np.float32)
    slo[:, :ncol] = lo.reshape(3, ncol, SUP).min(2)      # _BIG pads inert
    hi_m = np.where(np.arange(cp)[None, :] < c, hi, -_BIG)
    shi_v = hi_m.reshape(3, ncol, SUP).max(2)
    shi[:, :ncol] = np.where(shi_v <= -_BIG, _BIG, shi_v)  # all-pad supers
    return ns, sp, slo, shi


def _treelet_cut(nodes: np.ndarray, max_tris: int):
    """Cut the skip-link preorder BVH into maximal subtrees of <= max_tris
    primitives. Returns [(prim_start, prim_count)] segments in preorder,
    which tile the preorder primitive array contiguously."""
    ints = nodes[:, 6:9].copy().view(np.int32)
    skip, start, cnt = ints[:, 0], ints[:, 1], ints[:, 2]
    m = nodes.shape[0]
    sub_cnt = np.zeros(m, np.int64)
    sub_start = np.zeros(m, np.int64)
    for i in range(m - 1, -1, -1):
        if cnt[i] > 0:                                   # leaf
            sub_cnt[i] = cnt[i]
            sub_start[i] = start[i]
        else:                                            # left = i + 1,
            l = i + 1                                    # right = skip(left)
            r = skip[l]
            sub_cnt[i] = sub_cnt[l] + sub_cnt[r]
            sub_start[i] = sub_start[l]
    out = []
    stack = [0]
    while stack:
        i = stack.pop()
        if cnt[i] > 0 or sub_cnt[i] <= max_tris:
            out.append((int(sub_start[i]), int(sub_cnt[i])))
        else:
            l = i + 1
            stack.append(skip[l])                        # right after left
            stack.append(l)
    return out


def _box_area(lo_v, hi_v):
    """Surface area of the box [lo_v, hi_v] ([3] f32), in f32 as the
    reference's _sa (pallas_walk.py:223-225)."""
    d = np.maximum(hi_v - lo_v, 0.0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def build_walk_tables(geom, bvh=None, builder: str = None,
                      repack_alpha: float = None, k: int = K) -> WalkTables:
    """Host build over numpy geometry tables: the treelets of a SAH BVH
    (max_leaf = 8) greedily re-packed up to k per cluster, with tight
    per-cluster bounds. k (the tables' K, triangles per cluster) must pass
    ops/walk_trace.py:check_k.

    bvh: a caller's max_leaf = 8 build to share; else one is built with
    `builder`, "binned" (the default) or "sweep" (accel/bvh.py).
    repack_alpha: if set, the re-pack is tightness-aware: neighbours merge
    only when SA(merged) <= alpha * (SA(a) + SA(b)), so spatially disjoint
    treelets stay separate clusters at the price of a lower fill."""
    k = check_k(k)
    if bvh is None:
        bvh = build_bvh(geom, max_leaf=8, builder=builder or "binned")
    order = np.asarray(bvh.prim_index)                   # SAH preorder
    t = order.shape[0]
    nodes = np.stack([bvh.bbox_lo, bvh.bbox_hi], axis=1).reshape(-1, 6)
    ints = np.stack([bvh.skip, bvh.prim_start, bvh.prim_count], axis=1)
    nodes = np.concatenate([nodes.astype(np.float32),
                            ints.astype(np.int32).view(np.float32)], axis=1)
    segs = _treelet_cut(nodes, k)
    all_rows = np.asarray(geom.inter_rows[: geom.n_tris])[order]
    v0 = np.asarray(geom.v0[: geom.n_tris])[order]
    p1 = v0 + np.asarray(geom.e1[: geom.n_tris])[order]
    p2 = v0 + np.asarray(geom.e2[: geom.n_tris])[order]
    tri_lo = np.minimum(np.minimum(v0, p1), p2)          # [T, 3]
    tri_hi = np.maximum(np.maximum(v0, p1), p2)
    # greedy consecutive re-pack: segments tile the prim array in order, so
    # merged neighbours keep their ranges contiguous. With repack_alpha the
    # merged box must also stay tight (f32 arithmetic on the f32 rows, as
    # the reference, so the cuts fall where its cuts fall).
    sa_aware = repack_alpha is not None
    if sa_aware:
        seg_starts = np.fromiter((s for s, _ in segs), np.int64, len(segs))
        seg_lo = np.minimum.reduceat(tri_lo, seg_starts, axis=0)
        seg_hi = np.maximum.reduceat(tri_hi, seg_starts, axis=0)
        clo, chi = seg_lo[0].copy(), seg_hi[0].copy()
    cuts = []
    cs, cn = segs[0]
    for i, (s, n) in enumerate(segs[1:], start=1):
        ok = cn + n <= k
        if ok and sa_aware:
            mlo = np.minimum(clo, seg_lo[i])
            mhi = np.maximum(chi, seg_hi[i])
            ok = _box_area(mlo, mhi) <= repack_alpha * (
                _box_area(clo, chi) + _box_area(seg_lo[i], seg_hi[i]))
        if ok:
            cn += n
            if sa_aware:
                clo, chi = mlo, mhi
        else:
            cuts.append((cs, cn))
            cs, cn = s, n
            if sa_aware:
                clo, chi = seg_lo[i].copy(), seg_hi[i].copy()
    cuts.append((cs, cn))

    c = len(cuts)
    cp = ((c + 127) // 128) * 128
    _check_clusters(cp)
    starts = np.fromiter((s for s, _ in cuts), np.int64, c)
    counts = np.fromiter((n for _, n in cuts), np.int64, c)
    cluster_of = np.repeat(np.arange(c, dtype=np.int64), counts)
    dest = cluster_of * k + (np.arange(t, dtype=np.int64)
                             - np.repeat(starts, counts))
    rows = np.zeros((cp * k, 3, 4), np.float32)
    rows[dest] = all_rows
    ids = np.full(cp * k, -1, np.int32)
    ids[dest] = order
    lo = np.full((3, cp), _BIG, np.float32)
    hi = np.full((3, cp), _BIG, np.float32)
    lo[:, :c] = np.minimum.reduceat(tri_lo, starts, axis=0).T
    hi[:, :c] = np.maximum.reduceat(tri_hi, starts, axis=0).T
    ns, sp, slo, shi = _super_tables(lo, hi, c)
    return WalkTables(n_tris=t, n_clusters=cp, n_real=c, n_sup=ns,
                      n_sup_pad=sp, rows=rows, ids=ids, lo=lo, hi=hi,
                      slo=slo, shi=shi,
                      world_lo=tri_lo.min(0).astype(np.float32),
                      world_hi=tri_hi.max(0).astype(np.float32), k=k)


def walk_tables_from_numpy(wt) -> WalkTables:
    """This package's numpy WalkTables from the JAX package's (read by
    attribute): its resident layout, rows [4, C, 3K] + ids [C, K], or its
    HBM layout, rows [C, 8, 3K] with the ids bitcast into component row 4;
    K is read off the rows' width. This package's own tables pass
    through."""
    if isinstance(wt, WalkTables):
        return wt
    cp = int(wt.n_clusters)
    _check_clusters(cp)
    k = check_k(np.shape(wt.rows)[-1] // 3)
    if wt.resident:
        packed = np.asarray(wt.rows)                     # [4, C, 3K]
        ids = np.asarray(wt.ids, np.int32).reshape(-1)
    else:
        blk = np.asarray(wt.rows)                        # [C, 8, 3K]
        packed = blk[:, 0:4, :].transpose(1, 0, 2)
        ids = np.ascontiguousarray(blk[:, 4, :k]).view(np.int32).reshape(-1)
    # packed[j, c, b*K + i] is component j of row b of triangle i of c
    rows = packed.reshape(4, cp, 3, k).transpose(1, 3, 2, 0)
    rows = np.ascontiguousarray(rows.reshape(cp * k, 3, 4), np.float32)
    return WalkTables(
        n_tris=int(wt.n_tris), n_clusters=cp, n_real=int(wt.n_real),
        n_sup=int(wt.n_sup), n_sup_pad=int(wt.n_sup_pad), rows=rows, ids=ids,
        lo=np.asarray(wt.lo, np.float32), hi=np.asarray(wt.hi, np.float32),
        slo=np.asarray(wt.slo, np.float32), shi=np.asarray(wt.shi, np.float32),
        world_lo=np.asarray(wt.world_lo, np.float32),
        world_hi=np.asarray(wt.world_hi, np.float32), k=k)


def walk_tables_to(wt, device, walk_options: WalkOptions = None) -> WalkTables:
    """Upload numpy walk tables (this package's or the JAX package's), their
    K with them; `walk_options` replaces the tables' schedule options."""
    wt = walk_tables_from_numpy(wt)
    if walk_options is None:
        walk_options = wt.options
    arrays = {f: torch.as_tensor(np.ascontiguousarray(getattr(wt, f)),
                                 device=device)
              for f in ("rows", "ids", "lo", "hi", "slo", "shi", "world_lo",
                        "world_hi")}
    return WalkTables(n_tris=int(wt.n_tris), n_clusters=int(wt.n_clusters),
                      n_real=int(wt.n_real), n_sup=int(wt.n_sup),
                      n_sup_pad=int(wt.n_sup_pad),
                      options=WalkOptions(*walk_options), k=int(wt.k),
                      **arrays)


# ------------------------------------------------------------- coherence keys

def _sort_key(wt, o, d, tfar=None):
    """Morton coherence key as a (major, minor) int32 pair: major = direction
    octant | 5-bit/axis origin morton, minor = 5-bit/axis |d| morton. With
    `tfar`, inert lanes (tfar <= 0) take the bit above the octant, so they
    sort after every live lane."""
    octant = _octant(d)
    if tfar is not None:
        octant = octant | ((tfar <= 0.0).int() << 3)
    ext = torch.clamp(wt.world_hi - wt.world_lo, min=1e-9)
    m = _morton(_quantize((o - wt.world_lo) / ext * 32.0, 32), 5)
    dm = _morton(_quantize(torch.abs(d) * 32.0, 32), 5)
    return (octant << 15) | m, dm


def _incidence_key(wt, o, d, tnear, tfar):
    """Incidence coherence key as a (major, minor) int32 pair: a slab pass
    gives each ray its overlapped real clusters; major = direction octant |
    6-bit/axis morton of the centroid of their centres, minor = their count
    (capped at 63). One CUDA kernel on the card, its plain version on the
    CPU (ops/coherence_key.py:incidence_key). Kept under this name for the
    labs (tools/perf/sortkey_lab.py, grouping_lab.py), which call it
    directly, and for chip_smoke.py, which wraps it to capture a
    wavefront."""
    return incidence_key(wt, o, d, tnear, tfar)


# ----------------------------------------------------------------- the walk

def _origin_spread(o, tfar):
    """Largest extent of the live lanes' origins; dead lanes take the first
    live origin (lane 0 may be inert)."""
    live = tfar > 0.0
    ref_o = o[torch.argmax(live.int())]
    o_live = torch.where(live[:, None], o, ref_o)
    return torch.amax(o_live.amax(dim=0) - o_live.amin(dim=0))


def _prepare(wt, o, d, tnear, tfar, sort_rays: bool = True,
             compact_inert: bool = False, inc_sort: bool = True):
    """Sanitize, coherence-sort and pad a wavefront for the walk kernels.
    `inc_sort=False` gives every wavefront the morton key, with no host
    read; `compact_inert` hands that key the inert lanes. As in the
    reference (pallas_walk.py:1542-1546), the incidence key ignores
    compact_inert.

    Returns (o, d, tnear, tfar, order): contiguous [n_pad] rays in the
    order the kernels take them, and the lane of each sorted ray (None when
    unsorted)."""
    n = o.shape[0]
    # dead lanes can carry NaN rays or ranges: NaN/negative tfar -> 0 (an
    # inert ray), NaN tnear -> +inf
    tfar = torch.where(tfar > 0.0, tfar, 0.0)
    tnear = torch.where(tnear >= 0.0, tnear, float("inf"))
    order = None
    if sort_rays and n >= 2 * RAY_TILE:
        o_safe = torch.where(torch.isfinite(o), o, 0.0)
        d_safe = torch.where(torch.isfinite(d), d, 0.0)
        # point-origin wavefronts (camera rays) take the morton key
        spread = False
        if inc_sort and int(wt.n_clusters) <= _INC_SORT_MAX_C:
            with span("walk.sync"):
                spread = bool(_origin_spread(o_safe, tfar) > 1e-5
                              * torch.amax(wt.world_hi - wt.world_lo))
        if spread:
            count("walk.key.incidence")
            kmaj, kmin = _incidence_key(wt, o_safe, d_safe, tnear, tfar)
        else:
            count("walk.key.morton")
            kmaj, kmin = _sort_key(wt, o_safe, d_safe,
                                   tfar if compact_inert else None)
        key = (kmaj.long() << 32) | kmin.long()
        order = torch.sort(key, stable=True).indices
        o, d, tnear, tfar = o[order], d[order], tnear[order], tfar[order]
    pad = (-n) % RAY_TILE
    if pad:
        dev = o.device
        o = torch.cat([o, torch.zeros((pad, 3), device=dev)])
        d = torch.cat([d, torch.ones((pad, 3), device=dev)])
        tnear = torch.cat([tnear, torch.full((pad,), float("inf"), device=dev)])
        tfar = torch.cat([tfar, torch.zeros(pad, device=dev)])
    return (o.contiguous(), d.contiguous(), tnear.contiguous(),
            tfar.contiguous(), order)


def _unsort(x, order, n):
    x = x[:n]
    if order is None:
        return x
    out = torch.empty_like(x)
    out[order] = x
    return out


def _resolve(wt, hier, wide, sub, sparse, mxu=None):
    """The kernels' schedule for tables `wt`: (hier, wide, sub, sparse, mxu),
    resolved in the reference's order (pallas_walk.py:1499-1510,
    :1613-1654). None takes the tables' option. An option that cannot
    apply raises ValueError where the reference drops it; the sparse-visit
    walk with the tensor-core triangle test raises as in the reference
    (:1631-1639)."""
    opt = wt.options
    mxu = bool(opt.mxu_tritest if mxu is None else mxu)
    hier = opt.hier if hier is None else hier
    wide = opt.wide if wide is None else wide
    sub = opt.sub if sub is None else int(sub)
    sparse = bool(opt.sparse if sparse is None else sparse)
    cp = int(wt.n_clusters)
    if hier is None and wide is None:
        hier = cp > FLAT_MAX_CLUSTERS
    hier = bool(hier)
    if wide is None:
        wide = cp > FLAT_MAX_CLUSTERS and not hier
    if hier and wide:
        raise ValueError("walk: hier and wide are two routes; ask for one")
    if not wide and not hier and cp > FLAT_MAX_CLUSTERS:
        raise ValueError(f"walk: {cp} clusters exceed the packed entries' "
                         f"2^{_ID_BITS}; take wide=True or hier=True (or "
                         "leave both None)")
    for name, on in (("sub", sub > 1), ("sparse", sparse)):
        if not on:
            continue
        if hier or wide:
            raise ValueError(f"walk: {name} goes with the packed one-level "
                             f"walk, not with {'hier' if hier else 'wide'}")
        if cp > MAX_VMEM_CLUSTERS:
            raise ValueError(
                f"walk: {name} takes tables of at most {MAX_VMEM_CLUSTERS} "
                f"clusters (the reference's resident tables), not {cp}")
    if sub < 1 or (sub > 1 and sub not in SUBS):
        raise ValueError(f"walk: sub must be 1 or one of {SUBS} (whole "
                         f"8-ray rows of a {RAY_TILE}-ray tile), got {sub}")
    if sparse and sub > 1:
        raise ValueError("walk: sparse and sub > 1 are two schedules; ask "
                         "for one")
    if sparse and mxu:
        raise ValueError("walk: sparse and mxu_tritest are mutually "
                         "exclusive (the sparse visit has no tensor-core "
                         "triangle test; mixing the two forms breaks its bit "
                         "parity)")
    return hier, bool(wide), sub, sparse, mxu


def _walk_impl(wt, o, d, tnear, tfar, any_hit: bool, sort_rays: bool = True,
               hier: bool = None, wide: bool = None, sub: int = None,
               sparse: bool = None, compact_inert: bool = None,
               inc_sort: bool = None, mxu_tritest: bool = None):
    """Closest hit (RayHit) or occlusion ([n] bool) of a wavefront over
    device walk tables. The keyword options pick the schedule and the sort
    key; None takes the tables' option (wt.options), whose defaults are the
    two-level walk past FLAT_MAX_CLUSTERS clusters and the packed
    one-level walk below."""
    n = o.shape[0]
    hier, wide, sub, sparse, mxu = _resolve(wt, hier, wide, sub, sparse,
                                            mxu_tritest)
    opt = wt.options
    if hier:
        closest = lambda *a: walk_hier_closest(*a, mxu=mxu)
        anyhit = lambda *a: walk_hier_anyhit(*a, mxu=mxu)
    elif sub > 1:
        closest = lambda *a: walk_sub_closest(*a, sub, mxu=mxu)
        anyhit = lambda *a: walk_sub_anyhit(*a, sub, mxu=mxu)
    elif sparse:
        closest, anyhit = walk_sparse_closest, walk_sparse_anyhit
    else:
        closest = lambda *a: walk_closest(*a, wide=wide, mxu=mxu)
        anyhit = lambda *a: walk_anyhit(*a, wide=wide, mxu=mxu)
    dev = o.device
    with span("walk.prepare", dev):
        o, d, tnear, tfar, order = _prepare(
            wt, o, d, tnear, tfar, sort_rays,
            opt.compact_inert if compact_inert is None else compact_inert,
            opt.inc_sort if inc_sort is None else inc_sort)
    with span("walk.kernel", dev):
        res = (anyhit if any_hit else closest)(wt, o, d, tnear, tfar)
    with span("walk.unsort", dev):
        if any_hit:
            return _unsort(res, order, n)
        t, tri, u, v = (_unsort(x, order, n) for x in res)
        return RayHit(t=t, tri=tri, u=u, v=v, hit=tri >= 0)


def _default_range(o, tnear, tfar):
    n = o.shape[0]
    if tnear is None:
        tnear = torch.full((n,), EPSILON, dtype=torch.float32, device=o.device)
    if tfar is None:
        tfar = torch.full((n,), float("inf"), dtype=torch.float32,
                          device=o.device)
    return tnear, tfar


def intersect_walk(wt, o, d, tnear=None, tfar=None, wide: bool = None,
                   hier: bool = None, sub: int = None, sparse: bool = None,
                   inc_sort: bool = None, mxu_tritest: bool = None) -> RayHit:
    """Closest hit of rays (o, d) [n, 3] over device walk tables."""
    return _walk_impl(wt, o, d, *_default_range(o, tnear, tfar), False,
                      wide=wide, hier=hier, sub=sub, sparse=sparse,
                      inc_sort=inc_sort, mxu_tritest=mxu_tritest)


def occluded_walk(wt, o, d, tnear=None, tfar=None, wide: bool = None,
                  hier: bool = None, sub: int = None, sparse: bool = None,
                  inc_sort: bool = None, mxu_tritest: bool = None):
    """Any hit of rays (o, d) over device walk tables; True = blocked."""
    return _walk_impl(wt, o, d, *_default_range(o, tnear, tfar), True,
                      wide=wide, hier=hier, sub=sub, sparse=sparse,
                      inc_sort=inc_sort, mxu_tritest=mxu_tritest)

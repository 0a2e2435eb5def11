"""Tile-formation laboratory beyond sort keys: grouping algorithms measured
offline against the exact ray-cluster incidence matrix of the laboratory's
scene (tools/perf/sortkey_lab.py's, the same wavefronts, RAY_TILE 64); the
port's counterpart of the JAX package's tools/perf/grouping_lab.py.

  * production_sort      the catalog's 'oct|om5|dm5' order
  * port_incidence       the port's production incidence key
                         (accel/walk.py:_incidence_key)
  * surrogate            lexsort (lowest-id overlapped cluster, |set|)
  * entry+size           lexsort (first cluster entered along the ray,
                         |set|): one [N, C] slab pass, feasible at run time
  * entry+second+size    the second-entered cluster as a tie-break
  * bitset-lexsort       rays sorted by their packed incidence bitset
  * kmeans               minibatch k-means on incidence vectors, tiles
                         packed group by group
  * greedy-union         greedy tile packing: each tile seeded with the
                         first unassigned ray of the surrogate's order and
                         filled with the rays that add the fewest new
                         clusters to its union (the strongest offline
                         bound; minutes on the host at 262,144 rays)

The orders are host numpy with the reference's seeds, equal order for order
to the reference's. On a card the incidence matrix is formed there
(sortkey_lab.ray_cluster_hits).

    python -m rustlight_tpu_torch.tools.perf.grouping_lab [--device cpu]
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ...accel.walk import build_walk_tables, walk_tables_to
from . import common
from .sortkey_lab import (RAY_TILE, cluster_boxes, keys_catalog,
                          lab_wavefronts, production_orders, ray_cluster_hits,
                          tile_union)


def entry_cluster(lo, hi, o, d, chunk=8192):
    """Each ray's (first, second) cluster entered along it: the argmin of
    the clamped slab entry over its overlapped clusters (C where there is
    none); one [N, C] slab pass, no incidence matrix kept."""
    n, c = o.shape[0], lo.shape[0]
    first = np.full(n, c, np.int64)
    second = np.full(n, c, np.int64)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        inv = 1.0 / np.where(np.abs(d[s:e]) > 1e-12, d[s:e],
                             np.where(d[s:e] >= 0, 1e-12, -1e-12))
        t0 = (lo[None] - o[s:e, None, :]) * inv[:, None, :]
        t1 = (hi[None] - o[s:e, None, :]) * inv[:, None, :]
        tmin = np.minimum(t0, t1).max(-1)
        tmax = np.maximum(t0, t1).min(-1)
        entry = np.where(tmax >= np.maximum(tmin, 0.0),
                         np.maximum(tmin, 0.0), np.inf)
        order = np.argsort(entry, axis=1)
        first[s:e] = np.where(np.isfinite(
            np.take_along_axis(entry, order[:, :1], 1)[:, 0]),
            order[:, 0], c)
        second[s:e] = np.where(np.isfinite(
            np.take_along_axis(entry, order[:, 1:2], 1)[:, 0]),
            order[:, 1], c)
    return first, second


def bitset_lexsort(hits):
    """The rays in the order of their packed incidence bitsets (the lowest
    cluster ids most significant)."""
    packed = np.packbits(hits, axis=1)
    cols = [packed[:, i].astype(np.int64)
            for i in range(packed.shape[1] - 1, -1, -1)]
    return np.lexsort(cols)


def kmeans_order(hits, ray_tile, iters=8, sample=32768, seed=0):
    """Minibatch k-means on the incidence vectors; tiles packed group-major,
    by set size inside a group."""
    rng = np.random.default_rng(seed)
    n = hits.shape[0]
    k = max(n // ray_tile // 16, 64)     # coarse groups; tiles pack inside
    x = hits.astype(np.float32)
    idx = rng.choice(n, size=min(sample, n), replace=False)
    cent = x[rng.choice(n, size=k, replace=False)]
    for _ in range(iters):
        xb = x[idx]
        # the nearest centroid by dot similarity
        sim = xb @ cent.T
        assign = sim.argmax(1)
        for j in range(k):
            m = assign == j
            if m.any():
                cent[j] = xb[m].mean(0)
    assign_all = (x @ cent.T).argmax(1)
    sizes = hits.sum(1)
    return np.lexsort((sizes, assign_all))


def greedy_union_order(hits, ray_tile, max_scan=4096, seed=0):
    """Greedy tile packing: each tile seeded with the first unassigned ray
    of the surrogate's order (lowest-id overlapped cluster, set size), then
    filled from a window of max_scan candidates after it with the rays
    whose sets add the fewest new clusters to the tile's union.
    O(T x window x C)."""
    n, c = hits.shape
    first = np.where(hits.any(1), hits.argmax(1), c)
    sizes = hits.sum(1)
    base = np.lexsort((sizes, first))      # the candidates, floor order
    packed = np.packbits(hits[base], axis=1)
    taken = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    out_pos = 0
    ptr = 0
    while out_pos < n:
        while ptr < n and taken[ptr]:
            ptr += 1
        if ptr >= n:
            break
        tile_u = packed[ptr].copy()
        taken[ptr] = True
        order[out_pos] = base[ptr]
        out_pos += 1
        fill = 1
        while fill < ray_tile and out_pos < n:
            end = min(ptr + 1 + max_scan, n)
            cand = np.nonzero(~taken[ptr + 1:end])[0]
            if cand.size == 0:
                ptr = end
                if ptr >= n:
                    break
                continue
            cidx = cand + ptr + 1
            new_bits = np.unpackbits(packed[cidx] & ~tile_u[None],
                                     axis=1).sum(1)
            best = cidx[new_bits.argmin()]
            tile_u |= packed[best]
            taken[best] = True
            order[out_pos] = base[best]
            out_pos += 1
            fill += 1
    return order[:out_pos]


def _union(hits, order, **extra):
    mu, mx = tile_union(hits, order)
    return {"union_mean": round(mu, 2), "union_max": mx, **extra}


def main(argv=None) -> dict:
    p = common.parser(__doc__, "grouping_lab_h100.json")
    args = p.parse_args(argv)
    dev = common.pick_device(args.device)
    rng = np.random.default_rng(3)
    n = args.rays
    geom, ext = common.lab_scene(args.tris, args.theta)
    host = build_walk_tables(geom)
    wt = walk_tables_to(host, dev)
    lo, hi = cluster_boxes(host)
    wlo, whi = np.asarray(host.world_lo), np.asarray(host.world_hi)
    report = {**common.device_record(dev), "rays": n, "ray_tile": RAY_TILE,
              "clusters": int(host.n_real)}
    # divergent first, as the reference reports them
    for tag, (o, d) in reversed(lab_wavefronts(rng, n, ext)):
        o64, d64 = o.astype(np.float64), d.astype(np.float64)
        hits = ray_cluster_hits(lo, hi, o64, d64,
                                device=dev if dev.type == "cuda" else None)
        sizes = hits.sum(1)
        c = hits.shape[1]
        row = {}
        key = keys_catalog(o, d, wlo, whi)["oct|om5|dm5"]
        row["production_sort"] = _union(hits, np.argsort(key, kind="stable"))
        row["port_incidence"] = _union(
            hits, production_orders(wt, o, d)["port incidence"])
        firstid = np.where(hits.any(1), hits.argmax(1), c)
        row["surrogate_firstid_size"] = _union(hits,
                                               np.lexsort((sizes, firstid)))
        t0 = time.time()
        ent1, ent2 = entry_cluster(lo, hi, o64, d64)
        row["entry_precompute_s"] = round(time.time() - t0, 1)
        row["entry_size"] = _union(hits, np.lexsort((sizes, ent1)))
        row["entry_second_size"] = _union(hits,
                                          np.lexsort((sizes, ent2, ent1)))
        for name, fn in (("bitset_lexsort", lambda: bitset_lexsort(hits)),
                         ("kmeans", lambda: kmeans_order(hits, RAY_TILE)),
                         ("greedy_union",
                          lambda: greedy_union_order(hits, RAY_TILE))):
            t0 = time.time()
            order = fn()
            row[name] = _union(hits, order,
                               wall_s=round(time.time() - t0, 1))
        for k2, v in row.items():
            print(f"[{tag}] {k2}: {v}", flush=True)
        report[tag] = row
    common.write_record(args.out, report)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])

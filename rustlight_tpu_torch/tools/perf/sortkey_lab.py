"""Wavefront-coherence laboratory of the tile walk: the exact ray-cluster
incidence matrix of the laboratory's scene and the tile unions it gives
under candidate sort keys; the port's counterpart of the JAX package's
tools/perf/sortkey_lab.py.

The walk visits, per 64-ray tile, about the union of the clusters its rays
overlap, so two properties of the incidence matrix bound what a sort key
can do:

  * per-ray overlap: |clusters(r)|, the per-ray floor of a tree;
  * the clusters' pairwise box overlap: if it is near 0, spatial splits
    have no purchase on the scene;
  * the per-tile union |U_{r in tile} clusters(r)| under each key of
    `keys_catalog`, under the port's production keys (accel/walk.py:
    _sort_key, the morton key of point-origin wavefronts, and
    _incidence_key, the key of spread-origin ones) and under a RAY_TILE
    sweep;
  * the grouping floor: the union if rays were grouped by their
    lowest-id overlapped cluster and set size, which no key sees.

The incidence matrix is the reference's float64 slab test. On a card it
runs there as torch ops, 8,192 rays a chunk (`ray_cluster_hits` with a
device), equal bool for bool to the numpy form, which the CPU runs.

    python -m rustlight_tpu_torch.tools.perf.sortkey_lab [--device cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ...accel.walk import (_default_range, _incidence_key, _sort_key,
                           build_walk_tables, walk_tables_to)
from . import common

RAY_TILE = 64


def ray_cluster_hits(lo, hi, o, d, chunk=8192, device=None):
    """Exact slab test -> bool [N, C] incidence (tnear=0, tfar=inf), lo, hi
    [C, 3] and o, d [N, 3] float64. With a torch `device` the chunks run
    there as float64 torch ops (the same IEEE operations, so the same
    bools); the result is numpy either way."""
    n = o.shape[0]
    c = lo.shape[0]
    out = np.zeros((n, c), bool)
    if device is not None:
        lo_t, hi_t = (torch.as_tensor(x, dtype=torch.float64, device=device)
                      for x in (lo, hi))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        if device is not None:
            out[s:e] = _hits_torch(lo_t, hi_t, o[s:e], d[s:e], device)
            continue
        inv = 1.0 / np.where(np.abs(d[s:e]) > 1e-12, d[s:e],
                             np.where(d[s:e] >= 0, 1e-12, -1e-12))
        t0 = (lo[None] - o[s:e, None, :]) * inv[:, None, :]
        t1 = (hi[None] - o[s:e, None, :]) * inv[:, None, :]
        tmin = np.minimum(t0, t1).max(-1)
        tmax = np.maximum(t0, t1).min(-1)
        out[s:e] = (tmax >= np.maximum(tmin, 0.0))
    return out


def _hits_torch(lo, hi, o, d, device):
    """One chunk of ray_cluster_hits in float64 torch ops on `device`."""
    o, d = (torch.as_tensor(x, dtype=torch.float64, device=device)
            for x in (o, d))
    tiny = torch.full_like(d, 1e-12)
    inv = 1.0 / torch.where(d.abs() > 1e-12, d,
                            torch.where(d >= 0, tiny, -tiny))
    t0 = (lo[None] - o[:, None, :]) * inv[:, None, :]
    t1 = (hi[None] - o[:, None, :]) * inv[:, None, :]
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    return (tmax >= torch.maximum(tmin, torch.zeros_like(tmin))).cpu().numpy()


def cluster_overlap_stats(lo, hi):
    """Pairwise box overlap of the clusters lo, hi [C, 3]: the total
    intersection volume over twice the total volume, and the mean number of
    other clusters a cluster's box intersects."""
    c = lo.shape[0]
    vol = np.prod(np.maximum(hi - lo, 0.0), -1)
    inter_vol = 0.0
    touching = 0
    for i in range(c):
        ilo = np.maximum(lo[i], lo)
        ihi = np.minimum(hi[i], hi)
        iv = np.prod(np.maximum(ihi - ilo, 0.0), -1)
        iv[i] = 0.0
        inter_vol += iv.sum()
        touching += int((iv > 0).sum())
    return dict(
        overlap_vol_frac=float(inter_vol / max(2.0 * vol.sum(), 1e-30)),
        mean_touching=float(touching / c))


def tile_union(hits, order, ray_tile=RAY_TILE):
    """(mean, max) over whole tiles of ray_tile rays in `order` of the
    number of clusters any of their rays overlaps."""
    h = hits[order]
    t = h.shape[0] // ray_tile
    u = h[: t * ray_tile].reshape(t, ray_tile, -1).any(1).sum(-1)
    return float(u.mean()), int(u.max())


def morton(q, bits):
    """Interleave the low `bits` bits of q [n, 3] (x lowest), int64."""
    m = np.zeros(q.shape[0], np.int64)
    for b in range(bits):
        for ax in range(3):
            m |= ((q[:, ax].astype(np.int64) >> b) & 1) << (3 * b + ax)
    return m


def keys_catalog(o, d, wlo, whi):
    """Candidate coherence keys, int64 [N] each: 'oct|om5|dm5' orders as
    the production morton key (accel/walk.py:_sort_key); 'prod-r3(dm3)' is
    the key it replaced in the reference."""
    ext = np.maximum(whi - wlo, 1e-9)
    octant = ((d[:, 0] > 0).astype(np.int64) * 4
              + (d[:, 1] > 0).astype(np.int64) * 2
              + (d[:, 2] > 0).astype(np.int64))

    def oq(bits):
        return np.clip(((o - wlo) / ext * (1 << bits)).astype(np.int64),
                       0, (1 << bits) - 1)

    dq3 = np.clip((np.abs(d) * 8.0).astype(np.int64), 0, 7)
    dq5 = np.clip((np.abs(d) * 32.0).astype(np.int64), 0, 31)
    prod_r3 = (octant << 24) | (morton(oq(5), 5) << 9) | morton(dq3, 3)

    out = {"unsorted": np.arange(o.shape[0], dtype=np.int64),
           "prod-r3(dm3)": prod_r3}
    # finer origin morton (7 bits an axis)
    out["oct|om7|dm3"] = ((octant << 32) | (morton(oq(7), 7) << 9)
                          | morton(dq3, 3))
    # origin-major: the spatial cell before the octant
    out["om5|oct|dm3"] = ((morton(oq(5), 5) << 12) | (octant << 9)
                          | morton(dq3, 3))
    # direction-major: the fine |d| cone before the origin
    out["oct|dm5|om5"] = ((octant << 30) | (morton(dq5, 5) << 15)
                          | morton(oq(5), 5))
    # the production order: origin-major with fine direction bits below,
    # which take over when a wavefront's origins are one point
    out["oct|om5|dm5"] = ((octant << 30) | (morton(oq(5), 5) << 15)
                          | morton(dq5, 5))
    # origin and direction bits woven together
    q5, d3 = oq(5), dq3
    six = np.zeros(o.shape[0], np.int64)
    pos = 0
    for b in range(5):
        for ax in range(3):
            six |= ((q5[:, ax] >> (4 - b)) & 1) << (62 - pos)
            pos += 1
        if b < 3:
            for ax in range(3):
                six |= ((d3[:, ax] >> (2 - b)) & 1) << (62 - pos)
                pos += 1
    out["6d-interleave"] = (octant << 40) | (six >> 22)
    return out


def grouping_floor(hits):
    """The union if tiles were packed by (lowest-id overlapped cluster, set
    size): a surrogate of grouping by set similarity that no key can see
    (it needs the incidence matrix itself)."""
    c = hits.shape[1]
    first = np.where(hits.any(1), hits.argmax(1), c)
    sizes = hits.sum(1)
    order = np.lexsort((sizes, first))
    return tile_union(hits, order)


def production_orders(wt, o, d):
    """The order each production key gives the wavefront (o, d numpy f32)
    on device tables `wt`: {"port morton": _sort_key's, "port incidence":
    _incidence_key's}, stable, as accel/walk.py:_prepare sorts."""
    dev = wt.lo.device
    o_t, d_t = common.to_device(dev, o, d)
    tnear, tfar = _default_range(o_t, None, None)
    out = {}
    for name, (kmaj, kmin) in (
            ("port morton", _sort_key(wt, o_t, d_t)),
            ("port incidence", _incidence_key(wt, o_t, d_t, tnear, tfar))):
        key = (kmaj.long() << 32) | kmin.long()
        out[name] = torch.sort(key, stable=True).indices.cpu().numpy()
    return out


def lab_wavefronts(rng, n, ext):
    """The reference's two wavefronts: coherent (camera-like) then
    divergent, in its order of draws."""
    return (("coherent", common.coherent_rays(rng, n, ext)),
            ("divergent", common.divergent_rays(rng, n, ext)))


def cluster_boxes(host):
    """The real clusters' boxes of numpy walk tables, [C, 3] float64."""
    lo = np.asarray(host.lo)[:, : host.n_real].T.astype(np.float64)
    hi = np.asarray(host.hi)[:, : host.n_real].T.astype(np.float64)
    return lo, hi


def main(argv=None) -> dict:
    p = common.parser(__doc__, "sortkey_lab_h100.json")
    args = p.parse_args(argv)
    dev = common.pick_device(args.device)
    hits_dev = dev if dev.type == "cuda" else None
    rng = np.random.default_rng(3)
    n = args.rays
    geom, ext = common.lab_scene(args.tris, args.theta)
    host = build_walk_tables(geom)
    wt = walk_tables_to(host, dev)
    lo, hi = cluster_boxes(host)
    wlo, whi = np.asarray(host.world_lo), np.asarray(host.world_hi)
    report = {**common.device_record(dev), "rays": n,
              "tris": int(geom.n_tris), "clusters": int(host.n_real),
              "cluster_overlap": cluster_overlap_stats(lo, hi)}
    print("cluster overlap:", report["cluster_overlap"], flush=True)
    for tag, (o, d) in lab_wavefronts(rng, n, ext):
        hits = ray_cluster_hits(lo, hi, o.astype(np.float64),
                                d.astype(np.float64), device=hits_dev)
        sizes = hits.sum(1)
        row = {"per_ray_mean": float(sizes.mean()),
               "per_ray_p99": float(np.percentile(sizes, 99))}
        orders = {name: np.argsort(key, kind="stable")
                  for name, key in keys_catalog(o, d, wlo, whi).items()}
        orders.update(production_orders(wt, o, d))
        for name, order in orders.items():
            mean_u, max_u = tile_union(hits, order)
            row[name] = {"union_mean": round(mean_u, 2), "union_max": max_u}
            print(f"[{tag}] {name:14s} union {mean_u:7.2f} (max {max_u})",
                  flush=True)
        fl_mean, fl_max = grouping_floor(hits)
        row["grouping_floor"] = {"union_mean": round(fl_mean, 2),
                                 "union_max": fl_max}
        print(f"[{tag}] grouping floor  union {fl_mean:7.2f} (max {fl_max})"
              f"  per-ray {row['per_ray_mean']:.2f}", flush=True)
        # RAY_TILE under the production order of the reference's catalog:
        # per-ray test work follows the union / R, the per-tile pops and
        # entries are shared by R rays
        order = orders["oct|om5|dm5"]
        sweep = {}
        for r in (32, 64, 128, 256):
            mu, _ = tile_union(hits, order, ray_tile=r)
            sweep[r] = {"union_mean": round(mu, 2),
                        "work_per_ray": round(mu / r, 3)}
            print(f"[{tag}] R={r:3d} union {mu:7.2f}", flush=True)
        row["ray_tile_sweep"] = sweep
        report[tag] = row
    common.write_record(args.out, report)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])

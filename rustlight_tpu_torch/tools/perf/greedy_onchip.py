"""The greedy-union tile packing on the card (the assignment bound): the
greedy order (grouping_lab.greedy_union_order) of the laboratory's
divergent wavefront, computed on the host from the exact incidence matrix,
pre-permutes the rays, which the production walk then takes with
sort_rays=False (accel/walk.py:_walk_impl), against the production walk
with its own sort; the port's counterpart of the JAX package's
tools/perf/greedy_onchip.py.

Each time is the median of `--runs` calls between CUDA events, printed
beside the hits and the checksum of t; the visits a tile of the counted
kernel (K9a) and the host union of each order stand beside them.

    python -m rustlight_tpu_torch.tools.perf.greedy_onchip [--device cpu]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ...accel.walk import (_default_range, _prepare, _walk_impl,
                           build_walk_tables, intersect_walk, walk_tables_to)
from . import common
from .grouping_lab import greedy_union_order
from .sortkey_lab import (RAY_TILE, cluster_boxes, ray_cluster_hits,
                          tile_union)


def main(argv=None) -> dict:
    p = common.parser(__doc__, "greedy_onchip_h100.json")
    args = p.parse_args(argv)
    dev = common.pick_device(args.device)
    rng = np.random.default_rng(3)
    n = args.rays
    geom, ext = common.lab_scene(args.tris, args.theta)
    host = build_walk_tables(geom)
    wt = walk_tables_to(host, dev)
    lo, hi = cluster_boxes(host)
    rng.uniform(0, ext, (n, 3))      # the coherent set's draw, unused here
    o_d, d_d = common.divergent_rays(rng, n, ext)
    t0 = time.time()
    hits = ray_cluster_hits(lo, hi, o_d.astype(np.float64),
                            d_d.astype(np.float64),
                            device=dev if dev.type == "cuda" else None)
    inc_s = time.time() - t0
    t0 = time.time()
    order = greedy_union_order(hits, RAY_TILE)
    greedy_s = time.time() - t0
    mu, mx = tile_union(hits, order)
    print(f"greedy order: union {mu:.2f} (max {mx}); incidence {inc_s:.1f}s,"
          f" greedy {greedy_s:.1f}s on the host", flush=True)
    report = {**common.device_record(dev), "rays": n,
              "tris": int(geom.n_tris), "clusters": int(host.n_real),
              "incidence_s": round(inc_s, 1), "greedy_s": round(greedy_s, 1),
              "greedy_union": {"union_mean": round(mu, 2), "union_max": mx}}
    o, d = common.to_device(dev, o_d, d_d)
    prod_order = _prepare(wt, o, d, *_default_range(o, None, None))[4]
    mu, mx = tile_union(hits, prod_order.cpu().numpy())
    report["production_union"] = {"union_mean": round(mu, 2),
                                  "union_max": mx}
    perm = torch.as_tensor(order, device=dev)
    og, dg = o[perm].contiguous(), d[perm].contiguous()
    tnear, tfar = _default_range(og, None, None)
    runs = (("incidence sort (production)",
             lambda: intersect_walk(wt, o, d),
             common.sorted_tiles(wt, o, d)),
            ("greedy pre-permuted",
             lambda: _walk_impl(wt, og, dg, tnear, tfar, False,
                                sort_rays=False),
             _prepare(wt, og, dg, tnear, tfar, sort_rays=False)[:4]))
    for tag, fn, srt in runs:
        r = fn()
        ms = common.timed_ms(fn, dev, args.runs)
        nv = common.tile_visits(wt, srt)
        rec = {"ms": ms, "hits": int(r.hit.sum()),
               "chk": common.checksum(r.t),
               "visits_mean": float(nv.double().mean()),
               "visits_max": int(nv.max())}
        report[tag] = rec
        print(f"{tag}: {ms:8.3f} ms hits={rec['hits']} chk={rec['chk']:.1f} "
              f"visits/tile {rec['visits_mean']:.2f} (max "
              f"{rec['visits_max']})", flush=True)
    common.write_record(args.out, report)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])

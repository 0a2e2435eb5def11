"""Tree-quality A/B of the tile-walk intersector on the card; the port's
counterpart of the JAX package's tools/perf/tree_lab.py.

For each table-build variant, on the laboratory's scene with 262,144
coherent and 262,144 divergent rays:

  * clusters (C), fill rate, total cluster surface area
  * per-tile visit counts of the production walk (the counted kernel)
  * the walk's time (whole call with its sort, median)
  * hits and hit-checksum parity against the first variant

Variants: binned / greedy (the shipped build), sweep / greedy (full SAH
sweep), binned / sa1.0, binned / sa0.8, sweep / sa1.0 (tightness-aware
re-pack, SA(merged) <= alpha * (SA(a) + SA(b))).

    python -m rustlight_tpu_torch.tools.perf.tree_lab [--device cpu]
"""
from __future__ import annotations

import sys

import numpy as np

from ...accel.bvh import build_bvh
from ...accel.walk import build_walk_tables, intersect_walk, walk_tables_to
from . import common

VARIANTS = (("binned", None), ("sweep", None), ("binned", 1.0),
            ("binned", 0.8), ("sweep", 1.0))


def _tag(builder, alpha) -> str:
    return f"{builder}/{'greedy' if alpha is None else f'sa{alpha}'}"


def cluster_sa(wt) -> float:
    """Total surface area of the real clusters' boxes (numpy tables)."""
    lo = np.asarray(wt.lo)[:, : wt.n_real].T
    hi = np.asarray(wt.hi)[:, : wt.n_real].T
    d = np.maximum(hi - lo, 0.0)
    return float((2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                         + d[:, 2] * d[:, 0])).sum())


def main(argv=None) -> list:
    p = common.parser(__doc__, "tree_lab_h100.json")
    p.add_argument("--variants", default=",".join(
        _tag(b, a) for b, a in VARIANTS),
        help="comma-separated subset, the first is the parity reference")
    args = p.parse_args(argv)
    dev = common.pick_device(args.device)
    wanted = args.variants.split(",")
    variants = [v for v in VARIANTS if _tag(*v) in wanted]
    if len(variants) != len(wanted):
        raise ValueError(f"--variants: unknown name in {wanted}")
    geom, ext = common.lab_scene(args.tris, args.theta)
    rng = np.random.default_rng(3)
    n = args.rays
    # coherent before divergent: the draw order fixes the sets
    rays = {"coherent": common.to_device(
                dev, *common.coherent_rays(rng, n, ext)),
            "divergent": common.to_device(
                dev, *common.divergent_rays(rng, n, ext))}
    ref_chk = {}
    results = [common.device_record(dev)]
    for builder, alpha in variants:
        tag = _tag(builder, alpha)
        bvh = build_bvh(geom, max_leaf=8, builder=builder)
        host = build_walk_tables(geom, bvh=bvh, repack_alpha=alpha)
        fill = geom.n_tris / (host.n_real * host.k)
        sa = cluster_sa(host)
        wt = walk_tables_to(host, dev)
        row = {"variant": tag, "clusters": int(wt.n_real),
               "fill": round(fill, 3), "cluster_sa": sa, "mxu": args.mxu}
        print(f"{tag}: C={wt.n_real} fill={fill:.3f} SA={sa:.3g}", flush=True)
        for name, (o, d) in rays.items():
            walk = lambda: intersect_walk(wt, o, d, mxu_tritest=args.mxu)
            r = walk()
            chk, hits = common.checksum(r.t), int(r.hit.sum())
            ref_chk.setdefault(name, (hits, chk))
            parity = (hits == ref_chk[name][0]
                      and abs(chk - ref_chk[name][1]) < 0.5)
            ms = common.timed_ms(walk, dev, args.runs)
            nv = common.tile_visits(wt, common.sorted_tiles(wt, o, d),
                                    args.mxu)
            vm, vmax = float(nv.double().mean()), int(nv.max())
            row[name] = {"ms": round(ms, 3), "visits_mean": round(vm, 1),
                         "visits_max": vmax, "hits": hits, "parity": parity}
            print(f"  {name}: {ms:8.3f} ms  visits/tile {vm:6.1f} (max "
                  f"{vmax})  hits={hits} parity={parity}", flush=True)
        results.append(row)
    common.write_record(args.out, results)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])

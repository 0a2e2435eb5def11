"""Cluster-size (K) sweep of the tile walk on the laboratory's scene; the
port's counterpart of the JAX package's tools/perf/k_sweep.py.

The walk's visits test every ray of a 64-ray tile against all K triangles
of a cluster, and most of those tests are waste: each ray overlaps a few
clusters, the tile the union of them. Smaller clusters narrow each visit
at the price of more visits and a lower fill; larger ones the other way.
For each K the walk tables are built at that K (accel/walk.py:
build_walk_tables(k=)), and the library of that K's kernels
(ops/native.py:load_cuda(k), -DRL_KC=<k>; all of them built at once before
the sweep) walks coherent and divergent 262,144-ray wavefronts. Each K
prints: C, fill, the route (K3, K3w or K5, as accel/walk.py:_resolve picks
it for the tables), the walk's ms with its sort, the kernel's ms alone on
the walk's sorted tiles, the visits a tile of the counted kernel (K9a) at
that K, and the bound at that K (tools/perf/common.py:walk_bound_ms).

The first K is the parity reference (384, the shipped one): a K whose hits
or checksum of t drift from it prints PARITY DRIFT. K = 64 is not swept:
the port's kernels take multiples of 128 (ops/walk_trace.py:check_k), the
reference's own rule, whose K = 64 leg it reported as untrusted. There is
no counterpart of the reference's MAX_VMEM_CLUSTERS rescale: one kernel
pair takes every table size on the card.

    python -m rustlight_tpu_torch.tools.perf.k_sweep [--ks 384,128]
        [--device cpu]
"""
from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ...accel.walk import (_resolve, build_walk_tables, intersect_walk,
                           walk_tables_to)
from ...ops import native
from ...ops.walk_hier import walk_hier_closest
from ...ops.walk_trace import check_k, walk_closest
from . import common

KS = (384, 128, 256, 512, 640, 768)


def route(wt) -> str:
    """The walk kernel the tables take by default: K3 (the packed one-level
    walk), K3w (its wide pop) or K5 (the two-level walk)."""
    hier, wide = _resolve(wt, None, None, None, None)[:2]
    return "K5" if hier else "K3w" if wide else "K3"


def kernel_alone(wt, srt, name: str):
    """The closest-hit kernel of route `name` on sorted tiles srt."""
    if name == "K5":
        return lambda: walk_hier_closest(wt, *srt)
    return lambda: walk_closest(wt, *srt, wide=name == "K3w")


def build_libraries(ks, dev) -> float:
    """On a card, every K's library at once (one thread a K, each running
    its nvcc processes together); the seconds it took."""
    t0 = time.time()
    if dev.type == "cuda":
        with ThreadPoolExecutor(len(ks)) as ex:
            list(ex.map(native.build_k, ks))
    return time.time() - t0


def parser(doc, out_name, tris, theta):
    p = common.parser(doc, out_name)
    p.set_defaults(tris=tris, theta=theta)
    p.add_argument("--ks", default=",".join(map(str, KS)),
                   help="comma-separated K values, the first the parity "
                        "reference")
    return p


def sweep(args) -> list:
    """The sweep over args.ks on sphere_grid_mesh(args.tris, n_theta=
    args.theta) with the reference's two wavefronts: one record a K."""
    dev = common.pick_device(args.device)
    ks = [check_k(int(k)) for k in args.ks.split(",")]
    build_s = build_libraries(ks, dev)
    geom, ext = common.lab_scene(args.tris, args.theta)
    rng = np.random.default_rng(3)
    n = args.rays
    rays = {"coherent": common.to_device(
                dev, *common.coherent_rays(rng, n, ext)),
            "divergent": common.to_device(
                dev, *common.divergent_rays(rng, n, ext))}
    print(f"{len(ks)} libraries built in {build_s:.1f}s; "
          f"{geom.n_tris} triangles, {n} rays", flush=True)
    ref, rows = {}, [{**common.device_record(dev), "rays": n,
                      "tris": int(geom.n_tris), "build_s": build_s}]
    for k in ks:
        host = build_walk_tables(geom, k=k)
        wt = walk_tables_to(host, dev)
        fill = geom.n_tris / (host.n_real * k)
        name = route(wt)
        row = {"K": k, "C": int(host.n_real), "Cp": int(host.n_clusters),
               "fill": round(fill, 3), "route": name}
        print(f"K={k}: C={host.n_real} (Cp {host.n_clusters}) fill={fill:.3f}"
              f" route {name}", flush=True)
        for tag, (o, d) in rays.items():
            walk = lambda: intersect_walk(wt, o, d)
            r = walk()
            hits, chk = int(r.hit.sum()), common.checksum(r.t)
            ref.setdefault(tag, (hits, chk))
            parity = (hits == ref[tag][0] and abs(chk - ref[tag][1]) < 0.5)
            if not parity:
                print(f"  PARITY DRIFT {tag}: hits={hits} chk={chk:.1f} vs "
                      f"{ref[tag]}", flush=True)
            ms = common.timed_ms(walk, dev, args.runs)
            srt = common.sorted_tiles(wt, o, d)
            kms = common.timed_ms(kernel_alone(wt, srt, name), dev,
                                  args.runs)
            nv = common.tile_visits(wt, srt)
            bound, by = common.walk_bound_ms(wt, int(nv.sum()),
                                             srt[0].shape[0])
            row[tag] = {"ms": ms, "kernel_ms": kms,
                        "visits_mean": float(nv.double().mean()),
                        "visits_max": int(nv.max()), "bound_ms": bound,
                        "bound_by": by, "hits": hits, "chk": chk,
                        "parity": parity}
            print(f"  {tag}: walk {ms:8.3f} ms, kernel {kms:8.3f} ms, "
                  f"visits/tile {row[tag]['visits_mean']:.2f} (max "
                  f"{row[tag]['visits_max']}), bound {bound:.4f} ms ({by}), "
                  f"hits={hits} chk={chk:.1f} parity={parity}", flush=True)
        rows.append(row)
    common.write_record(args.out, rows)
    return rows


def main(argv=None) -> list:
    return sweep(parser(__doc__, "k_sweep_h100.json", 110_000, 18)
                 .parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])

"""Empirical roofline of the tile-walk intersector on the card; the port's
counterpart of the JAX package's tools/perf/roofline.py.

Three measurements on the laboratory's scene (sphere_grid_mesh(110_000,
n_theta=18): 132,192 triangles, 432 clusters padded to 512) under 262,144
divergent rays:

1. production: the closest-hit walk kernel on the wavefront as the walk sorts
   and pads it, and the whole call with its sort; the counted kernel gives
   the exact number of [64, 3K] visits the schedule executes per tile.
2. floor: the same number of visits per tile (the rounded mean) under a free
   schedule: round-robin clusters, no entry pass, no pops, no threshold.
3. FMA peak: chained fused multiply-adds on the same [64, 3K] shape, no
   loads: the card's practical f32 rate.

production / floor is the schedule's overhead (entry pass, pops, the tail of
the longest tile); floor flop / peak is how much of the f32 rate the visit's
data path uses, counting 16 flop a test (the two affine products and u, v).
With --mxu production and floor take the tensor-core form of the triangle
test, and the error of its two products against the default form's is
printed.

    python -m rustlight_tpu_torch.tools.perf.roofline [--mxu] [--device cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ...accel.walk import intersect_walk, walk_tables_to
from ...ops.walk_lab import (FMA_SHAPE, dot4_products, fma_peak, mma_products,
                             walk_floor)
from ...ops.walk_trace import K, RAY_TILE, walk_closest
from . import common

FMA_BLOCKS, FMA_ITERS = 8192, 4000
FLOP_PER_TEST = 16      # ao 7 + ad 5 + u, v 4: the dominant multiply-adds


def operand_error(wt, srt):
    """Max error of the tensor-core products of the first tile with cluster
    0, relative to the largest default-form product of each ray."""
    rows = wt.rows.view(-1, K, 3, 4)[0].contiguous()
    o, d = srt[0][:RAY_TILE].contiguous(), srt[1][:RAY_TILE].contiguous()
    out = []
    for got, ref in zip(mma_products(rows, o, d), dot4_products(rows, o, d)):
        scale = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        out.append(float(((got - ref).abs() / scale).max()))
    return out


def main(argv=None) -> dict:
    p = common.parser(__doc__, "roofline_h100.json")
    p.add_argument("--fma-blocks", type=int, default=FMA_BLOCKS)
    p.add_argument("--fma-iters", type=int, default=FMA_ITERS)
    args = p.parse_args(argv)
    dev = common.pick_device(args.device)
    geom, ext = common.lab_scene(args.tris, args.theta)
    rng = np.random.default_rng(3)
    n = args.rays
    o, d = common.to_device(dev, *common.divergent_rays(rng, n, ext))
    wt = walk_tables_to(geom.walk, dev)
    cp = int(wt.n_clusters)
    mxu = args.mxu
    print(f"K={K} C={cp} ({wt.n_real} real) tris={geom.n_tris} rays={n} "
          f"mxu={mxu}", flush=True)

    # 1. production: kernel on the walk's own tiles, whole call, visits
    srt = common.sorted_tiles(wt, o, d)
    t_walk = common.timed_ms(
        lambda: intersect_walk(wt, o, d, mxu_tritest=mxu).t, dev, args.runs)
    t_prod = common.timed_ms(lambda: walk_closest(wt, *srt, mxu=mxu), dev,
                             args.runs)
    nv = common.tile_visits(wt, srt, mxu)
    visits_mean, visits_total = float(nv.double().mean()), int(nv.sum())
    print(f"production: kernel {t_prod:.3f} ms (with its sort {t_walk:.3f} "
          f"ms), visits/tile mean {visits_mean:.1f} (max {int(nv.max())}, "
          f"C={cp}), total {visits_total}", flush=True)

    # 2. floor at the same mean visit count
    nv_iters = int(round(visits_mean))
    t_floor = common.timed_ms(
        lambda: walk_floor(wt, *srt, nv_iters, mxu=mxu), dev, args.runs)
    print(f"floor ({nv_iters} visits/tile, free schedule): {t_floor:.3f} ms "
          f"-> production/floor = {t_prod / t_floor:.2f}x", flush=True)

    # 3. FMA peak on the same [64, 3K] shape
    x = torch.ones(FMA_SHAPE, dtype=torch.float32, device=dev)
    t_fma = common.timed_ms(
        lambda: fma_peak(x, args.fma_iters, args.fma_blocks), dev, args.runs)
    g = srt[0].shape[0] // RAY_TILE
    peak = floor_gflops = pct = None
    if dev.type == "cuda":          # rates are device metrics: card runs only
        peak = (args.fma_blocks * args.fma_iters * RAY_TILE * 3 * K * 4
                / t_fma / 1e6)
        floor_gflops = (g * nv_iters * RAY_TILE * K * FLOP_PER_TEST
                        / t_floor / 1e6)
        pct = 100 * floor_gflops / peak
        print(f"fma peak (chained fma, same shape, {args.fma_blocks} blocks "
              f"x {args.fma_iters} steps): {peak:.0f} GFLOP/s f32",
              flush=True)
        print(f"floor data path: {floor_gflops:.0f} GFLOP/s of "
              f"fma-equivalents -> {pct:.1f}% of peak", flush=True)

    out = {
        **common.device_record(dev),
        "K": K, "clusters": cp, "rays": n, "tris": int(geom.n_tris),
        "mxu": mxu,
        "production_ms": t_prod, "production_walk_ms": t_walk,
        "visits_per_tile_mean": visits_mean,
        "visits_per_tile_max": int(nv.max()), "visits_total": visits_total,
        "floor_visits": nv_iters, "floor_ms": t_floor,
        "sched_overhead_x": t_prod / t_floor,
        "fma_blocks": args.fma_blocks, "fma_iters": args.fma_iters,
        "fma_ms": t_fma, "fma_peak_gflops": peak,
        "floor_gflops_fma_equiv": floor_gflops, "floor_vs_peak_pct": pct,
    }
    if mxu:
        err_o, err_d = operand_error(wt, srt)
        out["mxu_operand_err"] = {"ao": err_o, "ad": err_d}
        print(f"tensor-core products vs the default form's, relative to each "
              f"ray's largest: ao {err_o:.3g}, ad {err_d:.3g}", flush=True)
    common.write_record(args.out, out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])

"""Primitive-count scaling of the photon-primitive gathers; the port's
counterpart of the JAX package's tools/perf/prim_gather_scale.py.

The gathers of IntegratorVolPrimitives sweep every camera ray against every
primitive in chunks (O(rays x primitives)), where the reference renderer
splits beams and gathers through a BVH. For each nb_primitive of the sweep
this times one render pass (light paths and gather, synchronised) of the
BRE and beam estimators on a 64x64 Cornell box in a medium of sigma_s
0.0025 (depth 4, radius 8, prim_chunk = min(nb, 512)), the best of `--runs`
after a warm one, and reports the wall, the pair rate (rays x primitives /
s) and the marginal ms per 1k primitives between consecutive counts.

    python -m rustlight_tpu_torch.tools.perf.prim_gather_scale
        [--nb 1024,16384] [--device cpu]
"""
from __future__ import annotations

import sys
import time

import torch

from ...integrators import IntegratorVolPrimitives, render
from ...models import cornell_box
from ...scene import make_volume
from . import common

NBS = (1024, 4096, 16384, 65536, 131072)


def best_wall_s(fn, dev, runs: int) -> float:
    """The least host wall of `runs` synchronised calls after a warm one."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    fn()
    sync()
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> list:
    p = common.parser(__doc__, "prim_gather_scale_h100.json", walk=False,
                      runs=3)
    p.add_argument("--nb", default=",".join(map(str, NBS)),
                   help="comma-separated primitive counts")
    p.add_argument("--prims", default="bre,beams")
    p.add_argument("--res", type=int, default=64)
    args = p.parse_args(argv)
    dev = common.pick_device(args.device)
    sc = cornell_box(args.res, args.res)
    sc.volume = make_volume(sigma_s=(0.0025,) * 3)
    sd = sc.compile(device=dev)
    n_rays = args.res * args.res
    nbs = [int(x) for x in args.nb.split(",")]
    rows = [{**common.device_record(dev), "res": args.res}]
    for prim in args.prims.split(","):
        mine = []
        for nb in nbs:
            integ = IntegratorVolPrimitives(
                nb_primitive=nb, max_depth=4, hard_cap=4, primitives=prim,
                radius=8.0, prim_chunk=min(nb, 512))
            film = render(sd, integ, spp=1, seed=1)
            wall = best_wall_s(lambda: render(sd, integ, spp=1, seed=2), dev,
                               args.runs)
            rec = {"prim": prim, "nb_primitive": nb, "wall_s": wall,
                   "pair_rate_per_s": n_rays * nb / wall,
                   "mean": float(film["primal"].mean())}
            if mine:
                rec["marginal_ms_per_1k"] = ((wall - mine[-1]["wall_s"])
                                             / (nb - mine[-1]["nb_primitive"])
                                             * 1e6)
            mine.append(rec)
            print(rec, flush=True)
        rows += mine
    common.write_record(args.out, rows)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])

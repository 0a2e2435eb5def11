"""The walk's trace time on the laboratory's scene under coherent and
divergent rays; the port's counterpart of the JAX package's
tools/perf/trace_122k.py, and the entry point of the tensor-core A/B: run it
once without and once with --mxu.

The ray sets are that script's: three draws for a larger scene precede them
and are thrown away, so the generator stands where it stood there.

    python -m rustlight_tpu_torch.tools.perf.trace_122k [--mxu] [--device cpu]
"""
from __future__ import annotations

import sys

import numpy as np

from ...accel.walk import intersect_walk, walk_tables_to
from ...scene import make_sphere
from . import common


def main(argv=None) -> dict:
    p = common.parser(__doc__, "trace_122k_h100.json")
    args = p.parse_args(argv)
    dev = common.pick_device(args.device)
    rng = np.random.default_rng(3)
    n = args.rays
    # the reference's throw-away draws (its 4.2M-triangle grid's extent)
    nt_per = make_sphere((0, 0, 0), 1.0, n_theta=args.theta,
                         n_phi=args.theta).indices.shape[0]
    gs49 = int(np.ceil((4_200_000 / nt_per) ** (1 / 3)))
    rng.uniform(0, gs49 * 3.0, (n, 3))
    rng.uniform(0, gs49 * 3.0, (n, 3))
    rng.normal(size=(n, 3))
    geom, ext = common.lab_scene(args.tris, args.theta)
    wt = walk_tables_to(geom.walk, dev)
    sets = (("coherent", common.coherent_rays(rng, n, ext)),
            ("divergent", common.divergent_rays(rng, n, ext)))
    out = {**common.device_record(dev), "rays": n, "tris": int(geom.n_tris),
           "clusters": int(wt.n_clusters), "mxu": args.mxu}
    for name, (o, d) in sets:
        o, d = common.to_device(dev, o, d)
        walk = lambda: intersect_walk(wt, o, d, mxu_tritest=args.mxu)
        r = walk()
        ms = common.timed_ms(walk, dev, args.runs)
        out[name] = {"ms": ms, "hits": int(r.hit.sum()),
                     "chk": common.checksum(r.t)}
        print(f"122k {name}: {ms:8.3f} ms hits={out[name]['hits']} "
              f"chk={out[name]['chk']:.1f}", flush=True)
    common.write_record(args.out, out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])

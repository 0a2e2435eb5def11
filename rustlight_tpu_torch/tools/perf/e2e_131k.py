"""End-to-end wall of the benchmark's 131k-triangle scene; the port's
counterpart of the JAX package's tools/perf/e2e_131k.py.

sphere_grid(122_000) (models/presets.py: 676 UV spheres of 180 triangles,
121,680 triangles and the area light, bench.py's grid122k) at 256x256: the
path tracer (depth 5) at 8 spp, cold (the first render of the process,
seed 0: on a card it builds the kernels unless they are built) and warm
(seed 1), each wall synchronised, with the image mean. `--ao-spp` adds the
AO integrator (max_distance 2) the same way.

    python -m rustlight_tpu_torch.tools.perf.e2e_131k [--spp 8]
        [--device cpu]
"""
from __future__ import annotations

import sys
import time

import torch

from ...integrators import IntegratorAO, IntegratorPathTracing, render
from ...models.presets import sphere_grid
from . import common


def parser(doc, out_name, tris, spp, ao_spp):
    p = common.parser(doc, out_name, walk=False)
    p.add_argument("--tris", type=int, default=tris,
                   help="target triangle count of the sphere grid")
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--spp", type=int, default=spp,
                   help="the path tracer's spp (0: no path render)")
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--ao-spp", type=int, default=ao_spp,
                   help="the AO integrator's spp (0: no AO render)")
    return p


def cold_warm(sd, integ, spp: int, dev, label: str) -> tuple:
    """Two renders (seed 0, then 1), each wall synchronised: (record, the
    cold render's image as numpy)."""
    rec = {}
    for tag, seed in (("cold", 0), ("warm", 1)):
        t0 = time.perf_counter()
        img = render(sd, integ, spp=spp, seed=seed)["primal"]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec[f"{tag}_s"] = time.perf_counter() - t0
        if seed == 0:
            first = torch.as_tensor(img).cpu().numpy()
        rec[f"{tag}_mean"] = float(torch.as_tensor(img).double().mean())
    print(f"{label} {spp} spp: cold {rec['cold_s']:.3f}s (mean "
          f"{rec['cold_mean']:.5f}), warm {rec['warm_s']:.3f}s (mean "
          f"{rec['warm_mean']:.5f})", flush=True)
    return {"spp": spp, **rec}, first


def renders(args, sd, dev) -> tuple:
    """The path and AO renders args asks for: (records, last image)."""
    out, img = {}, None
    if args.spp:
        integ = IntegratorPathTracing(max_depth=args.depth,
                                      hard_cap=args.depth)
        out["path"], img = cold_warm(sd, integ, args.spp, dev,
                                     f"path depth {args.depth}")
    if args.ao_spp:
        out["ao"], img = cold_warm(sd, IntegratorAO(max_distance=2.0),
                                   args.ao_spp, dev, "ao max_distance 2")
    return out, img


def main(argv=None) -> dict:
    args = parser(__doc__, "e2e_131k_h100.json", 122_000, 8, 0).parse_args(
        argv)
    dev = common.pick_device(args.device)
    t0 = time.perf_counter()
    sd = sphere_grid(args.tris, args.res, args.res).compile(device=dev)
    compile_s = time.perf_counter() - t0
    wt = sd.geom.walk
    print(f"tris {sd.geom.n_tris}, clusters {wt.n_real} (Cp "
          f"{wt.n_clusters}), compile(scene) {compile_s:.2f}s", flush=True)
    out, _ = renders(args, sd, dev)
    rec = {**common.device_record(dev), "tris": int(sd.geom.n_tris),
           "clusters": int(wt.n_real), "res": args.res,
           "compile_s": compile_s, **out}
    common.write_record(args.out, rec)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])

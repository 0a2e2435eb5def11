"""The control of the comparison that decides `correct`: the plain reference
put in the renderer's place and computed one precision below the float32
the configurations state (bfloat16), judged by the same numbers as a run.

    python3 -m portbench.control --workload <name> --seeds 1,2,3

For each seed it draws the pixels a run of that seed checks and takes the
render seeds of as many passes as the cell compares (the mix's
`check.passes`), and prints off_share of the bfloat16 reference against the
float32 one on the card at the cell's own film and samples, with the
cell's limit beside it. It runs neither the renderer nor a window.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import check, window
from .scene import build_arrays, load_config

CONTROL_DTYPE = torch.bfloat16


def control_reading(cell: dict, seed: int, device) -> float:
    cfg = load_config(cell["config"])
    traffic = window.load_traffic(cell["traffic"])
    limits = check.load_limits(cell["name"])
    arrays = build_arrays(cfg)
    pixels = check.check_pixels(seed, traffic["width"] * traffic["height"],
                                traffic["check"]["pixels"])
    seeds = [window.pass_seed(seed, k)
             for k in range(traffic["check"]["passes"])]
    ref = check.reference_values(arrays, cfg, traffic, seeds, pixels, device)
    low = check.reference_values(arrays, cfg, traffic, seeds, pixels, device,
                                 CONTROL_DTYPE)
    return check.off_share(low, ref, limits["rtol"], limits["atol"])


def main(argv=None) -> int:
    from .run import find_cell, load_benchmark
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    cell = find_cell(load_benchmark(), args.workload)
    limit = check.load_limits(cell["name"])["off_share"]
    out = []
    for s in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        v = control_reading(cell, s, torch.device("cuda", 0))
        out.append(v)
        print(f"control {args.workload} seed {s}: off_share {v!r} limit "
              f"{limit!r} ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"workload": args.workload, "off_share": out,
                      "min": float(np.min(out))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

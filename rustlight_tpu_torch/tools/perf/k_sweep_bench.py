"""The K sweep (tools/perf/k_sweep.py) on the benchmark's sphere grid,
sphere_grid_mesh(122_000, n_theta=10): spheres of 180 triangles, where the
laboratory's have 612; the port's counterpart of the JAX package's
tools/perf/k_sweep_bench.py.

The treelet re-pack aligns clusters to sphere subtrees, so K against the
triangles of one object decides how many objects share a cluster (K = 384
packs two 180-triangle spheres a cluster, and a ray that overlaps one
wastes half of each visit's tests): the best K depends on the scene's
objects. Same columns, parity rule and record as k_sweep.

    python -m rustlight_tpu_torch.tools.perf.k_sweep_bench [--ks 384,128]
        [--device cpu]
"""
from __future__ import annotations

import sys

from .k_sweep import parser, sweep


def main(argv=None) -> list:
    return sweep(parser(__doc__, "k_sweep_bench_h100.json", 122_000, 10)
                 .parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])

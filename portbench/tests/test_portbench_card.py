"""On the card: a short traced run of each configuration at a small film,
held to the reference, with every per-layer reader finding its source.

    python3 -m pytest portbench/tests -m cuda -q
"""
import time

import pytest
import torch

from portbench import run

MIXES = {  # config: (integrator, route, spp)
    "cbox": ("path", "persistent", 4),
    "grid122k": ("ao", "per_pass", 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(MIXES))
def test_traced_run_on_the_card(tiny_cell, config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kind, route, spp = MIXES[config]
    bench, cell = tiny_cell(config, {
        "integrator": kind, "route": route, "width": 256, "height": 144,
        "spp_per_pass": spp, "check": {"pixels": 1024, "passes": 3},
        "trace_min_s": 0.2})
    for m in bench["per_layer"]:
        if m["name"] in ("device.idle_pct", "loop.kernels_per_spp",
                         "trace.mrays_s"):
            m["workloads"] = [cell["name"]]
    res = run.run_cell(bench, cell, 2_500_000_001, 2.0, True,
                       torch.device("cuda", 0), time.perf_counter(),
                       log=lambda s: None)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"device.idle_pct", "loop.kernels_per_spp",
                                   "trace.mrays_s"}
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]

"""The harness finds configurations, mixes, material kinds, integrators and
per-layer metrics by name from files of their own: new ones, added as new
files only, run without an edit to any file that is there. Also the traced
stretch's arithmetic on a planted event list."""
import json
import os
import time
import uuid

import numpy as np
import torch

from portbench import metrics, run, trace, window

PB = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

METRIC = '''"""A test's metric: kernels in the stretch."""


def read(ctx):
    return float(len(ctx["kernels"])) if ctx["kernels"] else None
'''

EVENTS = [  # name, start ns, duration ns
    ("dense_closest_kernel(float4 const*, int)", 1_000, 400),
    ("void rl::walk::walk_closest_split_kernel<false, 8>(float const*)",
     1_200, 500),
    ("Memcpy DtoH (Device -> Pageable)", 2_000, 100),
    ("at::native::vectorized_elementwise_kernel<4>", 5_000, 1_000),
]


class _PlantedProfiler:
    def start(self):
        pass

    def stop(self):
        return list(EVENTS)


def test_new_mix_and_metric_as_files_only(tiny_cell, monkeypatch):
    name = f"_t_{uuid.uuid4().hex[:10]}"
    path = os.path.join(PB, "metrics", f"{name}.py")
    with open(path, "w") as f:
        f.write(METRIC)
    try:
        bench, cell = tiny_cell("cbox", {
            "integrator": "ao", "route": "per_pass", "width": 12,
            "height": 8, "spp_per_pass": 2,
            "check": {"pixels": 40, "passes": 3}, "trace_min_s": 0.0})
        bench["per_layer"].append({
            "name": name, "unit": "kernels", "better": "lower",
            "source": "device_trace", "layer": "device (H100)",
            "moves": "msamples_s", "workloads": [cell["name"]]})
        res = run.run_cell(bench, cell, 11, 0.5, False, torch.device("cpu"),
                           time.perf_counter(), log=lambda s: None)
        assert res["correct"] and res["attempted"] >= 2
        assert set(res["metrics"]) == {"msamples_s", "frame_ms_p95",
                                       "setup_s"}
        # traced: the stretch's profiler planted, the card's sync a no-op
        monkeypatch.setattr(trace, "_DeviceProfiler", _PlantedProfiler)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
        res = run.run_cell(bench, cell, 12, 0.5, True, torch.device("cpu"),
                           time.perf_counter(), log=lambda s: None)
        assert res["correct"]
        assert res["metrics"] == {name: {"value": 3.0, "unit": "kernels"}}
        assert res["device"]["busy_s"] == 1_800 / 1e9
        assert res["breakdown"]["device_ops"][0][1] == 1_000 / 1e9
    finally:
        os.remove(path)


# a material kind and an integrator of their own, each for the renderer
# and for the reference: a grey diffuse and ambient occlusion under another
# name and parameter
NEW_FILES = {
    "materials/{m}.py": """
from rustlight_tpu_torch.bsdfs import diffuse


def make(spec):
    return diffuse((spec["grey"],) * 3)
""",
    "reference/materials/{m}.py": """
from . import diffuse


def params(spec):
    return [spec["grey"]] * 3


evaluate, sample = diffuse.evaluate, diffuse.sample
""",
    "integrators/{i}.py": """
from rustlight_tpu_torch.integrators import IntegratorAO

from ..port import film as render  # noqa: F401


def make(params):
    return IntegratorAO(max_distance=params["reach"])
""",
    "reference/integrators/{i}.py": """
from . import ao


def values(sc, seed, lanes, spp, params, route):
    return ao.values(sc, seed, lanes, spp,
                     {"max_distance": params["reach"]}, route)
""",
}


def test_new_config_material_and_integrator_as_files_only(tiny_cell):
    tag = uuid.uuid4().hex[:10]
    names = {"m": f"_t_m{tag}", "i": f"_t_i{tag}", "c": f"_t_c{tag}"}
    made = []
    try:
        for rel, body in NEW_FILES.items():
            made.append(os.path.join(PB, rel.format(**names)))
            with open(made[-1], "w") as f:
                f.write(body)
        with open(os.path.join(PB, "configs", "cbox.json")) as f:
            cfg = json.load(f)
        cfg["materials"]["white"] = {"kind": names["m"], "grey": 0.5}
        cfg["integrators"][names["i"]] = {"reach": 50.0}
        made.append(os.path.join(PB, "configs", f"{names['c']}.json"))
        with open(made[-1], "w") as f:
            json.dump(cfg, f)
        for kind, route in (("path", "persistent"), (names["i"], "per_pass")):
            bench, cell = tiny_cell(names["c"], {
                "integrator": kind, "route": route, "width": 12,
                "height": 8, "spp_per_pass": 2,
                "check": {"pixels": 40, "passes": 3}, "trace_min_s": 0.0})
            res = run.run_cell(bench, cell, 13, 0.5, False,
                               torch.device("cpu"), time.perf_counter(),
                               log=lambda s: None)
            assert res["correct"] and res["attempted"] >= 2, res["checks"]
    finally:
        for p in made:
            if os.path.exists(p):
                os.remove(p)


def _ctx():
    ev = sorted(EVENTS, key=lambda e: e[1])
    return {"events": ev, "kernels": [e for e in ev if "Memcpy" not in e[0]],
            "wall_s": 1e-5, "busy_s": trace.union_ns(ev) / 1e9,
            "passes": 2, "spp": 4, "rays": 2_000_000,
            "n_tris": 40}


def test_union_and_gaps():
    assert trace.union_ns([("a", 0, 10), ("b", 5, 10), ("c", 30, 5)]) == 20
    gaps = trace.breakdown(_ctx())["idle_gaps"]
    assert [g[1] for g in gaps] == [2_900 / 1e9, 300 / 1e9]
    assert gaps[0][0].startswith("before at::native")


def test_readers_on_planted_events():
    ctx = _ctx()
    read = {m: metrics.load(m) for m in (
        "device.idle_pct", "loop.kernels_per_spp", "trace.mrays_s",
        "dense_roofline", "walk.kernel_ms_per_mray")}
    assert abs(read["device.idle_pct"](ctx) - 82.0) < 1e-9
    assert read["loop.kernels_per_spp"](ctx) == 3 / 4
    assert abs(read["trace.mrays_s"](ctx) - 2e5) < 1e-6
    # 25 * 2e6 * 40 operations at 67 TFLOP/s, over 400 ns of K1
    assert abs(read["dense_roofline"](ctx)
               - 100 * (25 * 2e6 * 40 / 67e12) / 400e-9) < 1e-6
    assert abs(read["walk.kernel_ms_per_mray"](ctx) - 500e-6 / 2) < 1e-12
    for m in ("device.idle_pct", "loop.kernels_per_spp", "trace.mrays_s",
              "dense_roofline"):
        assert metrics.load(f"{m}.view")(ctx) == read[m](ctx)
    empty = dict(ctx, events=[], kernels=[], rays=0)
    assert all(r(empty) is None for r in read.values())


def test_window_holds_the_least_passes():
    def render(seed):
        return np.full((2, 3, 3), seed % 7, np.float32)
    win = window.run(render, 5, 0.0, np.arange(4), least_passes=9)
    assert win.passes == 9 and len(set(win.seeds)) == 9
    assert np.allclose(win.avg, np.mean([s % 7 for s in win.seeds]))

"""The readers of the renderer's spans and counters (portbench/spans.py,
the metrics of portbench/spans.json): their arithmetic on a planted
session of spans and device events, None where they find nothing, and a
traced CPU run that lists them as files only. The card's own run is the
test marked `cuda`."""
import time

import pytest
import torch

from portbench import metrics, run, spans, trace
from rustlight_tpu_torch.utils import tracing

S = tracing.Span
# one render on a made-up clock (ns): (name, start, end, parent, device)
PLANTED = [
    ("render", 1_000, 10_000, -1, None),
    ("render.setup", 1_000, 2_000, 0, None),
    ("loop.block", 2_100, 9_000, 0, None),
    ("rng.draw", 2_200, 3_000, 2, (2_500, 3_200)),
    ("walk.prepare", 3_100, 4_000, 2, (3_300, 4_500)),
    ("walk.sync", 3_500, 3_900, 4, None),
    ("walk.kernel", 4_100, 4_200, 2, (4_500, 6_000)),
    ("walk.unsort", 4_300, 4_400, 2, (6_000, 6_500)),
    ("loop.sync", 8_000, 8_900, 2, None),
    ("render.readback", 9_100, 9_900, 0, None),
]
EVENTS = [  # name, start ns, duration ns
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::BinaryFunctor<long, long, long>>", 2_500, 700),
    ("void at::native::elementwise_kernel<128, float>", 3_300, 1_200),
    ("void rl::walk::walk_closest_split_kernel<false, 8>", 4_500, 1_500),
    ("void at::native::index_elementwise_kernel<128, 4>", 6_000, 500),
    ("Memcpy DtoH (Device -> Pageable)", 9_200, 500),
]
COUNTERS = {"trace.lanes.closest": 1_000, "trace.live.closest": 600,
            "trace.lanes.anyhit": 1_000, "trace.live.anyhit": 200,
            "loop.iterations": 16}
WAITS = ("driver", "caller", "loop", "accel")


def _ctx():
    ev = sorted(EVENTS, key=lambda e: e[1])
    return {"events": ev, "kernels": [e for e in ev if "Memcpy" not in e[0]],
            "wall_s": 12_000 / 1e9, "busy_s": trace.union_ns(ev) / 1e9,
            "passes": 2, "spp": 4, "rays": 800, "n_tris": 40}


@pytest.fixture
def planted(monkeypatch):
    sp = [S(n, a, b, p, 0, *(dev or (None, None)))
          for n, a, b, p, dev in PLANTED]
    monkeypatch.setattr(spans, "recorded", lambda: (sp, dict(COUNTERS)))
    return sp


def test_waits_add_up_to_the_idle_share(planted):
    ctx = _ctx()
    got = {w: metrics.load(f"{w}.device_wait_pct")(ctx) for w in WAITS}
    # idle: [1000, 2500), [3200, 3300), [6500, 9200), [9700, 13000)
    want = {"driver": 1_600, "caller": 3_000, "loop": 2_900, "accel": 100}
    for w in WAITS:
        assert got[w] == pytest.approx(100 * want[w] / 12_000), w
        assert metrics.load(f"{w}.device_wait_pct.view")(ctx) == got[w]
    idle = metrics.load("device.idle_pct")(ctx)
    assert sum(got.values()) == pytest.approx(idle)


def test_rng_and_walk_shares(planted):
    ctx = _ctx()
    assert metrics.load("rng.device_pct")(ctx) == pytest.approx(
        100 * 700 / 4_400)
    # prepare [3300, 4500) and unsort [6000, 6500) busy, against 1500 of K3
    assert metrics.load("walk.prepare_pct")(ctx) == pytest.approx(
        100 * 1_700 / 3_200)
    assert metrics.load("trace.live_lane_pct")(ctx) == pytest.approx(40.0)
    assert metrics.load("loop.iterations_per_spp")(ctx) == 4.0
    # walk.sync, loop.sync and render.readback over 4 spp
    assert metrics.load("loop.host_syncs_per_spp")(ctx) == 0.75
    assert metrics.load("trace.walk_kernels_inside_pct")(ctx) == 100.0
    assert spans.WALK.search("void pair_split_kernel<false, false, 8, 1>")
    assert metrics.load("rng.int64_elementwise_pct")(ctx) == pytest.approx(
        100 * 700 / 4_400)


def test_setup_wait_is_a_part_of_the_driver_wait(planted):
    ctx = _ctx()
    # render.setup [1000, 2000) idle throughout; the driver's 1600 ns
    setup = metrics.load("driver.setup_wait_pct")(ctx)
    assert setup == pytest.approx(100 * 1_000 / 12_000)
    assert metrics.load("driver.setup_wait_pct.view")(ctx) == setup
    assert setup < metrics.load("driver.device_wait_pct")(ctx)


def test_readers_find_nothing(monkeypatch):
    # the readers of spans and counters; the device trace's are read alike
    # with and without a recorder
    names = [m["name"] for m in spans.entries()
             if m["source"] != "device_trace"]
    ctx = _ctx()
    monkeypatch.setattr(spans, "recorded", lambda: None)   # no recorder
    assert all(metrics.load(n)(ctx) is None for n in names)
    monkeypatch.setattr(spans, "recorded", lambda: ([], {}))
    assert all(metrics.load(n)(ctx) is None for n in names)
    # a cbox stretch: no walk
    sp = [S(n, a, b, p, 0, *(dev or (None, None)))
          for n, a, b, p, dev in PLANTED if not n.startswith("walk.")]
    monkeypatch.setattr(spans, "recorded", lambda: (sp, {}))
    dense = dict(ctx, kernels=[e for e in ctx["kernels"]
                               if "walk_" not in e[0]])
    assert metrics.load("walk.prepare_pct")(dense) is None
    assert metrics.load("trace.walk_kernels_inside_pct")(dense) is None
    assert metrics.load("trace.live_lane_pct")(dense) is None
    # a stretch without set-up spans
    sp = [s for s in sp if s.name != "render.setup"]
    monkeypatch.setattr(spans, "recorded", lambda: (sp, {}))
    assert metrics.load("driver.setup_wait_pct")(ctx) is None


class _ProfiledCPU:
    """The stretch's profiler on the CPU: a real CPU session, so that the
    renderer records, returning as device events the device intervals of
    its rng.draw and walk.* spans and a readback copy."""

    def start(self):
        from torch.autograd import profiler as ap
        self._p = ap.profile(use_cpu=True, use_kineto=True)
        self._p._prepare_trace()
        self._p._start_trace()

    def stop(self):
        torch.autograd._disable_profiler()
        out = []
        for s in tracing.spans():
            if s.dev_start_ns is not None:
                out.append((f"kernel of {s.name}", s.dev_start_ns,
                            s.dev_end_ns - s.dev_start_ns))
            elif s.name == "render.readback":
                out.append(("Memcpy DtoH", s.start_ns, s.end_ns - s.start_ns))
        return out


def test_new_readers_as_files_only(tiny_cell, monkeypatch):
    bench, cell = tiny_cell("cbox", {
        "integrator": "path", "route": "persistent", "width": 12,
        "height": 8, "spp_per_pass": 2,
        "check": {"pixels": 40, "passes": 3}, "trace_min_s": 0.0})
    new = [dict(m, workloads=[cell["name"]]) for m in spans.entries()
           if not m["name"].endswith(".view")
           and m["name"] not in ("walk.prepare_pct",
                                 "trace.walk_kernels_inside_pct")]
    bench["per_layer"] += new
    for m in bench["per_layer"]:
        if m["name"] == "device.idle_pct":
            m["workloads"] = [cell["name"]]
    monkeypatch.setattr(trace, "_DeviceProfiler", _ProfiledCPU)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    res = run.run_cell(bench, cell, 14, 0.3, True, torch.device("cpu"),
                       time.perf_counter(), log=lambda s: None)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == {m["name"] for m in new} | {"device.idle_pct"}
    waits = sum(got[f"{w}.device_wait_pct"] for w in WAITS)
    assert waits == pytest.approx(got["device.idle_pct"], abs=0.5)
    assert 0 <= got["driver.setup_wait_pct"] <= got["driver.device_wait_pct"]
    assert 0 < got["rng.device_pct"] <= 100
    assert 0 < got["trace.live_lane_pct"] <= 100
    assert got["loop.iterations_per_spp"] > 0


@pytest.mark.cuda
def test_new_readers_on_the_card(tiny_cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench, cell = tiny_cell("grid122k", {
        "integrator": "ao", "route": "per_pass", "width": 256,
        "height": 144, "spp_per_pass": 2,
        "check": {"pixels": 1024, "passes": 3}, "trace_min_s": 0.2})
    new = [dict(m, workloads=[cell["name"]]) for m in spans.entries()
           if not m["name"].endswith(".view")
           and m["name"] != "loop.iterations_per_spp"]
    bench["per_layer"] += new
    for m in bench["per_layer"]:
        if m["name"] == "device.idle_pct":
            m["workloads"] = [cell["name"]]
    res = run.run_cell(bench, cell, 2_500_000_003, 2.0, True,
                       torch.device("cuda", 0), time.perf_counter(),
                       log=lambda s: None)
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == {m["name"] for m in new} | {"device.idle_pct"}
    waits = sum(got[f"{w}.device_wait_pct"] for w in WAITS)
    assert waits == pytest.approx(got["device.idle_pct"], abs=0.5)
    assert got["trace.walk_kernels_inside_pct"] >= 98.0

"""The renderer's recorder of spans and counters (utils/tracing.py) on the
CPU: off without a profiler (no span, no counter, the same film as under
one), on under one (the span tree of a path and an AO render, and of an AO
render over pair tables), off again after `torch.autograd._disable_profiler()`, a
bounded buffer, and per-kind ray counts that add up to `counting_rays`."""
import numpy as np
import pytest
import torch
from torch.autograd import profiler as ap

from rustlight_tpu_torch.accel.walk import WalkOptions
from rustlight_tpu_torch.integrators import (IntegratorAO,
                                             IntegratorPathTracing, render)
from rustlight_tpu_torch.models import cornell_box, sphere_grid
from rustlight_tpu_torch.ops.native import counting_rays
from rustlight_tpu_torch.utils import tracing

KINDS = ("path", "ao")
SPP, SEED = 2, 7


@pytest.fixture(scope="module")
def scenes():
    grid = sphere_grid(3000, 16, 16)
    return {"path": cornell_box(16, 12).compile(device="cpu"),
            "ao": grid.compile(device="cpu"),
            "pair": grid.compile(device="cpu",
                                 walk_options=WalkOptions(pair=True))}


def _render(scenes, kind):
    if kind == "path":
        integ = IntegratorPathTracing(max_depth=4)
    else:
        integ = IntegratorAO(max_distance=2.0)
    return render(scenes[kind], integ, SPP, seed=SEED)["primal"]


class _Profiled:
    """A CPU profiler session, stopped as portbench/trace.py stops its
    own (`torch.autograd._disable_profiler()`)."""

    def __enter__(self):
        self._p = ap.profile(use_cpu=True, use_kineto=True)
        self._p._prepare_trace()
        self._p._start_trace()
        return self

    def __exit__(self, *exc):
        torch.autograd._disable_profiler()
        return False


def _profiled(scenes, kinds):
    with _Profiled():
        films = [_render(scenes, k) for k in kinds]
    return films, tracing.spans(), tracing.counters()


def test_off_records_nothing_and_keeps_the_film(scenes):
    before = (tracing.spans(), tracing.counters())
    films = [_render(scenes, k) for k in KINDS]
    assert not tracing.enabled()
    assert (tracing.spans(), tracing.counters()) == before
    on, _, _ = _profiled(scenes, KINDS)
    for f, g in zip(films, on):
        np.testing.assert_array_equal(f, g)


@pytest.mark.parametrize("kind, names", [
    ("path", {"render", "render.setup", "loop.block", "loop.sync",
              "rng.draw", "dense.trace", "render.readback"}),
    ("ao", {"render", "render.setup", "loop.sample", "rng.draw",
            "walk.prepare", "walk.sync", "walk.kernel", "walk.unsort",
            "render.readback"}),
    ("pair", {"render", "render.setup", "loop.sample", "rng.draw",
              "walk.prepare", "walk.kernel", "walk.unsort",
              "render.readback"}),
])
def test_profiled_render_gives_the_span_tree(scenes, kind, names):
    _, sp, c = _profiled(scenes, [kind, kind])
    assert {s.name for s in sp} == names
    roots = [i for i, s in enumerate(sp) if s.parent < 0]
    assert [sp[i].name for i in roots] == ["render", "render"]
    for i, s in enumerate(sp):
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent < 0:
            assert s.root == i
            continue
        p = sp[s.parent]
        assert s.parent < i and s.root == p.root
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        if s.name.startswith("render."):
            assert p.name == "render"
        if s.name in ("rng.draw", "walk.kernel"):   # device spans, CPU
            assert (s.dev_start_ns, s.dev_end_ns) == (s.start_ns, s.end_ns)
    # two renders, one root each, their spans apart
    assert sp[roots[0]].end_ns <= sp[roots[1]].start_ns
    assert {s.root for s in sp} == set(roots)
    if kind == "path":
        assert c["loop.iterations"] > 0
    assert c["trace.lanes.closest"] > 0 and c["trace.lanes.anyhit"] > 0


def test_disabled_profiler_turns_the_recorder_off(scenes):
    with _Profiled():
        assert tracing.enabled()
    # the Python flag stays set; the recorder reads the profiler's state
    assert ap._is_profiler_enabled and not tracing.enabled()
    _, sp, c = _profiled(scenes, ["path"])
    _render(scenes, "path")
    assert tracing.spans() == sp and tracing.counters() == c
    assert sum(s.name == "render" for s in sp) == 1


def test_buffer_is_bounded(scenes, monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 6)
    _, sp, c = _profiled(scenes, ["path"])
    assert len(sp) == 6 and c["tracing.dropped"] > 0
    assert all(s.end_ns is not None for s in sp)


def test_per_kind_counts_add_up_to_counting_rays(scenes):
    with counting_rays("cpu") as plain:
        _render(scenes, "ao")
    with counting_rays("cpu") as traced:
        _, _, c = _profiled(scenes, ["ao"])
    total = int(plain)
    assert total > 0 and int(traced) == total
    assert c["trace.live.closest"] + c["trace.live.anyhit"] == total
    lanes = c["trace.lanes.closest"] + c["trace.lanes.anyhit"]
    assert total <= lanes
    assert c["trace.lanes.closest"] == SPP * 16 * 16

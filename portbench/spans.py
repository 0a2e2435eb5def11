"""The renderer's spans and counters (rustlight_tpu_torch/utils/tracing.py)
set against the traced stretch's device events, for the per-layer readers
of portbench/metrics/ that read them.

A span's host interval and the profiler's device events share one clock
(Unix ns). The stretch runs from its first `render` span (or its first
device event, if earlier) for its wall time. Its device-idle time is split
by the innermost span open on the host while the device idles: `render`
and `render.*` (driver), `loop.*` and `rng.*` (wavefront loop), `walk.*`
and `dense.*` (trace), none (the caller's code). The four parts add up to
`device.idle_pct`.

`portbench/spans.json` holds those readers' entries in BENCHMARK.json's
form. The harness cannot list them yet: its run raises on a reader that
returns None, and a program without the recorder (one older than it) gives
them nothing to read. Until it can, `main` is a traced run of one cell
with them (to be deleted, with spans.json, once run_cell leaves a None
reading out of the line and the entries move into BENCHMARK.json):

    python3 -m portbench.spans --workload <name> --seed <n> --seconds <s>

prints the result line of `portbench.run --trace 1` with these metrics
added where the cell is listed.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# a span's layer, by the first word of its name
LAYERS = {"render": "driver", "loop": "loop", "rng": "loop",
          "walk": "accel", "dense": "accel"}
# the kernels of the tile walk and of the pair walk
WALK = re.compile(r"(^|[\s:])(walk|pair)_\w+")


def recorded():
    """(spans, counters) of the renderer's last profiled session, or None
    where the renderer has no recorder."""
    try:
        from rustlight_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans(), tracing.counters()


def merge(intervals):
    """The union of [a, b) intervals, as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def overlap(xs, ys) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def busy(ctx):
    """The union of the stretch's device events."""
    return merge((s, s + d) for _, s, d in ctx["events"])


def bounds(sp, ctx):
    """The stretch's [start, end) on the spans' clock: from its first
    `render` span or device event, for its wall time."""
    starts = [s.start_ns for s in sp if s.parent < 0 and s.name == "render"]
    starts += [e[1] for e in ctx["events"][:1]]
    t0 = min(starts)
    return t0, t0 + round(ctx["wall_s"] * 1e9)


def innermost(sp):
    """[(start, end, name)]: the host time in which span `name` is the
    innermost one open, disjoint, in order."""
    kids = {}
    for i, s in enumerate(sp):
        kids.setdefault(s.parent, []).append(i)
    out = []

    def walk(i):
        s = sp[i]
        t = s.start_ns
        for c in kids.get(i, ()):
            if sp[c].start_ns > t:
                out.append((t, sp[c].start_ns, s.name))
            walk(c)
            t = max(t, sp[c].end_ns)
        if s.end_ns > t:
            out.append((t, s.end_ns, s.name))
    for r in kids.get(-1, ()):
        walk(r)
    return out


def gaps(intervals, t0, t1):
    """The complement of sorted disjoint intervals within [t0, t1)."""
    t = t0
    for a, b in intervals:
        if a > t:
            yield t, min(a, t1)
        t = max(t, b)
        if t >= t1:
            return
    if t < t1:
        yield t, t1


def idle_by_span(ctx):
    """{span name: device-idle ns while it is the innermost open span},
    with None for no span open, over the stretch; None without spans."""
    rec = recorded()
    if rec is None or not rec[0] or not ctx["events"] or ctx["wall_s"] <= 0:
        return None
    sp = [s for s in rec[0] if s.end_ns is not None]
    idle = list(gaps(busy(ctx), *bounds(sp, ctx)))
    out = {None: sum(b - a for a, b in idle)}
    i = 0
    for a, b, name in innermost(sp):      # both in time order
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j, ns = i, 0
        while j < len(idle) and idle[j][0] < b:
            ns += min(b, idle[j][1]) - max(a, idle[j][0])
            j += 1
        out[None] -= ns
        out[name] = out.get(name, 0) + ns
    return out


def waits(ctx):
    """{layer: device-idle ns while that layer's span is innermost}, with
    `caller` for no span open, over the stretch; None without spans."""
    by = idle_by_span(ctx)
    if by is None:
        return None
    out = dict.fromkeys(LAYERS.values(), 0)
    out["caller"] = by.pop(None)
    for name, ns in by.items():
        layer = LAYERS.get(name.split(".")[0])
        if layer is not None:
            out[layer] += ns
    return out


def wait_pct(ctx, layer):
    w = waits(ctx)
    if w is None:
        return None
    return 100.0 * w[layer] / (ctx["wall_s"] * 1e9)


def span_wait_pct(ctx, name):
    """The share of the stretch's wall in which the device idled while span
    `name` was the innermost one open, in percent; None without spans or
    without that span."""
    by = idle_by_span(ctx)
    if by is None or name not in by:
        return None
    return 100.0 * by[name] / (ctx["wall_s"] * 1e9)


def device_intervals(sp, names):
    return merge((s.dev_start_ns, s.dev_end_ns) for s in sp
                 if s.name in names and s.dev_start_ns is not None)


def busy_inside(ctx, names):
    """Device-busy ns inside the resolved device intervals of spans
    `names`; None without such spans."""
    rec = recorded()
    if rec is None:
        return None
    iv = device_intervals(rec[0], names)
    if not iv or not ctx["events"]:
        return None
    return overlap(busy(ctx), iv)


def walk_kernel_ns(ctx) -> int:
    return sum(d for n, _, d in ctx["kernels"] if WALK.search(n))


def entries():
    with open(ROOT / "spans.json") as f:
        return json.load(f)


def main(argv=None) -> int:
    import argparse
    import sys

    from . import run

    import torch

    p = argparse.ArgumentParser(description="a traced run of one cell with "
                                "the readers of the renderer's spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    run._pin_caches()
    bench = run.load_benchmark()
    cell = run.find_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    bench["per_layer"] += entries()
    res = run.run_cell(bench, cell, args.seed, args.seconds, True,
                       torch.device("cuda", 0), run.T_START,
                       log=lambda s: print(s, file=sys.stderr, flush=True))
    print(f"portbench: card {run.card_line()}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Spans and counters of the renderer, on the profiler's clock.

The recorder is on exactly while a torch profiler records
(`torch.autograd._profiler_enabled()`; the Python flag
`torch.autograd.profiler._is_profiler_enabled` stays set after
`torch.autograd._disable_profiler()`). An operator who wraps renders in
`torch.profiler.profile` gets the spans; no flag, variable or argument
turns them on. Off, a span site costs that one check and returns a shared
no-op context, and a counter site the same check: nothing is recorded,
allocated, launched or synchronized.

Spans: `with span(name, device)` records the name, the host interval
(`time.time_ns()`, the clock of the profiler's kineto events), the
enclosing span and the root of its tree (one `render` call, through
`root()`: every span of one pass shares that root's index). Given a CUDA
device, a span also records a pair of timing events on that device's
current stream. At a session's first span (or a device's first device
span) the recorder synchronizes once and records an anchor event with its
host time; after the session each pair resolves, through `elapsed_time`
from the anchor, into the device interval of the work the span enqueued,
on the same clock. A span given the CPU takes its host interval as its
device interval. Spans nest: they assume one rendering thread.

Counters: `count(name, n)` adds n on the host. `count_rays(tfar, kind)`,
called by every trace wrapper of ops/ with the lanes it was handed, adds
the lanes with tfar > 0 (summed once, on the device) to every open
`counting_rays()` accumulator, recorder on or off; while the recorder is
on it also adds them to the kind's (`closest`, `anyhit`) live count and
counts the lanes handed in on the host (`trace.live.<kind>`,
`trace.lanes.<kind>`).

Sessions: the first record under a profiler after the last session was
read (`spans()` or `counters()` with the profiler off), or after a
`root()` site ran with the profiler off, starts a new session and drops
the last one's spans and counters. A session keeps at most CAPACITY spans;
those past it are counted in `tracing.dropped`.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import List, NamedTuple, Optional

import torch

CAPACITY = 1 << 20
# per-kind live-lane sums kept on the device before they are folded into one
_FOLD = 1024
_enabled = torch.autograd._profiler_enabled
_now = time.time_ns
_RAY_COUNTERS: List[torch.Tensor] = []


class Span(NamedTuple):
    name: str
    start_ns: int                  # host interval, Unix ns
    end_ns: Optional[int]          # None while the span is open
    parent: int                    # index of the enclosing span, -1: none
    root: int                      # index of the root of its tree
    dev_start_ns: Optional[int]    # device interval (device spans only)
    dev_end_ns: Optional[int]


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """A span being recorded: entering records its start, leaving its end."""
    __slots__ = ("name", "device", "idx")

    def __init__(self, name, device):
        self.name, self.device = name, device

    def __enter__(self):
        self.idx = _REC.open(self.name, self.device)
        return self

    def __exit__(self, *exc):
        _REC.close(self.idx)
        return False


def _cuda_index(device) -> Optional[int]:
    """The CUDA device index of a span's device, None off CUDA."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else \
        device.index


class _Recorder:
    def __init__(self):
        self.stale = True          # the next record starts a session
        self._reset()

    def _reset(self):
        self.recs = []             # [name, start, end, parent, root, dev]
        self.stack = []            # indices of the open spans (-1: dropped)
        self.root_idx = -1
        self.anchors = {}          # CUDA index -> (event, host ns)
        self.counts = defaultdict(int)
        self.live = defaultdict(list)
        self.resolved = None

    def session(self):
        if self.stale:
            self._reset()
            self.stale = False
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                self._anchor(torch.cuda.current_device())

    def _anchor(self, index: int):
        """Synchronize the device, then pin an event to the host clock: of
        three tries, the one whose record-to-completion took least, at the
        middle of that interval."""
        torch.cuda.synchronize(index)
        stream = torch.cuda.current_stream(index)
        best = None
        for _ in range(3):
            ev = torch.cuda.Event(enable_timing=True)
            t0 = _now()
            ev.record(stream)
            ev.synchronize()
            t1 = _now()
            if best is None or t1 - t0 < best[2] - best[1]:
                best = (ev, t0, t1)
        self.anchors[index] = (best[0], (best[1] + best[2]) // 2)

    def open(self, name, device) -> int:
        self.session()
        if len(self.recs) >= CAPACITY:
            self.counts["tracing.dropped"] += 1
            self.stack.append(-1)
            return -1
        idx = len(self.recs)
        if not self.stack:
            self.root_idx = idx
        parent = self.stack[-1] if self.stack else -1
        t0 = _now()
        dev = None
        index = _cuda_index(device)
        if index is not None:
            if index not in self.anchors:
                self._anchor(index)
            stream = torch.cuda.current_stream(index)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            dev = [index, stream, ev, None]
        elif device is not None:
            dev = "host"
        self.recs.append([name, t0, None, parent, self.root_idx, dev])
        self.stack.append(idx)
        self.resolved = None
        return idx

    def close(self, idx: int):
        if idx >= 0:
            rec = self.recs[idx]
            dev = rec[5]
            if isinstance(dev, list):
                dev[3] = torch.cuda.Event(enable_timing=True)
                dev[3].record(dev[1])
            rec[2] = _now()
        self.stack.pop()

    def add(self, name: str, n: int):
        self.session()
        self.counts[name] += int(n)

    def add_lanes(self, kind: str, live, lanes: int):
        self.session()
        self.counts[f"trace.lanes.{kind}"] += lanes
        pending = self.live[kind]
        pending.append(live)
        if len(pending) >= _FOLD:
            self.live[kind] = [torch.stack(pending).sum()]

    def resolve(self) -> List[Span]:
        for index in self.anchors:
            torch.cuda.synchronize(index)
        out = []
        for name, t0, t1, parent, root_, dev in self.recs:
            d0 = d1 = None
            if dev == "host":
                d0, d1 = t0, t1
            elif dev is not None and dev[3] is not None:
                anchor, host = self.anchors[dev[0]]
                d0 = host + round(anchor.elapsed_time(dev[2]) * 1e6)
                d1 = host + round(anchor.elapsed_time(dev[3]) * 1e6)
            out.append(Span(name, t0, t1, parent, root_, d0, d1))
        return out


_REC = _Recorder()


def enabled() -> bool:
    """Whether the recorder is on (a torch profiler records)."""
    return _enabled()


def span(name: str, device=None):
    """A context that records span `name`; `device` (a torch.device) is
    where the work it encloses runs, given for spans whose device interval
    is read."""
    if not _enabled():
        return _NULL
    return _Open(name, device)


def root(name: str):
    """`span(name)` at the root of a call tree (a `render` call). With the
    profiler off it marks the session ended, so that the next profiled
    record starts a new one."""
    if not _enabled():
        _REC.stale = True
        return _NULL
    return _Open(name, None)


def spanned(name: str):
    """Decorate a function so that each call is one span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the host counter `name` while the recorder is on."""
    if _enabled():
        _REC.add(name, n)


@contextlib.contextmanager
def counting_rays(device):
    """Yield an int64 device scalar that sums, while the context is open,
    the lanes with tfar > 0 handed to any trace kernel."""
    acc = torch.zeros((), dtype=torch.int64, device=device)
    _RAY_COUNTERS.append(acc)
    try:
        yield acc
    finally:
        _RAY_COUNTERS.remove(acc)


def count_rays(tfar, kind: str) -> None:
    """The lanes a trace wrapper of kind `kind` (closest, anyhit) was
    handed, with tfar [n]: see the module's docstring."""
    on = _enabled()
    if not (on or _RAY_COUNTERS):
        return
    live = (tfar > 0.0).sum()
    for acc in _RAY_COUNTERS:
        acc += live
    if on:
        _REC.add_lanes(kind, live, tfar.numel())


def _read():
    """After a session, the next record starts a new one."""
    if not _enabled():
        _REC.stale = True


def spans() -> List[Span]:
    """The last session's spans, in the order they were opened (a parent
    before its children), device intervals resolved (a host sync)."""
    if _REC.resolved is None:
        out = _REC.resolve()
        if _enabled():
            return out
        _REC.resolved = out
    _read()
    return _REC.resolved


def counters() -> dict:
    """The last session's counters by name, the live lanes summed."""
    out = dict(_REC.counts)
    for kind, pending in _REC.live.items():
        out[f"trace.live.{kind}"] = int(torch.stack(pending).sum())
    _read()
    return out

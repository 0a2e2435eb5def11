"""The traced stretch of a run: whole passes under torch.profiler (the
device's activity only) and the renderer's ray counter, reduced to the
context that the per-layer readers of portbench/metrics/ read.

The context (`Stretch.context()`):
  events    [(name, start_ns, dur_ns)] of every device operation, by start
  kernels   the same, kernels only (no memcpy or memset)
  wall_s    host wall of the stretch, from a synchronised start to the end of
            its last pass (the film on the host)
  busy_s    the union of the device operations' intervals
  passes, spp   whole passes in the stretch and the samples a pixel they gave
  rays      lanes with tfar > 0 handed to any trace kernel (the renderer's
            ops/native.py:counting_rays)
  n_tris    the scene's triangles
"""
from __future__ import annotations

import re
import time

import torch

from rustlight_tpu_torch.ops.native import counting_rays

_COPY = re.compile(r"^(Memcpy|Memset)")


def _kineto_fields(e):
    name = e.name()
    if hasattr(e, "start_ns"):
        return name, int(e.start_ns()), int(e.duration_ns())
    return name, int(e.start_us()) * 1000, int(e.duration_us()) * 1000


class _DeviceProfiler:
    """torch.profiler's recording of the device's activity, read as raw
    kineto events: the parse into FunctionEvents that leaving the profiler's
    context does takes seconds for a pass of 10^5 launches."""

    def start(self):
        from torch.autograd import profiler as ap
        self._p = ap.profile(use_cpu=False, use_device="cuda",
                             use_kineto=True)
        self._p._prepare_trace()
        self._p._start_trace()

    def stop(self):
        from torch.autograd import DeviceType
        res = torch.autograd._disable_profiler()
        return [_kineto_fields(e) for e in res.events()
                if e.device_type() == DeviceType.CUDA]


def union_ns(events) -> int:
    """Length of the union of the events' [start, start + dur) intervals."""
    total, cur_s, cur_e = 0, None, None
    for _, s, d in sorted(events, key=lambda e: e[1]):
        e = s + d
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def short_name(name: str, width: int = 120) -> str:
    return name[5:width + 5] if name.startswith("void ") else name[:width]


class Stretch:
    """Profile whole passes: `begin()` just before a pass, `after_pass()`
    just after each, which ends the stretch once `min_s` have passed (or
    `end()`), and `context()` once the window has closed."""

    def __init__(self, device, n_tris: int, spp: int, min_s: float):
        self.device, self.n_tris, self.spp, self.min_s = (
            device, n_tris, spp, min_s)
        self.passes = 0
        self.wall_s = 0.0
        self._prof = self._events = None

    def begin(self):
        torch.cuda.synchronize(self.device)
        self._rays_cm = counting_rays(self.device)
        self._rays = self._rays_cm.__enter__()
        self._prof = _DeviceProfiler()
        self._prof.start()
        self._t0 = time.perf_counter()

    def after_pass(self):
        self.passes += 1
        if time.perf_counter() - self._t0 >= self.min_s:
            self.end()

    def end(self):
        torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self._t0
        self._events = self._prof.stop()
        self.rays = int(self._rays.item())
        self._rays_cm.__exit__(None, None, None)

    @property
    def open(self) -> bool:
        return self._prof is not None and self._events is None

    def context(self) -> dict:
        ev = sorted(self._events, key=lambda e: e[1])
        return {
            "events": ev,
            "kernels": [e for e in ev if not _COPY.match(e[0])],
            "wall_s": self.wall_s,
            "busy_s": union_ns(ev) / 1e9,
            "passes": self.passes,
            "spp": self.passes * self.spp,
            "rays": self.rays,
            "n_tris": self.n_tris,
        }


def breakdown(ctx: dict, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps between device operations, named by the operation
    that ends each (what the host was issuing or waiting for)."""
    by = {}
    for name, _, d in ctx["events"]:
        by[name] = by.get(name, 0) + d
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], None
    for name, s, d in ctx["events"]:
        if end is not None and s > end:
            gaps.append((f"before {short_name(name, 80)}", s - end))
        end = s + d if end is None else max(end, s + d)
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[short_name(n), v / 1e9] for n, v in ops],
            "idle_gaps": [[n, v / 1e9] for n, v in gaps[:top]]}

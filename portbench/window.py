"""The one generator of traffic: a closed loop of passes, one render in
flight, read from a traffic mix's data file (portbench/traffic/<mix>.json).

A mix states the integrator (a module of portbench/integrators/ and of
portbench/reference/integrators/ by that name), the route (`persistent`:
the path tracer's `compute_block`; `per_pass`: `compute_pixel`), the film,
the samples a pixel of one pass, the check's sample of pixels and passes,
the shortest traced stretch, and optionally `least_passes`, the fewest
passes a window holds (default 1). Every pass is `render(spp=...,
seed=...)` with a seed of its own drawn from the run's; its film, copied
to the host, is folded into a float64 running average (`(avg * k + film)
/ (k + 1)`, as the `-a` driver and the progressive viewer do) before the
pass ends. A pass starts while the window is open: for `seconds`, and
until it holds the mix's least passes. The window's rate counts every
pass that started in it, up to the last one's end.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
_M32 = 0xFFFFFFFF


def load_traffic(name: str) -> dict:
    with open(ROOT / "traffic" / f"{name}.json") as f:
        return json.load(f)


def pass_seed(seed: int, k: int) -> int:
    """The render seed of pass k of a run seeded `seed` (k = -1: the
    warm-up); distinct passes of a run get distinct seeds."""
    return (int(seed) * 0x9E3779B1 + (k + 1) * 0x85EBCA77 + 0x165667B1) & _M32


@dataclass
class Window:
    starts: List[float] = field(default_factory=list)
    ends: List[float] = field(default_factory=list)
    seeds: List[int] = field(default_factory=list)
    values: List[np.ndarray] = field(default_factory=list)  # check pixels
    avg: Optional[np.ndarray] = None
    t0: float = 0.0

    @property
    def passes(self) -> int:
        return len(self.starts)

    def frame_ms(self) -> np.ndarray:
        return (np.asarray(self.ends) - np.asarray(self.starts)) * 1e3


def run(render: Callable[[int], np.ndarray], seed: int, seconds: float,
        check_pixels: np.ndarray, stretch=None,
        least_passes: int = 1) -> Window:
    """The measured window: passes `render(pass_seed)` back to back while
    fewer than `seconds` have passed or fewer than `least_passes` passes
    have ended. With `stretch` (portbench/trace.py), whole passes from the
    second on are traced until its least length has passed."""
    w = Window(t0=time.perf_counter())
    k = 0
    while time.perf_counter() - w.t0 < seconds or k < least_passes:
        if stretch is not None and k == 1:
            stretch.begin()
        s = pass_seed(seed, k)
        start = time.perf_counter()
        img = render(s)
        flat = img.reshape(-1, 3)
        if w.avg is None:
            w.avg = img.astype(np.float64)
        else:
            w.avg *= k
            w.avg += img
            w.avg /= k + 1
        end = time.perf_counter()
        if stretch is not None and stretch.open:
            stretch.after_pass()
        w.starts.append(start)
        w.ends.append(end)
        w.seeds.append(s)
        w.values.append(flat[check_pixels].copy())
        k += 1
    if stretch is not None and stretch.open:
        stretch.end()
    return w


def msamples_s(w: Window, spp: int, lanes: int) -> float:
    return w.passes * spp * lanes / (w.ends[-1] - w.t0) / 1e6

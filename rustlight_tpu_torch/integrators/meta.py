"""Meta-integrators: pass averaging and equal-time rendering; port of
rustlight_tpu/integrators/meta.py.

Reference: src/integrators/avg.rs (a running average across passes, an
optional timeout, per-pass dumps and the `<out>_time.csv` timeline) and
src/integrators/equal_time.rs (passes until a wall-clock budget, the
achieved spp reported). Pass p renders with seed + p, so a run resumed from
its dumps (`resume=True`) reproduces the uninterrupted run bit for bit.
"""
from __future__ import annotations

import inspect
import logging
import os
import re
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils import image as _image
from ..utils.film import Film
from .common import SplattingIntegrator, render, render_splat

log = logging.getLogger(__name__)


def _render_once(scene, integrator, spp, seed, sampler="independent",
                 mesh=None):
    """One render pass: a splatting integrator through render_splat, a
    self-driving one (gradient domain, MCMC, guiding) through its own
    render, any other through render with the sampler. `mesh` (the
    reference's -t; every rank calls this) routes to render_splat_sharded
    (spp * w * h paths), to the integrator's render(mesh=...), or to
    render_sharded; a self-driving integrator whose render takes no mesh
    logs a warning and renders on this rank's device alone, as the JAX
    package does."""
    if isinstance(integrator, SplattingIntegrator):
        if mesh is not None:
            from ..parallel import render_splat_sharded
            cam = scene.camera
            return render_splat_sharded(
                scene, integrator, n_paths=spp * cam.width * cam.height,
                mesh=mesh, seed=seed)
        return render_splat(scene, integrator, spp, seed=seed)
    if hasattr(integrator, "render"):
        kw = {}
        if mesh is not None:
            if "mesh" in inspect.signature(integrator.render).parameters:
                kw["mesh"] = mesh
            else:
                # a requested mesh is never dropped silently
                log.warning(
                    "%s.render() does not support a device mesh; the -t "
                    "request is ignored and this pass runs single-device",
                    type(integrator).__name__)
        return integrator.render(scene, spp, seed=seed, **kw)
    if mesh is not None:
        from ..parallel import render_sharded
        return render_sharded(scene, integrator, spp, mesh=mesh, seed=seed,
                              sampler=sampler)
    return render(scene, integrator, spp, seed=seed, sampler=sampler)


def _lead(mesh) -> bool:
    """Whether this process writes the run's files: rank 0 of a mesh, or
    the only process."""
    return mesh is None or mesh.rank == 0


def _decide(mesh, stop: bool) -> bool:
    """Rank 0's stop decision on every rank: ranks that decided from their
    own clocks would run different numbers of passes and deadlock in the
    next pass's collectives."""
    if mesh is None:
        return stop
    from ..parallel import agree
    return bool(agree(mesh, bool(stop)))


def _print_progress(it: int, nb_passes, timeout_s, elapsed: float,
                    spp_per_pass: int) -> None:
    """One in-place progress line on stderr (the reference's optional
    terminal progress bar)."""
    if nb_passes:
        frac = it / nb_passes
        eta = elapsed / max(it, 1) * (nb_passes - it)
        tail = f"pass {it}/{nb_passes}  eta {eta:6.1f}s"
    elif timeout_s:
        frac = min(elapsed / timeout_s, 1.0)
        tail = f"{elapsed:6.1f}/{timeout_s:.0f}s  pass {it}"
    else:
        frac = 0.0
        tail = f"pass {it} (unbounded)"
    n = int(frac * 30)
    bar = "#" * n + "-" * (30 - n)
    sys.stderr.write(f"\r[{bar}] {tail}  {it * spp_per_pass} spp")
    sys.stderr.flush()


def _film_of(path) -> Film:
    img = _image.load(str(path))
    film = Film(img.shape[1], img.shape[0])
    film.buffers["primal"] = np.asarray(img, np.float32)
    return film


def _load_state(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class IntegratorAverage:
    """Average repeated passes (the reference's `-a`): `nb_passes` passes,
    or passes until `timeout_s` seconds of render time, or, with neither,
    forever with a dump a pass (`-a inf`; `max_passes` bounds it).

    `dump_base` writes `{dump_base}_<k>.pfm` after pass k, the integrator's
    state (if it has `state_dict`) atomically to `{dump_base}_state.npz`
    beside it, and `{dump_base}_time.csv` (seconds, passes) at the end.
    `resume` continues from the newest dump; a non-averaging integrator
    (SMCMC with kept chains) continues from its state alone.

    With `mesh` every rank runs the loop: each pass renders over the mesh,
    rank 0 alone writes the dumps, the state and the timeline, and rank
    0's clock decides when a timed or equal-time run stops (broadcast to
    every rank each pass)."""

    def __init__(self, integrator, spp_per_pass: int = 1,
                 nb_passes: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 dump_base: Optional[str] = None,
                 mesh=None, max_passes: Optional[int] = None,
                 resume: bool = False, progress: bool = False):
        self.integrator = integrator
        self.spp_per_pass = spp_per_pass
        self.nb_passes = nb_passes
        self.timeout_s = timeout_s
        self.dump_base = dump_base
        self.mesh = mesh
        self.max_passes = max_passes
        self.infinite = nb_passes is None and timeout_s is None
        self.resume = resume
        self.progress = progress

    def _load_dump(self, k: int):
        """Dump pass k as a Film, or None."""
        path = f"{self.dump_base}_{k}.pfm"
        return _film_of(path) if os.path.exists(path) else None

    def _find_resume(self):
        """(film, pass count) of the newest dump, or None. The film is read
        from the file found, whatever its name's zero padding."""
        base = Path(self.dump_base)
        pat = re.compile(re.escape(base.name) + r"_(\d+)\.pfm$")
        best = None
        for f in (base.parent if base.parent.name else Path(".")).glob(
                base.name + "_*.pfm"):
            m = pat.match(f.name)
            if m:
                k = int(m.group(1))
                if best is None or k > best[0]:
                    best = (k, f)
        if best is None:
            return None
        return _film_of(best[1]), best[0]

    def _resume_from(self, scene, averaging):
        """(film or None, passes done) to continue from."""
        state_path = f"{self.dump_base}_state.npz"
        has_state = (hasattr(self.integrator, "load_state_dict")
                     and os.path.exists(state_path))
        if not averaging:
            # a film dump alone cannot seed a non-averaging integrator,
            # which replaces the film each pass: its state can
            if has_state:
                sd = _load_state(state_path)
                it = int(sd.pop("pass_count"))
                self.integrator.load_state_dict(sd, scene)
                return None, it
            log.warning(
                "--resume ignored: %s does not average passes and no "
                "chain-state dump was found, so a film dump cannot seed a "
                "bit-exact continuation", type(self.integrator).__name__)
            return None, 0
        got = self._find_resume()
        if got is None:
            return None, 0
        avg, it = got
        if has_state:
            sd = _load_state(state_path)
            k = int(sd.pop("pass_count"))
            older = self._load_dump(k) if k < it else None
            if k == it:
                self.integrator.load_state_dict(sd, scene)
            elif older is not None:
                # a crash between the film's save and the state's: rewind
                # to the pass the state matches
                avg, it = older, k
                self.integrator.load_state_dict(sd, scene)
            else:
                log.warning(
                    "--resume: state checkpoint (pass %d) does not align "
                    "with newest dump (pass %d) and no pass-%d dump exists; "
                    "continuing from the film only (auxiliary state "
                    "restarts)", k, it, k)
        return avg, it

    def _dump(self, avg: Film, it: int) -> None:
        if not _lead(self.mesh):
            return
        avg.save(f"{self.dump_base}_{it}.pfm")
        if hasattr(self.integrator, "state_dict"):
            sd = self.integrator.state_dict()
            if sd is not None:
                # atomic: a crash mid-save keeps the previous checkpoint
                sd["pass_count"] = np.asarray(it)
                tmp = f"{self.dump_base}_state_tmp.npz"
                np.savez(tmp, **sd)
                os.replace(tmp, f"{self.dump_base}_state.npz")

    def render(self, scene, seed: int = 0, verbose: bool = False) -> Film:
        if self.timeout_s is not None:
            # the budget is render time: the first pass's set-up (kernel
            # builds, allocations) runs outside the clock
            _render_once(scene, self.integrator, self.spp_per_pass, seed - 1,
                         mesh=self.mesh)
        t0 = time.time()
        avg: Optional[Film] = None
        timeline = []
        it = 0
        averaging = getattr(self.integrator, "averaging", True)
        if self.resume and self.dump_base:
            avg, it = self._resume_from(scene, averaging)
        if (self.infinite and self.dump_base is None
                and self.max_passes is None):
            raise ValueError(
                "IntegratorAverage with nb_passes=None and timeout_s=None "
                "runs forever: give it dump_base (per-pass checkpoints, the "
                "-a inf contract) or max_passes")
        while True:
            if (self.nb_passes is not None and self.timeout_s is None
                    and it >= self.nb_passes and avg is not None):
                break   # a resumed run that is complete adds no pass
            film = _render_once(scene, self.integrator, self.spp_per_pass,
                                seed + it, mesh=self.mesh)
            if avg is None or not averaging:
                avg = film
            else:
                avg.average_with(film, it)
            it += 1
            timeline.append((time.time() - t0, it))
            if self.progress and _lead(self.mesh):
                _print_progress(it, self.nb_passes, self.timeout_s,
                                time.time() - t0, self.spp_per_pass)
            if self.dump_base:
                self._dump(avg, it)
            if self.max_passes is not None and it >= self.max_passes:
                break
            if self.infinite:
                continue
            if self.timeout_s is not None:
                if _decide(self.mesh, time.time() - t0 >= self.timeout_s):
                    break
            elif it >= self.nb_passes:
                break
        if self.progress and _lead(self.mesh):
            sys.stderr.write("\n")
        if self.dump_base and _lead(self.mesh):
            # the per-pass cumulative time (avg.rs:97-106)
            with open(f"{self.dump_base}_time.csv", "w") as f:
                for t, i in timeline:
                    f.write(f"{t},{i}\n")
        if verbose and _lead(self.mesh):
            print(f"avg: {it} passes in {time.time() - t0:.2f}s")
        return avg


class IntegratorEqualTime:
    """Render passes until `target_s` seconds have elapsed (the reference's
    `-e`); `achieved_spp` reports the samples rendered."""

    def __init__(self, integrator, target_s: float, spp_per_pass: int = 1,
                 mesh=None, progress: bool = False):
        self.integrator = integrator
        self.target_s = target_s
        self.spp_per_pass = spp_per_pass
        self.achieved_spp = 0
        self.mesh = mesh
        self.progress = progress

    def render(self, scene, seed: int = 0, verbose: bool = False) -> Film:
        # the first pass's set-up runs outside the clock: the budget is
        # render time
        _render_once(scene, self.integrator, self.spp_per_pass, seed - 1,
                     mesh=self.mesh)
        t0 = time.time()
        acc: Optional[Film] = None
        passes = 0
        while passes == 0 or not _decide(
                self.mesh, time.time() - t0 >= self.target_s):
            film = _render_once(scene, self.integrator, self.spp_per_pass,
                                seed + passes, mesh=self.mesh)
            if acc is None:
                acc = film
            else:
                acc.average_with(film, passes)
            passes += 1
            if self.progress and _lead(self.mesh):
                _print_progress(passes, None, self.target_s,
                                time.time() - t0, self.spp_per_pass)
        self.achieved_spp = passes * self.spp_per_pass
        if self.progress and _lead(self.mesh):
            sys.stderr.write("\n")
        if verbose and _lead(self.mesh):
            print(f"equal_time: achieved {self.achieved_spp} spp "
                  f"in {time.time() - t0:.2f}s")
        return acc

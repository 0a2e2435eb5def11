"""The candidate and laboratory forms of the split sparse-visit walk K7 and
of the split wide pop K3w, each against the one-thread form of its kernel:
the instrument that chose ops/walk_sparse.py:PRODUCTION_FORMS, the wide
entries of ops/walk_trace.py:PRODUCTION_FORMS and _WIDE_SHARED_MAX.

    python -m rustlight_tpu_torch.tools.perf.split_forms [--runs 10]
        [--kernels sparse wide]

It builds csrc/walk_trace.cu and walk_sparse.cu with RL_LAB_FORMS into a
library beside the production one (ops/native.py), which also holds: K7 at
P = 4 and with the other feed (the ring for the closest hit, the staged
rows for the any hit); K3w's _dot4 form at P = 4 and with the other feed,
and its laboratory forms (csrc/walk_trace.cu: walk_wide_lab_kernel): the
entry pass alone (lab 1), the pops alone (lab 2: as many pops a tile, with
the termination checks' reductions, as the production walk visits, which
is the plain version's count). K7 runs on grid122k
(sphere_grid(122_000, 256, 256), bench.py:132-134) and its two walk
wavefronts (tools/perf/common.py:walk_wavefronts, seed 0); K3w on the
5.7M-triangle sphere grid of chip_smoke.py's grid5p7M
(sphere_grid_mesh(5_000_000, n_theta=18), 18,816 clusters) with 65,536
coherent and divergent rays (common.py), both sorted by the walk. Each form
is held to the one-thread form bit for bit (0 lanes differ) and timed in
turns (one-thread, form, form, one-thread; medians of --runs between CUDA
events; K3w with each heap, in shared and in device memory); the laboratory
forms in turns with the production form (production, entry pass, pops,
production), which splits its time into entry pass, pops and visits. One
line a form with ptxas's registers, static shared memory and spills; the
record goes to build/lab/split_forms_h100.json. chip_smoke.py's phase 13
runs the same functions on the main path's own wavefronts. Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from ...accel.walk import walk_tables_to
from ...ops import native
from ...ops import walk_sparse as ws
from ...ops import walk_trace as wk
from ...ops.walk_trace import ONE_THREAD_FORM
from . import common
from .sub_forms import _differ, _line, _turns

LAB_SOURCES = ("walk_trace.cu", "walk_sparse.cu")
GRID, WIDE_TRIS, WIDE_THETA, WIDE_RAYS = 122_000, 5_000_000, 18, 65_536


def build_lab() -> str:
    """Builds the RL_LAB_FORMS library of LAB_SOURCES; returns its path."""
    return native.build(defines=("RL_LAB_FORMS",), sources=LAB_SOURCES)


def lab_library(path=None):
    """The RL_LAB_FORMS library of LAB_SOURCES (built at `path`, else built
    now), loaded and bound: (lib, ptxas's usage)."""
    path = build_lab() if path is None else path
    lib = wk.bind(ws.bind(ctypes.CDLL(str(path))))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rl_walk_wide_lab.argtypes = [i, i, p, p, i, i, p, p, p, p, i, p, i,
                                     p, i, p, p]
    lib.rl_walk_wide_lab.restype = i
    return lib, native.ptxas_usage(path)


def launch_wide_lab(lib, any_hit: bool, lab: int, wt, o, d, tnear, tfar,
                    visits, heap: str):
    """K3w's laboratory form `lab` (1: the entry pass alone, 2: the pops
    alone, `visits` the int32 visits a tile) in the production form's layout
    and heap: the last popped bits (float32) or whether they are finite."""
    name = "walk_anyhit_wide" if any_hit else "walk_closest_wide"
    form = wk.PRODUCTION_FORMS[name]
    cp, n = int(wt.n_clusters), o.shape[0]
    blocks, glob, smem = wk._wide_heap(name, form, False, cp, n, heap)
    out = torch.empty(n, dtype=torch.bool if any_hit else torch.float32,
                      device=o.device)
    scratch = (torch.empty(blocks * cp, dtype=torch.int32, device=o.device)
               if glob else None)
    with torch.cuda.device(o.device):
        err = lib.rl_walk_wide_lab(
            int(any_hit), lab, wt.lo.data_ptr(), wt.hi.data_ptr(), cp,
            int(wt.n_real), o.data_ptr(), d.data_ptr(), tnear.data_ptr(),
            tfar.data_ptr(), n, visits.data_ptr(), smem,
            None if scratch is None else scratch.data_ptr(), blocks,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} lab {lab} launch failed: CUDA error {err}")
    return out


def _ptxas(usage, sym):
    hits = [v for k, v in usage.items() if sym in k]
    return hits[0] if hits else (-1, -1, -1)


def _rec(usage, sym, **rec):
    regs, static, spill = _ptxas(usage, sym)
    return {**rec, "regs": regs, "static_smem": static, "spill": spill}


def sparse_forms(lib, usage, wt, srt, runs: int, tag: str) -> list:
    """K7's production form, P = 4 and the other feed against the one-thread
    form on the sorted rays `srt`: one record a form, printed."""
    dev = srt[0].device
    out = []
    for kind, launch in (("closest", ws.launch_closest),
                         ("anyhit", ws.launch_anyhit)):
        prod = ws.PRODUCTION_FORMS[f"walk_sparse_{kind}"]

        def run(f, launch=launch):
            return launch(lib, wt, *srt, f, lab=True)

        ref = run(ONE_THREAD_FORM)
        for form in (prod, (4, prod[1]), (prod[0], not prod[1])):
            diff = _differ(run(form), ref)
            torch.cuda.synchronize()
            if diff:
                raise AssertionError(f"{tag} K7 {kind} form {form}: {diff} "
                                     "lanes differ from P1")
            rec = _rec(usage, f"walk_sparse_{kind}_split_kernelILi{form[0]}"
                       f"ELb{int(form[1])}EE", set=tag, kernel="K7",
                       kind=kind, p=form[0], ring=form[1],
                       production=form == prod,
                       **_turns(run, ONE_THREAD_FORM, form, runs, dev),
                       dyn_smem=ws.launch_geometry(
                           f"walk_sparse_{kind}", form, wt.n_clusters,
                           lab=True)[1])
            out.append(rec)
            print(f"{tag} K7 {kind} P{form[0]}{' ring' if form[1] else ''}"
                  f"{' (production)' if form == prod else ''}: P1, form, "
                  "form, P1 " + _line(rec), flush=True)
    return out


def _wide_sym(kind, form):
    return (f"walk_{kind}_wide_split_kernelILi{form[0]}ELb{int(form[1])}ELb0"
            "EE")


def wide_forms(lib, usage, wt, srt, runs: int, tag: str,
               visits=None) -> list:
    """K3w's forms against the one-thread form on the sorted rays `srt`:
    the production form with each heap, P = 4 and the other feed with the
    heaps in device memory; then the production form's time split by its
    laboratory forms, which pop `visits[any_hit]` visits a tile (by default
    the plain version's). One record a form, printed."""
    dev = srt[0].device
    out = []
    for any_hit, kind in ((False, "closest"), (True, "anyhit")):
        prod = wk.PRODUCTION_FORMS[f"walk_{kind}_wide"]

        def run(f, heap, any_hit=any_hit, prod=prod):
            return wk.launch_wide(lib, any_hit, wt, *srt, f, heap=heap,
                                  lab=tuple(f) not in (ONE_THREAD_FORM, prod))

        cands = [(prod, "shared"), (prod, "global"),
                 ((4, prod[1]), "global"), ((prod[0], not prod[1]), "global")]
        for form, heap in cands:
            ref = run(ONE_THREAD_FORM, heap)
            diff = _differ(run(form, heap), ref)
            torch.cuda.synchronize()
            if diff:
                raise AssertionError(f"{tag} K3w {kind} form {form} {heap}: "
                                     f"{diff} lanes differ from P1")
            turns = [common.timed_ms(lambda f=f: run(f, heap), dev, runs)
                     for f in (ONE_THREAD_FORM, form, form, ONE_THREAD_FORM)]
            rec = _rec(usage, _wide_sym(kind, form), set=tag, kernel="K3w",
                       kind=kind, p=form[0], ring=form[1], heap=heap,
                       production=form == prod, turns_ms=turns,
                       ratio=(turns[1] + turns[2]) / (turns[0] + turns[3]),
                       dyn_smem=wk._wide_heap(f"walk_{kind}_wide", form,
                                              False, int(wt.n_clusters),
                                              srt[0].shape[0], heap,
                                              lab=True)[2])
            out.append(rec)
            print(f"{tag} K3w {kind} P{form[0]}{' ring' if form[1] else ''} "
                  f"{heap} heap: P1, form, form, P1 " + _line(rec),
                  flush=True)
        nv = (wk._walk_ref(wt, *srt, any_hit, True)[1] if visits is None
              else visits[any_hit]).to(device=dev, dtype=torch.int32)
        for heap in ("shared", "global"):
            turns = [common.timed_ms(
                (lambda h=heap: run(prod, h)) if not lab else
                (lambda h=heap, lab=lab, a=any_hit: launch_wide_lab(
                    lib, a, lab, wt, *srt, nv, h)), dev, runs)
                for lab in (0, 1, 2, 0)]
            whole = (turns[0] + turns[3]) / 2
            split = {"entry_ms": turns[1], "pops_ms": turns[2] - turns[1],
                     "visits_ms": whole - turns[2]}
            rec = {"set": tag, "kernel": "K3w", "kind": kind, "lab": True,
                   "heap": heap, "turns_ms": turns, "ms": whole, **split,
                   "pops_share": split["pops_ms"] / whole,
                   "visits_mean": float(nv.float().mean()),
                   "visits_max": int(nv.max())}
            out.append(rec)
            print(f"{tag} K3w {kind} {heap} heap, production / entry pass / "
                  "pops / production: " + ", ".join(f"{t:.4f}" for t in turns)
                  + f" ms: entry {split['entry_ms']:.4f}, pops "
                  f"{split['pops_ms']:.4f} ({100 * rec['pops_share']:.1f}%), "
                  f"visits {split['visits_ms']:.4f} ms; visits/tile "
                  f"{rec['visits_mean']:.2f}, max {rec['visits_max']}",
                  flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--kernels", nargs="+", default=["sparse", "wide"],
                   choices=("sparse", "wide"))
    p.add_argument("--out", default=str(common.OUT_DIR
                                        / "split_forms_h100.json"))
    args = p.parse_args(argv)
    dev = common.pick_device("cuda")
    lib, usage = lab_library()
    out = {**common.device_record(dev), "runs": args.runs, "forms": []}
    if "sparse" in args.kernels:
        from ...accel.walk import _prepare
        from ...models import sphere_grid
        sd = sphere_grid(GRID, 256, 256).compile(device=dev)
        wt = sd.geom.walk
        for wname, rays in common.walk_wavefronts(
                sd, np.random.default_rng(0)).items():
            srt = _prepare(wt, *rays)[:4]
            out["forms"] += sparse_forms(lib, usage, wt, srt, args.runs,
                                         f"grid122k/{wname}")
        del sd, wt
    if "wide" in args.kernels:
        geom, ext = common.lab_scene(WIDE_TRIS, WIDE_THETA)
        wt = walk_tables_to(geom.walk, dev)
        rng = np.random.default_rng(0)
        for wname, make in (("coherent", common.coherent_rays),
                            ("divergent", common.divergent_rays)):
            o, d = common.to_device(dev, *make(rng, WIDE_RAYS, ext))
            srt = common.sorted_tiles(wt, o, d)
            out["forms"] += wide_forms(lib, usage, wt, srt, args.runs,
                                       f"grid5p7M/{wname}")
    common.write_record(args.out, out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])

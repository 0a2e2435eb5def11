"""Every candidate form of the sub-tiled walk K6 against its one-thread
form: the instrument that chose ops/walk_sub.py:PRODUCTION_FORMS and
MMA_FORMS; and the split tensor-core visit of K3/K4 at P = 2, 4 and 8.

    python -m rustlight_tpu_torch.tools.perf.sub_forms [--subs 2 4 8]
        [--tests dot4 mma] [--waves spread camera] [--runs 10] [--k3]

It builds the kernels with RL_LAB_FORMS (ops/native.py: a library beside
the production one holding every form: P = 2, 4, 8 threads a ray, the rows
staged or read through L1, both tests; the split tensor-core visit where a
warp lies in one group), on grid122k (sphere_grid(122_000, 256, 256),
bench.py:132-134) and the walk wavefronts chip_smoke.py's phase 13 hands
K6 (tools/perf/common.py:walk_wavefronts, seed 0), sorted by the walk. Each
form is held to the one-thread form of its test bit for bit (0 lanes
differ) and timed in turns: one-thread, form, form, one-thread, medians of
--runs between CUDA events. One line a form, with ptxas's registers, static
shared memory and spills; the record goes to build/lab/sub_forms_h100.json.
With --k3, K3/K4's split tensor-core visit (the production feed: staged
for the closest hit, the ring for the any hit) at P = 2, 4 and 8 threads a
ray (RL_LAB_FORMS builds P = 2 and 4 beside the production P), and the
closest hit's with the ring, the same way against the one-thread
tensor-core kernel. Needs a card: the forms exist
only as CUDA kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from ...accel.walk import _prepare
from ...models import sphere_grid
from ...ops import native
from ...ops import walk_sub as wsub
from ...ops import walk_trace as wk
from ...ops.walk_trace import ONE_THREAD_FORM
from . import common

GRID = 122_000


def _symbol(kind: str, sub: int, form, mxu: bool) -> str:
    """The mangled-name fragment of K6's kernel `kind` in `form`."""
    p, stage = form
    return (f"walk_sub_{kind}_kernelILi{sub}ELi{p}ELb{int(stage)}"
            f"ELb{int(mxu)}EE")


def _differ(a, b) -> int:
    """Lanes on which two outputs (tuples of [n] tensors, or one) differ in
    any bit."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    bad = torch.zeros(a[0].shape[0], dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        bad |= x != y
    return int(bad.sum())


def _k3_launch(lib, kind: str, wt, srt, form):
    """K3/K4 with the tensor-core test in `form` through the lab library's
    entry points, as ops/walk_trace.py's wrappers launch them."""
    o, d, tnear, tfar = srt
    n, cp = o.shape[0], int(wt.n_clusters)
    p, ring = form
    smem = 4 * cp + (0 if form == ONE_THREAD_FORM else (
        (2 if ring else 1) * wk.slot_bytes() + wk.mma_scratch_bytes(p)))
    head = (wt.lo.data_ptr(), wt.hi.data_ptr(), cp, int(wt.n_real),
            wt.rows.data_ptr())
    rays = (o.data_ptr(), d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(), n,
            1, p, int(ring), smem)
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "closest":
        out = (torch.empty(n, device=o.device),
               torch.empty(n, dtype=torch.int32, device=o.device),
               torch.empty(n, device=o.device), torch.empty(n, device=o.device))
        err = lib.rl_walk_closest(*head, wt.ids.data_ptr(), *rays,
                                  *(x.data_ptr() for x in out), stream)
    else:
        out = torch.empty(n, dtype=torch.bool, device=o.device)
        err = lib.rl_walk_anyhit(*head, *rays, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"K3 {kind} in form {form}: CUDA error {err}")
    return out


def _line(rec) -> str:
    return (", ".join(f"{t:.4f}" for t in rec["turns_ms"])
            + f" ms, ratio {rec['ratio']:.3f}; {rec['regs']} regs, "
            f"{rec['static_smem']} + {rec['dyn_smem']} B smem, "
            f"{rec['spill']} B spilled")


def _turns(run, one, form, runs, dev) -> dict:
    turns = [common.timed_ms(lambda f=f: run(f), dev, runs)
             for f in (one, form, form, one)]
    return {"turns_ms": turns,
            "ratio": (turns[1] + turns[2]) / (turns[0] + turns[3])}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--subs", type=int, nargs="+", default=list(wsub.SUBS))
    p.add_argument("--tests", nargs="+", default=["dot4", "mma"],
                   choices=("dot4", "mma"),
                   help="the triangle tests: _dot4, tensor-core")
    p.add_argument("--waves", nargs="+", default=["spread"],
                   choices=("spread", "camera"))
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--k3", action="store_true",
                   help="also K3/K4's split tensor-core visit at P = 2, 4, 8")
    p.add_argument("--out", default=str(common.OUT_DIR
                                        / "sub_forms_h100.json"))
    args = p.parse_args(argv)
    dev = common.pick_device("cuda")
    path = native.build(defines=("RL_LAB_FORMS",))
    lib = wk.bind(wsub.bind(ctypes.CDLL(str(path))))
    usage = native.ptxas_usage(path)
    sd = sphere_grid(GRID, 256, 256).compile(device=dev)
    wt = sd.geom.walk
    waves = common.walk_wavefronts(sd, np.random.default_rng(0))
    out = {**common.device_record(dev), "table": f"grid122k, Cp "
           f"{wt.n_clusters}", "runs": args.runs, "forms": []}
    one = ONE_THREAD_FORM
    for wname in args.waves:
        srt = _prepare(wt, *waves[wname])[:4]
        for sub in args.subs:
            for mxu in [t == "mma" for t in args.tests]:
                for kind, launch in (("closest", wsub.launch_closest),
                                     ("anyhit", wsub.launch_anyhit)):
                    run = lambda f: launch(lib, wt, *srt, sub, mxu, f)
                    ref = run(one)
                    for form in [(q, st) for q in wsub.SPLIT_PS
                                 for st in (False, True)]:
                        try:
                            smem = wsub.launch_geometry(sub, form,
                                                        wt.n_clusters, mxu)[1]
                        except ValueError:
                            continue
                        diff = _differ(run(form), ref)
                        torch.cuda.synchronize()
                        if diff:
                            raise AssertionError(
                                f"{wname} sub {sub} {kind} mxu={mxu} form "
                                f"{form}: {diff} lanes differ from P1")
                        hits = [v for k, v in usage.items()
                                if _symbol(kind, sub, form, mxu) in k]
                        regs, static, spill = hits[0] if hits else (-1,) * 3
                        rec = {"wave": wname, "sub": sub, "mxu": mxu,
                               "kind": kind, "p": form[0], "stage": form[1],
                               **_turns(run, one, form, args.runs, dev),
                               "regs": regs, "static_smem": static,
                               "dyn_smem": smem, "spill": spill}
                        out["forms"].append(rec)
                        print(f"{wname} sub{sub} {kind}{' mma' if mxu else ''}"
                              f" P{form[0]}{' stage' if form[1] else ' L1'}: "
                              "P1, form, form, P1 " + _line(rec), flush=True)
        for kind in ("closest", "anyhit") if args.k3 else ():
            run = lambda f: _k3_launch(lib, kind, wt, srt, f)
            ref = run(one)
            prod = wk.PRODUCTION_FORMS[f"walk_{kind}"]
            for q, ring in [(q, prod[1]) for q in wsub.SPLIT_PS] + (
                    [(prod[0], not prod[1])] if kind == "closest" else []):
                form = (q, ring)
                diff = _differ(run(form), ref)
                torch.cuda.synchronize()
                if diff:
                    raise AssertionError(f"{wname} K3 {kind} mma form {form}: "
                                         f"{diff} lanes differ from P1")
                sym = (f"walk_closest_split_kernelILb0ELi{q}ELb{int(ring)}ELb1EE"
                       if kind == "closest" else
                       f"walk_anyhit_split_kernelILi{q}ELb{int(ring)}ELb1EE")
                hits = [v for k, v in usage.items() if sym in k]
                regs, static, spill = hits[0] if hits else (-1,) * 3
                rec = {"wave": wname, "kernel": "K3", "mxu": True, "kind": kind,
                       "p": q, "ring": ring,
                       **_turns(run, one, form, args.runs, dev), "regs": regs,
                       "static_smem": static, "spill": spill,
                       "dyn_smem": 4 * int(wt.n_clusters)
                       + (2 if ring else 1) * wk.slot_bytes()
                       + wk.mma_scratch_bytes(q)}
                out["forms"].append(rec)
                print(f"{wname} K3 {kind} mma P{q}{' ring' if ring else ''}: "
                      "P1, form, form, P1 " + _line(rec), flush=True)
    common.write_record(args.out, out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])

"""Batch experiment runner (reference run.py + run_plane_exp.sh); the
port's counterpart of tools/run_experiments.py.

Sweeps integrator configurations over a scene under an spp or equal-time
budget, recording wall clock, achieved spp and metrics against a reference
render into a CSV (technique, spp, time_s, l1, mape, rmse).

  python -m rustlight_tpu_torch.tools.run_experiments --scene cbox \\
      --time 10 -t path pssmlt light vpl
  python -m rustlight_tpu_torch.tools.run_experiments --scene cbox \\
      --medium 0.004 -t point-normal:tr point-normal:ex \\
      point-normal:warp_T_bezier plane-single:average plane-single:cmis

Files go under --out (build/experiments_torch/ by default): the
reference <scene>_ref.exr (rendered once, 128 spp path), one EXR a
technique and results.csv, merge-updated by technique.
"""
from __future__ import annotations

import argparse
import csv
import sys
import time
from pathlib import Path

FIELDS = ["technique", "spp", "time_s", "l1", "mape", "rmse"]
OUT_DIR = Path("build") / "experiments_torch"


def make_integrator(spec: str):
    from .. import integrators as I
    from ..integrators.gradient import IntegratorGradientPath
    from ..integrators.mcmc import (IntegratorERPT, IntegratorPSSMLT,
                                    IntegratorSMCMC)

    name, _, opt = spec.partition(":")

    def path():
        return I.IntegratorPathTracing(max_depth=8, hard_cap=8)
    if name == "path":
        return path()
    if name == "ao":
        return I.IntegratorAO()
    if name == "direct":
        return I.IntegratorDirect()
    if name == "light":
        return I.IntegratorLightTracing(max_depth=8, hard_cap=8)
    if name == "vpl":
        return I.IntegratorVPL(nb_vpl=int(opt or 256), max_depth=6, hard_cap=6)
    if name == "pssmlt":
        return IntegratorPSSMLT(path(), nb_samples_norm=16384, nb_chains=65536)
    if name == "erpt":
        return IntegratorERPT(path(), chain_samples=64, nb_samples_norm=16384)
    if name == "smcmc":
        return IntegratorSMCMC(path(), recons=opt or "naive")
    if name == "gradient-path":
        return IntegratorGradientPath(max_depth=6, hard_cap=6,
                                      recons=opt or "uniform")
    if name == "point-normal":
        strat = {"tr": ("tr",), "ex": ("equiangular",),
                 "ex_clamp": ("eq_clamp",), "tr_ex": ("tr", "equiangular")}
        if opt.startswith("warp"):
            _, chars, kind = (opt.split("_") + ["linear"])[:3]
            return I.IntegratorPointNormal(strategies=("warp",), warps=chars,
                                           warps_strategy=kind)
        return I.IntegratorPointNormal(
            strategies=strat.get(opt, ("tr", "equiangular")))
    if name == "plane-single":
        return I.IntegratorSinglePlane(nb_primitive=512,
                                       strategy=opt or "average")
    if name == "vol-primitives":
        return I.IntegratorVolPrimitives(nb_primitive=2048,
                                         primitives=opt or "bre", radius=5.0)
    raise SystemExit(f"unknown technique {spec}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cbox")
    ap.add_argument("--res", type=float, default=0.25)
    ap.add_argument("--medium", type=float, default=0.0)
    ap.add_argument("-t", "--techniques", nargs="+", required=True)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--time", type=float, default=None,
                    help="equal-time budget in seconds instead of --spp")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--ref-spp", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda, cuda:1, cpu)")
    args = ap.parse_args(argv)

    from ..cli import build_parser, load_scene_arg
    from ..integrators.meta import IntegratorEqualTime, _render_once
    from ..utils import image as rimage
    from ..utils.metrics import metric_scalar
    from .device import pick_device

    dev = pick_device(args.device)
    cli = build_parser().parse_args(
        [args.scene, "-s", str(args.res), "-m", str(args.medium), "path"])
    sd = load_scene_arg(cli).compile(device=dev)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ref_path = out / f"{Path(args.scene).stem}_ref.exr"
    if not ref_path.exists():
        print(f"rendering reference ({args.ref_spp} spp)...")
        film = _render_once(sd, make_integrator("path"), args.ref_spp,
                            seed=999)
        rimage.save(str(ref_path), film["primal"])
    ref = rimage.load(str(ref_path))

    rows = []
    for spec in args.techniques:
        integ = make_integrator(spec)
        t0 = time.time()
        if args.time is not None:
            meta = IntegratorEqualTime(integ, target_s=args.time,
                                       spp_per_pass=4)
            film = meta.render(sd)
            spp = meta.achieved_spp
        else:
            film = _render_once(sd, integ, args.spp, seed=0)
            spp = args.spp
        dt = time.time() - t0
        img = film["primal"]
        rimage.save(str(out / f"{spec.replace(':', '_')}.exr"), img)
        row = dict(technique=spec, spp=spp, time_s=round(dt, 3),
                   l1=metric_scalar(ref, img, "l1"),
                   mape=metric_scalar(ref, img, "mape"),
                   rmse=metric_scalar(ref, img, "rmse"))
        rows.append(row)
        print(row, flush=True)

    # merge-update by technique: a single-technique rerun keeps the other
    # rows
    csv_path = out / "results.csv"
    old_rows = {}
    if csv_path.exists():
        with open(csv_path, newline="") as f:
            for r in csv.DictReader(f):
                old_rows[r["technique"]] = r
    for r in rows:
        old_rows[r["technique"]] = r
    with open(csv_path, "w", newline="") as f:
        wcsv = csv.DictWriter(f, fieldnames=FIELDS)
        wcsv.writeheader()
        wcsv.writerows(old_rows.values())
    print(f"wrote {csv_path} ({len(old_rows)} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

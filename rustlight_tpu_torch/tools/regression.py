"""Image-regression harness (reference tests/launch.py); the port's
counterpart of tools/regression.py, with the same rows, integrators, gate
and HTML table.

Renders named scene x technique combinations, compares them against
reference images with l1/l2/mape/dssim, and writes an HTML comparison
table.

  python -m rustlight_tpu_torch.tools.regression --spp 32       # run + compare
  python -m rustlight_tpu_torch.tools.regression --make-refs    # (re)build refs
  python -m rustlight_tpu_torch.tools.regression -s cbox_path -t path pssmlt
  python -m rustlight_tpu_torch.tools.regression --make-floors  # ref-vs-ref floors
  python -m rustlight_tpu_torch.tools.regression --check        # GATE: exit 1 on drift

The gate: --check re-renders each row and fails if any metric exceeds
  limit = stored * 1.3 + 1.5 * floor
where `floor` is the scene's ref-vs-ref noise floor (floors.json; a gated
row with no measured floor fails loudly).

Files. Everything the harness writes goes under --out (build/regress_torch/
by default): the renders (gate renders under check/), refs/ made here,
results.json, floors.json and index.html. The repository's committed
matrix (regress/: refs/<row>.exr, results.json, floors.json, made by the
JAX package's harness on the CPU) is read-only: each of those files is
read from --out where this harness made it, else from --stored
(regress/ by default). So `--check` with an empty --out holds the port,
on --device (the card by default), to the committed matrix.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

METRICS = ["l1", "l2", "mape", "dssim"]
GI_ALGO = ["path", "light", "pssmlt", "vpl", "erpt", "smcmc",
           "gradient-path"]
GATE_STORED, GATE_FLOOR = 1.3, 1.5
# the JAX package's committed matrix, beside this package
STORED_DIR = Path(__file__).resolve().parents[2] / "regress"
OUT_DIR = Path("build") / "regress_torch"


def build_tests():
    from ..models import cornell_box
    from ..scene import make_volume

    def cbox():
        return cornell_box(128, 128)

    def cbox_medium():
        sc = cornell_box(128, 128)
        sc.volume = make_volume(sigma_s=(0.0025,) * 3)
        return sc

    def veach():
        from ..models import veach_mis
        return veach_mis(128, 96)

    return {
        "cbox_ao": dict(scene=cbox, techniques=["ao"]),
        "cbox_direct": dict(scene=cbox, techniques=["direct"],
                            ref_tech="direct"),
        "cbox_path": dict(scene=cbox,
                          techniques=GI_ALGO + ["gradient-path-explicit"]),
        # volumetric: forward path vs adjoint light tracing in the medium
        "cbox_medium": dict(scene=cbox_medium, techniques=["path", "light"]),
        # veach's l2 floor is dominated by ~50 near-delta pixels; a
        # 4096-spp reference puts the row inside an ordinary floor
        "veach_mis": dict(scene=veach, techniques=["path"], ref_spp=4096),
        # single-scatter estimators compare against a single-scatter ref
        "cbox_medium_single": dict(scene=cbox_medium,
                                   techniques=["point-normal", "path-single",
                                               "plane-single",
                                               "plane-single-unc"],
                                   ref_tech="path-single"),
        # photon-primitive family (BRE/beams/planes/VRL): biased density
        # estimators, gated on their own stored rows against the
        # multiple-scattering path ref
        "cbox_medium_prims": dict(scene=cbox_medium,
                                  techniques=["bre", "beams", "planes",
                                              "vrl"],
                                  ref_tech="path", spp=8),
    }


def make_integrator(name):
    from .. import integrators as I
    from ..integrators.mcmc import (IntegratorERPT, IntegratorPSSMLT,
                                    IntegratorSMCMC)

    if name == "ao":
        return I.IntegratorAO()
    if name == "path":
        return I.IntegratorPathTracing(max_depth=8, hard_cap=8)
    if name == "light":
        return I.IntegratorLightTracing(max_depth=8, hard_cap=8)
    if name == "vpl":
        return I.IntegratorVPL(nb_vpl=256, max_depth=6, hard_cap=6)
    if name == "pssmlt":
        return IntegratorPSSMLT(
            I.IntegratorPathTracing(max_depth=8, hard_cap=8),
            nb_samples_norm=16384, nb_chains=65536)
    if name == "erpt":
        return IntegratorERPT(
            I.IntegratorPathTracing(max_depth=6, hard_cap=6),
            nb_mc=2, chain_samples=16, nb_samples_norm=16384)
    if name == "smcmc":
        return IntegratorSMCMC(
            I.IntegratorPathTracing(max_depth=6, hard_cap=6), recons="naive")
    if name == "direct":
        return I.IntegratorDirect(nb_light_samples=1, nb_bsdf_samples=1)
    if name == "gradient-path":
        from ..integrators.gradient import IntegratorGradientPathReconnect
        return IntegratorGradientPathReconnect(max_depth=6)
    if name == "gradient-path-explicit":
        from ..integrators.gradient import IntegratorGradientPath
        return IntegratorGradientPath(max_depth=6)
    if name == "point-normal":
        return I.IntegratorPointNormal(strategies=("tr", "equiangular"))
    if name == "path-single":
        return I.IntegratorPathTracing(max_depth=2, hard_cap=2, min_depth=1,
                                       single_scattering=True)
    if name == "plane-single":
        return I.IntegratorSinglePlane(nb_primitive=256, strategy="average")
    if name == "plane-single-unc":
        return I.IntegratorSinglePlane(nb_primitive=256, strategy="average",
                                       uncorrelated=True)
    if name in ("bre", "beams", "planes", "vrl"):
        return I.IntegratorVolPrimitives(nb_primitive=1024, max_depth=6,
                                         hard_cap=6, primitives=name,
                                         radius=8.0)
    raise ValueError(name)


def render_one(scene_data, name, spp, seed=0):
    from ..integrators.meta import _render_once
    return _render_once(scene_data, make_integrator(name), spp, seed)


def _find(out: Path, stored: Path, rel: str):
    """`rel` under --out where this harness wrote it, else under --stored;
    None where neither has it."""
    for d in (out, stored):
        if (d / rel).exists():
            return d / rel
    return None


def _read_json(path) -> dict:
    return json.loads(Path(path).read_text()) if path is not None else {}


def gate(results: dict, stored: dict, floors: dict) -> list:
    """The breaches of `results` against the stored rows: every metric
    over stored * GATE_STORED + GATE_FLOOR * floor, and every row whose
    scene has no floor. A result with no stored row is reported and
    skipped."""
    breaches = []
    for key, row in results.items():
        srow = stored.get(key)
        if srow is None:
            print(f"[check] {key}: no stored row (skipped)")
            continue
        scene_name = key.split("/")[0]
        fl = floors.get(scene_name)
        if fl is None:
            breaches.append(f"{key}: no noise floor for scene "
                            f"'{scene_name}' — run --make-floors")
            continue
        for m in METRICS:
            limit = srow[m] * GATE_STORED + GATE_FLOOR * fl.get(m, 0.0)
            if not row[m] <= limit:
                breaches.append(
                    f"{key} {m}: {row[m]:.6g} > limit {limit:.6g} "
                    f"(stored {srow[m]:.6g}, floor {fl.get(m, 0.0):.6g})")
    return breaches


def _html(out: Path, merged: dict) -> None:
    rows = "".join(
        f"<tr><td>{k}</td>" + "".join(
            f"<td>{v[m]:.5g}</td>" for m in METRICS + ["time_s"]) + "</tr>"
        for k, v in sorted(merged.items()))
    (out / "index.html").write_text(
        "<html><body><h1>rustlight_tpu_torch regression</h1>"
        "<table border=1><tr><th>test</th>"
        + "".join(f"<th>{m}</th>" for m in METRICS + ["time_s"])
        + f"</tr>{rows}</table></body></html>")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--stored", default=str(STORED_DIR),
                    help="the committed matrix, read-only (refs/, "
                    "results.json, floors.json)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda, cuda:1, cpu)")
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--ref-spp", type=int, default=256)
    ap.add_argument("--make-refs", action="store_true")
    ap.add_argument("--make-floors", action="store_true",
                    help="render a second independent reference per scene "
                         "and store ref-vs-ref metrics as noise floors")
    ap.add_argument("--check", action="store_true",
                    help="gate: exit 1 if any recomputed metric exceeds "
                         "stored * 1.3 + 1.5 * floor")
    ap.add_argument("-t", "--techniques", nargs="+")
    ap.add_argument("-s", "--scenes", nargs="+")
    args = ap.parse_args(argv)

    from ..utils import image as rimage
    from ..utils.metrics import metric_scalar
    from .device import pick_device

    dev = pick_device(args.device)
    out, stored = Path(args.out), Path(args.stored)
    if out.resolve() == stored.resolve():
        raise SystemExit(f"--out {out} is the committed matrix, which this "
                         "harness only reads; write elsewhere")
    out.mkdir(parents=True, exist_ok=True)

    tests = build_tests()
    results = {}
    floors_path = _find(out, stored, "floors.json")
    floors = _read_json(floors_path)
    for tname, spec in tests.items():
        if args.scenes and tname not in args.scenes:
            continue
        scene_data = spec["scene"]().compile(device=dev)
        ref_spp = spec.get("ref_spp", args.ref_spp)
        ref_path = _find(out, stored, f"refs/{tname}.exr")
        ref_tech = spec.get("ref_tech",
                            "ao" if spec["techniques"] == ["ao"] else "path")
        if args.make_refs or ref_path is None:
            print(f"[{tname}] rendering reference ({ref_spp} spp "
                  f"{ref_tech})...")
            film = render_one(scene_data, ref_tech, ref_spp, seed=777)
            ref_path = out / "refs" / f"{tname}.exr"
            ref_path.parent.mkdir(parents=True, exist_ok=True)
            rimage.save(str(ref_path), film["primal"])
        ref = rimage.load(str(ref_path))
        if args.make_floors:
            # an INDEPENDENT equal-spp reference: its metrics against the
            # stored one are the pure-MC noise floor for this scene/ref_spp
            print(f"[{tname}] rendering second reference (noise floor)...")
            film2 = render_one(scene_data, ref_tech, ref_spp, seed=778)
            floors[tname] = {m: metric_scalar(ref, film2["primal"], m)
                             for m in METRICS}
            print(f"[{tname}] floor: {floors[tname]}")
            (out / "floors.json").write_text(json.dumps(floors, indent=2))
            continue

        for tech in spec["techniques"]:
            if args.techniques and tech not in args.techniques:
                continue
            t0 = time.time()
            film = render_one(scene_data, tech, spec.get("spp", args.spp))
            dt = time.time() - t0
            img_dir = out / "check" if args.check else out
            img_dir.mkdir(parents=True, exist_ok=True)
            rimage.save(str(img_dir / f"{tname}_{tech}.exr"), film["primal"])
            row = {m: metric_scalar(ref, film["primal"], m) for m in METRICS}
            row["time_s"] = round(dt, 2)
            row["backend"] = dev.type
            results[f"{tname}/{tech}"] = row
            print(f"[{tname}/{tech}] {row} (reference {ref_path})",
                  flush=True)

    res_path = _find(out, stored, "results.json")
    if args.check:
        # GATE mode: compare fresh rows against the stored matrix; do NOT
        # update it
        print(f"[check] stored rows {res_path}, floors {floors_path}")
        breaches = gate(results, _read_json(res_path), floors)
        if breaches:
            print("REGRESSION GATE FAILED:")
            for b in breaches:
                print("  " + b)
            return 1
        print(f"regression gate OK ({len(results)} rows checked)")
        return 0
    if args.make_floors:
        print(f"floors written: {out / 'floors.json'}")
        return 0

    # merge-update: a partial run (one scene/technique) keeps the other
    # rows of the matrix it started from
    merged = _read_json(res_path)
    merged.update(results)
    (out / "results.json").write_text(json.dumps(merged, indent=2))
    _html(out, merged)
    print(f"report: {out / 'index.html'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

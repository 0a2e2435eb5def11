"""Smoke-render every scene under examples/ (reference tests/run_pbrt.sh:
render each pbrt-v3 scene and fail loudly on crashes/black frames); the
port's counterpart of tools/smoke_scenes.py.

  python -m rustlight_tpu_torch.tools.smoke_scenes [--spp 16] [--size 128]
      [--out DIR] [--device cuda|cpu]

Each scene renders with the path integrator (max_depth 6) at size x size;
the check is crash-freedom plus a finite, non-black film. Each line names
the scene's tier (dense or walk) and the kernels its render launched.
Exit 1 when any scene fails.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

EXAMPLES = Path(__file__).resolve().parents[2] / "examples"
SUFFIXES = (".pbrt", ".xml", ".obj")


def _kernel_modules():
    from ..ops import (dense_trace, pair_trace, walk_hier, walk_lab,
                       walk_sparse, walk_sub, walk_trace)
    return (dense_trace, walk_trace, walk_hier, walk_sub, walk_sparse,
            pair_trace, walk_lab)


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel name (the CPU's plain
    versions count none)."""
    return {k: v for m in _kernel_modules() for k, v in m.LAUNCHES.items()}


def reset_launches() -> None:
    for m in _kernel_modules():
        m.reset_launches()


def smoke_one(path: Path, size: int, spp: int, device, out=None) -> dict:
    """Render one scene file; its record: name, tier, ok, status, seconds,
    mean, kernels launched (counts reset just before the render)."""
    import torch
    from ..integrators import IntegratorPathTracing, render
    from ..scene import resize_camera
    from ..scene.loaders import load_scene
    from ..utils.image import write_pfm
    t0 = time.time()
    rec = {"name": path.name, "tier": None, "ok": False, "mean": None,
           "launches": {}}
    try:
        host = load_scene(str(path))
        # resize_camera re-derives the projection for the new aspect
        host.camera = resize_camera(host.camera, size, size)
        sd = host.compile(device=device)
        rec["tier"] = "walk" if sd.geom.walk is not None else "dense"
        reset_launches()
        film = render(sd, IntegratorPathTracing(max_depth=6), spp=spp,
                      seed=0)
        if sd.device.type == "cuda":
            torch.cuda.synchronize(sd.device)
        rec["launches"] = {k: v for k, v in kernel_launches().items() if v}
        img = np.asarray(film["primal"])
        rec["mean"] = float(img.mean())
        rec["ok"] = bool(np.isfinite(img).all()) and float(img.max()) > 0.0
        rec["status"] = "ok" if rec["ok"] else "BAD FILM"
        if out:
            Path(out).mkdir(parents=True, exist_ok=True)
            write_pfm(Path(out) / (path.stem + ".pfm"), img)
    except Exception as e:  # noqa: BLE001 — a smoke harness reports all
        rec["status"] = f"FAIL: {type(e).__name__}: {e}"
    rec["seconds"] = time.time() - t0
    return rec


def smoke(paths, size: int, spp: int, device, out=None, log=print) -> list:
    """smoke_one over `paths`, a line each through `log`."""
    recs = []
    for p in paths:
        rec = smoke_one(Path(p), size, spp, device, out)
        log(f"{rec['name']:24s} {rec['status']}  ({rec['seconds']:.1f}s; "
            f"{rec['tier']}, mean {rec['mean']}, launches {rec['launches']})")
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--out", default=None,
                    help="optional directory for the rendered PFMs")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda, cuda:1, cpu)")
    args = ap.parse_args(argv)
    from .device import pick_device
    dev = pick_device(args.device)

    scenes = sorted(p for p in EXAMPLES.iterdir() if p.suffix in SUFFIXES)
    if not scenes:
        print(f"no scenes found under {EXAMPLES}", file=sys.stderr)
        return 1
    recs = smoke(scenes, args.size, args.spp, dev, args.out,
                 log=lambda s: print(s, flush=True))
    failures = [r["name"] for r in recs if not r["ok"]]
    if failures:
        print(f"{len(failures)} scene(s) failed: {failures}",
              file=sys.stderr)
        return 1
    print(f"all {len(scenes)} scenes smoke-rendered clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())

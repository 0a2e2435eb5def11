"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell (BENCHMARK.json's `workloads`) names a configuration
(portbench/configs/<config>.json) and a traffic mix
(portbench/traffic/<traffic>.json). The run builds the scene from the
configuration's arrays, compiles it on the card, warms up with one pass of
the mix, then renders passes back to back for `--seconds` (portbench/
window.py). With `--trace 0` the line's metrics are the cell's end-to-end
ones; with `--trace 1` a stretch of whole passes inside the window is
traced and the line's metrics are the cell's per-layer ones
(portbench/metrics/<name>.py). Once the window has closed, the films are
held to the plain reference (portbench/check.py); the numbers compared are
the last lines on standard error and the line's last key. Exits non-zero,
with no result, without a CUDA card for the cell, or if the process has
loaded jax, jaxlib, flax or rustlight_tpu.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "rustlight_tpu")


def _pin_caches() -> None:
    """Every build or kernel cache at a fixed path inside the checkout (the
    renderer's own kernels build into build/kernels/ beside it)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, section: str, workload: str) -> list:
    """The section's metrics that cell `workload` reports."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, log=print) -> dict:
    """One run of `cell` on `device`: the result line as a dict."""
    import numpy as np
    import torch

    from . import check, port, window
    from .metrics import load as load_reader
    from .scene import build_arrays, load_config

    cfg = load_config(cell["config"])
    traffic = window.load_traffic(cell["traffic"])
    limits = check.load_limits(cell["name"])
    w, h = traffic["width"], traffic["height"]
    lanes = w * h
    spp = traffic["spp_per_pass"]
    arrays = build_arrays(cfg)
    sd = port.compile_scene(arrays, w, h, device)
    integ = port.make_integrator(traffic["integrator"],
                                 cfg["integrators"][traffic["integrator"]])

    def render(s):
        return port.render_pass(sd, integ, spp, s, traffic["route"])
    render(window.pass_seed(seed, -1))          # warm-up: the mix's shapes
    pixels = check.check_pixels(seed, lanes, traffic["check"]["pixels"])
    stretch = None
    if trace:
        from .trace import Stretch
        stretch = Stretch(device, arrays.n_triangles, spp,
                          traffic["trace_min_s"])
    win = window.run(render, seed, seconds, pixels, stretch,
                     traffic.get("least_passes", 1))
    setup_s = win.t0 - t_start
    cuda = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    frames = win.frame_ms()
    log(f"portbench: {cell['name']} seed {seed}: {win.passes} passes of "
        f"{spp} spp at {w}x{h}; pass ms median "
        f"{float(np.median(frames))!r}, p95 "
        f"{float(np.percentile(frames, 95))!r} over {len(frames)}; setup "
        f"{setup_s!r} s")
    values = {"msamples_s": window.msamples_s(win, spp, lanes),
              "frame_ms_p95": float(np.percentile(frames, 95)),
              "setup_s": setup_s}
    out = {"device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(device) if cuda
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": peak}}
    if trace:
        ctx = stretch.context()
        log(f"portbench: traced stretch of {ctx['passes']} passes, "
            f"{ctx['wall_s']!r} s, {len(ctx['kernels'])} kernels, "
            f"{ctx['rays']} rays")
        metrics = {}
        for m in cell_metrics(bench, "per_layer", cell["name"]):
            v = load_reader(m["name"])(ctx)
            if v is None:
                raise RuntimeError(f"per-layer metric {m['name']} found "
                                   "nothing to read in the traced stretch")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["device"].update(busy_s=ctx["busy_s"], window_s=ctx["wall_s"])
        from .trace import breakdown
        out["breakdown"] = breakdown(ctx)
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, "end_to_end", cell["name"])}
    del sd, integ, stretch
    if cuda:
        torch.cuda.empty_cache()

    picked = check.check_passes(seed, win.passes, traffic["check"]["passes"])
    ref = check.reference_values(arrays, cfg, traffic,
                                 [win.seeds[k] for k in picked], pixels,
                                 device)
    got = np.stack([win.values[k] for k in picked])
    failed = sum(int(not (np.all(np.isfinite(v)) and np.all(v >= 0)))
                 for v in win.values)
    numbers = {
        "off_share": check.off_share(got, ref, limits["rtol"],
                                     limits["atol"]),
        "film_bad": int(np.sum(~np.isfinite(win.avg)) + np.sum(win.avg < 0)),
    }
    checks = check.judge(numbers, limits)
    log(f"portbench: compared {got.shape[0]} passes x {got.shape[1]} "
        f"pixels with the reference (rtol {limits['rtol']}, atol "
        f"{limits['atol']})")
    return {"correct": check.passed(checks), "attempted": win.passes,
            "failed": failed, "metrics": metrics, **out, "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _pin_caches()
    bench = load_benchmark()
    cell = find_cell(bench, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              "card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                   device, T_START,
                   log=lambda s: print(s, file=sys.stderr, flush=True))
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"portbench: card {card_line()}", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

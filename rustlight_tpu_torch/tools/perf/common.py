"""What the laboratory's tools share: the device, the scenes and their
ray sets, the timing and the record they write."""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ...accel.walk import _default_range, _prepare
from ...models.presets import sphere_grid_mesh
from ...ops.walk_lab import walk_closest_counted
from ...ops.walk_trace import RAY_TILE
from ...scene.geometry import build_geometry_tables
from ..device import pick_device  # noqa: F401 (the tools' import)

TIMING_RUNS = 5
# records go under build/, which git ignores; never over regress/*.json, the
# JAX package's records of another machine
OUT_DIR = Path("build") / "lab"


def parser(doc: str, out_name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu (plain versions, no "
                        "device times)")
    p.add_argument("--rays", type=int, default=262_144)
    p.add_argument("--tris", type=int, default=110_000,
                   help="target triangle count of the sphere grid")
    p.add_argument("--theta", type=int, default=18,
                   help="n_theta = n_phi of each UV sphere")
    p.add_argument("--runs", type=int, default=TIMING_RUNS,
                   help="timed runs per number; the median is reported")
    p.add_argument("--mxu", action="store_true",
                   help="the tensor-core form of the triangle test")
    p.add_argument("--out", default=str(OUT_DIR / out_name))
    return p


def device_record(dev: torch.device) -> dict:
    """The device's name, and on a card its nvidia-smi name and power
    limit: every time in a record stands beside them."""
    if dev.type != "cuda":
        return {"device": "cpu", "card": None,
                "note": "CPU run: times are host times of the plain "
                        "versions, not device metrics"}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(dev), "card": card}


def lab_scene(tris: int, theta: int):
    """The laboratory's scene: (numpy geometry tables, grid extent). At the
    defaults sphere_grid_mesh(110_000, n_theta=18): 216 spheres, 132,192
    triangles."""
    mesh, gs = sphere_grid_mesh(tris, n_theta=theta)
    return build_geometry_tables([mesh], [-1]), gs * 3.0


def coherent_rays(rng, n: int, ext: float):
    """Camera-like rays from one point outside the grid to random targets."""
    o = np.tile(np.array([ext / 2, ext / 2, -0.35 * ext], np.float32), (n, 1))
    tgt = rng.uniform(0, ext, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def divergent_rays(rng, n: int, ext: float):
    """Rays from random points inside the grid in random directions."""
    o = rng.uniform(0, ext, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def inert_lanes(rng, tnear, tfar, span):
    """Lanes k % 7 == 3 inert (tfar = 0), k % 11 == 5 with tnear >= tfar,
    k % 5 == 1 a finite tfar (in place)."""
    k = np.arange(tfar.shape[0])
    tfar[k % 5 == 1] = rng.uniform(0.05, 1.0, (k % 5 == 1).sum()) * span
    tfar[k % 7 == 3] = 0.0
    tnear[k % 11 == 5] = 0.5 * span
    tfar[k % 11 == 5] = 0.25 * span


def walk_wavefronts(sd, rng):
    """The two walk wavefronts on a grid scene: its camera rays (one
    origin) and rays from their hits in random directions, with inert,
    empty and bounded lanes (inert_lanes). Returns {"camera": [o, d, tnear,
    tfar], "spread": [...]}."""
    from ...accel import intersect_rays
    from ...scene import generate_rays
    dev = sd.device
    w, h = sd.camera.width, sd.camera.height
    ys, xs = np.mgrid[0:h, 0:w]
    px = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    px += rng.uniform(0, 1, px.shape).astype(np.float32)
    o, d = generate_rays(sd.camera, torch.as_tensor(px, device=dev))
    o = o.contiguous()
    n = o.shape[0]
    tnear = torch.full((n,), 1e-4, device=dev)
    tfar = torch.full((n,), float("inf"), device=dev)
    rh = intersect_rays(sd.geom, o, d, tnear, tfar)
    p = torch.where(rh.hit[:, None], o + d * (rh.t - 1e-3)[:, None], o)
    d2 = rng.normal(size=(n, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    tn2 = np.full(n, 1e-4, np.float32)
    tf2 = np.full(n, np.inf, np.float32)
    walk = sd.geom.walk
    span = float(torch.linalg.norm(walk.world_hi - walk.world_lo))
    inert_lanes(rng, tn2, tf2, span)
    spread = [p.contiguous(), *(torch.as_tensor(x, device=dev)
                                for x in (d2, tn2, tf2))]
    return {"camera": [o, d.contiguous(), tnear, tfar], "spread": spread}


def to_device(dev, *arrays):
    return [torch.as_tensor(x, device=dev) for x in arrays]


def timed_ms(fn, dev: torch.device, runs: int = TIMING_RUNS) -> float:
    """Median ms of `runs` calls after a warm one: between CUDA events on a
    card, on the host clock on the CPU."""
    fn()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end))
    else:
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sorted_tiles(wt, o, d):
    """The wavefront as the walk hands it to its kernels: default range,
    coherence sort, pad (accel/walk.py:_prepare)."""
    return _prepare(wt, o, d, *_default_range(o, None, None))[:4]


def tile_visits(wt, srt, mxu: bool = False):
    """Per-tile visit counts of the production walk on sorted tiles, from
    the counted kernel: [tiles] int64 on the host."""
    nv = walk_closest_counted(wt, *srt, mxu=mxu)[4]
    return nv.view(-1, RAY_TILE)[:, 0].long().cpu()


def checksum(t) -> float:
    return float(torch.where(torch.isfinite(t), t, 0.0).double().sum())


def write_record(path: str, record) -> None:
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=2))
    print(json.dumps(record), flush=True)

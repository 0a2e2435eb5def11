"""How `correct` is decided: the films the window produced against the plain
reference (portbench/reference/), pixel by pixel.

From the run's seed, a sample of pixels is drawn before the window opens
and each pass's film is kept at those pixels; once the window has closed, a
sample of its passes (the first, the last and others drawn from the seed)
is replayed there by the reference with the pass's own seed. A value is
off where it differs from the reference's by more than atol + rtol |ref| in
some channel. Numbers compared, each against its limit in
portbench/limits/<workload>.json:

  off_share   the share of compared values that are off;
  film_bad    entries of the window's running average that are not finite
              or are negative (limit 0).
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path

import numpy as np
import torch

from .reference import scene as ref_scene

ROOT = Path(__file__).resolve().parent
_M64 = (1 << 64) - 1


def load_limits(workload: str) -> dict:
    with open(ROOT / "limits" / f"{workload}.json") as f:
        return json.load(f)


def check_pixels(seed: int, n_pixels: int, k: int) -> np.ndarray:
    """k distinct pixels (flat indices y * width + x) drawn from the seed."""
    rng = np.random.default_rng([int(seed) & _M64, 0x7069])
    return np.sort(rng.choice(n_pixels, size=min(k, n_pixels),
                              replace=False))


def check_passes(seed: int, n_passes: int, k: int) -> list:
    """The first and last pass and k - 2 others drawn from the seed."""
    if n_passes <= k:
        return list(range(n_passes))
    rng = np.random.default_rng([int(seed) & _M64, 0x7061])
    mid = rng.choice(np.arange(1, n_passes - 1), size=k - 2, replace=False)
    return sorted({0, n_passes - 1, *map(int, mid)})


def reference_values(arrays, cfg: dict, traffic: dict, seeds, pixels,
                     device, dtype=torch.float32) -> np.ndarray:
    """The reference's film values [len(seeds), len(pixels), 3] of the
    passes seeded `seeds` at `pixels`, computed in `dtype` by the mix's
    integrator's module of portbench/reference/integrators/."""
    name = traffic["integrator"]
    est = importlib.import_module(
        f"{__package__}.reference.integrators.{name}")
    sc = ref_scene.build(arrays, traffic["width"], traffic["height"], device,
                         dtype)
    lanes = torch.as_tensor(np.asarray(pixels, np.int64), device=device)
    return np.stack([
        est.values(sc, s, lanes, traffic["spp_per_pass"],
                   cfg["integrators"][name], traffic["route"]).float()
        .cpu().numpy() for s in seeds])


def off_share(values: np.ndarray, ref: np.ndarray, rtol: float,
              atol: float) -> float:
    """The share of pixel values (all channels) off the reference's."""
    values = np.asarray(values, np.float64)
    ref = np.asarray(ref, np.float64)
    bad = np.any(~(np.abs(values - ref) <= atol + rtol * np.abs(ref)), -1)
    return float(bad.mean())


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number compared; a number passes
    at or under its limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())

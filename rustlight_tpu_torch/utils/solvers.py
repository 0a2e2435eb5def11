"""Vectorized numeric solvers; port of rustlight_tpu/utils/solvers.py.

Every form is branch-free over whole wavefronts: each case (linear
degeneracy, one or three real roots) is computed and mask-selected.
`newton_bisect` runs a fixed number of iterations with no early exit, so
every lane takes the reference's steps.
"""
from __future__ import annotations

import math

import torch


def solve_quadratic(a, b, c):
    """Roots of a x^2 + b x + c, numerically stable (citardauq for the small
    root). Returns (x0, x1, has_root); x0 <= x1. Linear inputs (a ~ 0) give
    the single root in both slots."""
    linear = torch.abs(a) < 1e-20
    x_lin = -c / torch.where(torch.abs(b) > 1e-20, b, 1.0)
    disc = b * b - 4.0 * a * c
    has = linear | (disc >= 0.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.where(b >= 0.0, sq, -sq))
    r1 = q / torch.where(torch.abs(a) > 1e-20, a, 1.0)
    r2 = c / torch.where(torch.abs(q) > 1e-20, q, 1.0)
    x0 = torch.where(linear, x_lin, torch.minimum(r1, r2))
    x1 = torch.where(linear, x_lin, torch.maximum(r1, r2))
    return x0, x1, has


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def solve_cubic(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d: (roots [.., 3], count), count
    in {1, 3}; with one root it fills all three slots. a ~ 0 falls back to
    the quadratic (count 1, its roots in slots 0 and 1)."""
    cubic = torch.abs(a) >= 1e-20
    sa = torch.where(cubic, a, 1.0)
    # depressed form t^3 + p t + q, x = t - b/(3a)
    p = (3.0 * sa * c - b * b) / (3.0 * sa * sa)
    q = (2.0 * b ** 3 - 9.0 * sa * b * c + 27.0 * sa * sa * d) / (27.0 * sa ** 3)
    shift = -b / (3.0 * sa)

    disc = (q * q) / 4.0 + (p ** 3) / 27.0
    three = disc < 0.0

    # three real roots: the trigonometric method
    mp = torch.sqrt(torch.clamp(-p / 3.0, min=1e-30))
    arg = torch.clamp(3.0 * q / (2.0 * p * mp), -1.0, 1.0)
    theta = torch.arccos(torch.where(three, arg, 0.0)) / 3.0
    two_pi3 = 2.0 * math.pi / 3.0
    t3 = torch.stack([2.0 * mp * torch.cos(theta - k * two_pi3)
                      for k in range(3)], -1)

    # one real root: Cardano
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)

    roots = torch.where(three[..., None], t3, t1[..., None].expand(t3.shape)) \
        + shift[..., None]

    x0, x1, _ = solve_quadratic(b, c, d)
    quad = torch.stack([x0, x1, x1], -1)
    roots = torch.where(cubic[..., None], roots, quad)
    count = torch.where(cubic & three, 3, 1)
    return roots, count


def newton_bisect(cdf_fn, pdf_fn, lo, hi, target, iters: int = 20):
    """Monotone-CDF inversion: `iters` Newton steps with a bisection
    safeguard (a step that leaves the bracket, is not finite or has a
    vanishing derivative bisects instead)."""
    x = 0.5 * (lo + hi)
    for _ in range(iters):
        f = cdf_fn(x) - target
        lo = torch.where(f < 0, x, lo)
        hi = torch.where(f > 0, x, hi)
        df = pdf_fn(x)
        x_new = x - f / torch.where(torch.abs(df) > 1e-10, df, 1.0)
        bad = ((x_new <= lo) | (x_new >= hi) | (~torch.isfinite(x_new))
               | (torch.abs(df) <= 1e-10))
        x = torch.where(bad, 0.5 * (lo + hi), x_new)
    return x

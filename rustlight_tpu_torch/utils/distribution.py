"""Discrete and continuous distributions as flat CDF tables; port of
rustlight_tpu/utils/distribution.py.

CDF layout matches the reference: cdf has n+1 entries, cdf[0] = 0,
cdf[n] = 1, pdf(i) = cdf[i+1] - cdf[i], func_int = mean(func). Building is
numpy at scene-compile time; sampling is a batched `searchsorted`. The 2D
distribution (an environment map's luminance) keeps the reference's index
rules: `searchsorted(side="right") - 1` on the marginal, and the count of
`ccdf <= u` over the sampled row of the conditional, so that both packages
pick the same cells. `build_distribution_1d` builds a 1D table on the
device from a tensor (the MCMC seed pool), its prefix sums in the order of
the reference's, so that the two cdfs are equal bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Distribution1D(NamedTuple):
    cdf: object       # [n+1] f32
    func: object      # [n] f32
    func_int: object  # scalar f32 (mean of func, as in the reference)


class Distribution2D(NamedTuple):
    """Marginal over rows x conditional over columns."""
    marginal_cdf: object      # [h+1]
    conditional_cdf: object   # [h, w+1]
    func: object              # [h, w]
    marginal_func: object     # [h] row integrals
    marginal_int: object      # scalar


def build_distribution_1d_np(func) -> Distribution1D:
    """Host-side (numpy) build; a leading axis builds one table a row."""
    func = np.asarray(func, dtype=np.float32)
    n = func.shape[-1]
    csum = np.cumsum(func / n, axis=-1)
    cdf = np.concatenate([np.zeros_like(csum[..., :1]), csum], axis=-1)
    total = cdf[..., -1:]
    safe_total = np.where(total > 0.0, total, 1.0)
    cdf = cdf / safe_total
    cdf[..., -1] = 1.0
    return Distribution1D(cdf=cdf, func=func, func_int=total[..., 0])


# the row length of the reference's prefix sum (XLA:CPU rewrites a long
# cumulative sum into rows of this many entries, see `_prefix_sum`)
_SCAN_BASE = 16


def _prefix_sum(x):
    """Inclusive prefix sum of a 1D float32 tensor, associated as the
    reference's (jnp.cumsum on the CPU): the entries in rows of
    _SCAN_BASE (zero-padded), a running sum left to right within each row,
    the rows' totals scanned the same way, recursively, and each row's
    exclusive prefix added to its entries. Left-to-right adds over columns
    keep the order fixed on any device."""
    n = x.shape[0]
    if n <= _SCAN_BASE:
        rows = x[None]
    else:
        m = -(-n // _SCAN_BASE)
        rows = torch.zeros(m * _SCAN_BASE, dtype=x.dtype, device=x.device)
        rows[:n] = x
        rows = rows.reshape(m, _SCAN_BASE)
    cols = [rows[:, 0]]
    for k in range(1, rows.shape[1]):
        cols.append(cols[-1] + rows[:, k])
    run = torch.stack(cols, dim=1)
    if n <= _SCAN_BASE:
        return run[0]
    tot = _prefix_sum(run[:, -1])
    excl = torch.cat([torch.zeros_like(tot[:1]), tot[:-1]])
    return (run + excl[:, None]).reshape(-1)[:n]


def build_distribution_1d(func) -> Distribution1D:
    """Device build of a 1D distribution over a [n] float32 tensor, on its
    device; the cdf equals the reference's (the JAX package's eager
    build_distribution_1d) bit for bit, the all-zero case included
    (uniform cdf but the last bin: cdf [0, ..., 0, 1])."""
    func = func.to(torch.float32)
    n = func.shape[-1]
    csum = _prefix_sum(func / n)
    cdf = torch.cat([torch.zeros_like(csum[:1]), csum])
    total = cdf[-1:]
    cdf = cdf / torch.where(total > 0.0, total, 1.0)
    cdf[-1] = 1.0
    return Distribution1D(cdf=cdf, func=func, func_int=total[0])


def build_distribution_2d_np(f) -> Distribution2D:
    """f [h, w] nonnegative (an environment map's luminance * sin theta)."""
    f = np.asarray(f, dtype=np.float32)
    cond = build_distribution_1d_np(f)
    row_int = cond.func_int
    marg = build_distribution_1d_np(row_int)
    return Distribution2D(
        marginal_cdf=marg.cdf, conditional_cdf=cond.cdf, func=f,
        marginal_func=row_int, marginal_int=marg.func_int)


def _t(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def distribution_to(dist: Distribution1D, device) -> Distribution1D:
    """Upload a numpy-built distribution to `device`."""
    return Distribution1D(cdf=_t(dist.cdf, device), func=_t(dist.func, device),
                          func_int=_t(dist.func_int, device))


def distribution_2d_to(d2, device) -> Distribution2D:
    """Upload a numpy-built 2D distribution (this module's or the JAX
    package's, read by attribute) to `device`."""
    return Distribution2D(*(_t(getattr(d2, f), device)
                            for f in Distribution2D._fields))


def sample_discrete_1d(dist: Distribution1D, u):
    """u [...] in [0,1) -> index [...] (int64)."""
    idx = torch.searchsorted(dist.cdf, u, right=True) - 1
    return torch.clamp(idx, 0, dist.func.shape[-1] - 1)


def pdf_discrete_1d(dist: Distribution1D, idx):
    return dist.cdf[idx + 1] - dist.cdf[idx]


def sample_continuous_1d(dist: Distribution1D, u):
    """u [...] -> (continuous position in [0, n), index, remapped u)."""
    idx = sample_discrete_1d(dist, u)
    c0 = dist.cdf[idx]
    p = pdf_discrete_1d(dist, idx)
    dv = u - c0
    dv = torch.where(p > 0.0, dv / torch.where(p > 0.0, p, 1.0), dv)
    return idx.to(torch.float32) + dv, idx, dv


def sample_continuous_2d(d2: Distribution2D, uv):
    """uv [..., 2] -> (x, y) continuous positions in [0, w) x [0, h)."""
    h, w = d2.func.shape
    ux, uy = uv[..., 0], uv[..., 1]
    yi = torch.clamp(torch.searchsorted(d2.marginal_cdf, uy.contiguous(),
                                      right=True) - 1,
                     0, h - 1)
    my0 = d2.marginal_cdf[yi]
    mp = d2.marginal_cdf[yi + 1] - my0
    dy = uy - my0
    dy = torch.where(mp > 0.0, dy / torch.where(mp > 0.0, mp, 1.0), dy)
    y = yi.to(torch.float32) + dy

    ccdf = d2.conditional_cdf[yi]                  # [..., w+1]
    xi = torch.clamp(torch.sum(ccdf <= ux[..., None], dim=-1) - 1, 0, w - 1)
    cx0 = torch.gather(ccdf, -1, xi[..., None])[..., 0]
    cp = torch.gather(ccdf, -1, xi[..., None] + 1)[..., 0] - cx0
    dx = ux - cx0
    dx = torch.where(cp > 0.0, dx / torch.where(cp > 0.0, cp, 1.0), dx)
    x = xi.to(torch.float32) + dx
    return torch.stack([x, y], dim=-1)


def pdf_2d(d2: Distribution2D, xi, yi):
    """Discrete cell density: func[y, x] / marginal_int."""
    safe = torch.where(d2.marginal_int > 0.0, d2.marginal_int, 1.0)
    return d2.func[yi, xi] / safe

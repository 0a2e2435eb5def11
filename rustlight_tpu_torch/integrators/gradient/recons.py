"""Screened-Poisson reconstructions for gradient-domain rendering; port of
rustlight_tpu/integrators/gradient/recons.py.

Jacobi iterations combining the primal estimate with forward-difference
gradients, I[p] <- (I[p] + sum_q (I[q] +- g[q,p])) / w, as whole-image
stencils: `torch.roll` and the edge masks, on the images' device.
"""
from __future__ import annotations

import torch


def _shift(img, dy, dx):
    """Shift image content by (dy, dx); the callers mask the wrapped
    rows and columns."""
    return torch.roll(img, (dy, dx), dims=(0, 1))


def _edge_masks(h, w, device):
    ys = torch.arange(h, device=device).reshape(h, 1, 1)
    xs = torch.arange(w, device=device).reshape(1, w, 1)
    has = (xs > 0, xs < w - 1, ys > 0, ys < h - 1)  # left/right/up/down
    return tuple(m.expand(h, w, 1) for m in has)


def uniform_poisson_reconstruction(primal, gx, gy, very_direct=None,
                                   iterations: int = 50):
    """Uniform Jacobi solve. All images [h, w, 3] float32 tensors."""
    h, w = primal.shape[:2]
    has_l, has_r, has_u, has_d = _edge_masks(h, w, primal.device)
    cur = primal
    for _ in range(iterations):
        c = cur
        wgt = torch.ones((h, w, 1), dtype=torch.float32, device=cur.device)
        left = _shift(cur, 0, 1) + _shift(gx, 0, 1)     # I[x-1] + gx[x-1]
        c = c + torch.where(has_l, left, 0.0)
        wgt = wgt + has_l
        right = _shift(cur, 0, -1) - gx                 # I[x+1] - gx[x]
        c = c + torch.where(has_r, right, 0.0)
        wgt = wgt + has_r
        up = _shift(cur, 1, 0) + _shift(gy, 1, 0)       # I[y-1] + gy[y-1]
        c = c + torch.where(has_u, up, 0.0)
        wgt = wgt + has_u
        down = _shift(cur, -1, 0) - gy                  # I[y+1] - gy[y]
        c = c + torch.where(has_d, down, 0.0)
        wgt = wgt + has_d
        cur = c / wgt
    if very_direct is not None:
        cur = cur + very_direct
    return cur


def _sum0(stack):
    """The sum over the leading axis, left to right on every device."""
    out = stack[0]
    for x in stack[1:]:
        out = out + x
    return out


def _mean_var(stack):
    """stack [k, h, w, 3] -> (mean, sample variance) across k replicates."""
    k = stack.shape[0]
    mean = _sum0(stack) / k
    if k < 2:
        return mean, torch.zeros_like(mean)
    var = _sum0((stack - mean[None]) ** 2) / (k - 1)
    return mean, var


def _inv_or_1(v):
    return torch.where(v > 0.0, 1.0 / torch.clamp(v, min=1e-30), 1.0)


def weighted_poisson_reconstruction(primal_stack, gx_stack, gy_stack,
                                    very_direct=None, iterations: int = 50):
    """Variance-weighted Jacobi solve. *_stack [k, h, w, 3]: independent
    buffer replicates; weights are inverse variances (channel max), the
    primal's confidence annealed over the iterations by
    coeff = 1 / (1.01 + 4 * 0.5^iter)."""
    primal, var_p = _mean_var(primal_stack)
    gx, var_gx = _mean_var(gx_stack)
    gy, var_gy = _mean_var(gy_stack)
    h, w = primal.shape[:2]
    dev = primal.device
    has_l, has_r, has_u, has_d = _edge_masks(h, w, dev)
    vp = torch.amax(var_p, dim=-1, keepdim=True)
    vgx = torch.amax(var_gx, dim=-1, keepdim=True)
    vgy = torch.amax(var_gy, dim=-1, keepdim=True)
    cur = primal
    for it in range(iterations):
        half = torch.pow(torch.tensor(0.5, device=dev),
                         torch.tensor(float(it), device=dev))
        coeff = 1.0 / ((0.01 + 1.0) + 4.0 * half)
        var_pos = vp * coeff
        w0 = _inv_or_1(var_pos)
        c = cur * w0
        wgt = w0
        wl = _inv_or_1(var_pos + _shift(vgx, 0, 1))
        c = c + torch.where(has_l, (_shift(cur, 0, 1) + _shift(gx, 0, 1)) * wl,
                            0.0)
        wgt = wgt + torch.where(has_l, wl, 0.0)
        wr = _inv_or_1(var_pos + vgx)
        c = c + torch.where(has_r, (_shift(cur, 0, -1) - gx) * wr, 0.0)
        wgt = wgt + torch.where(has_r, wr, 0.0)
        wu = _inv_or_1(var_pos + _shift(vgy, 1, 0))
        c = c + torch.where(has_u, (_shift(cur, 1, 0) + _shift(gy, 1, 0)) * wu,
                            0.0)
        wgt = wgt + torch.where(has_u, wu, 0.0)
        wd = _inv_or_1(var_pos + vgy)
        c = c + torch.where(has_d, (_shift(cur, -1, 0) - gy) * wd, 0.0)
        wgt = wgt + torch.where(has_d, wd, 0.0)
        cur = c / wgt
    if very_direct is not None:
        cur = cur + very_direct
    return cur


def bagging_poisson_reconstruction(primal_stack, gx_stack, gy_stack,
                                   very_direct=None, iterations: int = 50):
    """Leave-one-out bagging over weighted reconstructions. Returns the
    (mean, variance, relative error) AOVs."""
    k = primal_stack.shape[0]
    if k < 2:
        raise ValueError("bagging needs at least two buffers")
    recons = []
    for leave in range(k):
        keep = [i for i in range(k) if i != leave]
        recons.append(weighted_poisson_reconstruction(
            primal_stack[keep], gx_stack[keep], gy_stack[keep], very_direct,
            iterations))
    mean, var = _mean_var(torch.stack(recons, 0))
    return mean, var, var / (mean + 1e-3)

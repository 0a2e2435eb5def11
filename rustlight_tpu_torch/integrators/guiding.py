"""Practical path guiding on the wavefront; port of
rustlight_tpu/integrators/guiding.py.

A world-space voxel grid stores per-voxel directional radiance histograms
(equal-solid-angle bins); path vertices deposit their incident-radiance
estimates, and the directional bounce samples a defensive one-sample-MIS
mixture of the BSDF and the learned distribution. Every bin keeps a uniform
prior mass, so the mixture pdf keeps the estimator unbiased for any table.

Design after "Practical Path Guiding" (Mueller et al. 2017), simplified for
lockstep lanes: a regular grid instead of an adaptive SD-tree, and
equal-solid-angle binning, so that pdf(d) = w_bin * B / (4 pi * sum_w) with
no per-bin area table.

Two choices keep the table the same on every device:

  - `deposit` sums each cell's values in an order fixed by the lanes: on
    the card with `index_put_(accumulate=True)`, whose CUDA form sorts the
    indices and reduces each cell's run in a fixed order (the atomics of
    `index_add_` add in whatever order the lanes arrive), on the CPU with
    `index_add_`, which adds in lane order as the reference's scatter does
    (the CPU's `index_put_` accumulates from several threads at once);
    lanes that deposit nothing point at spare cells past the table, spread
    over DUMP_CELLS of them so that no cell gathers a long run of zeros;
  - the inverse-CDF draw's prefix sum over a row's 128 bins is associated
    as the reference's cumulative sum on the CPU (`_row_cumsum`: runs of
    16 bins, then the runs' totals), by elementwise adds whose order no
    device changes.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from ..utils.film import Film
from ..utils.rng import make_stream, stream_fold
from .common import _pixel_grid

_PI = math.pi
N_THETA = 8          # cos-theta slabs (equal solid angle)
N_PHI = 16
N_BINS = N_THETA * N_PHI          # 128 bins a row
# Per-bin prior mass: only needs to make cold-start rows samplable; the
# defensive mixture bounds the weights (pdf_mix >= (1 - alpha) * pdf_bsdf).
UNIFORM_PRIOR = 0.01
# spare cells past the table that take the lanes which deposit nothing
DUMP_CELLS = 256
# the run length of the reference's prefix sum over a row (see _row_cumsum)
_RUN = 16


@dataclass
class GuideGrid:
    g: int                # voxels per axis
    lo: Any = None        # [3] world bounds
    inv_extent: Any = None  # [3] 1 / (hi - lo)
    table: Any = None     # [g^3, N_BINS] weights


def make_guide_grid(scene, g: int = 16) -> GuideGrid:
    """A zero table over the scene's bounds (from its host geometry),
    widened by 1e-4 of the extent, on the scene's device."""
    geom = scene.host.geom if getattr(scene, "host", None) else scene.geom
    v0 = np.asarray(geom.v0[: geom.n_tris])
    p1 = v0 + np.asarray(geom.e1[: geom.n_tris])
    p2 = v0 + np.asarray(geom.e2[: geom.n_tris])
    lo = np.minimum(np.minimum(v0.min(0), p1.min(0)), p2.min(0))
    hi = np.maximum(np.maximum(v0.max(0), p1.max(0)), p2.max(0))
    ext = np.maximum(hi - lo, 1e-6)
    dev = scene.device
    return GuideGrid(
        g=g,
        lo=torch.as_tensor(np.float32(lo - 1e-4 * ext), device=dev),
        inv_extent=torch.as_tensor(np.float32(1.0 / (ext * (1 + 2e-4))),
                                   device=dev),
        table=torch.zeros((g ** 3, N_BINS), dtype=torch.float32, device=dev))


def _cell(x, hi: int):
    """int32(x) clipped to [0, hi], with the reference's saturating
    conversion of NaN (to 0) and of infinities."""
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), 0.0, float(hi))
    return x.to(torch.int32)


def voxel_of(grid: GuideGrid, p):
    """[n, 3] world points -> [n] flat voxel ids (clipped into the grid)."""
    f = (p - grid.lo[None, :]) * grid.inv_extent[None, :]
    i = _cell(f * grid.g, grid.g - 1)
    return (i[:, 0] * grid.g + i[:, 1]) * grid.g + i[:, 2]


def bin_of(d):
    """[n, 3] unit directions -> [n] equal-solid-angle bin ids."""
    ct = torch.clamp(d[:, 2], -1.0, 1.0)
    ti = _cell((ct + 1.0) * (N_THETA / 2.0), N_THETA - 1)
    phi = torch.atan2(d[:, 1], d[:, 0])
    phi = torch.where(phi < 0, phi + 2 * _PI, phi)
    pi_ = _cell(phi * (N_PHI / (2 * _PI)), N_PHI - 1)
    return ti * N_PHI + pi_


def _row_weights(grid: GuideGrid, vox):
    row = grid.table[vox.long()] + UNIFORM_PRIOR          # [n, B]
    return row, torch.sum(row, dim=1)


def _row_cumsum(row):
    """Inclusive prefix sum over the last axis (N_BINS), associated as
    XLA:CPU's cumulative sum: a running sum left to right within each run
    of _RUN bins, then over the runs' totals, each run's exclusive prefix
    added to its entries."""
    n = row.shape[0]
    runs = row.reshape(n, N_BINS // _RUN, _RUN)
    cols = [runs[..., 0]]
    for k in range(1, _RUN):
        cols.append(cols[-1] + runs[..., k])
    run = torch.stack(cols, dim=-1)
    tot = [run[:, 0, -1]]
    for k in range(1, N_BINS // _RUN):
        tot.append(tot[-1] + run[:, k, -1])
    excl = torch.stack([torch.zeros_like(tot[0])] + tot[:-1], dim=1)
    return (run + excl[..., None]).reshape(n, N_BINS)


def guide_pdf(grid: GuideGrid, vox, d):
    """Solid-angle pdf of the learned distribution at directions d [n, 3]."""
    row, tot = _row_weights(grid, vox)
    w = torch.gather(row, 1, bin_of(d).long()[:, None])[:, 0]
    return w * (N_BINS / (4.0 * _PI)) / torch.clamp(tot, min=1e-30)


def guide_sample(grid: GuideGrid, vox, u):
    """Sample d ~ the learned distribution; u [n, 2]. Returns (d, pdf)."""
    row, tot = _row_weights(grid, vox)
    cdf = _row_cumsum(row)
    target = u[:, 0:1] * cdf[:, -1:]
    b = torch.sum((cdf < target).to(torch.int32), dim=1)
    b = torch.clamp(b, 0, N_BINS - 1).long()
    ti = b // N_PHI
    pi_ = b - ti * N_PHI
    # uniform within the bin: cos-theta uniform in the slab, phi uniform;
    # the CDF residual is a fresh uniform for cos-theta (the within-bin
    # offset of an inverse-CDF draw is U[0, 1) given the bin)
    w = torch.gather(row, 1, b[:, None])[:, 0]
    lo_c = torch.gather(cdf, 1, b[:, None])[:, 0] - w
    u_in = (target[:, 0] - lo_c) / torch.clamp(w, min=1e-30)
    u_in = torch.clamp(u_in, 0.0, 1.0 - 1e-7)
    ct = -1.0 + (ti.to(torch.float32) + u_in) * (2.0 / N_THETA)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = (pi_.to(torch.float32) + u[:, 1]) * (2 * _PI / N_PHI)
    d = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    pdf = w * (N_BINS / (4.0 * _PI)) / torch.clamp(tot, min=1e-30)
    return d, pdf


def deposit(acc, grid: GuideGrid, p, d, value, ok):
    """Scatter incident-radiance estimates into the flat [g^3 * N_BINS]
    accumulator: value [n] at (voxel(p), bin(d)) where ok. Returns the new
    accumulator. Each cell's values are summed in an order fixed by the
    lanes' indices (see the module's note)."""
    n_cells = acc.shape[0]
    idx = (voxel_of(grid, p) * N_BINS + bin_of(d)).long()
    spare = n_cells + torch.arange(idx.shape[0],
                                   device=idx.device) % DUMP_CELLS
    idx = torch.where(ok, idx, spare)
    out = torch.cat([acc, acc.new_zeros(DUMP_CELLS)])
    value = torch.where(ok, value, 0.0)
    if out.is_cuda:
        out.index_put_((idx,), value, accumulate=True)
    else:
        out.index_add_(0, idx, value)
    return out[:n_cells]


def guided_pass(scene, integrator, grid: GuideGrid, pix, stream,
                decay: float):
    """One 1-spp guided pass over `pix`: (radiance [n, 3] with non-finite
    or negative lanes zeroed, the grid trained on the pass's deposits:
    table * decay + deposits)."""
    rad, dep = _guided_lanes(scene, integrator, grid, pix, stream)
    return rad, _trained(grid, dep, decay)


def _guided_lanes(scene, integrator, grid: GuideGrid, pix, stream):
    """One guided sample of the lanes `pix`: (radiance with non-finite or
    negative lanes zeroed, the flat deposits)."""
    rad, dep = integrator.compute_pixel(scene, pix, stream, guide=grid,
                                        collect=True)
    ok = torch.all(torch.isfinite(rad), dim=-1) & torch.all(rad >= 0.0,
                                                            dim=-1)
    return torch.where(ok[:, None], rad, 0.0), dep


def _trained(grid: GuideGrid, dep, decay: float) -> GuideGrid:
    """The grid after a pass's deposits: table * decay + deposits."""
    return replace(grid, table=grid.table * decay
                   + dep.reshape(grid.table.shape))


def render_guided(scene, integrator, spp: int, seed: int = 0, g: int = 16,
                  alpha: float = 0.5, decay: float = 0.8,
                  verbose: bool = False, grid: GuideGrid = None,
                  return_grid: bool = False, mesh=None):
    """Guided progressive render on the scene's device: every 1-spp pass j
    renders with the current grid, drawing from stream_fold(make_stream(
    seed), j), and its deposits train the next pass's grid. Each pass is
    unbiased (its grid depends only on earlier passes), so all passes
    accumulate with equal weight.

    `grid` continues training an existing table (IntegratorGuidedPath);
    `return_grid` also returns the trained grid.

    `mesh` (parallel/mesh.py; every rank calls this) shards each pass as
    the JAX package does: the pixels padded with copies of the last one to
    a multiple of the rank count, shard d drawing from stream_fold(
    stream_fold(base, j), d); the radiance gathered, and each rank's
    deposits (its lanes', padding lanes included, in the fixed order of
    `deposit`) summed over the ranks in rank order, so that the table is
    the same on every rank."""
    cam = scene.camera
    w, h = cam.width, cam.height
    n = w * h
    dev = scene.device
    if grid is None:
        grid = make_guide_grid(scene, g)
    integrator.guide_alpha = alpha
    base = make_stream(seed, dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    t0 = time.time()
    if mesh is None:
        pix = torch.as_tensor(_pixel_grid(w, h), device=dev)
    else:
        from ..parallel.mesh import gather_rows, sum_over_ranks
        from ..parallel.render import _local, _padded_grid
        pix = torch.as_tensor(_local(mesh, _padded_grid(w, h, mesh.size)),
                              device=dev)
    for j in range(spp):
        if mesh is None:
            rad, grid = guided_pass(scene, integrator, grid, pix,
                                    stream_fold(base, j), decay)
        else:
            rad, dep = _guided_lanes(scene, integrator, grid, pix,
                                     stream_fold(stream_fold(base, j),
                                                 mesh.rank))
            rad = gather_rows(mesh, rad)[:n]
            grid = _trained(grid, sum_over_ranks(mesh, dep), decay)
        acc = acc + rad
    img = acc.cpu().numpy().reshape(h, w, 3) / spp
    if verbose:
        print(f"render_guided: {spp} passes in {time.time() - t0:.2f}s "
              f"(grid mass {float(torch.sum(grid.table)):.3g})")
    film = Film(w, h)
    film.buffers["primal"] = img
    if return_grid:
        return film, grid
    return film


class IntegratorGuidedPath:
    """Self-driving guided path tracer whose guide table persists across
    render() calls for the same scene: under `-a`, every averaging pass
    continues training the table the previous passes built. Averaging
    stays unbiased: each pass's grid depends only on earlier samples.

    state_dict / load_state_dict checkpoint the table beside the `-a`
    dumps (SMCMC's protocol), so that --resume reproduces an uninterrupted
    run bit for bit."""

    averaging = True

    def __init__(self, integrator, g: int = 16, alpha: float = 0.5,
                 decay: float = 0.8):
        self.integrator = integrator
        self.g = g
        self.alpha = alpha
        self.decay = decay
        self._grid = None
        self._grid_scene = None

    def render(self, scene, spp: int, seed: int = 0, verbose: bool = False,
               mesh=None):
        grid = self._grid if self._grid_scene is scene else None
        film, grid = render_guided(
            scene, self.integrator, spp, seed=seed, g=self.g,
            alpha=self.alpha, decay=self.decay, verbose=verbose,
            grid=grid, return_grid=True, mesh=mesh)
        self._grid = grid
        self._grid_scene = scene
        return film

    def state_dict(self):
        if self._grid is None:
            return None
        return {"table": self._grid.table.cpu().numpy(),
                "g": np.asarray(self.g)}

    def load_state_dict(self, d, scene):
        if int(d["g"]) != self.g:
            raise ValueError(f"guide-grid mismatch: dumped g={int(d['g'])} "
                             f"!= configured g={self.g}")
        grid = make_guide_grid(scene, self.g)
        self._grid = replace(grid, table=torch.as_tensor(
            np.asarray(d["table"]), device=scene.device))
        self._grid_scene = scene

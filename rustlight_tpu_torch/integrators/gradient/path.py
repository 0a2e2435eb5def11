"""Gradient-domain path tracing, random-replay shift; port of
rustlight_tpu/integrators/gradient/path.py.

The base path renders pixel p from a recorded primary-sample vector; the
four offset pixels re-render with the same vector (an ArrayStream over the
path tracer, with no Russian roulette). Each shift adds base 0.5 L_b,
offset 0.5 L_o and gradient 0.5 (L_o - L_b): primal[p] += main,
primal[p + off] += offset, the gradient buffers signed by direction, and a
final 0.25 primal scale. `min_survival` weights the evaluation by an
adaptive survival draw.

The film is assembled by rolls: the scatter targets are fixed +-1-pixel
displacements, and the lanes whose target leaves the film are zeroed, so
scatter-at-(p + o) is a roll by o. `_render_gradient_film`, shared with the
reconnection shift, sums the passes into `nb_buffers` buffers on the host
(pass s into buffer s % nb, float32 numpy) and reconstructs them on the
scene's device.

On a device mesh (parallel/mesh.py) each rank traces the lanes of its row
band (np.array_split of the rows) with a lane window on its stream, so that
its draws are its lanes' slice of the single-device draws; a pass's
per-lane results are gathered, and the film assembly and the
reconstruction run whole on every rank (`_mesh_pass`). The JAX package's
GSPMD lowers the film shifts to halo exchanges instead.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...utils.film import Film
from ...utils.rng import ArrayStream, make_stream, stream_fold, stream_next
from ...utils.vec import luminance
from ..common import _pixel_grid
from ..path import IntegratorPathTracing
from .recons import (_sum0, bagging_poisson_reconstruction,
                     uniform_poisson_reconstruction,
                     weighted_poisson_reconstruction)

# (dy, dx) offsets and their gradient buffer and sign
_OFFSETS = [(1, 0, "y", +1), (-1, 0, "y", -1), (0, 1, "x", +1),
            (0, -1, "x", -1)]
_NB_BUFFERS = {"uniform": 1, "weighted": 2, "bagging": 4}


def _shift2d(img, dy, dx):
    """Scatter lane (y, x)'s value to (y+dy, x+dx): out[q] = img[q - o].
    Callers zero the lanes whose target falls outside the film, so the
    wrapped rows and columns carry zeros and a plain roll is exact."""
    return torch.roll(img, (dy, dx), dims=(0, 1))


def _offset_inside(px, py, dx, dy, w, h):
    """[h, w, 1] mask of the lanes whose offset pixel is on the film."""
    ox, oy = px + dx, py + dy
    return ((ox >= 0) & (ox < w) & (oy >= 0) & (oy < h)).reshape(h, w, 1)


class IntegratorGradientPath:
    """`gradient-path-explicit`: the random-replay shift."""

    def __init__(self, max_depth: Optional[int] = None,
                 recons: str = "uniform", recons_iterations: int = 50,
                 min_survival: Optional[float] = None,
                 nb_buffers: Optional[int] = None,
                 hard_cap: int = 8, pss_dims: Optional[int] = None):
        self.max_depth = max_depth
        self.recons = recons
        self.iterations = recons_iterations
        self.min_survival = min_survival
        # no Russian roulette inside the shifted paths
        self.inner = IntegratorPathTracing(max_depth=max_depth, rr_depth=None,
                                           hard_cap=hard_cap)
        self.pss_dims = pss_dims or (2 + 6 * self.inner.hard_cap)
        self.nb_buffers = nb_buffers or _NB_BUFFERS[recons]

    def _eval(self, scene, pix, u):
        li = self.inner.compute_pixel(scene, pix, ArrayStream(values=u,
                                                              counter=0))
        return torch.where(torch.all(torch.isfinite(li), -1, keepdim=True),
                           li, 0.0)

    def render(self, scene, spp: int, seed: int = 0, mesh=None) -> Film:
        w, h = scene.camera.width, scene.camera.height
        base = make_stream(seed, scene.device)
        if mesh is None:
            def one_pass(s):
                return self.one_pass(scene, stream_fold(base, s))
        else:
            def one_pass(s):
                return _mesh_pass(mesh, scene, stream_fold(base, s),
                                  self.lanes, self.assemble)
        return _render_gradient_film(scene, spp, one_pass, self.nb_buffers,
                                     self.recons, self.iterations, w, h)

    def one_pass(self, scene, stream):
        """One sample of every pixel: (primal, gradient_x, gradient_y),
        each [n, 3]."""
        w, h = scene.camera.width, scene.camera.height
        pix = torch.as_tensor(_pixel_grid(w, h), device=scene.device)
        return self.assemble(scene, self.lanes(scene, pix, stream))

    def lanes(self, scene, pix, stream):
        """The per-lane results of the lanes `pix` [m, 2]: [m, 6, 3], the
        base path's radiance, the four offsets' and the survival weight
        (in all three channels)."""
        m = pix.shape[0]
        w, h = scene.camera.width, scene.camera.height
        px, py = pix[:, 0], pix[:, 1]
        u, stream = stream_next(stream, (m, self.pss_dims))
        lb = self._eval(scene, pix, u)
        if self.min_survival is not None:
            u_s, stream = stream_next(stream, (m,))
            prob = torch.clamp(luminance(lb) / 0.1, self.min_survival, 1.0)
            keep = (prob >= 1.0) | (u_s < prob)
            w_surv = torch.where(keep, 1.0 / prob, 0.0)
        else:
            w_surv = torch.ones(m, dtype=torch.float32, device=scene.device)
        out = [lb]
        for dy, dx, _, _ in _OFFSETS:
            opix = torch.stack([torch.clamp(px + dx, 0, w - 1),
                                torch.clamp(py + dy, 0, h - 1)], -1)
            out.append(self._eval(scene, opix, u))
        out.append(w_surv[:, None].expand(m, 3))
        return torch.stack(out, dim=1)

    def assemble(self, scene, res):
        """The film of one pass from every lane's `lanes` results [n, 6,
        3]: (primal, gradient_x, gradient_y), each [n, 3]."""
        w, h = scene.camera.width, scene.camera.height
        n = w * h
        pix = torch.as_tensor(_pixel_grid(w, h), device=scene.device)
        px, py = pix[:, 0], pix[:, 1]
        lb = res[:, 0]
        ws = res[:, 5, :1]
        primal = torch.zeros((h, w, 3), dtype=torch.float32,
                             device=scene.device)
        grads = {"x": torch.zeros_like(primal), "y": torch.zeros_like(primal)}
        for i, (dy, dx, axis, sign) in enumerate(_OFFSETS):
            inside = _offset_inside(px, py, dx, dy, w, h)
            lo = res[:, 1 + i]
            main = (0.5 * lb * ws).reshape(h, w, 3)
            offv = (0.5 * lo * ws).reshape(h, w, 3)
            grad = (0.5 * (lo - lb) * ws).reshape(h, w, 3)
            primal = primal + torch.where(inside, main, 0.0)
            primal = primal + _shift2d(torch.where(inside, offv, 0.0), dy, dx)
            g = torch.where(inside, grad, 0.0)
            if sign > 0:
                grads[axis] = grads[axis] + g
            else:
                grads[axis] = grads[axis] - _shift2d(g, dy, dx)
        return (primal.reshape(n, 3) * 0.25, grads["x"].reshape(n, 3),
                grads["y"].reshape(n, 3))


def _mesh_pass(mesh, scene, stream, lanes, assemble):
    """One pass over a mesh: this rank's row band traced through `lanes`
    with its lane window on `stream`, every band's results gathered, the
    pass assembled whole by `assemble`."""
    from ...parallel.mesh import gather_rows
    from ...utils.rng import with_window
    w, h = scene.camera.width, scene.camera.height
    bands = mesh.bands(h)
    r0, r1 = bands[mesh.rank]
    pix = torch.as_tensor(_pixel_grid(w, h)[r0 * w:r1 * w],
                          device=scene.device)
    res = lanes(scene, pix, with_window(stream, r0 * w, r1 * w))
    return assemble(scene, gather_rows(
        mesh, res, counts=[(b - a) * w for a, b in bands]))


def _render_gradient_film(scene, spp, one_pass, nb, recons, iterations, w, h):
    """The gradient film: pass s (of `spp`) into buffer s % nb, summed in
    float32 numpy on the host; each buffer averaged over its passes,
    very_direct (the fourth output of a pass, if any) over spp; the
    reconstruction `recons` on the scene's device, very_direct added
    back. Buffers: primal_raw, very_direct, gradient_x, gradient_y,
    primal, and primal_variance and relerr for bagging."""
    primal_acc = np.zeros((nb, h * w, 3), np.float32)
    gx_acc = np.zeros((nb, h * w, 3), np.float32)
    gy_acc = np.zeros((nb, h * w, 3), np.float32)
    vd_acc = np.zeros((h * w, 3), np.float32)
    counts = np.zeros(nb, np.int64)
    for s in range(spp):
        out = one_pass(s)
        b = s % nb
        primal_acc[b] += out[0].cpu().numpy()
        gx_acc[b] += out[1].cpu().numpy()
        gy_acc[b] += out[2].cpu().numpy()
        if len(out) > 3:
            vd_acc += out[3].cpu().numpy()
        counts[b] += 1
    counts = np.maximum(counts, 1)[:, None, None]
    primal_acc /= counts
    gx_acc /= counts
    gy_acc /= counts
    vd_acc /= spp

    shape = (nb, h, w, 3)
    dev = scene.device
    ps, gxs, gys = (torch.as_tensor(a.reshape(shape), device=dev)
                    for a in (primal_acc, gx_acc, gy_acc))
    vd = vd_acc.reshape(h, w, 3)

    p_mean, gx_mean, gy_mean = (_sum0(x) / nb for x in (ps, gxs, gys))
    film = Film(w, h)
    film.buffers["primal_raw"] = p_mean.cpu().numpy() + vd
    film.buffers["very_direct"] = vd
    film.buffers["gradient_x"] = gx_mean.cpu().numpy()
    film.buffers["gradient_y"] = gy_mean.cpu().numpy()
    if recons == "uniform":
        out = uniform_poisson_reconstruction(p_mean, gx_mean, gy_mean,
                                             iterations=iterations)
    elif recons == "weighted":
        out = weighted_poisson_reconstruction(ps, gxs, gys,
                                              iterations=iterations)
    elif recons == "bagging":
        out, var, relerr = bagging_poisson_reconstruction(
            ps, gxs, gys, iterations=iterations)
        film.buffers["primal_variance"] = var.cpu().numpy()
        film.buffers["relerr"] = relerr.cpu().numpy()
    else:
        raise ValueError(recons)
    film.buffers["primal"] = out.cpu().numpy() + vd
    return film

"""Integrator framework: the Monte Carlo render entry point; port of
rustlight_tpu/integrators/common.py:render.

Integrators with `compute_block` (the path tracer) render every pixel's
spp samples in one persistent wavefront. Integrators with only
`compute_pixel` (ambient occlusion) take the per-pass route: one wavefront
of every pixel per sample, in passes of `spp_per_pass`. The variance AOVs
and the stratified sampler are not ported yet and raise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.film import Film
from ..utils.rng import make_stream, stream_fold


def mis_power(pdf_a, pdf_b):
    """Power heuristic beta=2 with zero/NaN guards."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    w = a2 / torch.clamp(a2 + b2, min=1e-30)
    w = torch.where(torch.isfinite(pdf_a) & torch.isfinite(pdf_b), w, 0.0)
    return torch.where(pdf_a > 0.0, w, 0.0)


def mis_balance(pdf_a, pdf_b):
    """Balance heuristic (the path tracer's per-strategy MIS)."""
    w = pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-30)
    w = torch.where(torch.isfinite(pdf_a) & torch.isfinite(pdf_b), w, 0.0)
    return torch.where(pdf_a > 0.0, w, 0.0)


def _pixel_grid(width, height):
    ys, xs = np.mgrid[0:height, 0:width]
    return np.stack([xs.ravel(), ys.ravel()], -1).astype(np.int32)


def _guarded(li):
    """Zero the pixels whose sum is non-finite or negative, as the
    reference guards its splats (accumulate_safe, mod.rs:160-175)."""
    ok = torch.all(torch.isfinite(li), dim=-1) & torch.all(li >= 0.0, dim=-1)
    return torch.where(ok[:, None], li, 0.0)


def render(scene, integrator, spp: int, seed: int = 0, spp_per_pass: int = 8,
           sampler: str = "independent", persistent: bool = None,
           variance: bool = False) -> Film:
    """Monte Carlo render on the scene's device: returns the averaged film.

    With `compute_block` (and unless `persistent=False`), the reference's
    persistent route: one call renders all spp samples of every pixel
    (pixel-pinned lanes respawn as soon as their path ends). Otherwise the
    per-pass route over `compute_pixel`: sample s of every pixel uses
    stream_fold(make_stream(seed), s), passes of min(spp_per_pass, spp)
    samples, spp rounded up to whole passes and the sum divided by that
    count, as the reference does. Non-finite or negative sums (per sample on
    the per-pass route) are zeroed. An integrator with `prepare(scene)` has
    it called once, before either route, as the reference does."""
    if variance or sampler != "independent":
        raise NotImplementedError(
            "only the independent sampler without variance AOVs is ported "
            "so far (no variance or stratified)")
    if hasattr(integrator, "prepare"):
        integrator.prepare(scene)
    cam = scene.camera
    w, h = cam.width, cam.height
    device = scene.device
    pix = torch.as_tensor(_pixel_grid(w, h), device=device)
    base = make_stream(seed, device)
    if hasattr(integrator, "compute_block") and persistent is not False:
        acc = _guarded(integrator.compute_block(scene, pix,
                                                stream_fold(base, 0), spp))
        n_samples = spp
    elif hasattr(integrator, "compute_pixel"):
        chunk = max(1, min(spp_per_pass, spp))
        acc = torch.zeros((h * w, 3), dtype=torch.float32, device=device)
        n_samples = 0
        while n_samples < spp:
            part = torch.zeros_like(acc)
            for k in range(chunk):
                li = integrator.compute_pixel(
                    scene, pix, stream_fold(base, n_samples + k))
                part = part + _guarded(li)
            acc = acc + part
            n_samples += chunk
    else:
        raise NotImplementedError(
            f"{type(integrator).__name__} has no ported render route")
    img = (acc.reshape(h, w, 3) / n_samples).cpu().numpy()
    film = Film(w, h)
    film.buffers["primal"] = img
    return film

"""Integrator framework: the Monte Carlo render entry point; port of
rustlight_tpu/integrators/common.py:render.

Integrators with `compute_block` (the path tracer) render every pixel's
spp samples in one persistent wavefront. Integrators with only
`compute_pixel` (ambient occlusion, direct), and the path tracer when the
caller asks for it, take the per-pass route: one wavefront of every pixel
per sample, in passes of `spp_per_pass`; `variance=True` takes it too and
adds the `mean` and `variance` AOVs. Splatting integrators (the light
tracer) render through `render_splat` into a scatter-added film. The
stratified sampler (`sampler="stratified"`) takes the per-pass route: pass
s draws through StratifiedStream(stream_fold(base, s)), its permutations
keyed by the base key. `render_adaptive` spends a variance-driven budget
over the pixels after a per-pass pilot; `render_feature_aovs` renders the
first-hit albedo, normal and depth for denoisers.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..utils.film import Film, accumulate_safe, splat_add
from ..utils.rng import StratifiedStream, make_stream, stream_fold
from ..utils.tracing import root, span

SAMPLERS = ("independent", "stratified")


class SplattingIntegrator:
    """Base for image-space splatting integrators (light tracing):
    `trace_paths(scene, n, stream) -> (pixel_ids, values)`, contributions
    that `render_splat` scatter-adds into the film."""

    def trace_paths(self, scene, n: int, stream):
        raise NotImplementedError


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
    the per-pass route) are zeroed. `variance=True` forces the per-pass
    route and adds the `mean` AOV (the primal) and the `variance` AOV (the
    unbiased per-sample variance from the sums of li and li^2). An
    integrator with `prepare(scene)` has it called once, before either
    route, as the reference does.

    `sampler="stratified"` takes the per-pass route too (its strata are
    laid over the passes): sample s of every pixel draws through
    StratifiedStream(inner=stream_fold(base, s), pixel_ids=y*w+x,
    pass_idx=s, spp=spp, base_key=base.key). It cannot take the
    persistent route: `persistent=True` with it raises ValueError.

    Under a profiler (utils/tracing.py) the call is one `render` span, with
    `render.setup` (up to the integrator's first call) and
    `render.readback` (the film's copy to the host) inside it."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}")
    if sampler == "stratified":
        if persistent:
            raise ValueError("the stratified sampler takes the per-pass "
                             "route only (persistent=True)")
        persistent = False
    if variance:
        persistent = False
    with root("render"):
        with span("render.setup"):
            if hasattr(integrator, "prepare"):
                integrator.prepare(scene)
            cam = scene.camera
            w, h = cam.width, cam.height
            device = scene.device
            pix = torch.as_tensor(_pixel_grid(w, h), device=device)
            base = make_stream(seed, device)
            pid = pix[:, 1] * w + pix[:, 0]

        def pass_stream(s):
            stream = stream_fold(base, s)
            if sampler == "stratified":
                return StratifiedStream(inner=stream, pixel_ids=pid,
                                        pass_idx=s, spp=spp,
                                        base_key=base.key)
            return stream
        if hasattr(integrator, "compute_block") and persistent is not False:
            acc = accumulate_safe(integrator.compute_block(
                scene, pix, stream_fold(base, 0), spp))
            n_samples = spp
        elif hasattr(integrator, "compute_pixel"):
            chunk = max(1, min(spp_per_pass, spp))
            acc = torch.zeros((h * w, 3), dtype=torch.float32, device=device)
            acc2 = acc if variance else None
            n_samples = 0
            while n_samples < spp:
                part = torch.zeros_like(acc)
                part2 = part
                for k in range(chunk):
                    li = accumulate_safe(integrator.compute_pixel(
                        scene, pix, pass_stream(n_samples + k)))
                    if variance:
                        part2 = part2 + li * li
                    part = part + li
                acc = acc + part
                if variance:
                    acc2 = acc2 + part2
                n_samples += chunk
        else:
            raise NotImplementedError(
                f"{type(integrator).__name__} has no ported render route")
        with span("render.readback"):
            img = (acc.reshape(h, w, 3) / n_samples).cpu().numpy()
            film = Film(w, h)
            film.buffers["primal"] = img
            if variance:
                m2 = (acc2.reshape(h, w, 3).cpu().numpy()
                      - n_samples * img * img)
                film.buffers["mean"] = img
                film.buffers["variance"] = np.maximum(
                    m2 / max(n_samples - 1, 1), 0.0)
    return film


def render_splat(scene, integrator: SplattingIntegrator, spp: int,
                 seed: int = 0) -> Film:
    """Render with a splatting integrator on the scene's device.

    spp * w * h light paths in passes of min(total, w * h); pass p uses
    stream_fold(make_stream(seed), p). A pass's splats that are non-finite
    or negative are zeroed, the rest scatter-added (`index_add_`) into a
    film of its own, which is added to the sum as the reference groups its
    sum; the sum is scaled by w * h / paths at the end."""
    cam = scene.camera
    w, h = cam.width, cam.height
    total = spp * w * h
    n = min(total, w * h)
    device = scene.device
    base = make_stream(seed, device)
    acc = torch.zeros((h * w, 3), dtype=torch.float32, device=device)
    done = 0
    p = 0
    while done < total:
        pids, vals = integrator.trace_paths(scene, n, stream_fold(base, p))
        acc = acc + splat_add(torch.zeros_like(acc), pids,
                              accumulate_safe(vals))
        done += n
        p += 1
    img = acc.reshape(h, w, 3).cpu().numpy() * (w * h / done)
    film = Film(w, h)
    film.buffers["primal"] = img
    return film


def render_adaptive(scene, integrator, spp: int, seed: int = 0,
                    pilot_frac: float = 0.25, verbose: bool = False,
                    mesh=None) -> Film:
    """Variance-adaptive render on the scene's device: a pilot measures
    per-pixel noise, then the rest of the sample budget goes to the pixels
    in proportion to their standard deviation.

    The pilot is max(8, min(round(spp * pilot_frac), spp)) samples on the
    per-pass route (render(variance=True, persistent=False) in one pass).
    The allocation runs on the host, as the reference's: sigma, a 0.7 / 0.3
    blend with the uniform share, floor, then largest-remainder rounding,
    so that the budget (spp - pilot) * w * h is exact. The extra samples
    run in passes of w * h lanes, pass k drawing from stream_fold(
    make_stream(seed + 7919), k); padding lanes point past the film and
    are dropped. Unbiased: each pixel's estimate is the mean of its own
    samples, whose count depends on the pilot alone. The film holds the
    `spp` AOV (each pixel's sample count).

    `mesh` (parallel/mesh.py; every rank calls this) shards both phases as
    the JAX package does: the pilot through render_variance_sharded, then
    passes of w * h lanes rounded up to a multiple of the rank count, each
    through adaptive_step_sharded (shard d drawing from stream_fold(
    stream_fold(base, d), k), the ranks' films summed). The allocation
    runs on every rank's host, the same on each."""
    cam = scene.camera
    w, h = cam.width, cam.height
    n_pix = w * h
    # below a pilot of 8 the variance estimates misallocate against
    # fireflies; spp_per_pass=pilot renders exactly `pilot` samples
    pilot = max(8, min(int(round(spp * pilot_frac)), spp))
    if mesh is not None:
        from ..parallel import render_variance_sharded
        film = render_variance_sharded(scene, integrator, pilot, mesh=mesh,
                                       seed=seed, spp_per_pass=pilot)
    else:
        film = render(scene, integrator, pilot, seed=seed, variance=True,
                      persistent=False, spp_per_pass=pilot)
    extra_budget = (spp - pilot) * n_pix
    if extra_budget <= 0:
        return film

    var = film.buffers["variance"].mean(-1).reshape(-1)     # [n_pix]
    sigma = np.sqrt(np.maximum(var, 0.0)) + 1e-12
    # defensive blend: 30% of the budget stays uniform, since a small
    # pilot's variance estimates are themselves noisy
    share = 0.7 * sigma / sigma.sum() + 0.3 / n_pix
    alloc = share * extra_budget
    counts = np.floor(alloc).astype(np.int64)
    rem = int(extra_budget - counts.sum())
    if rem > 0:  # largest-remainder rounding keeps the budget exact
        frac = alloc - counts
        counts[np.argpartition(-frac, rem - 1)[:rem]] += 1

    pix = _pixel_grid(w, h)
    pix_list = np.repeat(pix, counts, axis=0)               # [extra_budget, 2]
    pids = (pix_list[:, 1].astype(np.int64) * w + pix_list[:, 0]).astype(
        np.int32)
    # passes of the base resolution's lane count, rounded up to a multiple
    # of the ranks on a mesh
    lanes = n_pix if mesh is None else n_pix + (-n_pix) % mesh.size
    n_total = pix_list.shape[0]
    pad = (-n_total) % lanes
    if pad:
        # padding lanes resample pixel 0 and splat past the film
        pix_list = np.concatenate([pix_list, np.tile(pix_list[:1], (pad, 1))])
        pids = np.concatenate([pids, np.full(pad, n_pix, np.int32)])
    n_passes = pix_list.shape[0] // lanes
    device = scene.device
    pix_d = torch.as_tensor(pix_list.reshape(n_passes, lanes, 2),
                            device=device)
    pid_d = torch.as_tensor(pids.reshape(n_passes, lanes), device=device)
    base = make_stream(seed + 7919, device)
    if mesh is None:
        def extra_pass(k):
            li = accumulate_safe(integrator.compute_pixel(
                scene, pix_d[k], stream_fold(base, k)))
            return splat_add(torch.zeros((n_pix + 1, 3), dtype=torch.float32,
                                         device=device), pid_d[k], li)[:n_pix]
    else:
        from ..parallel import adaptive_step_sharded

        def extra_pass(k):
            return adaptive_step_sharded(scene, integrator, mesh, n_pix,
                                         pix_d[k], pid_d[k], base, k)
    extra_sum = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
    t0 = time.time()
    for k in range(n_passes):
        extra_sum = extra_sum + extra_pass(k)
    extra = extra_sum.cpu().numpy().reshape(h, w, 3)
    if verbose:
        print(f"render_adaptive: pilot {pilot} spp + {n_total} adaptive "
              f"samples in {time.time() - t0:.2f}s (max/pixel "
              f"{pilot + counts.max()})")
    total = pilot + counts.reshape(h, w)
    img = (film.buffers["primal"] * pilot + extra) / total[..., None]
    out = Film(w, h)
    out.buffers["primal"] = img.astype(np.float32)
    out.buffers["spp"] = total[..., None].astype(np.float32)
    return out


def render_feature_aovs(scene, spp: int = 8, seed: int = 0) -> dict:
    """First-hit feature AOVs for external denoisers: `albedo`, `normal`
    and `depth`, each [h, w, 3] float32, averaged over `spp` jittered camera
    samples (sample s draws its pixel offsets from stream_fold(make_stream(
    seed), s)). albedo: the textured diffuse reflectance at the first hit,
    1 on smooth materials and emitters, 0 on a miss; normal: the world-space
    shading normal, averaged without renormalizing; depth: the first hit's
    distance in all three channels, 0 on a miss."""
    from ..accel import intersect_rays
    from ..bsdfs import bsdf_is_smooth
    from ..bsdfs.kernels import _gather, _present, diffuse_color
    from ..scene import fill_hit, generate_rays
    from ..utils.rng import stream_next2d

    cam = scene.camera
    w, h = cam.width, cam.height
    device = scene.device
    pix = torch.as_tensor(_pixel_grid(w, h), device=device)
    n = pix.shape[0]
    present = _present(scene.materials)
    base = make_stream(seed, device)
    alb_a = torch.zeros((n, 3), dtype=torch.float32, device=device)
    nrm_a = torch.zeros_like(alb_a)
    dep_a = torch.zeros(n, dtype=torch.float32, device=device)
    for s in range(spp):
        u_pix, _ = stream_next2d(stream_fold(base, s), (n,))
        o, d = generate_rays(scene.camera, pix.to(torch.float32) + u_pix)
        hit = fill_hit(scene, o, d, intersect_rays(scene.geom, o, d))
        v = hit.valid
        alb = diffuse_color(_gather(scene.materials, hit.mat), hit.uv,
                            present)
        one_alb = bsdf_is_smooth(scene.materials, hit.mat) | hit.is_light
        alb = torch.where(one_alb[:, None], 1.0, alb)
        alb_a = alb_a + torch.where(v[:, None], alb, 0.0)
        nrm_a = nrm_a + torch.where(v[:, None], hit.n_s, 0.0)
        dep_a = dep_a + torch.where(v, hit.t, 0.0)
    alb = alb_a.cpu().numpy().reshape(h, w, 3) / spp
    nrm = nrm_a.cpu().numpy().reshape(h, w, 3) / spp
    dep = np.repeat(dep_a.cpu().numpy().reshape(h, w, 1) / spp, 3, axis=-1)
    return {"albedo": alb.astype(np.float32),
            "normal": nrm.astype(np.float32),
            "depth": dep.astype(np.float32)}

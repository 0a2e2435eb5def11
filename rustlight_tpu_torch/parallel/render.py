"""Rendering over a device mesh; port of rustlight_tpu/parallel/render.py.

Each function runs on every rank of a mesh (parallel/mesh.py) and returns
the same result on every rank, as the JAX package's single-controller call
does. The decompositions, shards, padding and streams are the JAX
package's:

  P1 (image-block data parallelism): the pixel wavefront, padded with
     copies of the last pixel to a multiple of the rank count, splits into
     equal shards, shard d holding rows [d * per, (d + 1) * per); shard d's
     sample s draws on stream_fold(stream_fold(base, d), start + s), its
     persistent route on stream_fold(stream_fold(base, d), 0); the shards
     concatenate (`gather_rows`).
  P2/P6 (splatting and reduction): each rank splats its paths, drawn on
     stream_fold(stream_fold(base, d), pass), into a film of its own, and
     `sum_over_ranks` merges the films a pass.

Non-finite or negative samples are zeroed before accumulation. Scene tables
are replicated: every rank compiles the scene on its own device. The JAX
package's executable cache (`_STEP_CACHE`) has no counterpart: the ranks run
eagerly.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..integrators.common import _pixel_grid
from ..utils.film import Film, accumulate_safe, splat_add
from ..utils.rng import StratifiedStream, make_stream, stream_fold
from .mesh import Mesh, gather_rows, make_device_mesh, sum_over_ranks


def _padded_grid(w: int, h: int, n_dev: int) -> np.ndarray:
    """The pixel grid padded with copies of its last pixel to a multiple of
    n_dev lanes."""
    pix = _pixel_grid(w, h)
    pad = (-pix.shape[0]) % n_dev
    if pad:
        pix = np.concatenate([pix, np.tile(pix[-1:], (pad, 1))], 0)
    return pix


def _local(mesh: Mesh, x):
    """This rank's shard of a lane array whose length is a multiple of the
    rank count."""
    lo, hi = mesh.shard(x.shape[0])
    return x[lo:hi]


def render_step_sharded(scene, integrator, mesh: Mesh, pix_sharded,
                        seed: int = 0, spp_per_pass: int = 1,
                        sampler: str = "independent", spp_total: int = None,
                        start_idx: int = 0, base=None, with_sq: bool = False):
    """One sharded step of `spp_per_pass` samples over pix_sharded [n_dev *
    lanes, 2] (every rank's copy; it renders its shard): the gathered
    radiance sums [n_dev * lanes, 3], and with `with_sq` also the sums of
    squares. Sample s of shard d draws on stream_fold(stream_fold(base, d),
    start_idx + s); `sampler="stratified"` wraps it in a StratifiedStream
    keyed by (pixel id, global pass index), as the single-device render."""
    dev = scene.device
    base = make_stream(seed, dev) if base is None else base
    pix = torch.as_tensor(_local(mesh, pix_sharded), device=dev)
    pid = pix[:, 1] * scene.camera.width + pix[:, 0]
    d_base = stream_fold(base, mesh.rank)
    acc = torch.zeros((pix.shape[0], 3), dtype=torch.float32, device=dev)
    acc2 = torch.zeros_like(acc) if with_sq else None
    for s in range(spp_per_pass):
        stream = stream_fold(d_base, start_idx + s)
        if sampler == "stratified":
            stream = StratifiedStream(inner=stream, pixel_ids=pid,
                                      pass_idx=start_idx + s,
                                      spp=spp_total or spp_per_pass,
                                      base_key=base.key)
        li = accumulate_safe(integrator.compute_pixel(scene, pix, stream))
        if with_sq:
            acc2 = acc2 + li * li
        acc = acc + li
    acc = gather_rows(mesh, acc)
    return (acc, gather_rows(mesh, acc2)) if with_sq else acc


def render_block_sharded(scene, integrator, mesh: Mesh, pix_sharded,
                         spp: int, seed: int = 0, base=None):
    """The persistent route sharded: each rank runs compute_block over its
    shard, all spp at once, on stream_fold(stream_fold(base, d), 0); the
    gathered sums [n_dev * lanes, 3]."""
    dev = scene.device
    base = make_stream(seed, dev) if base is None else base
    pix = torch.as_tensor(_local(mesh, pix_sharded), device=dev)
    stream = stream_fold(stream_fold(base, mesh.rank), 0)
    acc = accumulate_safe(integrator.compute_block(scene, pix, stream, spp))
    return gather_rows(mesh, acc)


def splat_step_sharded(scene, integrator, mesh: Mesh, n_per_dev: int,
                       seed: int = 0, pass_idx: int = 0, base=None):
    """One sharded splatting pass: each rank traces n_per_dev light paths
    on stream_fold(stream_fold(base, d), pass_idx) into a film of its own,
    and the films are summed over the ranks. Returns the merged [h * w, 3]
    film of unnormalized sums."""
    dev = scene.device
    cam = scene.camera
    base = make_stream(seed, dev) if base is None else base
    stream = stream_fold(stream_fold(base, mesh.rank), pass_idx)
    pids, vals = integrator.trace_paths(scene, n_per_dev, stream)
    film = splat_add(torch.zeros((cam.width * cam.height, 3),
                                 dtype=torch.float32, device=dev), pids,
                     accumulate_safe(vals))
    return sum_over_ranks(mesh, film)


def render_splat_sharded(scene, integrator, n_paths: int,
                         mesh: Optional[Mesh] = None, seed: int = 0,
                         paths_per_pass: Optional[int] = None,
                         verbose: bool = False) -> Film:
    """The sharded splatting render (light tracing): n_paths light paths
    split evenly over the ranks, passes of ceil(per_pass / n_dev) paths a
    rank (per_pass = paths_per_pass or min(n_paths, n_dev * w * h)), the
    films merged a pass, the sum scaled by w * h / paths traced."""
    mesh = make_device_mesh(device=scene.device) if mesh is None else mesh
    n_dev = mesh.size
    cam = scene.camera
    w, h = cam.width, cam.height
    per_pass = paths_per_pass or min(n_paths, n_dev * w * h)
    n_per_dev = max(1, -(-per_pass // n_dev))
    base = make_stream(seed, scene.device)
    acc = torch.zeros((h * w, 3), dtype=torch.float32, device=scene.device)
    t0 = time.time()
    done = p = 0
    while done < n_paths:
        acc = acc + splat_step_sharded(scene, integrator, mesh, n_per_dev,
                                       pass_idx=p, base=base)
        done += n_per_dev * n_dev
        p += 1
    img = acc.reshape(h, w, 3).cpu().numpy() * (w * h / done)
    if verbose:
        print(f"render_splat_sharded[{n_dev}dev]: {done} paths "
              f"in {time.time() - t0:.2f}s")
    film = Film(w, h)
    film.buffers["primal"] = img
    return film


def _chunked(scene, integrator, mesh, pix, spp, spp_per_pass, sampler, base,
             with_sq):
    """The chunked passes of render_sharded / render_variance_sharded:
    (sums, sums of squares or None, samples)."""
    chunk = max(1, min(spp_per_pass, spp))
    n = pix.shape[0]
    dev = scene.device
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    acc2 = torch.zeros_like(acc) if with_sq else None
    done = 0
    while done < spp:
        out = render_step_sharded(scene, integrator, mesh, pix,
                                  spp_per_pass=chunk, sampler=sampler,
                                  spp_total=spp, start_idx=done, base=base,
                                  with_sq=with_sq)
        if with_sq:
            acc = acc + out[0]
            acc2 = acc2 + out[1]
        else:
            acc = acc + out
        done += chunk
    return acc, acc2, done


def render_sharded(scene, integrator, spp: int, mesh: Optional[Mesh] = None,
                   seed: int = 0, spp_per_pass: int = 8,
                   verbose: bool = False, persistent: bool = None,
                   sampler: str = "independent") -> Film:
    """The sharded render: pixels split over the ranks, spp in chunked
    passes, or in one persistent wavefront a rank where the integrator has
    compute_block. `persistent=None` takes the persistent route wherever
    compute_block exists and the sampler is independent (the port's rule
    for render, on every device)."""
    mesh = make_device_mesh(device=scene.device) if mesh is None else mesh
    w, h = scene.camera.width, scene.camera.height
    n = w * h
    pix = _padded_grid(w, h, mesh.size)
    if persistent is None:
        persistent = sampler == "independent"
    if hasattr(integrator, "prepare"):
        integrator.prepare(scene)
    base = make_stream(seed, scene.device)
    t0 = time.time()
    if persistent and hasattr(integrator, "compute_block"):
        acc = render_block_sharded(scene, integrator, mesh, pix, spp,
                                   base=base)
        done = spp
    else:
        acc, _, done = _chunked(scene, integrator, mesh, pix, spp,
                                spp_per_pass, sampler, base, False)
    if verbose:
        print(f"render_sharded[{mesh.size}dev]: {done} spp in "
              f"{time.time() - t0:.2f}s")
    film = Film(w, h)
    film.buffers["primal"] = (acc[:n].reshape(h, w, 3) / done).cpu().numpy()
    return film


def render_variance_sharded(scene, integrator, spp: int,
                            mesh: Optional[Mesh] = None, seed: int = 0,
                            spp_per_pass: int = 8,
                            sampler: str = "independent") -> Film:
    """The sharded chunked render with per-sample second moments: the mesh
    form of render(variance=True), with the `mean` and `variance` AOVs
    (render_adaptive's pilot on a mesh)."""
    mesh = make_device_mesh(device=scene.device) if mesh is None else mesh
    w, h = scene.camera.width, scene.camera.height
    n = w * h
    pix = _padded_grid(w, h, mesh.size)
    if hasattr(integrator, "prepare"):
        integrator.prepare(scene)
    base = make_stream(seed, scene.device)
    acc, acc2, done = _chunked(scene, integrator, mesh, pix, spp,
                               spp_per_pass, sampler, base, True)
    img = acc[:n].reshape(h, w, 3).cpu().numpy() / done
    m2 = acc2[:n].reshape(h, w, 3).cpu().numpy() - done * img * img
    film = Film(w, h)
    film.buffers["primal"] = img
    film.buffers["mean"] = img
    film.buffers["variance"] = np.maximum(m2 / max(done - 1, 1), 0.0)
    return film


def adaptive_step_sharded(scene, integrator, mesh: Mesh, n_pix: int,
                          pix_lanes, pid_lanes, base, pass_idx: int):
    """One sharded adaptive pass: the lanes (every rank's copy, a multiple
    of the rank count) split into shards, shard d draws on stream_fold(
    stream_fold(base, d), pass_idx) and splats into an [n_pix, 3] film of
    its own (padding lanes carry pid == n_pix and are dropped); the films
    are summed over the ranks."""
    dev = scene.device
    pix = torch.as_tensor(_local(mesh, pix_lanes), device=dev)
    pid = torch.as_tensor(_local(mesh, pid_lanes), device=dev)
    stream = stream_fold(stream_fold(base, mesh.rank), pass_idx)
    li = accumulate_safe(integrator.compute_pixel(scene, pix, stream))
    film = splat_add(torch.zeros((n_pix + 1, 3), dtype=torch.float32,
                                 device=dev), pid, li)[:n_pix]
    return sum_over_ranks(mesh, film)

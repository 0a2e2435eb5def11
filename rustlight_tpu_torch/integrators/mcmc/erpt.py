"""Energy-redistribution path tracing (ERPT); port of
rustlight_tpu/integrators/mcmc/erpt.py.

Per pixel, `nb_mc` exploration rounds; each contributive exploration sample
spawns chains of small-step (Kelemen) mutations that redistribute its
energy under the equal-deposit rule w0 = b / (chains_per_pixel *
chain_samples). Spawning is data-dependent in the reference
(floor(mean + u) chains); here each exploration lane has `poisson_slots`
chain slots: slot s runs a chain with probability clip(mean - s, 0, 1), and
the last slot carries the weighted spawn of the tail, so the expectation is
the reference's. With `stratified`, the exploration sample's pixel dims
are remapped onto the lane's own pixel.

Round r draws on stream_fold(base, r): u (n, d), then for each slot
u_spawn (n,) and, a chain step, um (n, d) and ua (n,). The normalization
takes nb_samples_norm // (w h) batches on stream_fold(base, 900 + i).
On a device mesh (parallel/mesh.py) the lanes are padded to a multiple of
the ranks with lanes that never spawn (`live` False), rank d runs lanes
[d L / n, (d + 1) L / n) on stream_fold(stream_fold(base, d), r), and each
round's films are summed over the ranks, as the JAX package's shard_map
and psum; the normalization runs on every rank alike.
With `record_accepts`, `render` keeps on the host every lane's acceptance
masks, `self.accepts` ([nb_mc * poisson_slots, chain_samples, w h] bool: a
lane's decisions whether or not its chain was spawned, which only gates its
splats), the pixels it splatted, `self.visits` ([..., chain_samples + 1,
w h]: a step's discarded state, then the flush), and its tf, `self.tfs`
([..., chain_samples + 1, w h]: the exploration sample's, then each step's
proposal's).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...samplers.pss import kelemen_mutate
from ...utils.film import Film, splat_add
from ...utils.rng import make_stream, stream_fold, stream_next
from .pssmlt import flush, metropolis_step, sample_fn


class IntegratorERPT:
    def __init__(self, integrator, nb_mc: int = 1, chain_samples: int = 100,
                 stratified: bool = True, nb_samples_norm: int = 65536,
                 pss_dims: Optional[int] = None, poisson_slots: int = 1):
        self.integrator = integrator
        self.nb_mc = nb_mc
        self.chain_samples = chain_samples
        self.stratified = stratified
        self.nb_samples_norm = nb_samples_norm
        self.poisson_slots = max(1, poisson_slots)
        cap = getattr(integrator, "hard_cap", 16)
        self.pss_dims = pss_dims or (4 + 6 * cap)
        self.record_accepts = False
        self.accepts = self.visits = self.tfs = None

    def _sample_fn(self, scene, u):
        return sample_fn(self.integrator, scene, u)

    def normalization(self, scene, base) -> float:
        """b: the mean of tf over max(1, nb_samples_norm // (w h)) batches
        of w h samples."""
        n = scene.camera.width * scene.camera.height
        tfs = []
        for i in range(max(1, self.nb_samples_norm // n)):
            u, _ = stream_next(stream_fold(base, 900 + i), (n, self.pss_dims))
            tfs.append(float(torch.mean(self._sample_fn(scene, u)[2])))
        b = float(np.mean(tfs))
        if b <= 0:
            raise RuntimeError("ERPT normalization is zero")
        return b

    def render(self, scene, spp: int, seed: int = 0, mesh=None) -> Film:
        w, h = scene.camera.width, scene.camera.height
        n, d = w * h, self.pss_dims
        dev = scene.device
        base = make_stream(seed, dev)
        chains_per_pixel = max(1, spp - self.nb_mc) / self.chain_samples
        b = self.normalization(scene, base)
        lane = torch.arange(n, device=dev)
        px = torch.remainder(lane, w).to(torch.float32)
        py = (lane // w).to(torch.float32)
        live = None
        if mesh is not None:
            # dead padding lanes never spawn chains nor deposit energy
            pad = (-n) % mesh.size
            z = torch.zeros(pad, dtype=torch.float32, device=dev)
            lo, hi = mesh.shard(n + pad)
            px, py = torch.cat([px, z])[lo:hi], torch.cat([py, z])[lo:hi]
            live = (torch.arange(n + pad, device=dev) < n)[lo:hi]
            base = stream_fold(base, mesh.rank)
            from ...parallel.mesh import gather_axis, sum_over_ranks
        record = ([], [], []) if self.record_accepts else None
        acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        for r in range(self.nb_mc):
            film = self._round(scene, stream_fold(base, r), px, py, b,
                               chains_per_pixel, record, live)
            acc = acc + (film if mesh is None else sum_over_ranks(mesh, film))
        if record is not None:
            self.accepts, self.visits, self.tfs = (
                torch.stack([torch.stack(c) for c in x]).cpu()
                for x in record)
            if mesh is not None:
                self.accepts, self.visits, self.tfs = (
                    gather_axis(mesh, x, 2)
                    for x in (self.accepts, self.visits, self.tfs))
            self.accepts, self.visits, self.tfs = (
                x.numpy() for x in (self.accepts, self.visits, self.tfs))
        film = Film(w, h)
        film.buffers["primal"] = acc.reshape(h, w, 3).cpu().numpy()
        return film

    def _round(self, scene, stream, px, py, b, chains_per_pixel, record,
               live=None):
        """One exploration round over the lanes at pixels (px, py): its
        film. `record` (or None) collects each slot's acceptance masks,
        splatted pixels and tf; lanes where `live` is False spawn no
        chain."""
        w, h = scene.camera.width, scene.camera.height
        nl, d = px.shape[0], self.pss_dims
        u, stream = stream_next(stream, (nl, d))
        if self.stratified:
            # the exploration pixel is the lane's own, the draw its
            # sub-pixel position
            u = torch.cat([((u[:, 0] + px) / w)[:, None],
                           ((u[:, 1] + py) / h)[:, None], u[:, 2:]], dim=1)
        pid0, col0, tf0 = self._sample_fn(scene, u)
        mean_chains = (tf0 / b) * (chains_per_pixel / self.nb_mc)
        w_base = b / (chains_per_pixel * self.chain_samples)
        film = torch.zeros((w * h, 3), dtype=torch.float32,
                           device=scene.device)
        slots = self.poisson_slots
        for s in range(slots):
            u_spawn, stream = stream_next(stream, (nl,))
            if s < slots - 1:
                p_s = torch.clamp(mean_chains - s, 0.0, 1.0)
                w0 = w_base
            else:
                rest = torch.clamp(mean_chains - s, min=0.0)
                p_s = torch.clamp(rest, 0.0, 1.0)
                w0 = w_base * torch.where(
                    p_s > 0, rest / torch.clamp(p_s, min=1e-20), 0.0)
            spawn = (u_spawn < p_s) & (tf0 > 0.0)
            if live is not None:
                spawn = spawn & live
            # one chain a spawned lane, small steps only
            state = (u, pid0, col0, tf0, torch.zeros_like(tf0))
            accepts, visits, tfs = [], [], [tf0]
            for _ in range(self.chain_samples):
                um, stream = stream_next(stream, (nl, d))
                ua, stream = stream_next(stream, (nl,))
                u_prop = kelemen_mutate(state[0], um)
                prop = (u_prop,) + tuple(self._sample_fn(scene, u_prop))
                state, (spid, val), acc = metropolis_step(state, prop, ua,
                                                          w0, spawn)
                splat_add(film, spid, val)
                if record is not None:
                    accepts.append(acc)
                    visits.append(spid)
                    tfs.append(prop[3])
            flush(film, state, w0, spawn)
            if record is not None:
                record[0].append(accepts)
                record[1].append(visits + [state[1]])
                record[2].append(tfs)
        return film

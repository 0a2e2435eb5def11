"""Primary-sample-space Metropolis light transport (PSSMLT, Kelemen MLT);
port of rustlight_tpu/integrators/mcmc/pssmlt.py.

The target function is a pixel integrator evaluated at a primary-sample
vector: dims 0-1 choose the pixel, the rest drive the path (an ArrayStream
from dim 2). Thousands of chains advance in lockstep, one dense vector a
chain. The algorithm: a normalization estimate b over nb_samples_norm
samples, a seed cdf proportional to tf = mean(rgb), stratified seed
selection, large steps with probability large_prob and Kelemen mutations
otherwise, waste recycling (the discarded state splats with its weight,
`index_add_`), the final states flushed, and the film rescaled by
b / its mean.

Each chain step draws, in order, ul (c,), uf (c, d), um (c, d) and ua (c,)
on stream_fold(base, 77). On a device mesh (parallel/mesh.py) the chain
count is rounded down to a multiple of the ranks, the seeds are drawn and
picked on every rank alike, rank d evolves chains [d c / n, (d + 1) c / n)
on stream_fold(stream_fold(base, d), 77) into a film of its own, and the
films are summed over the ranks before the rescale, as the JAX package's
shard_map and psum. With `record_accepts`, `render` keeps on the host
the chains' acceptance masks, `self.accepts` ([1, steps, c] bool), the
pixels they splatted, `self.visits` ([1, steps + 1, c]: a step's discarded
state, then the flush), and their tf, `self.tfs` ([1, steps + 1, c]: the
seed's, then each step's proposal's), so that two runs can be compared
chain by chain.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...samplers.pss import kelemen_mutate
from ...utils.distribution import build_distribution_1d
from ...utils.film import Film, splat_add
from ...utils.rng import ArrayStream, make_stream, stream_fold, stream_next


def sample_fn(integrator, scene, u):
    """PSS vectors u [c, d] -> (pixel ids, radiance [c, 3], tf): the pixel
    from u[:, 0:2], the path from an ArrayStream at column 2; non-finite
    radiance is zeroed, tf = (r + g + b) / 3."""
    cam = scene.camera
    x = torch.clamp((u[:, 0] * cam.width).to(torch.int32), 0, cam.width - 1)
    y = torch.clamp((u[:, 1] * cam.height).to(torch.int32), 0,
                    cam.height - 1)
    li = integrator.compute_pixel(scene, torch.stack([x, y], dim=-1),
                                  ArrayStream(values=u, counter=2))
    li = torch.where(torch.all(torch.isfinite(li), -1, keepdim=True), li, 0.0)
    # the mean in a fixed order, the same on every device
    return y * cam.width + x, li, (li[:, 0] + li[:, 1] + li[:, 2]) / 3.0


def metropolis_step(state, prop, ua, w0=1.0, spawn=None):
    """The Metropolis decision and waste recycling shared by PSSMLT and
    ERPT. `state` and `prop` are (u, pid, col, tf) of the current and the
    proposed states, `state` with its weight `wgt` as a fifth entry.
    Returns (the new state, the splat (pid, value), the acceptance mask);
    the splat is the state being discarded, weighted by its share of the
    visits, times w0, zero where `spawn` is False."""
    u, pid, col, tf, wgt = state
    u_p, pid_p, col_p, tf_p = prop
    a = torch.clamp(tf_p / torch.clamp(tf, min=1e-30), max=1.0)
    a = torch.where(tf_p > 0.0, a, 0.0)
    w_cur = wgt + (1.0 - a)
    accept = ua < a
    spl_pid = torch.where(accept, pid, pid_p)
    spl_col = torch.where(accept[:, None], col, col_p)
    spl_tf = torch.where(accept, tf, tf_p)
    spl_w = torch.where(accept, w_cur, a)
    val = spl_col * (w0 * spl_w / torch.clamp(spl_tf, min=1e-30))[:, None]
    ok = spl_tf > 0.0 if spawn is None else spawn & (spl_tf > 0.0)
    val = torch.where(ok[:, None], val, 0.0)
    new = (torch.where(accept[:, None], u_p, u),
           torch.where(accept, pid_p, pid),
           torch.where(accept[:, None], col_p, col),
           torch.where(accept, tf_p, tf),
           torch.where(accept, a, w_cur))
    return new, (spl_pid, val), accept


def flush(film, state, w0=1.0, spawn=None):
    """Splat the chains' final states with their weights into `film`."""
    _, pid, col, tf, wgt = state
    val = col * (w0 * wgt / torch.clamp(tf, min=1e-30))[:, None]
    ok = tf > 0.0 if spawn is None else spawn & (tf > 0.0)
    return splat_add(film, pid, torch.where(ok[:, None], val, 0.0))


class IntegratorPSSMLT:
    """Wraps a pixel integrator (`compute_pixel`) as the MCMC target."""

    def __init__(self, integrator, large_prob: float = 0.3,
                 nb_samples_norm: int = 100_000,
                 nb_chains: int = 65536,
                 pss_dims: Optional[int] = None):
        self.integrator = integrator
        self.large_prob = large_prob
        self.nb_samples_norm = nb_samples_norm
        self.nb_chains = nb_chains
        cap = getattr(integrator, "hard_cap", 16)
        # 2 pixel dims + 2 jitter + 6 a bounce (NEE 3, bsdf 2, rr 1)
        self.pss_dims = pss_dims or (4 + 6 * cap)
        self.record_accepts = False
        self.accepts = self.visits = self.tfs = None

    def _sample_fn(self, scene, u):
        return sample_fn(self.integrator, scene, u)

    def seed_chains(self, scene, base, c: Optional[int] = None):
        """The normalization b and the initial states of c chains (by
        default nb_chains): batches of c samples on stream_fold(base, 1000 +
        i), seeds picked by searchsorted(cdf, (i + 0.5) / c, right) - 1 over
        the pool's build_distribution_1d. Returns (b, u0, tf0, seed
        indices)."""
        c, d = c or self.nb_chains, self.pss_dims
        n_batches = max(1, (self.nb_samples_norm + c - 1) // c)
        seeds_u, seeds_tf = [], []
        for i in range(n_batches):
            u, _ = stream_next(stream_fold(base, 1000 + i), (c, d))
            seeds_u.append(u)
            seeds_tf.append(self._sample_fn(scene, u)[2])
        seeds_u = torch.cat(seeds_u, 0)
        seeds_tf = torch.cat(seeds_tf, 0)
        b = float(torch.mean(seeds_tf))
        if b <= 0.0:
            raise RuntimeError("PSSMLT normalization is zero: no light found")
        cdf = build_distribution_1d(seeds_tf).cdf
        idv = (torch.arange(c, dtype=torch.float32, device=base.device)
               + 0.5) / c
        sidx = torch.clamp(torch.searchsorted(cdf, idv, right=True) - 1, 0,
                           seeds_tf.shape[0] - 1)
        return b, seeds_u[sidx], seeds_tf[sidx], sidx

    def render(self, scene, spp: int, seed: int = 0, mesh=None) -> Film:
        w, h = scene.camera.width, scene.camera.height
        c = self.nb_chains
        if mesh is not None:
            c = max(1, c // mesh.size) * mesh.size    # even chain shards
        steps = max(1, spp * w * h // c)
        base = make_stream(seed, scene.device)
        b, u0, tf0, _ = self.seed_chains(scene, base, c)
        stream = stream_fold(base, 77)
        if mesh is not None:
            lo, hi = mesh.shard(c)
            u0, tf0 = u0[lo:hi], tf0[lo:hi]
            stream = stream_fold(stream_fold(base, mesh.rank), 77)
        film = self.evolve(scene, u0, tf0, stream, steps)
        if mesh is not None:
            from ...parallel.mesh import gather_axis, sum_over_ranks
            film = sum_over_ranks(mesh, film)
            if self.record_accepts:
                self.accepts, self.visits, self.tfs = (
                    gather_axis(mesh, torch.as_tensor(x), 2).numpy()
                    for x in (self.accepts, self.visits, self.tfs))
        img = film.reshape(h, w, 3).cpu().numpy()
        # the final rescale to absolute units
        avg_lum = img.mean()
        if avg_lum > 0:
            img = img * (b / avg_lum)
        out = Film(w, h)
        out.buffers["primal"] = img
        return out

    def evolve(self, scene, u0, tf0, stream, steps: int):
        """`steps` steps of the chains seeded at u0 [c, d] (tf0 their tf)
        drawing from `stream`, then the flush: the [h * w, 3] film of their
        splats."""
        w, h = scene.camera.width, scene.camera.height
        c, d = u0.shape
        pid0, col0, _ = self._sample_fn(scene, u0)
        film = torch.zeros((h * w, 3), dtype=torch.float32,
                           device=scene.device)
        state = (u0, pid0, col0, tf0, torch.zeros_like(tf0))
        accepts, visits, tfs = [], [], [tf0]
        for _ in range(steps):
            ul, stream = stream_next(stream, (c,))
            uf, stream = stream_next(stream, (c, d))
            um, stream = stream_next(stream, (c, d))
            ua, stream = stream_next(stream, (c,))
            u_prop = torch.where((ul < self.large_prob)[:, None], uf,
                                 kelemen_mutate(state[0], um))
            prop = (u_prop,) + tuple(self._sample_fn(scene, u_prop))
            state, (spid, val), acc = metropolis_step(state, prop, ua)
            splat_add(film, spid, val)
            if self.record_accepts:
                accepts.append(acc)
                visits.append(spid)
                tfs.append(prop[3])
        flush(film, state)
        if self.record_accepts:
            self.accepts, self.visits, self.tfs = (
                torch.stack(x)[None].cpu().numpy()
                for x in (accepts, visits + [state[1]], tfs))
        return film

"""Stratified MCMC (SMCMC, Gruson et al.): one chain a pixel tile with
neighbour replica exchange; port of rustlight_tpu/integrators/mcmc/smcmc.py.

Each pixel owns a chain whose state is a primary-sample vector evaluated
over the 5-pixel cross centred there (`generate_state`: one [5 n] wavefront
replays the same vector at each cross pixel). The schedule alternates
MCMC / H0 / MCMC / V0 / MCMC / H1 / MCMC / V1: an MCMC step proposes a large
step (probability large_prob, or forced while the chain has no state with
light) or a Kelemen mutation whose pixel-jitter dims are drawn afresh, and
splats the discarded state with waste recycling; an exchange step swaps
states between even / odd neighbour pairs along x or y and accepts jointly
with min(1, tf0' tf1' / (tf0 tf1)), the pair sharing the even lane's
uniform. tf sums the channel maxima over the cross, in a fixed order.

Initialization: 'independent' (init_spp uniform attempts a tile) or
'mcmc' (m roaming chains seeded from the tiles' flux cdf, which move in
image space for init_chain_length steps and deposit their states into the
tiles they visit reservoir-style). Reconstruction: 'naive' overlap
averaging or the IRLS overlap-consistency solve (`irls_reconstruction`, in
float64 on the render's device).

Draws, on stream_fold(make_stream(seed), 31337): the init's u0 (n, d),
then (independent) init_spp - 1 more (n, d), or (mcmc) uc (m,) and, each
roaming step, key (m,), ur (n,), r2 (m, 2), um (m, d), u01 (m, 2), ua
(m,); then each MCMC step ul (n,), uf (n, d), um (n, d), u01 (n, 2), ua
(n,) and each exchange step ua (n,). The schedule is a Python loop over the
steps with no host read inside.

The reservoir update: a tile visited by k roaming chains replaces its
state with probability k / (visits so far) by the visitor of the largest
key; where two visitors of one tile draw the same key, the one of the
highest chain index wins (the JAX package's CPU scatter keeps the last
update, the same chain).

With `record_accepts`, `render` keeps on the host every tile chain's
decision a step, `self.accepts` ([1, spp, n] bool), and its tf,
`self.tfs` ([1, spp + 1, n]: the initial state's, then each step's
proposal's), the tf of each init attempt, `self.init_tfs` ([init_spp, n],
or [1, n] for the mcmc init: the seeding draw's), and the roaming chains'
decisions, `self.init_accepts` ([init_chain_length, m] bool, or None for
the independent init), so that two runs can be compared chain by chain;
and the flushed accumulators, `self.flushed` (a Carry on the render's
device), so that their reconstructions can be compared apart.
`keep_chains` carries the whole chain state across render() calls (each
call then returns the cumulative reconstruction); `state_dict` /
`load_state_dict` dump and restore it.

On a device mesh (parallel/mesh.py) the tile chains split into row bands
(np.array_split of the rows, so bands may be uneven). Each rank steps its
band with a lane window on the stream, so that its draws are its lanes'
slice of the single-device draws; the vertical replica exchange takes its
partner rows through `halo_rows` (one boundary row each way), the
horizontal one stays local. The mcmc init (whose roaming chains deposit
anywhere) runs whole on every rank and each keeps its band; the
independent init runs on the band. The flushed accumulators are gathered
and reconstructed whole on every rank (the IRLS solve included);
`exchange_moved` counts the elements the steps' collectives sent.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ...samplers.pss import kelemen_mutate
from ...utils.distribution import _prefix_sum
from ...utils.film import Film
from ...utils.rng import (ArrayStream, make_stream, stream_fold, stream_next,
                          with_window)

# cross offsets; slot 0 is the tile centre (the reference's Tile::pixels)
_CROSS = [(0, 0), (-1, 0), (0, -1), (1, 0), (0, 1)]
SCHEDULE = (None, ("h", 0), None, ("v", 0), None, ("h", 1), None, ("v", 1))


class Carry(NamedTuple):
    """The tile chains' state and accumulators, one row a pixel."""
    u: torch.Tensor        # [n, d] primary samples
    tf: torch.Tensor       # [n]
    col: torch.Tensor      # [n, 5, 3] the state's radiance at the cross
    wgt: torch.Tensor      # [n] waste-recycling weight
    acc_v: torch.Tensor    # [n, 5, 3] the splats, normalized by tf
    acc_mc: torch.Tensor   # [n, 5, 3] the large steps' plain MC sum
    nb_s: torch.Tensor     # [n] int32 splats
    b_acc: torch.Tensor    # [n] the large steps' tf sum
    nb_u: torch.Tensor     # [n] int32 large steps


class Layout(NamedTuple):
    """The image's tile geometry on the render's device: every tile, or on
    a mesh the tiles of this rank's rows."""
    w: int
    h: int
    px: torch.Tensor            # [n] int64
    py: torch.Tensor            # [n] int64
    cross_valid: torch.Tensor   # [n, 5] bool
    cross_pid: torch.Tensor     # [n, 5] int64, clipped to the image
    cross_all: torch.Tensor     # [5 n, 2] int32 pixel coordinates
    mesh: Any = None            # the mesh whose row band this is


def _cross(px, py, w, h):
    """The 5-pixel crosses centred at (px, py) [m]: their pixels, clipped
    to the image, slot-major [5, m, 2], and which lie inside [m, 5]."""
    pix, valid = [], []
    for dx, dy in _CROSS:
        cx, cy = px + dx, py + dy
        valid.append((cx >= 0) & (cx < w) & (cy >= 0) & (cy < h))
        pix.append(torch.stack([torch.clamp(cx, 0, w - 1),
                                torch.clamp(cy, 0, h - 1)], -1))
    return torch.stack(pix), torch.stack(valid, 1)


def make_layout(w, h, device, rows=None, mesh=None) -> Layout:
    """The layout of every tile, or of the tiles of `rows` [r0, r1) (the
    band of `mesh`)."""
    r0, r1 = (0, h) if rows is None else rows
    lane = torch.arange(r0 * w, r1 * w, device=device)
    px, py = torch.remainder(lane, w), lane // w
    pix, valid = _cross(px, py, w, h)
    return Layout(w=w, h=h, px=px, py=py, cross_valid=valid,
                  cross_pid=(pix[..., 1] * w + pix[..., 0]).T,
                  cross_all=pix.reshape(-1, 2).to(torch.int32), mesh=mesh)


def _sum5(x):
    """Sum over the last axis of 5, left to right on every device."""
    return (((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]) + x[..., 4]


def mutate_smcmc(u, r, fresh01):
    """Kelemen everywhere, the pixel-jitter dims 0-1 drawn afresh."""
    return torch.cat([fresh01, kelemen_mutate(u, r)[:, 2:]], dim=1)


def _recycle(acc_v, accept, col, tf, col_p, tf_p, w_cur, a, gate=None):
    """Waste recycling: acc_v plus the state being discarded (the current
    one where the proposal is accepted, else the proposal) weighted by its
    share of the visits over its tf; nothing where its tf is 0 or `gate`
    is False."""
    spl_col = torch.where(accept[:, None, None], col, col_p)
    spl_tf = torch.where(accept, tf, tf_p)
    spl_w = torch.where(accept, w_cur, a)
    good = spl_tf > 0.0 if gate is None else (spl_tf > 0.0) & gate
    return acc_v + torch.where(
        good[:, None, None],
        spl_col * (spl_w / torch.clamp(spl_tf, min=1e-30))[:, None, None],
        0.0)


def reservoir_update(n, pid, key, ur, nb_visit, tiles, chains):
    """One batch reservoir deposit of the roaming chains (MCMCInit,
    smcmc.rs:974-1172): each tile visited by k chains this step replaces its
    state with probability k / (nb_visit + k) by the visitor of the largest
    key (ties: the highest chain index), if that visitor carries light.
    `tiles` and `chains` are (u, tf, col). Returns (tiles, nb_visit +
    visits)."""
    m = pid.shape[0]
    dev = pid.device
    visits = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
        0, pid, torch.ones(m, dtype=torch.float32, device=dev))
    nb_new = nb_visit + visits
    keymax = torch.full((n,), -1.0, dtype=torch.float32,
                        device=dev).scatter_reduce_(0, pid, key, "amax")
    winner = key == keymax[pid]
    repl = (visits > 0.0) & (ur < visits / torch.clamp(nb_new, min=1.0))
    ch_u, ch_tf, ch_col = chains
    sel = winner & repl[pid] & (ch_tf > 0.0)
    tgt = torch.where(sel, pid, n)
    who = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    who = who.scatter_reduce_(0, tgt, torch.arange(m, device=dev),
                              "amax")[:n]
    take = who >= 0
    j = torch.clamp(who, min=0)
    t_u, t_tf, t_col = tiles
    tiles = (torch.where(take[:, None], ch_u[j], t_u),
             torch.where(take, ch_tf[j], t_tf),
             torch.where(take[:, None, None], ch_col[j], t_col))
    return tiles, nb_new


class IntegratorSMCMC:
    def __init__(self, integrator, large_prob: float = 0.3,
                 recons: str = "naive", pss_dims: Optional[int] = None,
                 init: str = "independent", init_spp: int = 4,
                 init_chain_length: int = 25, init_spp_mcmc: int = 2,
                 keep_chains: bool = False):
        if init not in ("independent", "mcmc"):
            raise ValueError(f"unknown init {init!r}")
        if recons not in ("naive", "irls"):
            raise ValueError(f"unknown reconstruction {recons!r}")
        self.integrator = integrator
        self.large_prob = large_prob
        self.recons = recons
        self.init = init
        self.init_spp = init_spp
        self.init_chain_length = init_chain_length
        self.init_spp_mcmc = init_spp_mcmc
        # keep_chains: the chain state persists across render() calls, each
        # of which continues the chains and returns the cumulative
        # reconstruction (smcmc.rs:1174-1212)
        self.keep_chains = keep_chains
        self.averaging = not keep_chains
        self._chain_state = None          # (scene, Carry)
        cap = getattr(integrator, "hard_cap", 16)
        self.pss_dims = pss_dims or (2 + 6 * cap)
        self.record_accepts = False
        self.accepts = self.tfs = self.init_tfs = self.init_accepts = None
        self.flushed = None

    # ---- the chain state: a flat tuple of arrays, the JAX package's leaves

    def state_dict(self):
        """Serializable chain state, or None if no chains are held."""
        if self._chain_state is None:
            return None
        _, carry = self._chain_state
        d = {f"leaf_{i}": x.cpu().numpy() for i, x in enumerate(carry)}
        d["n_leaves"] = np.asarray(len(carry))
        d["pss_dims"] = np.asarray(self.pss_dims)
        return d

    def load_state_dict(self, d, scene):
        """Bind a dumped chain state to `scene` for the next render()."""
        if int(d["pss_dims"]) != self.pss_dims:
            raise ValueError(
                "SMCMC state mismatch: dumped pss_dims "
                f"{int(d['pss_dims'])} != configured {self.pss_dims}")
        carry = Carry(*(torch.as_tensor(np.asarray(d[f"leaf_{i}"]),
                                        device=scene.device)
                        for i in range(int(d["n_leaves"]))))
        n = scene.camera.width * scene.camera.height
        if carry.u.shape[0] != n:
            raise ValueError(
                f"SMCMC state mismatch: {carry.u.shape[0]} tile-chains "
                f"dumped, scene has {n} pixels")
        self._chain_state = (scene, carry)

    # ---- the target function

    def _evaluate(self, scene, pix5, valid, u):
        """The path tracer over the 5 cross pixels of each state: (col
        [m, 5, 3], tf [m])."""
        m = u.shape[0]
        li = self.integrator.compute_pixel(
            scene, pix5, ArrayStream(values=u.repeat(5, 1), counter=0))
        li = torch.where(torch.all(torch.isfinite(li), -1, keepdim=True),
                         li, 0.0)
        col = li.reshape(5, m, 3).transpose(0, 1)
        col = torch.where(valid[..., None], col, 0.0)
        return col, _sum5(torch.amax(col, -1))

    def generate_state(self, scene, lay: Layout, u):
        """Every tile's state u [n, d] over its cross."""
        return self._evaluate(scene, lay.cross_all, lay.cross_valid, u)

    def generate_state_at(self, scene, lay: Layout, pos, u):
        """States u [m, d] of chains at tile positions pos [m, 2]."""
        pix, valid = _cross(pos[:, 0], pos[:, 1], lay.w, lay.h)
        return self._evaluate(scene, pix.reshape(-1, 2).to(torch.int32),
                              valid, u)

    # ---- one step of the schedule

    def mcmc_step(self, scene, lay: Layout, carry: Carry, stream,
                  exchange_axis=None, offset=0):
        """One schedule step: exchange_axis None, an MCMC step; 'h' / 'v',
        the replica exchange along x / y with pair offset `offset`.
        Returns (carry, stream, the decisions [n], the proposals' tf)."""
        u, tf, col, wgt, acc_v, acc_mc, nb_s, b_acc, nb_u = carry
        n, d = u.shape

        if exchange_axis is None:
            ul, stream = stream_next(stream, (n,))
            uf, stream = stream_next(stream, (n, d))
            um, stream = stream_next(stream, (n, d))
            u01, stream = stream_next(stream, (n, 2))
            ua, stream = stream_next(stream, (n,))
            uninit = tf <= 0.0
            large = (ul < self.large_prob) | uninit
            u_prop = torch.where(large[:, None], uf,
                                 mutate_smcmc(u, um, u01))
            col_p, tf_p = self.generate_state(scene, lay, u_prop)

            # the normalization accumulators on large steps: the plain MC
            # estimate, as the JAX package's (the reference weights it by a
            # weight that is always 0 there)
            b_acc = b_acc + torch.where(large, tf_p, 0.0)
            nb_u = nb_u + large.to(torch.int32)
            acc_mc = acc_mc + torch.where(large[:, None, None], col_p, 0.0)

            a = torch.clamp(tf_p / torch.clamp(tf, min=1e-30), max=1.0)
            a = torch.where(tf_p > 0.0, a, 0.0)
            a = torch.where(uninit, torch.where(tf_p > 0.0, 1.0, 0.0), a)
            w_cur = wgt + (1.0 - a)
            accept = (ua < a) | (uninit & (tf_p > 0.0))
            acc_v = _recycle(acc_v, accept, col, tf, col_p, tf_p, w_cur, a)
            nb_s = nb_s + (~uninit).to(torch.int32)

            u = torch.where(accept[:, None], u_prop, u)
            tf_new = torch.where(accept, tf_p, tf)
            col = torch.where(accept[:, None, None], col_p, col)
            wgt = torch.where(accept, a, w_cur)
            return (Carry(u, tf_new, col, wgt, acc_v, acc_mc, nb_s, b_acc,
                          nb_u), stream, accept, tf_p)

        # the partner by rolls on the (h, w) grid
        if exchange_axis == "h":
            even = (lay.px - offset) % 2 == 0
            partner_c = torch.where(even, lay.px + 1, lay.px - 1)
            pvalid = (partner_c >= 0) & (partner_c < lay.w)
            roll_ax = 1
        else:
            even = (lay.py - offset) % 2 == 0
            partner_c = torch.where(even, lay.py + 1, lay.py - 1)
            pvalid = (partner_c >= 0) & (partner_c < lay.h)
            roll_ax = 0

        def nb(arr):
            """`arr` at the partner lane (the wrapped rows are masked out by
            pvalid); on a mesh the vertical partner rows come by halo."""
            a2 = arr.reshape((-1, lay.w) + tuple(arr.shape[1:]))
            if roll_ax == 0 and lay.mesh is not None:
                from ...parallel.mesh import halo_rows
                nxt = halo_rows(lay.mesh, a2, -1)
                prv = halo_rows(lay.mesh, a2, 1)
            else:
                nxt = torch.roll(a2, -1, dims=roll_ax)
                prv = torch.roll(a2, 1, dims=roll_ax)
            e2 = even.reshape((-1, lay.w) + (1,) * (arr.dim() - 1))
            return torch.where(e2, nxt, prv).reshape(arr.shape)

        u_sw = torch.where(pvalid[:, None], nb(u), u)
        col_p, tf_p = self.generate_state(scene, lay, u_sw)
        ua, stream = stream_next(stream, (n,))
        # the pair's joint decision takes the even lane's uniform
        ua_pair = torch.where(even, ua, nb(ua))
        tf_nb = nb(tf)
        prod_new = tf_p * nb(tf_p)
        prod_old = tf * tf_nb
        a = torch.clamp(prod_new / torch.clamp(prod_old, min=1e-30), max=1.0)
        a = torch.where((prod_new > 0.0) & pvalid, a, 0.0)
        bothinit = (tf > 0.0) & (tf_nb > 0.0)
        a = torch.where(bothinit, a, 0.0)
        accept = (ua_pair < a) & pvalid & bothinit

        w_cur = wgt + (1.0 - a)
        acc_v = _recycle(acc_v, accept, col, tf, col_p, tf_p, w_cur, a,
                         bothinit)
        nb_s = nb_s + bothinit.to(torch.int32)

        u = torch.where(accept[:, None], u_sw, u)
        tf_new = torch.where(accept, tf_p, tf)
        col = torch.where(accept[:, None, None], col_p, col)
        wgt = torch.where(accept, a,
                          torch.where(bothinit & pvalid, w_cur, wgt))
        # an uninitialized chain borrows an initialized partner's state
        borrow = (tf_new <= 0.0) & pvalid & (tf_p > 0.0)
        u = torch.where(borrow[:, None], u_sw, u)
        tf_new = torch.where(borrow, tf_p, tf_new)
        col = torch.where(borrow[:, None, None], col_p, col)
        wgt = torch.where(borrow, 0.0, wgt)
        return (Carry(u, tf_new, col, wgt, acc_v, acc_mc, nb_s, b_acc, nb_u),
                stream, accept, tf_p)

    # ---- initialization

    def init_states(self, scene, lay: Layout, stream):
        """The tiles' starting states and normalization accumulators:
        (u0, tf0, col0, b_acc, nb_u, acc_mc, stream)."""
        n, d = lay.px.shape[0], self.pss_dims
        dev = lay.px.device
        u0, stream = stream_next(stream, (n, d))
        col0, tf0 = self.generate_state(scene, lay, u0)
        b_acc, acc_mc = tf0, col0
        nb_u = torch.ones(n, dtype=torch.int32, device=dev)
        tfs = [tf0]
        self.init_accepts = None

        if self.init == "independent":
            for _ in range(max(self.init_spp - 1, 0)):
                uk, stream = stream_next(stream, (n, d))
                colk, tfk = self.generate_state(scene, lay, uk)
                tfs.append(tfk)
                b_acc = b_acc + tfk
                nb_u = nb_u + 1
                acc_mc = acc_mc + colk
                take = (tf0 <= 0.0) & (tfk > 0.0)
                u0 = torch.where(take[:, None], uk, u0)
                col0 = torch.where(take[:, None, None], colk, col0)
                tf0 = torch.where(take, tfk, tf0)
            self._record_init(tfs)
            return u0, tf0, col0, b_acc, nb_u, acc_mc, stream

        # roaming chains seeded from the tiles' flux cdf
        m = max((n * self.init_spp_mcmc) // self.init_chain_length, 64)
        cdf = _prefix_sum(tf0)
        tot = torch.clamp(cdf[-1], min=1e-30)
        uc, stream = stream_next(stream, (m,))
        v = (torch.arange(m, dtype=torch.float32, device=dev) + uc) / m * tot
        idx = torch.clamp(torch.searchsorted(cdf, v), 0, n - 1)
        ch_u = u0[idx]
        ch_pos = torch.stack([torch.remainder(idx, lay.w), idx // lay.w], -1)
        ch_col, ch_tf = self.generate_state_at(scene, lay, ch_pos, ch_u)

        tiles = (u0, tf0, col0)
        nb_visit = torch.zeros(n, dtype=torch.float32, device=dev)
        accepts = []
        for _ in range(self.init_chain_length):
            pid = ch_pos[:, 1] * lay.w + ch_pos[:, 0]
            key, stream = stream_next(stream, (m,))
            ur, stream = stream_next(stream, (n,))
            tiles, nb_visit = reservoir_update(n, pid, key, ur, nb_visit,
                                               tiles, (ch_u, ch_tf, ch_col))
            # an image-space move (Kelemen on normalized coordinates) and a
            # small step in primary samples, accepted on tf
            r2, stream = stream_next(stream, (m, 2))
            posn = torch.stack([(ch_pos[:, 0] + 0.5) / lay.w,
                                (ch_pos[:, 1] + 0.5) / lay.h],
                               -1).to(torch.float32)
            posn = kelemen_mutate(posn, r2)
            new_pos = torch.stack(
                [torch.clamp((posn[:, 0] * lay.w).to(torch.int32), 0,
                             lay.w - 1),
                 torch.clamp((posn[:, 1] * lay.h).to(torch.int32), 0,
                             lay.h - 1)], -1).to(ch_pos.dtype)
            um, stream = stream_next(stream, (m, d))
            u01, stream = stream_next(stream, (m, 2))
            u_prop = mutate_smcmc(ch_u, um, u01)
            col_p, tf_p = self.generate_state_at(scene, lay, new_pos, u_prop)
            ua, stream = stream_next(stream, (m,))
            a = torch.clamp(tf_p / torch.clamp(ch_tf, min=1e-30), max=1.0)
            acc = (ua < a) & (tf_p > 0.0)
            ch_pos = torch.where(acc[:, None], new_pos, ch_pos)
            ch_u = torch.where(acc[:, None], u_prop, ch_u)
            ch_tf = torch.where(acc, tf_p, ch_tf)
            ch_col = torch.where(acc[:, None, None], col_p, ch_col)
            if self.record_accepts:
                accepts.append(acc)
        self._record_init(tfs, accepts)
        u0, tf0, col0 = tiles
        return u0, tf0, col0, b_acc, nb_u, acc_mc, stream

    def _record_init(self, tfs, accepts=()):
        if self.record_accepts:
            self.init_tfs = torch.stack(tfs).cpu().numpy()
            if accepts:
                self.init_accepts = torch.stack(accepts).cpu().numpy()

    def init_carry(self, scene, lay: Layout, stream):
        """The initial Carry, and the stream after the init's draws."""
        u0, tf0, col0, b_acc, nb_u, acc_mc, stream = self.init_states(
            scene, lay, stream)
        n = u0.shape[0]
        zeros = torch.zeros(n, dtype=torch.float32, device=u0.device)
        return Carry(u0, tf0, col0, zeros,
                     torch.zeros_like(col0), acc_mc,
                     torch.zeros(n, dtype=torch.int32, device=u0.device),
                     b_acc, nb_u), stream

    def evolve(self, scene, lay: Layout, carry: Carry, stream, steps: int,
               record=None):
        """`steps` steps of the schedule, from its start. `record` (or None)
        collects each step's decisions and proposals' tf."""
        for s in range(steps):
            step = SCHEDULE[s % len(SCHEDULE)]
            if step is None:
                carry, stream, acc, tf_p = self.mcmc_step(scene, lay, carry,
                                                          stream)
            else:
                carry, stream, acc, tf_p = self.mcmc_step(
                    scene, lay, carry, stream, exchange_axis=step[0],
                    offset=step[1])
            if record is not None:
                record[0].append(acc)
                record[1].append(tf_p)
        return carry

    # ---- render

    def render(self, scene, spp: int, seed: int = 0, mesh=None) -> Film:
        w, h = scene.camera.width, scene.camera.height
        lay = make_layout(w, h, scene.device)
        base = make_stream(seed, scene.device)
        if mesh is not None:
            if self.record_accepts:
                raise ValueError("record_accepts is single-device")
            return self._render_mesh(scene, lay, base, spp, mesh)
        st = self._chain_state
        # chains persist on the scene object (a collected scene's id can be
        # reused)
        if self.keep_chains and st is not None and st[0] is scene:
            carry0, stream0 = st[1], stream_fold(base, 31337)
        else:
            carry0, stream0 = self.init_carry(scene, lay,
                                              stream_fold(base, 31337))
        record = ([], [carry0.tf]) if self.record_accepts else None
        carry = self.evolve(scene, lay, carry0, stream0, spp, record)
        if record is not None:
            self.accepts = torch.stack(record[0])[None].cpu().numpy() if (
                record[0]) else np.zeros((1, 0, w * h), bool)
            self.tfs = torch.stack(record[1])[None].cpu().numpy()
        if self.keep_chains:
            self._chain_state = (scene, carry)
        flushed = flush(carry)
        if self.record_accepts:
            self.flushed = flushed
        return self._film(lay, flushed)

    def _render_mesh(self, scene, lay: Layout, base, spp: int, mesh):
        """render() on a mesh: this rank's band of tile chains (see the
        module's note)."""
        from ...parallel.mesh import gather_rows
        w, h = lay.w, lay.h
        bands = mesh.bands(h)
        r0, r1 = bands[mesh.rank]
        lo, hi = r0 * w, r1 * w
        counts = [(b - a) * w for a, b in bands]
        band = make_layout(w, h, scene.device, (r0, r1), mesh)
        stream0 = stream_fold(base, 31337)
        st = self._chain_state
        if self.keep_chains and st is not None and st[0] is scene:
            carry0 = Carry(*(x[lo:hi] for x in st[1]))
        elif self.init == "mcmc":
            # the roaming chains deposit into any tile: the init runs whole
            carry0, stream0 = self.init_carry(scene, lay, stream0)
            carry0 = Carry(*(x[lo:hi] for x in carry0))
        else:
            carry0, stream0 = self.init_carry(
                scene, band, with_window(stream0, lo, hi))
        moved = mesh.moved
        carry = self.evolve(scene, band, carry0,
                            with_window(stream0, lo, hi), spp)
        self.exchange_moved = mesh.moved - moved
        if self.keep_chains:
            full = Carry(*(gather_rows(mesh, x, counts) for x in carry))
            self._chain_state = (scene, full)
            flushed = flush(full)
        else:
            # the reconstructions read the accumulators alone
            flushed = Carry(carry.u.new_empty((w * h, 0)),
                            *(gather_rows(mesh, x, counts)
                              for x in flush(carry)[1:]))
        return self._film(lay, flushed)

    def _film(self, lay: Layout, flushed: Carry) -> Film:
        img = self.reconstruct(lay, flushed)
        w, h = lay.w, lay.h
        film = Film(w, h)
        film.buffers["primal"] = img.reshape(h, w, 3).cpu().numpy()
        return film

    def reconstruct(self, lay: Layout, carry: Carry):
        """The image [n, 3] (f32, on the carry's device) from the flushed
        accumulators, by the configured reconstruction."""
        if self.recons == "irls":
            return irls_reconstruction(
                carry.acc_v, carry.acc_mc, carry.nb_s, carry.b_acc,
                carry.nb_u, lay.cross_valid, lay.cross_pid, lay.w, lay.h)
        return naive_reconstruction(carry, lay.cross_valid, lay.cross_pid)


def flush(carry: Carry) -> Carry:
    """Splat the final states with their weights."""
    keep = torch.ones_like(carry.tf, dtype=torch.bool)
    return carry._replace(acc_v=_recycle(
        carry.acc_v, keep, carry.col, carry.tf, carry.col, carry.tf,
        carry.wgt, carry.wgt))


def naive_reconstruction(carry: Carry, cross_valid, cross_pid):
    """Overlap averaging (smcmc.rs:318-358): each tile's splats times its
    normalization b_acc / nb_u, summed into its cross pixels, over the
    splat counts."""
    n = carry.tf.shape[0]
    dev = carry.tf.device
    norm = torch.where(carry.nb_u > 0,
                       carry.b_acc / torch.clamp(carry.nb_u, min=1), 0.0)
    accum = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    counts = torch.zeros(n, dtype=torch.float32, device=dev)
    vals = carry.acc_v * norm[:, None, None]
    for s in range(5):
        # a pixel gets at most one non-zero term a slot: the order of the
        # adds does not matter
        ok = cross_valid[:, s] & (carry.nb_s > 0)
        accum.index_add_(0, cross_pid[:, s],
                         torch.where(ok[:, None], vals[:, s], 0.0))
        counts.index_add_(0, cross_pid[:, s], torch.where(
            cross_valid[:, s], carry.nb_s.to(torch.float32), 0.0))
    return torch.where(counts[:, None] > 0,
                       accum / torch.clamp(counts[:, None], min=1.0), 0.0)


# slot layout: 0 centre, 1 left (dx -1), 2 top (dy -1), 3 right, 4 down;
# the overlap rules (slot, neighbour's slot, (dy, dx)), smcmc.rs:491-695
_IRLS_PAIRS = [
    (0, 3, (0, -1)), (1, 0, (0, -1)),      # left neighbour
    (0, 1, (0, +1)), (3, 0, (0, +1)),      # right neighbour
    (0, 4, (-1, 0)), (2, 0, (-1, 0)),      # top neighbour
    (0, 2, (+1, 0)), (4, 0, (+1, 0)),      # down neighbour
    (2, 3, (-1, -1)), (1, 4, (-1, -1)),    # top-left diagonal
    (4, 1, (+1, +1)), (3, 2, (+1, +1)),    # down-right diagonal
    (4, 3, (+1, -1)), (1, 2, (+1, -1)),    # down-left diagonal
    (2, 1, (-1, +1)), (3, 4, (-1, +1)),    # top-right diagonal
    (1, 3, (0, -2)), (3, 1, (0, +2)),      # distance-2 horizontal
    (2, 4, (-2, 0)), (4, 2, (+2, 0)),      # distance-2 vertical
]


def irls_reconstruction(acc_v, acc_mc, nb_s, b_acc, nb_u, cross_valid,
                        cross_pid, w, h, irls_iter=4, internal_iter=20,
                        alpha=0.1):
    """The IRLS overlap-consistency solve (the reference's
    ReconstructionIRLS, smcmc.rs:359-904) in float64 on the accumulators'
    device, with the JAX package's arithmetic term by term. Its 21 terms
    (the regularization against the per-pixel MC estimate, then the 20
    overlap rules) and three channels go as one [21, n, 3] batch: a
    neighbour's value is a gather at a precomputed index (the JAX
    package's np.roll), and the terms' sum runs over the batch axis.
    Returns the image [n, 3] float32."""
    n = w * h
    dev = acc_v.device
    f64 = torch.float64
    nb_s64 = nb_s.to(torch.int64)
    nb_u64 = nb_u.to(torch.int64)
    lane = torch.arange(n, device=dev)
    px, py = torch.remainder(lane, w), lane // w
    # the rules' neighbour p + (dy, dx), wrapped as a roll, and whether it
    # lies in the image
    nbr = torch.stack([torch.remainder(py + dy, h) * w
                       + torch.remainder(px + dx, w)
                       for _, _, (dy, dx) in _IRLS_PAIRS])           # [20, n]
    inside = torch.stack([(py + dy >= 0) & (py + dy < h) & (px + dx >= 0)
                          & (px + dx < w) for _, _, (dy, dx) in _IRLS_PAIRS])

    # the robust per-pixel MC estimate (weighted_reconstruction_channel)
    mc_acc = torch.zeros((n, 3), dtype=f64, device=dev)
    mc_cnt = torch.zeros(n, dtype=torch.int64, device=dev)
    for s in range(5):
        ok = cross_valid[:, s]
        mc_acc.index_add_(0, cross_pid[:, s], torch.where(
            ok[:, None], acc_mc[:, s], 0.0).to(f64))
        mc_cnt.index_add_(0, cross_pid[:, s], torch.where(ok, nb_u64, 0))
    mc_est = torch.where(mc_cnt[:, None] > 0, mc_acc / torch.clamp(
        mc_cnt, min=1).to(f64)[:, None], 0.0)

    cache = torch.where(cross_valid[..., None], acc_v, 0.0)   # [n, 5, 3] f32
    sums_mcmc = _sum5(cache.transpose(1, 2))                   # [n, 3] f32
    sums_mc = _sum5(torch.where(cross_valid[..., None], mc_est[cross_pid],
                                0.0).transpose(1, 2))          # [n, 3] f64
    # the terms' values (f32 values enter as float64, exactly)
    v1 = torch.stack([sums_mcmc.to(f64) / torch.clamp(
        nb_s64, min=1).to(f64)[:, None]] + [cache[:, s1].to(f64)
                                             for s1, _, _ in _IRLS_PAIRS])
    v2 = torch.stack([sums_mc] + [cache[nbr[k], s2].to(f64)
                                  for k, (_, s2, _) in enumerate(_IRLS_PAIRS)])
    valid = torch.cat([torch.ones((1, n), dtype=torch.bool, device=dev),
                       inside])[..., None]
    al = valid & (v1 != 0.0) & (v2 != 0.0)                     # [21, n, 3]
    ones = torch.ones((1, n, 3), dtype=f64, device=dev)

    def weights(wgt):
        """min(w1, w2) of every term, and the fixed denominator."""
        w_nb = wgt[nbr]
        w1 = torch.cat([alpha * wgt[None], wgt.expand(len(_IRLS_PAIRS), n,
                                                      3)])
        w2 = torch.cat([alpha * wgt[None], w_nb])
        ww = torch.minimum(w1, w2)
        return ww, torch.where(al, ww * v1, 0.0).sum(0)

    def forces(b):
        """Each term's 0.5 (v1 b1 - v2 b2)."""
        b2 = torch.cat([ones, b[nbr]])
        return 0.5 * (v1 * b[None] - v2 * b2)

    b = torch.where(nb_u > 0, b_acc.to(f64) / torch.clamp(nb_u64, min=1).to(
        f64), 0.0)[:, None].repeat(1, 3)
    wgt = torch.ones((n, 3), dtype=f64, device=dev)
    for it in range(irls_iter):
        ww, pos = weights(wgt)
        for _ in range(internal_iter):
            force = torch.where(al, ww * forces(b), 0.0).sum(0)
            newb = torch.where(pos != 0.0, b - force / torch.where(
                pos != 0, pos, 1.0), b)
            newb = torch.clamp(torch.where(torch.isfinite(newb), newb, b),
                               min=0.0)
            b = torch.where(sums_mcmc > 0, newb, b)
        err = torch.where(al, torch.abs(forces(b)), 0.0).sum(0)
        w_new = 1.0 / (err + max(0.05 * 0.5 ** it, 1e-4))
        wgt = w_new * n / torch.clamp(w_new.sum(0), min=1e-12)
    out_b = b.to(torch.float32)

    # the final splat: each value times its tile's b, averaged by overlaps
    accum = torch.zeros((n, 3), dtype=f64, device=dev)
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    vals = acc_v * out_b[:, None, :]
    for s in range(5):
        ok = cross_valid[:, s] & (nb_s > 0)
        accum.index_add_(0, cross_pid[:, s],
                         torch.where(ok[:, None], vals[:, s], 0.0).to(f64))
        counts.index_add_(0, cross_pid[:, s], torch.where(ok, nb_s64, 0))
    img = torch.where(counts[:, None] > 0,
                      accum / torch.clamp(counts[:, None], min=1).to(f64),
                      0.0)
    return img.to(torch.float32)

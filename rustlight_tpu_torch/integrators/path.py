"""Wavefront path tracer with NEE + MIS; port of the persistent-wavefront
route of rustlight_tpu/integrators/path.py (`compute_block`).

Semantics mirrored: BSDF-directional and light-NEE strategies combined by
the balance heuristic; `strategy` all | bsdf | emitter filters them (the
sensor edge always contributes); emission with k edges gated by
min_depth <= k-1; expansion stops at max_depth edges; Russian roulette from
rr_depth with survival min(max(throughput), 0.95).

Each iteration draws its uniforms in the reference's order and shapes, for
every lane: u_pix (n,2), u_sel (n,), u_pos (n,2), u_nrr (n,) only with
NEE Russian roulette on, u_bsdf (n,2), u_rr (n,). The streams are bit-exact
with the reference's, so the two packages render sample for sample alike.

Loop shape: the reference's `while_loop` tests `any(alive | done < spp)`
before every iteration; read on the host, that test would cost a device
sync per iteration. Here the loop runs CHECK_EVERY iterations between two
tests and never passes the reference's iteration cap. An iteration after
the last sample has finished changes no accumulator, so the result is
the reference's.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..accel import intersect_rays, visible
from ..bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample, bsdf_is_smooth
from ..scene import (fill_hit, generate_rays, sample_light, direct_pdf_tri,
                     emitted_radiance)
from ..scene.scene import offset_ray_origin
from ..utils.frame import to_world, to_local
from ..utils.rng import stream_next, stream_next2d
from ..utils.vec import channel_max
from .common import mis_balance

STRATEGY_ALL = "all"
STRATEGY_BSDF = "bsdf"
STRATEGY_EMITTER = "emitter"

# iterations between two host-side checks of the loop condition
CHECK_EVERY = 8


class _PersistentState(NamedTuple):
    """Pixel-pinned persistent-wavefront state: each lane renders its own
    pixel's samples back to back, respawning the moment its path dies."""
    stream: Any
    o: Any
    d: Any
    throughput: Any
    rad_path: Any     # [n, 3] radiance of the path in flight
    accum: Any        # [n, 3] sum over finished samples of this lane's pixel
    alive: Any        # [n] path in flight
    done: Any         # [n] int32 samples completed
    depth: Any        # [n] int32 edges completed on the current path
    prev_pdf: Any
    prev_delta: Any
    prev_nee: Any
    prev_occ: Any


class IntegratorPathTracing:
    def __init__(self, min_depth: Optional[int] = None,
                 max_depth: Optional[int] = None,
                 rr_depth: Optional[int] = 0,
                 strategy: str = STRATEGY_ALL,
                 single_scattering: bool = False,
                 nee_rr="default",
                 hard_cap: int = 64):
        if strategy not in (STRATEGY_ALL, STRATEGY_BSDF, STRATEGY_EMITTER):
            raise NotImplementedError(f"strategy {strategy!r} is not ported yet")
        self.min_depth = min_depth or 0
        self.max_depth = max_depth
        self.rr_depth = rr_depth
        self.strategy = strategy
        self.single_scattering = single_scattering
        # visibility-history NEE Russian roulette: "default" is the
        # reference's tier-aware choice, resolved per scene (_nee_rr_for);
        # a float sets the survival probability, None turns it off
        self.nee_rr = nee_rr
        self.hard_cap = hard_cap if max_depth is None else min(hard_cap, max_depth)

    def _nee_rr_for(self, scene):
        """Effective NEE-RR survival probability for this scene (None =
        off): by default 0.25 on walk scenes, where the skipped shadow rays
        vacate walk tiles, and off on the dense tier, which traces every
        lane regardless."""
        if self.nee_rr == "default":
            return 0.25 if scene.geom.walk is not None else None
        return self.nee_rr

    def compute_block(self, scene, pix, stream, spp: int):
        """All `spp` samples of every pixel in one persistent wavefront.
        Returns the per-pixel SUM over spp samples, [n, 3]."""
        n = pix.shape[0]
        dev = pix.device
        zero3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        s = _PersistentState(
            stream=stream, o=zero3,
            d=torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(n, 3),
            throughput=zero3, rad_path=zero3, accum=zero3,
            alive=torch.zeros(n, dtype=torch.bool, device=dev),
            done=torch.zeros(n, dtype=torch.int32, device=dev),
            depth=torch.zeros(n, dtype=torch.int32, device=dev),
            prev_pdf=torch.ones(n, dtype=torch.float32, device=dev),
            prev_delta=torch.ones(n, dtype=torch.bool, device=dev),
            prev_nee=torch.zeros(n, dtype=torch.bool, device=dev),
            prev_occ=torch.zeros(n, dtype=torch.bool, device=dev),
        )
        pixf = pix.to(torch.float32)
        nee_rr = self._nee_rr_for(scene)
        it_cap = spp * self.hard_cap + 4
        it = 0
        while it < it_cap:
            if not bool(torch.any(s.alive | (s.done < spp))):
                break
            for _ in range(min(CHECK_EVERY, it_cap - it)):
                s = self._step(scene, pixf, s, spp, nee_rr)
            it += min(CHECK_EVERY, it_cap - it)
        return s.accum

    def _step(self, scene, pixf, s: _PersistentState, spp: int, nee_rr):
        n = pixf.shape[0]
        use_nee = self.strategy in (STRATEGY_ALL, STRATEGY_EMITTER)
        mis_on = self.strategy == STRATEGY_ALL
        keep_bsdf_hits = self.strategy in (STRATEGY_ALL, STRATEGY_BSDF)
        stream = s.stream

        # ---- respawn: dead lanes with samples left start a new path
        u_pix, stream = stream_next2d(stream, (n,))
        o0, d0 = generate_rays(scene.camera, pixf + u_pix)
        need = (~s.alive) & (s.done < spp)
        nm = need[:, None]
        o = torch.where(nm, o0, s.o)
        d = torch.where(nm, d0, s.d)
        thr = torch.where(nm, 1.0, s.throughput)
        rad_path = torch.where(nm, 0.0, s.rad_path)
        depth = torch.where(need, 0, s.depth)
        prev_pdf = torch.where(need, 1.0, s.prev_pdf)
        prev_delta = need | s.prev_delta
        prev_nee = (~need) & s.prev_nee
        prev_occ = (~need) & s.prev_occ
        alive = s.alive | need

        # dead lanes trace inert (tfar = 0) rays, which the kernel skips
        rh = intersect_rays(scene.geom, o, d,
                            tfar=torch.where(alive, float("inf"), 0.0))
        hit = fill_hit(scene, o, d, rh)

        # ---- emission picked up through the BSDF/sensor edge
        lane_hit = alive & hit.valid
        min_ok = depth >= self.min_depth
        le = emitted_radiance(scene.emitters, scene.geom, hit.tri, d)
        pdf_light = direct_pdf_tri(scene.emitters, hit.tri, o, hit.p, hit.n_g, d)
        if mis_on:
            w_hit = torch.where(prev_delta | (~prev_nee), 1.0,
                                mis_balance(prev_pdf, pdf_light))
        else:
            w_hit = torch.ones_like(prev_pdf)
        add = lane_hit & min_ok
        if not keep_bsdf_hits:   # the sensor edge always contributes
            add = add & (depth == 0)
        rad_path = rad_path + torch.where(add[:, None],
                                          thr * le * w_hit[:, None], 0.0)

        smooth = bsdf_is_smooth(scene.materials, hit.mat)
        lane_surface = (torch.zeros_like(lane_hit) if self.single_scattering
                        else lane_hit)
        depth_cap = self.hard_cap if self.max_depth is None else self.max_depth
        can_expand = lane_surface & (depth + 1 < depth_cap)

        # ---- NEE (light strategy); u_sel/u_pos are drawn in every case
        u_sel, stream = stream_next(stream, (n,))
        u_pos, stream = stream_next2d(stream, (n,))
        if use_nee:
            ls = sample_light(scene.emitters, scene.geom, hit.p, u_sel, u_pos)
            wo_l = to_local(hit.frame, ls.d)
            f = bsdf_eval(scene.materials, hit.mat, hit.uv, hit.wi, wo_l)
            pdf_s = bsdf_pdf(scene.materials, hit.mat, hit.uv, hit.wi, wo_l)
            p_shadow = offset_ray_origin(hit.p, hit.n_g, ls.d)
            pre_ok = (can_expand & (~smooth) & ls.valid
                      & ((depth + 1) >= self.min_depth))
            nee_scale = None
            if nee_rr is not None:
                u_nrr, stream = stream_next(stream, (n,))
                p_keep = torch.where(prev_occ, float(nee_rr), 1.0)
                pre_ok = pre_ok & (u_nrr < p_keep)
                nee_scale = (1.0 / p_keep)[:, None]
            # lanes that cannot contribute shoot an inert (tfar = 0) ray
            vis = visible(scene.geom, p_shadow, ls.p, mask=pre_ok)
            if mis_on:
                w_nee = torch.where(ls.is_delta, 1.0, mis_balance(ls.pdf, pdf_s))
            else:
                w_nee = torch.ones_like(ls.pdf)
            nee_ok = pre_ok & vis
            prev_occ = torch.where(pre_ok, ~vis, prev_occ)
            contrib = thr * f * ls.weight * w_nee[:, None]
            if nee_scale is not None:
                contrib = contrib * nee_scale
            rad_path = rad_path + torch.where(nee_ok[:, None], contrib, 0.0)

        # ---- directional bounce
        u_bsdf, stream = stream_next2d(stream, (n,))
        bs = bsdf_sample(scene.materials, hit.mat, hit.uv, hit.wi, u_bsdf)
        wo_world = to_world(hit.frame, bs.wo)
        throughput = thr * bs.weight

        # ---- Russian roulette
        u_rr, stream = stream_next(stream, (n,))
        if self.rr_depth is None:
            rr_keep = torch.ones_like(alive)
        else:
            do_rr = (depth + 1) >= self.rr_depth
            rr_p = torch.clamp(channel_max(throughput), max=0.95)
            rr_keep = torch.where(do_rr, u_rr < rr_p, True)
            rr_w = torch.where(do_rr & rr_keep,
                               1.0 / torch.clamp(rr_p, min=1e-8), 1.0)
            throughput = throughput * rr_w[:, None]

        alive_new = (can_expand & bs.valid & rr_keep
                     & (channel_max(throughput) > 0.0))
        o_new = offset_ray_origin(hit.p, hit.n_g, wo_world)
        nee_possible = (~smooth) if use_nee else torch.zeros_like(smooth)

        # ---- sample bookkeeping: paths that just ended bank their sum
        finished = alive & (~alive_new)
        accum = s.accum + torch.where(finished[:, None], rad_path, 0.0)
        done = s.done + finished.to(torch.int32)
        an = alive_new[:, None]
        return _PersistentState(
            stream=stream,
            o=torch.where(an, o_new, o),
            d=torch.where(an, wo_world, d),
            throughput=torch.where(an, throughput, thr),
            rad_path=rad_path, accum=accum,
            alive=alive_new, done=done, depth=depth + 1,
            prev_pdf=torch.where(alive_new, bs.pdf, prev_pdf),
            prev_delta=torch.where(alive_new, bs.is_delta, prev_delta),
            prev_nee=torch.where(alive_new, nee_possible, prev_nee),
            prev_occ=prev_occ,
        )

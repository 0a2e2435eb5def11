"""Wavefront path tracer with NEE + MIS; port of
rustlight_tpu/integrators/path.py (`compute_pixel`, the per-pass route, and
`compute_block`, the persistent wavefront).

Semantics mirrored: BSDF-directional and light-NEE strategies combined by
the balance heuristic; `strategy` all | bsdf | emitter filters them (the
sensor edge always contributes); `naive` samples the cosine hemisphere on
non-delta surfaces, with no NEE and no MIS; emission with k edges gated by
min_depth <= k-1; expansion stops at max_depth edges; Russian roulette from
rr_depth with survival min(max(throughput), 0.95). A vertex whose BSDF
has a delta lobe (glass, smooth metal or substrate) takes no NEE, and the
emission found after a delta bounce has weight 1. A ray that escapes the
scene picks up the environment's radiance, weighted against the
environment's NEE pdf as an emitter hit is; NEE samples every atom kind
(triangles, point, directional and point-normal lights, the environment),
at surface and medium vertices alike. With the ATS light tree
(`scene.ats`, `-x ats`), NEE picks an emissive triangle by a descent of the
tree from the vertex and its shading normal, and an emitter hit is MIS'd
against the tree's pdf from the previous vertex; the tree holds triangles
only, as the reference's. Camera paths use the importance transport, as
the reference's call sites do.

In a scene with a homogeneous medium (`scene.volume`), each segment
samples a free-flight distance (`tfar = 1e8` where the ray misses: the
medium is infinite). A lane that scatters makes a medium vertex: NEE with
the phase function and the shadow segment's transmittance, and a phase
bounce. `single_scattering` keeps the medium vertices only: a surface hit
adds its emission and ends the path.

Each iteration draws its uniforms in the reference's order and shapes, for
every lane: u_pix (n,2) (compute_block only; compute_pixel draws it once),
u_med (n,) only with a medium, u_sel (n,), u_pos (n,2), u_nrr (n,) only
with NEE Russian roulette on, u_bsdf (n,2), then u_gsel (n,) and u_gdir
(n,2) only in a guided pass (compute_pixel with `guide`), u_rr (n,). The
streams are bit-exact with the reference's, so the two packages render
sample for sample alike.

Loop shape: the reference's `while_loop`s test `any(alive)` (any(alive |
done < spp) in compute_block) before every iteration; read on the host,
that test would cost a device sync per iteration. Here the loops run
CHECK_EVERY iterations between two tests and never pass the reference's
iteration cap. An iteration with no path in flight changes no
accumulator, so the result is the reference's.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from ..accel import intersect_rays, visible
from ..bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample, bsdf_is_smooth
from ..bsdfs.table import TRANSPORT_IMPORTANCE
from ..scene import (fill_hit, generate_rays, sample_light, direct_pdf_tri,
                     emitted_radiance, env_direction_pdf, env_radiance,
                     sample_light_ats, direct_pdf_tri_ats)
from ..scene.scene import offset_ray_origin
from ..scene.volume import (phase_eval, phase_sample, transmittance,
                            volume_sample_distance)
from ..utils.frame import to_world, to_local
from ..utils.rng import stream_next, stream_next2d
from ..utils.tracing import count, span, spanned
from ..utils.vec import channel_max
from ..utils.warps import cosine_sample_hemisphere
from . import guiding as _gd
from .common import mis_balance

STRATEGY_ALL = "all"
STRATEGY_BSDF = "bsdf"
STRATEGY_EMITTER = "emitter"
# cosine-hemisphere sampling, no BSDF importance sampling and no NEE: the
# reference's NaiveSamplingStrategy, the importance-sampling oracle
STRATEGY_NAIVE = "naive"

# iterations between two host-side checks of the loop condition
CHECK_EVERY = 8


class _PathState(NamedTuple):
    """Per-pass state: one path a lane."""
    stream: Any
    o: Any            # [n, 3] current ray origin (previous vertex)
    d: Any            # [n, 3] current ray direction
    throughput: Any   # [n, 3]
    radiance: Any     # [n, 3]
    alive: Any        # [n]
    depth: Any        # 0-d int32: edges completed (the reference's k)
    prev_pdf: Any     # [n] solid-angle pdf of the directional strategy
    prev_delta: Any   # [n] previous bounce was a delta lobe (or the sensor)
    prev_nee: Any     # [n] NEE was possible at the previous vertex
    prev_occ: Any     # [n] this lane's most recent NEE shadow ray was blocked


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


class _Vertex(NamedTuple):
    """What one segment and its vertex give a lane (see `_vertex`)."""
    stream: Any
    radiance: Any     # [n, 3] the path's radiance with this vertex's terms
    thr: Any          # [n, 3] throughput after the segment's medium weight
    alive: Any        # [n] the path goes on
    o: Any            # [n, 3] next ray origin
    d: Any            # [n, 3] next ray direction
    throughput: Any   # [n, 3] throughput after the bounce and roulette
    pdf_dir: Any
    is_delta: Any
    nee_possible: Any
    prev_occ: Any
    dep: Any = None   # the guide's deposit accumulator (guided passes)


class IntegratorPathTracing:
    def __init__(self, min_depth: Optional[int] = None,
                 max_depth: Optional[int] = None,
                 rr_depth: Optional[int] = 0,
                 strategy: str = STRATEGY_ALL,
                 single_scattering: bool = False,
                 nee_rr="default",
                 hard_cap: int = 64):
        if strategy not in (STRATEGY_ALL, STRATEGY_BSDF, STRATEGY_EMITTER,
                            STRATEGY_NAIVE):
            raise ValueError(f"unknown strategy {strategy!r}")
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

    @spanned("loop.sample")
    def compute_pixel(self, scene, pix, stream, guide=None, collect=False):
        """One sample of every pixel: the radiance of one path a lane,
        [n, 3]. The loop runs at most hard_cap iterations.

        `guide` (a guiding.GuideGrid) turns the directional bounce on rough
        surfaces into a defensive one-sample-MIS mixture of the BSDF and the
        learned distribution (with probability `guide_alpha`, 0.5 unless
        set, the draw comes from the guide; the realized direction is
        weighted by f cos / pdf_mixture); each iteration then draws u_gsel
        (n,) and u_gdir (n, 2) after u_bsdf. `collect=True` also returns the
        flat [g^3 * N_BINS] accumulator of incident-radiance deposits
        (emission hits, environment escapes, NEE contributions and their
        one-bounce look-ahead, binned by the direction they arrived from):
        (radiance, dep)."""
        n = pix.shape[0]
        dev = pix.device
        u_pix, stream = stream_next2d(stream, (n,))
        o, d = generate_rays(scene.camera, pix.to(torch.float32) + u_pix)
        s = _PathState(
            stream=stream, o=o, d=d,
            throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
            radiance=torch.zeros((n, 3), dtype=torch.float32, device=dev),
            alive=torch.ones(n, dtype=torch.bool, device=dev),
            depth=torch.zeros((), dtype=torch.int32, device=dev),
            prev_pdf=torch.ones(n, dtype=torch.float32, device=dev),
            prev_delta=torch.ones(n, dtype=torch.bool, device=dev),
            prev_nee=torch.zeros(n, dtype=torch.bool, device=dev),
            prev_occ=torch.zeros(n, dtype=torch.bool, device=dev),
        )
        nee_rr = self._nee_rr_for(scene)
        collect = guide is not None and collect
        dep = (torch.zeros(guide.table.numel(), dtype=torch.float32,
                           device=dev) if collect else None)
        k = 0
        while k < self.hard_cap:
            with span("loop.sync"):
                if not bool(torch.any(s.alive)):
                    break
            m = min(CHECK_EVERY, self.hard_cap - k)
            count("loop.iterations", m)
            for _ in range(m):
                v = self._vertex(scene, s.o, s.d, s.throughput, s.radiance,
                                 s.alive, s.depth, s.prev_pdf, s.prev_delta,
                                 s.prev_nee, s.prev_occ, s.stream, nee_rr,
                                 self.max_depth, guide=guide, dep=dep)
                dep = v.dep
                an = v.alive[:, None]
                s = _PathState(
                    stream=v.stream,
                    o=torch.where(an, v.o, s.o),
                    d=torch.where(an, v.d, s.d),
                    throughput=torch.where(an, v.throughput, s.throughput),
                    radiance=v.radiance, alive=v.alive, depth=s.depth + 1,
                    prev_pdf=torch.where(v.alive, v.pdf_dir, s.prev_pdf),
                    prev_delta=torch.where(v.alive, v.is_delta, s.prev_delta),
                    prev_nee=torch.where(v.alive, v.nee_possible, s.prev_nee),
                    prev_occ=v.prev_occ,
                )
            k += m
        if collect:
            return s.radiance, dep
        return s.radiance

    @spanned("loop.block")
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
            with span("loop.sync"):
                if not bool(torch.any(s.alive | (s.done < spp))):
                    break
            m = min(CHECK_EVERY, it_cap - it)
            count("loop.iterations", m)
            for _ in range(m):
                s = self._step(scene, pixf, s, spp, nee_rr)
            it += m
        return s.accum

    def _step(self, scene, pixf, s: _PersistentState, spp: int, nee_rr):
        n = pixf.shape[0]
        # ---- respawn: dead lanes with samples left start a new path
        u_pix, stream = stream_next2d(s.stream, (n,))
        o0, d0 = generate_rays(scene.camera, pixf + u_pix)
        need = (~s.alive) & (s.done < spp)
        nm = need[:, None]
        o = torch.where(nm, o0, s.o)
        d = torch.where(nm, d0, s.d)
        prev_pdf = torch.where(need, 1.0, s.prev_pdf)
        prev_delta = need | s.prev_delta
        prev_nee = (~need) & s.prev_nee
        alive = s.alive | need
        # the reference caps a path at hard_cap edges when max_depth is None,
        # so that no path is still in flight at it_cap
        v = self._vertex(scene, o, d, torch.where(nm, 1.0, s.throughput),
                         torch.where(nm, 0.0, s.rad_path), alive,
                         torch.where(need, 0, s.depth), prev_pdf, prev_delta,
                         prev_nee, (~need) & s.prev_occ, stream, nee_rr,
                         self.hard_cap if self.max_depth is None
                         else self.max_depth)

        # ---- sample bookkeeping: paths that just ended bank their sum
        finished = alive & (~v.alive)
        an = v.alive[:, None]
        return _PersistentState(
            stream=v.stream,
            o=torch.where(an, v.o, o),
            d=torch.where(an, v.d, d),
            throughput=torch.where(an, v.throughput, v.thr),
            rad_path=v.radiance,
            accum=s.accum + torch.where(finished[:, None], v.radiance, 0.0),
            alive=v.alive, done=s.done + finished.to(torch.int32),
            depth=torch.where(need, 0, s.depth) + 1,
            prev_pdf=torch.where(v.alive, v.pdf_dir, prev_pdf),
            prev_delta=torch.where(v.alive, v.is_delta, prev_delta),
            prev_nee=torch.where(v.alive, v.nee_possible, prev_nee),
            prev_occ=v.prev_occ,
        )

    def _naive_bounce(self, scene, hit, smooth, u_bsdf, bs):
        """STRATEGY_NAIVE: cosine-hemisphere sampling on the wi side, weight
        f * cos / pdf with pdf = |cos| / pi. Delta materials keep BSDF
        sampling: a cosine draw never lands on a delta lobe."""
        wo_n = cosine_sample_hemisphere(u_bsdf)
        sz = torch.where(hit.wi[:, 2] < 0.0, -1.0, 1.0)
        wo_n = torch.cat([wo_n[:, :2], wo_n[:, 2:3] * sz[:, None]], dim=-1)
        pdf_n = torch.abs(wo_n[:, 2]) / math.pi
        f_n = bsdf_eval(scene.materials, hit.mat, hit.uv, hit.wi, wo_n,
                        TRANSPORT_IMPORTANCE)
        w_n = f_n / torch.clamp(pdf_n, min=1e-12)[:, None]
        use_n = ~smooth
        return (torch.where(use_n[:, None], wo_n, bs.wo),
                torch.where(use_n[:, None], w_n, bs.weight),
                torch.where(use_n, pdf_n, bs.pdf),
                use_n.logical_not() & bs.is_delta,
                torch.where(use_n, pdf_n > 0.0, bs.valid))

    def _vertex(self, scene, o, d, thr0, rad, alive, depth, prev_pdf,
                prev_delta, prev_nee, prev_occ, stream, nee_rr,
                depth_cap, guide=None, dep=None) -> _Vertex:
        """One segment from o along d and the vertex it ends at, for every
        lane: the medium's free flight, the emission found, NEE, the bounce
        and Russian roulette. `depth` (edges completed, [n] or 0-d) gates
        the terms; a vertex expands while depth + 1 < depth_cap (None: no
        cap here). With `guide` (compute_pixel only) the bounce samples the
        guide mixture; with `dep` too, the vertex's deposits are added to
        it (the deposits' values divide by prev_pdf, so that a bin's mass
        estimates the integral of the radiance over it whatever the
        sampling frequency)."""
        n = o.shape[0]
        use_nee = self.strategy in (STRATEGY_ALL, STRATEGY_EMITTER)
        mis_on = self.strategy == STRATEGY_ALL
        keep_bsdf_hits = self.strategy != STRATEGY_EMITTER
        vol = scene.volume

        # dead lanes trace inert (tfar = 0) rays, which the kernel skips
        rh = intersect_rays(scene.geom, o, d,
                            tfar=torch.where(alive, float("inf"), 0.0))
        hit = fill_hit(scene, o, d, rh)

        # ---- medium: free-flight sampling along the segment
        if vol is not None:
            u_med, stream = stream_next(stream, (n,))
            sd = volume_sample_distance(vol, torch.where(rh.hit, rh.t, 1e8),
                                        u_med)
            scattered = alive & (~sd.exited)
            thr = thr0 * sd.w
            p_scatter = o + d * sd.t[:, None]
        else:
            scattered = torch.zeros_like(alive)
            thr = thr0
        lane_hit = alive & hit.valid & (~scattered)

        # ---- emission picked up through the BSDF/sensor edge
        le = emitted_radiance(scene.emitters, scene.geom, hit.tri, d,
                              uv=hit.uv)
        if scene.ats is not None:
            pdf_light = direct_pdf_tri_ats(scene.emitters, scene.geom,
                                           scene.ats, hit.tri, o, hit.p,
                                           hit.n_g, d)
        else:
            pdf_light = direct_pdf_tri(scene.emitters, hit.tri, o, hit.p,
                                       hit.n_g, d)

        def mis_hit(pdf_nee):
            """The directional strategy's weight against NEE's pdf."""
            if not mis_on:
                return torch.ones_like(prev_pdf)
            return torch.where(prev_delta | (~prev_nee), 1.0,
                               mis_balance(prev_pdf, pdf_nee))
        senses = depth >= self.min_depth
        if not keep_bsdf_hits:   # the sensor edge always contributes
            senses = senses & (depth == 0)
        w_hit = mis_hit(pdf_light)
        rad = rad + torch.where((lane_hit & senses)[:, None],
                                thr * le * w_hit[:, None], 0.0)
        if dep is not None:
            # incident radiance into o along d (the previous bounce)
            from_bounce = (depth > 0) & (~prev_delta)
            inv_p = 1.0 / torch.clamp(prev_pdf, min=1e-4)
            dep = _gd.deposit(dep, guide, o, d,
                              torch.mean(le, -1) * w_hit * inv_p,
                              lane_hit & senses & from_bounce)

        # ---- escaped rays: the environment
        if scene.emitters.has_env:
            esc = alive & (~hit.valid) & (~scattered)
            le_env = env_radiance(scene.emitters, d)
            w_env = mis_hit(env_direction_pdf(scene.emitters, d))
            rad = rad + torch.where((esc & senses)[:, None],
                                    thr * le_env * w_env[:, None], 0.0)
            if dep is not None:
                dep = _gd.deposit(
                    dep, guide, o, d, torch.mean(le_env, -1) * w_env
                    / torch.clamp(prev_pdf, min=1e-4),
                    esc & senses & from_bounce)

        smooth = bsdf_is_smooth(scene.materials, hit.mat)
        # single scattering: a surface vertex adds its emission and ends
        lane_surface = (torch.zeros_like(lane_hit) if self.single_scattering
                        else lane_hit)
        can_expand = lane_surface | scattered
        if depth_cap is not None:
            can_expand = can_expand & (depth + 1 < depth_cap)
        p_v = hit.p if vol is None else torch.where(scattered[:, None],
                                                    p_scatter, hit.p)
        if guide is not None:
            g_alpha = getattr(self, "guide_alpha", 0.5)
            vox = _gd.voxel_of(guide, p_v)
            rough = lane_surface & (~smooth)

        # ---- NEE (light strategy); u_sel/u_pos are drawn in every case
        u_sel, stream = stream_next(stream, (n,))
        u_pos, stream = stream_next2d(stream, (n,))
        if use_nee:
            if scene.ats is not None:
                ls = sample_light_ats(scene.emitters, scene.geom, scene.ats,
                                      p_v, hit.n_s, u_sel, u_pos)
            else:
                ls = sample_light(scene.emitters, scene.geom, p_v, u_sel,
                                  u_pos)
            wo_l = to_local(hit.frame, ls.d)
            f = bsdf_eval(scene.materials, hit.mat, hit.uv, hit.wi, wo_l,
                          TRANSPORT_IMPORTANCE)
            pdf_s = bsdf_pdf(scene.materials, hit.mat, hit.uv, hit.wi,
                             wo_l, TRANSPORT_IMPORTANCE)
            pdf_other = pdf_s
            p_shadow = offset_ray_origin(hit.p, hit.n_g, ls.d)
            tr_sh = None
            if vol is not None:
                ph = phase_eval(vol.phase_g, -d, ls.d)
                f = torch.where(scattered[:, None], ph[:, None], f)
                pdf_other = torch.where(scattered, ph, pdf_other)
                p_shadow = torch.where(scattered[:, None], p_v, p_shadow)
                tr_sh = transmittance(vol, ls.dist)
            if guide is not None:
                # on rough surfaces the directional strategy is the
                # BSDF/guide mixture: its pdf enters the NEE MIS weight
                pdf_other = torch.where(
                    rough, g_alpha * _gd.guide_pdf(guide, vox, ls.d)
                    + (1.0 - g_alpha) * pdf_s, pdf_other)
            pre_ok = (can_expand & (scattered | (lane_surface & (~smooth)))
                      & ls.valid & ((depth + 1) >= self.min_depth))
            nee_scale = None
            if nee_rr is not None:
                u_nrr, stream = stream_next(stream, (n,))
                p_keep = torch.where(prev_occ, float(nee_rr), 1.0)
                pre_ok = pre_ok & (u_nrr < p_keep)
                nee_scale = (1.0 / p_keep)[:, None]
            # lanes that cannot contribute shoot an inert (tfar = 0) ray
            vis = visible(scene.geom, p_shadow, ls.p, mask=pre_ok)
            if mis_on:
                w_nee = torch.where(ls.is_delta, 1.0,
                                    mis_balance(ls.pdf, pdf_other))
            else:
                w_nee = torch.ones_like(ls.pdf)
            nee_ok = pre_ok & vis
            prev_occ = torch.where(pre_ok, ~vis, prev_occ)
            contrib = thr * f
            if tr_sh is not None:
                contrib = contrib * tr_sh
            contrib = contrib * ls.weight * w_nee[:, None]
            if nee_scale is not None:
                contrib = contrib * nee_scale
            rad = rad + torch.where(nee_ok[:, None], contrib, 0.0)
            if dep is not None:
                # ls.weight = Le G / pdf, the incident radiance along ls.d
                # (f left out: the grid learns L_i, not the product)
                li = ls.weight if tr_sh is None else ls.weight * tr_sh
                dep = _gd.deposit(dep, guide, p_v, ls.d,
                                  torch.mean(li, -1) * w_nee, nee_ok)
                # one-bounce look-ahead: the same event seen from the
                # previous vertex along its bounce direction, so that a
                # wall whose own NEE is occluded still learns where the
                # light comes from
                fl = f if tr_sh is None else f * tr_sh
                dep = _gd.deposit(
                    dep, guide, o, d, torch.mean(fl * ls.weight, -1) * w_nee
                    / torch.clamp(prev_pdf, min=1e-4),
                    nee_ok & from_bounce)

        # ---- directional bounce: BSDF at surfaces, phase in the medium
        u_bsdf, stream = stream_next2d(stream, (n,))
        bs = bsdf_sample(scene.materials, hit.mat, hit.uv, hit.wi, u_bsdf,
                         TRANSPORT_IMPORTANCE)
        if self.strategy == STRATEGY_NAIVE:
            wo, weight, pdf_dir, is_delta, valid_dir = self._naive_bounce(
                scene, hit, smooth, u_bsdf, bs)
        else:
            wo, weight, pdf_dir, is_delta, valid_dir = (
                bs.wo, bs.weight, bs.pdf, bs.is_delta, bs.valid)
        wo_world = to_world(hit.frame, wo)
        if guide is not None:
            # defensive one-sample MIS: with probability alpha the draw
            # comes from the learned distribution, else from the BSDF;
            # either way the direction is weighted by f cos / pdf_mixture
            u_gsel, stream = stream_next(stream, (n,))
            u_gdir, stream = stream_next2d(stream, (n,))
            d_guided, _ = _gd.guide_sample(guide, vox, u_gdir)
            mixable = (rough if self.strategy != STRATEGY_NAIVE
                       else torch.zeros_like(rough))
            take_g = mixable & (u_gsel < g_alpha)
            wo_world = torch.where(take_g[:, None], d_guided, wo_world)
            wo_loc = to_local(hit.frame, wo_world)
            f_mix = bsdf_eval(scene.materials, hit.mat, hit.uv, hit.wi,
                              wo_loc, TRANSPORT_IMPORTANCE)
            pdf_b = bsdf_pdf(scene.materials, hit.mat, hit.uv, hit.wi,
                             wo_loc, TRANSPORT_IMPORTANCE)
            pdf_mix = (g_alpha * _gd.guide_pdf(guide, vox, wo_world)
                       + (1.0 - g_alpha) * pdf_b)
            w_mix = f_mix / torch.clamp(pdf_mix, min=1e-20)[:, None]
            weight = torch.where(mixable[:, None], w_mix, weight)
            pdf_dir = torch.where(mixable, pdf_mix, pdf_dir)
            valid_dir = torch.where(mixable, pdf_mix > 0.0, valid_dir)
            is_delta = (~mixable) & is_delta
        if vol is not None:
            d_ph, w_ph, pdf_ph = phase_sample(vol.phase_g, -d, u_bsdf)
            sc = scattered[:, None]
            wo_world = torch.where(sc, d_ph, wo_world)
            weight = torch.where(sc, w_ph, weight)
            pdf_dir = torch.where(scattered, pdf_ph, pdf_dir)
            is_delta = (~scattered) & is_delta
            valid_dir = torch.where(scattered, pdf_ph > 0.0, valid_dir)
        throughput = thr * weight

        # ---- Russian roulette
        u_rr, stream = stream_next(stream, (n,))
        if self.rr_depth is None:
            rr_keep = torch.ones_like(alive)
        else:
            do_rr = (depth + 1) >= self.rr_depth
            rr_p = torch.clamp(channel_max(throughput), max=0.95)
            if guide is not None:
                # guided bounces carry small f / pdf_mix throughput into
                # bright regions: floor their survival
                rr_p = torch.where(mixable, torch.clamp(rr_p, min=0.6), rr_p)
            rr_keep = torch.where(do_rr, u_rr < rr_p, True)
            rr_w = torch.where(do_rr & rr_keep,
                               1.0 / torch.clamp(rr_p, min=1e-8), 1.0)
            throughput = throughput * rr_w[:, None]

        alive_new = (can_expand & valid_dir & rr_keep
                     & (channel_max(throughput) > 0.0))
        o_new = offset_ray_origin(hit.p, hit.n_g, wo_world)
        if vol is not None:
            o_new = torch.where(scattered[:, None], p_v, o_new)
        nee_possible = ((scattered | (~smooth)) if use_nee
                        else torch.zeros_like(smooth))
        return _Vertex(stream=stream, radiance=rad, thr=thr, alive=alive_new,
                       o=o_new, d=wo_world, throughput=throughput,
                       pdf_dir=pdf_dir, is_delta=is_delta,
                       nee_possible=nee_possible, prev_occ=prev_occ, dep=dep)

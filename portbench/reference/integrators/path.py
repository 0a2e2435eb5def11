"""The path tracer, replayed pixel by pixel.

A film of the renderer is a deterministic function of its seed: every
random number a lane uses is a counter-based draw (reference/rng.py) whose
counter is fixed by the order in which the estimator draws. This follows
the path tracer as the renderer states it (its integrators' module docs)
for a chosen set of pixels only, with its own camera, intersection,
shading and materials (reference/scene.py, reference/materials/), so that
each pixel's value can be held to the renderer's:

  - route "persistent" (`path_block`): lane i is pinned to pixel i and
    starts its pixel's next sample in the iteration after its path ends,
    until it has `spp`; each iteration draws, for every lane, u_pix (2D),
    u_sel, u_pos (2D), u_nrr (walk scenes only), u_bsdf (2D), u_rr. The
    film holds the pixel's sum over its samples (zeroed where not finite or
    negative) over spp.
  - route "per_pass" (`path_pixel`): one path a lane a sample: sample s
    draws from the stream folded with s, u_pix once and then the same
    per-bounce draws.

Next-event estimation and BSDF sampling combined by the balance heuristic,
emission counted from the first hit on, Russian roulette from the first
bounce with survival min(max throughput, 0.95), a path of at most
`max_depth` edges; on scenes over the dense tier's size the shadow ray of a
vertex whose previous shadow ray was blocked is itself kept with
probability `nee_rr` and weighted by its inverse.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..rng import Stream, fold_in, seed_key
from ..scene import (EPSILON, SHADOW_SHORT, RefScene, bsdf_eval, bsdf_sample,
                     camera_rays, closest, dot, occluded, offset_origin,
                     pixel_coords, shade, to_local, to_world)

HARD_CAP = 64     # the most edges a path may have when max_depth is None


def _safe(values):
    """A sample sum counts only where finite and non-negative."""
    ok = torch.all(torch.isfinite(values) & (values >= 0.0), -1, keepdim=True)
    return torch.where(ok, values, torch.zeros_like(values))


def _balance(a, b):
    w = a / torch.clamp(a + b, min=1e-30)
    w = torch.where(torch.isfinite(a) & torch.isfinite(b), w,
                    torch.zeros_like(w))
    return torch.where(a > 0.0, w, torch.zeros_like(w))


class _Vertex(NamedTuple):
    rad: torch.Tensor
    thr: torch.Tensor
    alive: torch.Tensor
    o: torch.Tensor
    d: torch.Tensor
    throughput: torch.Tensor
    pdf_dir: torch.Tensor
    delta: torch.Tensor
    prev_occ: torch.Tensor


def _visible(sc, p0, p1, mask):
    """Mutual visibility p0 <-> p1 of the lanes in `mask` (True elsewhere)."""
    vis = torch.ones(mask.shape, dtype=torch.bool, device=mask.device)
    idx = torch.nonzero(mask).squeeze(1)
    if idx.numel():
        delta = p1[idx] - p0[idx]
        dist = torch.sqrt(dot(delta, delta))
        d = delta / torch.clamp(dist, min=1e-20)[:, None]
        tnear = torch.full_like(dist, EPSILON)
        vis[idx] = ~occluded(sc, p0[idx], d, tnear,
                             dist * (1.0 - SHADOW_SHORT))
    return vis


def _vertex(sc: RefScene, st: Stream, o, d, thr, rad, alive, depth,
            prev_pdf, prev_delta, prev_nee, prev_occ, depth_cap,
            nee_rr) -> _Vertex:
    """One segment and the vertex it ends at, for every lane."""
    dt = sc.dtype
    zero = torch.zeros((), dtype=dt, device=o.device)
    tfar = torch.where(alive, torch.full_like(o[:, 0], math.inf),
                       torch.zeros_like(o[:, 0]))
    t, tri, u, v, valid = closest(sc, o, d, torch.full_like(tfar, EPSILON),
                                  tfar)
    hit = shade(sc, o, d, t, tri, u, v, valid)
    lane_hit = alive & valid

    # emission through the BSDF (or sensor) edge, MIS'd against NEE
    front = valid & (dot(sc.n_g[hit.tri], -d) > 0.0)
    le = torch.where(front[:, None], sc.emission[hit.tri], zero)
    cos_l = torch.clamp(dot(hit.n_g, -d), min=0.0)
    to_hit = hit.p - o
    pdf_light = torch.where(
        valid & (cos_l > 0.0), sc.pdf_area[hit.tri] * dot(to_hit, to_hit)
        / torch.clamp(cos_l, min=1e-20), zero)
    w_hit = torch.where(prev_delta | (~prev_nee), torch.ones_like(prev_pdf),
                        _balance(prev_pdf, pdf_light))
    rad = rad + torch.where(lane_hit[:, None], thr * le * w_hit[:, None],
                            zero)
    can_expand = lane_hit & (depth + 1 < depth_cap)

    # next-event estimation: an emissive triangle by flux, a uniform point
    u_sel = st.next1()
    u_pos = st.next2()
    pick = torch.searchsorted(sc.light_cdf, u_sel.to(torch.float64),
                              right=True) - 1
    pick = torch.clamp(pick, 0, sc.light_tri.shape[0] - 1)
    ltri = sc.light_tri[pick]
    sel_pdf = sc.light_prob[pick]
    su = torch.sqrt(u_pos[:, 0])
    b0, b1 = 1.0 - su, u_pos[:, 1] * su
    lp = sc.v0[ltri] + b0[:, None] * sc.e1[ltri] + b1[:, None] * sc.e2[ltri]
    delta = lp - hit.p
    dist = torch.sqrt(dot(delta, delta))
    ld = delta / torch.clamp(dist, min=1e-20)[:, None]
    cos_e = torch.clamp(dot(sc.n_g[ltri], -ld), min=0.0)
    g = torch.where(dist > 0.0, cos_e / torch.clamp(dist * dist, min=1e-20),
                    zero)
    pdf_a = sel_pdf / torch.clamp(sc.area[ltri], min=1e-20)
    l_pdf = torch.where(g > 0.0, pdf_a * dist * dist
                        / torch.clamp(cos_e, min=1e-20), zero)
    l_ok = (g > 0.0) & (sel_pdf > 0.0)
    l_w = torch.where(l_ok[:, None], sc.emission[ltri]
                      * (g / torch.clamp(pdf_a, min=1e-30))[:, None], zero)
    wo_l = to_local(hit.frame, ld)
    f, pdf_s = bsdf_eval(sc, hit.tri, hit.wi, wo_l)
    p_shadow = offset_origin(hit.p, hit.n_g, ld)
    pre_ok = can_expand & l_ok
    scale = None
    if nee_rr is not None:
        u_nrr = st.next1()
        p_keep = torch.where(prev_occ, torch.full_like(u_nrr, nee_rr),
                             torch.ones_like(u_nrr))
        pre_ok = pre_ok & (u_nrr < p_keep)
        scale = (1.0 / p_keep)[:, None]
    vis = _visible(sc, p_shadow, lp, pre_ok)
    nee_ok = pre_ok & vis
    prev_occ = torch.where(pre_ok, ~vis, prev_occ)
    contrib = thr * f * l_w * _balance(l_pdf, pdf_s)[:, None]
    if scale is not None:
        contrib = contrib * scale
    rad = rad + torch.where(nee_ok[:, None], contrib, zero)

    # the BSDF's bounce
    wo, weight, pdf_dir, is_delta, ok_dir = bsdf_sample(sc, hit.tri, hit.wi,
                                                        st.next2())
    throughput = thr * weight
    wo_w = to_world(hit.frame, wo)

    # Russian roulette
    u_rr = st.next1()
    rr_p = torch.clamp(torch.amax(throughput, -1), max=0.95)
    keep = u_rr < rr_p
    throughput = throughput * torch.where(
        keep, 1.0 / torch.clamp(rr_p, min=1e-8),
        torch.ones_like(rr_p))[:, None]
    alive_new = (can_expand & ok_dir & keep
                 & (torch.amax(throughput, -1) > 0.0))
    return _Vertex(rad=rad, thr=thr, alive=alive_new,
                   o=offset_origin(hit.p, hit.n_g, wo_w), d=wo_w,
                   throughput=throughput, pdf_dir=pdf_dir, delta=is_delta,
                   prev_occ=prev_occ)


def path_block(sc: RefScene, seed: int, lanes: torch.Tensor, spp: int,
               max_depth: int, nee_rr) -> torch.Tensor:
    """The persistent route's film values [p, 3] of pixels `lanes`
    (y * width + x) in the render seeded `seed`."""
    dt, dev = sc.dtype, lanes.device
    n = lanes.shape[0]
    cap = min(HARD_CAP, max_depth)
    st = Stream(fold_in(seed_key(seed), 0), lanes, dt)
    pixf = pixel_coords(sc, lanes)
    z3 = torch.zeros((n, 3), dtype=dt, device=dev)
    o, d, thr, rad, acc = z3, z3, z3, z3, z3
    alive = torch.zeros(n, dtype=torch.bool, device=dev)
    done = torch.zeros(n, dtype=torch.int64, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    prev_pdf = torch.ones(n, dtype=dt, device=dev)
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
    prev_nee = torch.zeros_like(alive)
    prev_occ = torch.zeros_like(alive)
    for _ in range(spp * cap + 4):
        if not bool(torch.any(alive | (done < spp))):
            break
        o0, d0 = camera_rays(sc, pixf + st.next2())
        need = (~alive) & (done < spp)
        nm = need[:, None]
        o = torch.where(nm, o0, o)
        d = torch.where(nm, d0, d)
        prev_pdf = torch.where(need, torch.ones_like(prev_pdf), prev_pdf)
        prev_delta = need | prev_delta
        prev_nee = (~need) & prev_nee
        alive = alive | need
        depth = torch.where(need, torch.zeros_like(depth), depth)
        v = _vertex(sc, st, o, d, torch.where(nm, 1.0, thr).to(dt),
                    torch.where(nm, 0.0, rad).to(dt), alive, depth, prev_pdf,
                    prev_delta, prev_nee, (~need) & prev_occ, max_depth,
                    nee_rr)
        finished = alive & (~v.alive)
        acc = acc + torch.where(finished[:, None], v.rad, torch.zeros_like(
            v.rad))
        done = done + finished.to(done.dtype)
        an = v.alive[:, None]
        o = torch.where(an, v.o, o)
        d = torch.where(an, v.d, d)
        thr = torch.where(an, v.throughput, v.thr)
        rad = v.rad
        alive = v.alive
        depth = depth + 1
        prev_pdf = torch.where(v.alive, v.pdf_dir, prev_pdf)
        prev_delta = torch.where(v.alive, v.delta, prev_delta)
        prev_nee = torch.where(v.alive, True, prev_nee)
        prev_occ = v.prev_occ
    return _safe(acc) / spp


def path_pixel(sc: RefScene, seed: int, lanes: torch.Tensor, spp: int,
               max_depth: int, nee_rr) -> torch.Tensor:
    """The per-pass route's film values [p, 3] of pixels `lanes`."""
    dt, dev = sc.dtype, lanes.device
    n = lanes.shape[0]
    cap = min(HARD_CAP, max_depth)
    pixf = pixel_coords(sc, lanes)
    total = torch.zeros((n, 3), dtype=dt, device=dev)
    for s in range(spp):
        st = Stream(fold_in(seed_key(seed), s), lanes, dt)
        o, d = camera_rays(sc, pixf + st.next2())
        thr = torch.ones((n, 3), dtype=dt, device=dev)
        rad = torch.zeros((n, 3), dtype=dt, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        prev_pdf = torch.ones(n, dtype=dt, device=dev)
        prev_delta = torch.ones_like(alive)
        prev_nee = torch.zeros_like(alive)
        prev_occ = torch.zeros_like(alive)
        for k in range(cap):
            if not bool(torch.any(alive)):
                break
            v = _vertex(sc, st, o, d, thr, rad, alive,
                        torch.tensor(k, device=dev), prev_pdf, prev_delta,
                        prev_nee, prev_occ, max_depth, nee_rr)
            an = v.alive[:, None]
            o = torch.where(an, v.o, o)
            d = torch.where(an, v.d, d)
            thr = torch.where(an, v.throughput, thr)
            rad, alive = v.rad, v.alive
            prev_pdf = torch.where(v.alive, v.pdf_dir, prev_pdf)
            prev_delta = torch.where(v.alive, v.delta, prev_delta)
            prev_nee = torch.where(v.alive, True, prev_nee)
            prev_occ = v.prev_occ
        total = total + _safe(rad)
    return total / spp


def values(sc: RefScene, seed: int, lanes: torch.Tensor, spp: int,
           params: dict, route: str) -> torch.Tensor:
    """The film values [p, 3] of pixels `lanes` (y * width + x) in the pass
    seeded `seed` of `spp` samples on `route`."""
    route_fn = {"persistent": path_block, "per_pass": path_pixel}[route]
    return route_fn(sc, seed, lanes, spp, params["max_depth"],
                    params["nee_rr"])

"""Single-scattering distance-sampling integrator (equiangular sampling and
its extensions), the `point-normal` family; port of
rustlight_tpu/integrators/point_normal.py.

Strategies, all per lane and branch-free:
  tr            spectral transmittance distance sampling
  equiangular   equiangular sampling around the sampled light point
  eq_clamp      equiangular on the angular domain clamped by the light
                normal's half-space
  warp          linear or Bezier warps of the equiangular angle, shaped by
                transmittance (T), phase (P) and/or the point-normal cosine
                (N), chained
  pn            the analytic a cos + b sin point-normal factor on the
                clamped domain
  taylor_tr / taylor_phase        degree-6 Taylor product sampling
  pn_taylor_tr / pn_taylor_phase  Taylor x point-normal
  best / pn_best                  the phase-Taylor draw composed with a
                                  transmittance-shaped Bezier warp
The strategies combine by the balance heuristic over their distance pdfs.
A lane whose product sampler is degenerate falls back to plain equiangular
sampling, sample and pdf alike. The `ex` connection samples the light; the
`phase` connection samples the phase function and intersects the emitter.

Draws per lane, in the reference's order: u_pix (n, 2), u_sel, u_lpos (n,
2), then per strategy u_t and, with the `phase` connection, u_ph (n, 2).
`splitting` (-k) takes the reference's ATS traversal when the scene has
the ATS light tree (`-x ats`): `ats_sample_split` returns a set of up to 8
lights a camera ray, each with its own distance sample (the first strategy;
warp and pn fall back to equiangular) and explicit connection. Its draws:
u_pix (n, 2), u_sel, u_pos (n, 2), u_stack (n, 40), then u_t a light slot.
Without the tree the ordinary route renders, as the reference's does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..accel import intersect_rays, visible
from ..scene import emitted_radiance, fill_hit, generate_rays, sample_light
from ..scene.ats import ats_sample_split
from ..scene.emitters import _tri_le
from ..scene.volume import (distance_pdf, phase_eval, phase_sample,
                            transmittance, volume_sample_distance)
from ..utils.rng import stream_next, stream_next2d
from ..utils.vec import dot, length
from ..utils.warps import uniform_sample_triangle
from . import point_normal_poly as pp

STRATEGY_TR = "tr"
STRATEGY_EQUIANGULAR = "equiangular"
STRATEGY_EQ_CLAMP = "eq_clamp"
STRATEGY_WARP = "warp"
STRATEGY_PN = "pn"
STRATEGY_TAYLOR_TR = "taylor_tr"
STRATEGY_TAYLOR_PHASE = "taylor_phase"
STRATEGY_PN_TAYLOR_TR = "pn_taylor_tr"
STRATEGY_PN_TAYLOR_PHASE = "pn_taylor_phase"
STRATEGY_BEST = "best"          # phase-Taylor x TR-Bezier
STRATEGY_PN_BEST = "pn_best"    # PointNormalTaylor(phase) x TR-Bezier

_ALL_STRATEGIES = (STRATEGY_TR, STRATEGY_EQUIANGULAR, STRATEGY_EQ_CLAMP,
                   STRATEGY_WARP, STRATEGY_PN, STRATEGY_TAYLOR_TR,
                   STRATEGY_TAYLOR_PHASE, STRATEGY_PN_TAYLOR_TR,
                   STRATEGY_PN_TAYLOR_PHASE, STRATEGY_BEST, STRATEGY_PN_BEST)
_TAYLOR = (STRATEGY_TAYLOR_TR, STRATEGY_TAYLOR_PHASE)
_PN_TAYLOR = (STRATEGY_PN_TAYLOR_TR, STRATEGY_PN_TAYLOR_PHASE)
_BEST = (STRATEGY_BEST, STRATEGY_PN_BEST)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


# ------------------------------------------------------------ angular warps

def _linear_pdf(v0, v1, x):
    return 2.0 * (v0 * (1.0 - x) + v1 * x) / torch.clamp(v0 + v1, min=1e-30)


def _linear_cdf(v0, v1, x):
    return x * (v0 * (2.0 - x) + v1 * x) / torch.clamp(v0 + v1, min=1e-30)


def _linear_cdf_inv(v0, v1, s):
    # solve (v1 - v0) x^2 + 2 v0 x - (v0 + v1) s = 0 on [0, 1]
    a = v1 - v0
    b = 2.0 * v0
    c = -(v0 + v1) * s
    disc = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
    lin = torch.abs(a) < 1e-8 * torch.clamp(torch.abs(v0) + torch.abs(v1),
                                            min=1e-20)
    q = -0.5 * (b + torch.where(b >= 0, disc, -disc))
    r1 = q / torch.where(torch.abs(a) > 1e-30, a, 1.0)
    r2 = c / torch.where(torch.abs(q) > 1e-30, q, 1.0)
    in01 = (r1 >= -1e-4) & (r1 <= 1.0 + 1e-4)
    root = torch.where(lin, s, torch.where(in01, r1, r2))
    return torch.clamp(root, 0.0, 1.0)


def _bezier_pdf(v0, v1, v2, x):
    tot = v0 + v1 + v2
    c = (1 - x) ** 2 * v0 + 2 * (1 - x) * x * v1 + x ** 2 * v2
    return torch.where(tot > 1e-5, 3.0 * c / torch.clamp(tot, min=1e-30), 1.0)


def _bezier_cdf(v0, v1, v2, x):
    tot = v0 + v1 + v2
    c = (v0 - 2 * v1 + v2) * x ** 3 + 3 * (v1 - v0) * x ** 2 + 3 * v0 * x
    return torch.where(tot > 1e-5, c / torch.clamp(tot, min=1e-30), x)


def _bezier_cdf_inv(v0, v1, v2, s, iters: int = 24):
    """Monotone-CDF inversion: `iters` Newton steps with a bisection
    safeguard, no early exit (the pdf is nonnegative, so the CDF is
    monotone)."""
    lo = torch.zeros_like(s)
    hi = torch.ones_like(s)
    x = s
    for _ in range(iters):
        f = _bezier_cdf(v0, v1, v2, x) - s
        lo = torch.where(f < 0, x, lo)
        hi = torch.where(f > 0, x, hi)
        df = _bezier_pdf(v0, v1, v2, x)
        x_new = x - f / torch.clamp(df, min=1e-8)
        bad = (x_new <= lo) | (x_new >= hi) | (~torch.isfinite(x_new))
        x = torch.where(bad, 0.5 * (lo + hi), x_new)
    return torch.clamp(x, 0.0, 1.0)


def _warp_values(kind, theta, o, d, p_light, n_light, delta, d_l,
                 sigma_t_avg, g):
    """A warp's shaping value at angle theta."""
    if kind == "P":
        tmp = 1.0 + g * g + 2.0 * g * torch.sin(theta)
        return 1.0 / (tmp * torch.sqrt(torch.clamp(tmp, min=1e-12)))
    if kind == "N":
        dd = ((o + d * delta[:, None] - p_light)
              / torch.clamp(d_l, min=1e-20)[:, None])
        a = dot(n_light, dd)
        b = dot(n_light, d)
        return torch.clamp(a * torch.cos(theta) + b * torch.sin(theta),
                           min=0.0)
    if kind == "T":
        ct = torch.cos(theta)
        return torch.exp(-sigma_t_avg * (
            d_l * torch.tan(theta) + delta
            + d_l / torch.clamp(torch.abs(ct), min=1e-6)))
    raise ValueError(kind)


def _equiangular_params(o, d, pos, tmax):
    """Per-lane equiangular parametrization: (delta, d_l, theta_a,
    theta_b)."""
    delta = dot(d, pos - o)
    closest = o + d * delta[:, None]
    d_l = torch.clamp(length(pos - closest), min=1e-6)
    theta_a = torch.arctan(-delta / d_l)
    theta_b = torch.arctan((tmax - delta) / d_l)
    return delta, d_l, theta_a, theta_b


def _equiangular_clamp(o, d, pos, nrm, tmax, theta_a, theta_b, delta, d_l):
    """Clamp the angular range by the light's normal half-space. Returns
    (theta_a, theta_b, valid)."""
    d_dot_n = dot(d, nrm)
    p_dot_n = dot(pos - o, nrm)
    invisible = (d_dot_n <= 0.0) & (p_dot_n >= 0.0)
    parallel = (torch.abs(d_dot_n) < 1e-5) | ((p_dot_n == 0.0)
                                              & (d_dot_n > 0.0))
    t_hit = p_dot_n / torch.where(torch.abs(d_dot_n) > 1e-12, d_dot_n, 1.0)
    hit_inside = (t_hit >= 0.0) & (t_hit <= tmax)
    alpha = torch.arctan((t_hit - delta) / d_l)
    keep = parallel | (~hit_inside)
    ta = torch.where(keep, theta_a,
                     torch.where(p_dot_n > 0.0, alpha, theta_a))
    tb = torch.where(keep, theta_b,
                     torch.where(p_dot_n > 0.0, theta_b, alpha))
    valid = (~invisible) & (ta < tb)
    return ta, tb, valid


def _equiangular_sample(u, delta, d_l, theta_a, theta_b, tmax):
    t = d_l * torch.tan((1.0 - u) * theta_a + u * theta_b)
    t_eq = _clip(t + delta, torch.zeros_like(tmax), tmax)
    denom = (theta_b - theta_a) * (d_l ** 2 + t ** 2)
    pdf = torch.where(denom > 0.0, d_l / torch.clamp(denom, min=1e-30), 0.0)
    return t_eq, pdf


def _equiangular_pdf(dist, delta, d_l, theta_a, theta_b, clamped: bool):
    t = dist - delta
    pdf = d_l / torch.clamp((theta_b - theta_a) * (d_l ** 2 + t ** 2),
                            min=1e-30)
    if not clamped:
        return pdf
    theta = torch.arctan(t / d_l)
    return torch.where((theta >= theta_a) & (theta <= theta_b), pdf, 0.0)


def _angle_to_distance(theta, pdf_ang, valid, u_t, eq, tmax):
    """An angular sample theta (pdf pdf_ang) -> distance and pdf, plain
    equiangular sampling on the lanes that are not `valid`."""
    delta, d_l, ta, tb = eq
    tt = d_l * torch.tan(theta)
    t_s = _clip(tt + delta, torch.zeros_like(tmax), tmax)
    pdf_s = pdf_ang * d_l / torch.clamp(d_l ** 2 + tt ** 2, min=1e-30)
    t_eq, pdf_eq = _equiangular_sample(u_t, delta, d_l, ta, tb, tmax)
    t = torch.where(valid, t_s, t_eq)
    pdf = torch.where(valid, pdf_s, pdf_eq)
    return t, pdf, pdf > 0.0


def _taylor_poly(vol, name, d_l):
    """The degree-6 Taylor polynomial of a product strategy's factor and its
    clamp angle: transmittance for the *_tr names, else the phase."""
    if name.endswith("_tr"):
        st_avg = torch.mean(vol.sigma_t)
        return pp.poly6_tr(d_l, st_avg), pp.clamp_angle_tr(st_avg, d_l)
    g = vol.phase_g
    return pp.poly6_phase(g), pp.clamp_angle_phase(g).expand(d_l.shape)


class IntegratorPointNormal:
    def __init__(self, strategies: Sequence[str] = (STRATEGY_EQUIANGULAR,),
                 splitting: Optional[float] = None,
                 warps: str = "T", warps_strategy: str = "linear",
                 use_aa: bool = True, connection: str = "ex"):
        for s in strategies:
            if s not in _ALL_STRATEGIES:
                raise ValueError(f"unknown strategy {s!r}")
        if connection not in ("ex", "phase"):
            raise ValueError(f"unknown connection {connection!r}")
        self.strategies = tuple(strategies)
        self.splitting = splitting
        self.warps = warps                    # chars from {T, P, N} (-w)
        self.warps_strategy = warps_strategy  # linear | bezier
        self.use_aa = use_aa                  # -z: pixel centers, no jitter
        self.connection = connection

    # ------------------------------------------------------- warp chains
    def _warp_params(self, scene, o, d, ls0, eq):
        delta, d_l, ta, tb = eq
        g = scene.volume.phase_g
        st = torch.mean(scene.volume.sigma_t)
        mid = 0.5 * (ta + tb)
        args = (o, d, ls0.p, ls0.n, delta, d_l, st, g)
        params = []
        for c in self.warps:
            v0 = _warp_values(c, ta, *args)
            v1 = _warp_values(c, tb, *args)
            if self.warps_strategy == "bezier":
                params.append((v0, _warp_values(c, mid, *args), v1))
            else:
                params.append((v0, v1))
        return params

    @staticmethod
    def _warp_chain_sample(params, s):
        """Position: the inverse CDFs chained; pdf: their product."""
        pdf = torch.ones_like(s)
        pos = s
        for pr in params:
            if len(pr) == 2:
                pos = _linear_cdf_inv(pr[0], pr[1], pos)
                pdf = pdf * _linear_pdf(pr[0], pr[1], pos)
            else:
                pos = _bezier_cdf_inv(pr[0], pr[1], pr[2], pos)
                pdf = pdf * _bezier_pdf(pr[0], pr[1], pr[2], pos)
        return pos, pdf

    @staticmethod
    def _warp_chain_pdf(params, x):
        """The chain's pdf at angular position x, walked in reverse."""
        pdf = torch.ones_like(x)
        pos = x
        for pr in reversed(params):
            if len(pr) == 2:
                pdf = pdf * _linear_pdf(pr[0], pr[1], pos)
                pos = _linear_cdf(pr[0], pr[1], pos)
            else:
                pdf = pdf * _bezier_pdf(pr[0], pr[1], pr[2], pos)
                pos = _bezier_cdf(pr[0], pr[1], pr[2], pos)
        return pdf

    def _product_setups(self, scene, o, d, ls0, eq, eqc):
        """Per-lane setups of the analytic and Taylor product samplers."""
        delta, d_l, ta, tb = eq
        _, _, ta_c, tb_c, valid_c = eqc
        st_avg = torch.mean(scene.volume.sigma_t)
        g = scene.volume.phase_g
        setups = {}
        if any(s in self.strategies
               for s in (STRATEGY_PN, STRATEGY_PN_BEST) + _PN_TAYLOR):
            a0, b0 = pp.pn_coeffs(o, d, ls0.p, ls0.n, delta, d_l)
            nrm = pp.pn_norm(a0, b0, ta_c, tb_c)
            safe = torch.where(torch.abs(nrm) > 1e-20, nrm, 1.0)
            setups["_pn_raw"] = (a0, b0)
            setups[STRATEGY_PN] = (a0 / safe, b0 / safe,
                                   valid_c & (nrm > 1e-20))
        for name in self.strategies:
            if name not in _TAYLOR + _PN_TAYLOR + _BEST:
                continue
            c, clamp = _taylor_poly(scene.volume, name, d_l)
            if name in _TAYLOR + (STRATEGY_BEST,):
                st = pp.taylor_setup(c, ta, tb, clamp)
            else:
                a0, b0 = setups["_pn_raw"]
                st = pp.pn_taylor_setup(c, a0, b0, ta_c, tb_c, clamp)
                st["valid"] = st["valid"] & valid_c
            if name in _BEST:
                # the Taylor draw composed with a transmittance-shaped
                # Bezier warp
                dom_a, dom_b = ((ta_c, tb_c) if name == STRATEGY_PN_BEST
                                else (ta, tb))
                mid = 0.5 * (dom_a + dom_b)
                args = (o, d, ls0.p, ls0.n, delta, d_l, st_avg, g)
                wp = (_warp_values("T", dom_a, *args),
                      _warp_values("T", mid, *args),
                      _warp_values("T", dom_b, *args))
                setups[name] = (c, st, wp)
            else:
                setups[name] = (c, st)
        return setups

    @staticmethod
    def _best_compose_sample(theta1, pdf_ang, wp, dom_a, dom_b):
        """theta2 = the warp's inverse at the normalized Taylor draw; its
        density times the warp pdf (the range factors cancel)."""
        rng = torch.clamp(dom_b - dom_a, min=1e-12)
        x1 = torch.clamp((theta1 - dom_a) / rng, 0.0, 1.0)
        x2 = _bezier_cdf_inv(*wp, x1)
        return dom_a + x2 * rng, pdf_ang * _bezier_pdf(*wp, x2)

    @staticmethod
    def _best_compose_pdf(theta2, wp, dom_a, dom_b):
        """The inverse map for MIS: theta2 -> theta1 and the warp pdf."""
        rng = torch.clamp(dom_b - dom_a, min=1e-12)
        x2 = torch.clamp((theta2 - dom_a) / rng, 0.0, 1.0)
        return dom_a + _bezier_cdf(*wp, x2) * rng, _bezier_pdf(*wp, x2)

    def _distance_pdfs(self, scene, name, t, eq, eqc, wparams, setups):
        """The pdf of strategy `name` at distance t (for MIS)."""
        delta, d_l, ta, tb = eq
        if name == STRATEGY_TR:
            return distance_pdf(scene.volume, t, torch.zeros_like(t,
                                                                  dtype=bool))
        if name == STRATEGY_EQUIANGULAR:
            return _equiangular_pdf(t, delta, d_l, ta, tb, False)
        tt = t - delta
        theta = torch.arctan(tt / d_l)
        jac = d_l / torch.clamp(d_l ** 2 + tt ** 2, min=1e-30)
        if name == STRATEGY_WARP:
            rng = torch.clamp(tb - ta, min=1e-12)
            x = torch.clamp((theta - ta) / rng, 0.0, 1.0)
            return (self._warp_chain_pdf(wparams, x) / rng * d_l
                    / torch.clamp(d_l ** 2 + tt ** 2, min=1e-30))
        eq_fallback = _equiangular_pdf(t, delta, d_l, ta, tb, False)
        _, _, ta_c, tb_c, valid_c = eqc
        if name in _TAYLOR:
            c, st = setups[name]
            return torch.where(st["valid"], pp.taylor_pdf(c, st, theta) * jac,
                               eq_fallback)
        if name in _PN_TAYLOR:
            c, st = setups[name]
            return torch.where(st["valid"],
                               pp.pn_taylor_pdf(c, st, theta) * jac,
                               eq_fallback)
        if name in _BEST:
            c, st, wp = setups[name]
            dom_a, dom_b = ((ta_c, tb_c) if name == STRATEGY_PN_BEST
                            else (ta, tb))
            theta1, pdf_w = self._best_compose_pdf(theta, wp, dom_a, dom_b)
            base = (pp.pn_taylor_pdf(c, st, theta1)
                    if name == STRATEGY_PN_BEST
                    else pp.taylor_pdf(c, st, theta1))
            return torch.where(st["valid"], base * pdf_w * jac, eq_fallback)
        if name == STRATEGY_PN:
            a_n, b_n, ok = setups[STRATEGY_PN]
            inside = (theta >= ta_c) & (theta <= tb_c)
            p = torch.abs(a_n * torch.cos(theta) + b_n * torch.sin(theta)) * jac
            return torch.where(ok, torch.where(inside, p, 0.0), eq_fallback)
        p = _equiangular_pdf(t, delta, d_l, ta_c, tb_c, True)
        return torch.where(valid_c, p, 0.0)

    def _sample(self, scene, name, u_t, eq, eqc, tmax, wparams, setups):
        """Strategy `name`'s distance sample: (t, pdf, valid)."""
        delta, d_l, ta, tb = eq
        _, _, ta_c, tb_c, valid_c = eqc

        def to_dist(theta, pdf_ang, valid):
            return _angle_to_distance(theta, pdf_ang, valid, u_t, eq, tmax)

        if name == STRATEGY_TR:
            sd = volume_sample_distance(scene.volume, tmax, u_t)
            return sd.t, sd.pdf, ~sd.exited
        if name == STRATEGY_EQUIANGULAR:
            t, pdf = _equiangular_sample(u_t, delta, d_l, ta, tb, tmax)
            return t, pdf, pdf > 0.0
        if name == STRATEGY_WARP:
            x, pdf_ang = self._warp_chain_sample(wparams, u_t)
            theta = ta + x * (tb - ta)
            tt = d_l * torch.tan(theta)
            t = _clip(tt + delta, torch.zeros_like(tmax), tmax)
            jac = d_l / torch.clamp(d_l ** 2 + tt ** 2, min=1e-30)
            pdf = pdf_ang / torch.clamp(tb - ta, min=1e-12) * jac
            return t, pdf, pdf > 0.0
        if name in _TAYLOR:
            c, st = setups[name]
            theta, pdf_ang = pp.taylor_sample(c, st, u_t)
            return to_dist(theta, pdf_ang, st["valid"])
        if name in _PN_TAYLOR:
            c, st = setups[name]
            theta, pdf_ang = pp.pn_taylor_sample(c, st, u_t)
            return to_dist(theta, pdf_ang, st["valid"])
        if name in _BEST:
            c, st, wp = setups[name]
            if name == STRATEGY_PN_BEST:
                theta1, pdf_ang = pp.pn_taylor_sample(c, st, u_t)
                dom_a, dom_b = ta_c, tb_c
            else:
                theta1, pdf_ang = pp.taylor_sample(c, st, u_t)
                dom_a, dom_b = ta, tb
            theta, pdf_ang = self._best_compose_sample(theta1, pdf_ang, wp,
                                                       dom_a, dom_b)
            return to_dist(theta, pdf_ang, st["valid"])
        if name == STRATEGY_PN:
            a_n, b_n, ok = setups[STRATEGY_PN]
            theta = pp.pn_invert(a_n, b_n, ta_c, tb_c, u_t)
            pdf_ang = torch.abs(a_n * torch.cos(theta) + b_n * torch.sin(theta))
            return to_dist(theta, pdf_ang, ok)
        t, pdf = _equiangular_sample(u_t, delta, d_l, ta_c, tb_c, tmax)
        return t, pdf, valid_c & (pdf > 0.0)

    def _sample_distance_single(self, scene, name, u_t, o, d, p_l, n_l, tmax):
        """A distance sample toward one split light's point (the
        reference's create_distance_sampling a selected light): (t, pdf,
        valid)."""
        eq = _equiangular_params(o, d, p_l, tmax)
        delta, d_l, ta, tb = eq
        if name == STRATEGY_TR:
            sd = volume_sample_distance(scene.volume, tmax, u_t)
            return sd.t, sd.pdf, ~sd.exited
        if name in _TAYLOR:
            c, clamp = _taylor_poly(scene.volume, name, d_l)
            st = pp.taylor_setup(c, ta, tb, clamp)
            theta, pdf_ang = pp.taylor_sample(c, st, u_t)
            return _angle_to_distance(theta, pdf_ang, st["valid"], u_t, eq,
                                      tmax)
        if name == STRATEGY_EQ_CLAMP:
            ta_c, tb_c, ok = _equiangular_clamp(o, d, p_l, n_l, tmax, ta, tb,
                                                delta, d_l)
            t, pdf = _equiangular_sample(u_t, delta, d_l, ta_c, tb_c, tmax)
            return t, pdf, ok & (pdf > 0.0)
        # equiangular, also for the other strategies under splitting
        t, pdf = _equiangular_sample(u_t, delta, d_l, ta, tb, tmax)
        return t, pdf, pdf > 0.0

    def _compute_splitting(self, scene, pix, stream):
        """Variance-splitting single scattering: the ATS traversal returns a
        set of lights a camera ray; each gets its own distance sample and
        explicit connection (compute_single_strategy_splitting,
        point_normal.rs:2455-2580, emitter.rs:1669-1727)."""
        vol = scene.volume
        geom = scene.geom
        n = pix.shape[0]
        K = 8
        u_pix, stream = stream_next2d(stream, (n,))
        if not self.use_aa:
            u_pix = torch.full_like(u_pix, 0.5)
        o, d = generate_rays(scene.camera, pix.to(torch.float32) + u_pix)
        rh = intersect_rays(geom, o, d)
        tmax = torch.where(rh.hit, rh.t, 1e7)

        u_sel, stream = stream_next(stream, (n,))
        u_pos, stream = stream_next2d(stream, (n,))
        u_stack, stream = stream_next(stream, (n, K + 32))
        tris, pdf_sel, valid, _ = ats_sample_split(
            scene.ats, o, d, tmax, u_sel, u_stack, self.splitting, K)

        b = uniform_sample_triangle(u_pos)   # shared by the split lights
        name = self.strategies[0]
        li = torch.zeros((n, 3), dtype=torch.float32, device=pix.device)
        for k in range(K):
            tri = torch.clamp(tris[:, k], 0, geom.v0.shape[0] - 1)
            psel = torch.clamp(pdf_sel[:, k], min=1e-30)
            p_l = (geom.v0[tri] + b[..., 0:1] * geom.e1[tri]
                   + b[..., 1:2] * geom.e2[tri])
            n_l = geom.n_g[tri]
            le = _tri_le(scene.emitters, geom, tri, b)
            # flux = Le pi area / pdf_sel, times correct_flux (1 / pi)
            flux = le * (geom.area[tri] / psel)[:, None]

            u_t, stream = stream_next(stream, (n,))
            t, pdf_t, d_ok = self._sample_distance_single(
                scene, name, u_t, o, d, p_l, n_l, tmax)
            x_t = o + d * t[:, None]
            dv = p_l - x_t
            t_light = torch.clamp(length(dv), min=1e-20)
            d_hat = dv / t_light[:, None]
            g_f = dot(n_l, -d_hat) / t_light ** 2
            ph = phase_eval(vol.phase_g, -d, d_hat)
            vis = visible(geom, x_t, p_l)
            contrib = (vol.sigma_s[None, :] * flux
                       * transmittance(vol, t) * transmittance(vol, t_light)
                       * (g_f * ph / torch.clamp(pdf_t, min=1e-30))[:, None])
            use = valid[:, k] & d_ok & vis & (g_f > 0.0) & (t > 0.0) & (
                t < tmax)
            li = li + torch.where(use[:, None], contrib, 0.0)
        return li

    def compute_pixel(self, scene, pix, stream):
        if scene.volume is None:
            raise ValueError("point_normal needs a medium")
        if self.splitting is not None and scene.ats is not None:
            return self._compute_splitting(scene, pix, stream)
        vol = scene.volume
        n = pix.shape[0]
        u_pix, stream = stream_next2d(stream, (n,))
        if not self.use_aa:
            u_pix = torch.full_like(u_pix, 0.5)
        o, d = generate_rays(scene.camera, pix.to(torch.float32) + u_pix)
        rh = intersect_rays(scene.geom, o, d)
        tmax = torch.where(rh.hit, rh.t, 1e7)

        # one light sample shared by every strategy
        u_sel, stream = stream_next(stream, (n,))
        u_lpos, stream = stream_next2d(stream, (n,))
        ls0 = sample_light(scene.emitters, scene.geom, o, u_sel, u_lpos)
        eq = _equiangular_params(o, d, ls0.p, tmax)
        delta, d_l, ta, tb = eq
        eqc = (delta, d_l) + _equiangular_clamp(o, d, ls0.p, ls0.n, tmax, ta,
                                                tb, delta, d_l)
        wparams = (self._warp_params(scene, o, d, ls0, eq)
                   if STRATEGY_WARP in self.strategies else None)
        setups = self._product_setups(scene, o, d, ls0, eq, eqc)

        li = torch.zeros((n, 3), dtype=torch.float32, device=pix.device)
        for name in self.strategies:
            u_t, stream = stream_next(stream, (n,))
            t, pdf_t, strat_valid = self._sample(scene, name, u_t, eq, eqc,
                                                 tmax, wparams, setups)
            x_t = o + d * t[:, None]
            tr_cam = transmittance(vol, t)

            # balance-heuristic MIS over the distance strategies
            pdf_sum = torch.zeros_like(pdf_t)
            for other in self.strategies:
                pdf_sum = pdf_sum + self._distance_pdfs(
                    scene, other, t, eq, eqc, wparams, setups)
            w = torch.where(pdf_t > 0.0,
                            pdf_t / torch.clamp(pdf_sum, min=1e-30), 0.0)
            w_pdf = w / torch.clamp(pdf_t, min=1e-30)

            if self.connection == "phase":
                # sample the phase function, intersect the emitter
                u_ph, stream = stream_next2d(stream, (n,))
                d_ph, w_ph, _ = phase_sample(vol.phase_g, -d, u_ph)
                rh2 = intersect_rays(scene.geom, x_t, d_ph)
                hit2 = fill_hit(scene, x_t, d_ph, rh2)
                le = emitted_radiance(scene.emitters, scene.geom, hit2.tri,
                                      d_ph, uv=hit2.uv)
                tr_light = transmittance(vol, torch.where(rh2.hit, rh2.t, 0.0))
                contrib = (vol.sigma_s * tr_cam * tr_light * w_ph * le
                           * w_pdf[:, None])
                ok = (strat_valid & hit2.valid & hit2.is_light
                      & (t > 0.0) & (t < tmax))
            else:
                # the light sample, re-evaluated from the scatter point
                ls = sample_light(scene.emitters, scene.geom, x_t, u_sel,
                                  u_lpos)
                tr_light = transmittance(vol, ls.dist)
                ph = phase_eval(vol.phase_g, -d, ls.d)
                vis = visible(scene.geom, x_t, ls.p)
                contrib = (vol.sigma_s * tr_cam * tr_light * ls.weight
                           * (ph / torch.clamp(pdf_t, min=1e-30) * w)[:, None])
                ok = strat_valid & ls.valid & vis & (t > 0.0) & (t < tmax)
            li = li + torch.where(ok[:, None], contrib, 0.0)
        return li

"""Taylor-polynomial product distance sampling for single scattering; port
of rustlight_tpu/integrators/point_normal_poly.py.

Degree-6 Taylor expansions of the transmittance and Henyey-Greenstein
factors around theta = 0 in the equiangular angle parametrization, with
closed-form CDFs (TaylorSampling), the analytic a cos + b sin point-normal
factor (PointNormalSampling) and their product (PointNormalTaylorSampling).
Every sampler is a set of per-lane functions: setups are [n]-shaped
tensors, the CDF inversion is `utils/solvers.py:newton_bisect` (a fixed 20
iterations), and a lane whose setup is degenerate carries valid = False
(callers fall back to plain equiangular sampling there, sample and pdf
alike).
"""
from __future__ import annotations

import torch

from ..utils.solvers import newton_bisect
from ..utils.vec import dot


# ----------------------------------------------------------------- Poly6

def poly6_phase(g):
    """Degree-6 Taylor coefficients (around theta = 0) of the reduced HG
    kernel 1 / (1 + g^2 + 2 g sin(theta))^(3/2)."""
    g = torch.as_tensor(g, dtype=torch.float32)
    h = 1.0 + g * g
    hs = torch.sqrt(h)
    h32, h52, h72 = 1.0 / (h * hs), 1.0 / (h ** 2 * hs), 1.0 / (h ** 3 * hs)
    h92, h112 = 1.0 / (h ** 4 * hs), 1.0 / (h ** 5 * hs)
    h132, h152 = 1.0 / (h ** 6 * hs), 1.0 / (h ** 7 * hs)
    g2, g3, g4, g5 = g * g, g ** 3, g ** 4, g ** 5
    g6, g7, g8, g9 = g ** 6, g ** 7, g ** 8, g ** 9
    return (
        h32,
        -3.0 * h52 * g,
        7.5 * h72 * g2,
        0.5 * (g - 33.0 * g3 + g5) * h92,
        -0.625 * (4.0 * g2 - 55.0 * g4 + 4.0 * g6) * h112,
        (-0.025 * g + 8.65 * g3 - 69.275 * g5 + 8.65 * g7 - 0.025 * g9) * h132,
        (g2 * (1.0 / 3.0 - 24.916666666666664 * g2 + 137.1875 * g4
               - 24.916666666666664 * g6 + (1.0 / 3.0) * g8)) * h152,
    )


def poly6_tr(d_l, sigma_t):
    """Degree-6 Taylor coefficients of exp(-sigma_t (d_l tan t + d_l / cos
    t)) around theta = 0, up to a constant that cancels in the normalized
    pdf. `d_l` is per lane."""
    x = d_l * sigma_t
    return (
        torch.ones_like(x),
        -x,
        x * (-1.0 + x) / 2.0,
        -x * (-2.0 + x) * (-1.0 + x) / 6.0,
        x * (-5.0 + x * (11.0 + x * (-6.0 + x))) / 24.0,
        -x * (16.0 + x * (-45.0 + x * (35.0 + x * (-10.0 + x)))) / 120.0,
        x * (-61.0 + x * (211.0 + x * (-210.0 + x * (85.0 + x * (-15.0 + x)))))
        / 720.0,
    )


def poly_eval(c, x):
    acc = c[-1] * torch.ones_like(x)
    for ci in reversed(c[:-1]):
        acc = acc * x + ci
    return acc


def poly_cdf(c, x):
    """The integral of the polynomial from 0 to x: Horner on c_i / (i + 1)."""
    acc = (c[-1] / len(c)) * torch.ones_like(x)
    for i in range(len(c) - 2, -1, -1):
        acc = acc * x + c[i] / (i + 1.0)
    return acc * x


def poly_cdf_pn(c, a, b, min_theta, max_theta):
    """Closed form of the integral of poly(t) (a cos t + b sin t) over
    [min_theta, max_theta] (repeated integration by parts folded into two
    polynomials multiplying cos and sin at the ends)."""
    t = c
    c1 = (
        -(b * t[0]) + a * t[1] - 6.0 * a * (t[3] - 20.0 * t[5])
        + 2.0 * b * (t[2] - 12.0 * t[4] + 360.0 * t[6]),
        -(b * t[1]) + 2.0 * a * t[2] + 6.0 * b * (t[3] - 20.0 * t[5])
        - 24.0 * a * (t[4] - 30.0 * t[6]),
        -(b * t[2]) + 3.0 * a * t[3] - 60.0 * a * t[5]
        + 12.0 * b * (t[4] - 30.0 * t[6]),
        -(b * t[3]) + 4.0 * a * t[4] + 20.0 * b * t[5] - 120.0 * a * t[6],
        -(b * t[4]) + 5.0 * a * t[5] + 30.0 * b * t[6],
        -(b * t[5]) + 6.0 * a * t[6],
        -(b * t[6]),
    )
    c2 = (
        a * t[0] + b * t[1] - 6.0 * b * (t[3] - 20.0 * t[5])
        - 2.0 * a * (t[2] - 12.0 * t[4] + 360.0 * t[6]),
        a * t[1] + 2.0 * b * t[2] - 6.0 * a * (t[3] - 20.0 * t[5])
        - 24.0 * b * (t[4] - 30.0 * t[6]),
        a * t[2] + 3.0 * b * t[3] - 60.0 * b * t[5]
        - 12.0 * a * (t[4] - 30.0 * t[6]),
        a * t[3] + 4.0 * b * t[4] - 20.0 * a * t[5] - 120.0 * b * t[6],
        a * t[4] + 5.0 * b * t[5] - 30.0 * a * t[6],
        a * t[5] + 6.0 * b * t[6],
        a * t[6],
    )
    return (poly_eval(c1, max_theta) * torch.cos(max_theta)
            - poly_eval(c1, min_theta) * torch.cos(min_theta)
            + poly_eval(c2, max_theta) * torch.sin(max_theta)
            - poly_eval(c2, min_theta) * torch.sin(min_theta))


# ----------------------------------------------- clamp-angle heuristics

def clamp_angle_tr(sigma_t, d_l):
    """Fitted domain clamp of the Tr expansion."""
    return torch.exp(0.210824 - 0.15974 * d_l * sigma_t)


def clamp_angle_phase(g):
    """Fitted domain clamp of the HG expansion."""
    return (18.8217 - 93.8831 * g + 184.173 * g ** 2 - 160.212 * g ** 3
            + 51.7683 * g ** 4)


# --------------------------------------------------- TaylorSampling (eq)

def taylor_setup(c, theta_a, theta_b, clamp_angle):
    """Per-lane mixture setup: poly-CDF sampling on [theta_a, clamp] and a
    uniform tail on [clamp, theta_b]. Returns a dict of per-lane tensors,
    `valid` among them."""
    clamp = torch.minimum(torch.maximum(clamp_angle, theta_a), theta_b)
    cdf_a = poly_cdf(c, theta_a)
    norm = poly_cdf(c, clamp) - cdf_a
    nn = torch.clamp(norm, min=0.0)
    pdf_cl = torch.clamp(poly_eval(c, clamp), min=0.0)
    cdf_other = pdf_cl * (theta_b - clamp)
    denom = nn + cdf_other
    prob_poly = torch.where(denom > 0.0, nn / torch.clamp(denom, min=1e-30),
                            0.0)
    # clamp == theta_a degenerates to the uniform tail alone (valid);
    # otherwise the mixture must have mass somewhere
    valid = denom > 0.0
    return dict(clamp=clamp, cdf_a=cdf_a, norm=nn, prob_poly=prob_poly,
                valid=valid, theta_a=theta_a, theta_b=theta_b)


def taylor_sample(c, st, u):
    """(theta, angular pdf): both mixture branches evaluated, the one u
    picks selected."""
    prob = st["prob_poly"]
    take_poly = u < prob
    # poly branch: invert the normalized CDF on [theta_a, clamp]
    u_p = torch.clamp(u / torch.clamp(prob, min=1e-12), 0.0, 1.0)
    nrm = torch.clamp(st["norm"], min=1e-30)
    theta_p = newton_bisect(
        lambda v: (poly_cdf(c, v) - st["cdf_a"]) / nrm,
        lambda v: poly_eval(c, v) / nrm,
        st["theta_a"], st["clamp"], u_p)
    pdf_p = prob * torch.clamp(poly_eval(c, theta_p), min=0.0) / nrm
    # uniform tail
    u_u = torch.clamp((u - prob) / torch.clamp(1.0 - prob, min=1e-12), 0.0,
                      1.0)
    rng = torch.clamp(st["theta_b"] - st["clamp"], min=1e-12)
    theta_u = st["clamp"] + u_u * rng
    pdf_u = (1.0 - prob) / rng
    return (torch.where(take_poly, theta_p, theta_u),
            torch.where(take_poly, pdf_p, pdf_u))


def taylor_pdf(c, st, theta):
    """Angular mixture pdf at theta (for the strategies' MIS)."""
    in_dom = (theta >= st["theta_a"]) & (theta <= st["theta_b"])
    nrm = torch.clamp(st["norm"], min=1e-30)
    pdf_p = st["prob_poly"] * torch.clamp(poly_eval(c, theta), min=0.0) / nrm
    rng = torch.clamp(st["theta_b"] - st["clamp"], min=1e-12)
    pdf_u = (1.0 - st["prob_poly"]) / rng
    pdf = torch.where(theta <= st["clamp"], pdf_p, pdf_u)
    return torch.where(in_dom & st["valid"], pdf, 0.0)


# -------------------------------------- PointNormalSampling (a cos + b sin)

def pn_coeffs(o, d, p_light, n_light, delta, d_l):
    """Raw point-normal factors a, b with angular pdf proportional to
    a cos(theta) + b sin(theta)."""
    dd = (o + d * delta[:, None] - p_light) / torch.clamp(d_l, min=1e-20)[:, None]
    a = dot(n_light, dd)
    b = dot(n_light, d)
    return a, b


def pn_norm(a, b, theta_a, theta_b):
    return (a * (torch.sin(theta_b) - torch.sin(theta_a))
            - b * (torch.cos(theta_b) - torch.cos(theta_a)))


def pn_invert(a, b, theta_a, theta_b, u):
    """Closed-form inversion of the normalized a cos + b sin CDF on
    [theta_a, theta_b]; a and b normalized so that the CDF spans [0, 1]."""
    s2 = u + a * torch.sin(theta_a) - b * torch.cos(theta_a)
    v = torch.sqrt(torch.clamp(a * a + b * b - s2 * s2, min=0.0))
    sgn = torch.where(a >= 0.0, 1.0, -1.0)
    q, r = a * s2, b * v * sgn
    s, t = -b * s2, v * torch.abs(a)
    sol1 = torch.atan2(q + r, s + t)
    ok1 = (sol1 >= theta_a) & (sol1 <= theta_b)
    sol = torch.where(ok1, sol1, torch.atan2(q - r, s - t))
    return torch.minimum(torch.maximum(sol, theta_a), theta_b)


# ------------------------------------- PointNormalTaylorSampling (pn x poly)

def pn_taylor_setup(c, a0, b0, theta_a, theta_b, clamp_angle):
    """Mixture of poly(theta) (a cos + b sin) on [theta_a, clamp] (Newton on
    the closed-form cdf_pn) and plain point-normal on [clamp, theta_b];
    a0, b0 raw."""
    clamp = torch.minimum(torch.maximum(clamp_angle, theta_a), theta_b)
    has_poly = clamp > theta_a + 1e-7
    has_other = theta_b > clamp + 1e-7

    norm_pp = pn_norm(a0, b0, theta_a, clamp)          # poly region's pn norm
    safe_pp = torch.where(torch.abs(norm_pp) > 1e-20, norm_pp, 1.0)
    a_p, b_p = a0 / safe_pp, b0 / safe_pp
    norm_poly = torch.where(has_poly & (norm_pp > 0.0),
                            poly_cdf_pn(c, a_p, b_p, theta_a, clamp), 0.0)
    norm_poly = torch.clamp(norm_poly, min=0.0)

    norm_o = pn_norm(a0, b0, clamp, theta_b)           # the tail's pn norm
    safe_o = torch.where(torch.abs(norm_o) > 1e-20, norm_o, 1.0)
    a_o, b_o = a0 / safe_o, b0 / safe_o

    pdf_cl = torch.clamp(poly_eval(c, clamp), min=0.0) * torch.clamp(
        a_p * torch.cos(clamp) + b_p * torch.sin(clamp), min=0.0)
    tail = has_other & (norm_o > 0.0)
    cdf_other = torch.where(tail, pdf_cl * (theta_b - clamp), 0.0)
    denom = norm_poly + cdf_other
    prob_poly = torch.where(denom > 0.0,
                            norm_poly / torch.clamp(denom, min=1e-30),
                            torch.where(tail, 0.0, float("nan")))
    # lanes where neither branch has mass are invalid
    valid = (denom > 0.0) | tail
    prob_poly = torch.where(valid, torch.nan_to_num(prob_poly), 0.0)
    return dict(clamp=clamp, a_p=a_p, b_p=b_p, norm_poly=norm_poly,
                a_o=a_o, b_o=b_o, prob_poly=prob_poly, valid=valid,
                theta_a=theta_a, theta_b=theta_b)


def pn_taylor_sample(c, st, u):
    """(theta, angular pdf)."""
    prob = st["prob_poly"]
    take_poly = u < prob
    nrm = torch.clamp(st["norm_poly"], min=1e-30)
    a_p, b_p = st["a_p"], st["b_p"]
    u_p = torch.clamp(u / torch.clamp(prob, min=1e-12), 0.0, 1.0)
    theta_p = newton_bisect(
        lambda v: poly_cdf_pn(c, a_p, b_p, st["theta_a"], v) / nrm,
        lambda v: poly_eval(c, v) * (a_p * torch.cos(v)
                                     + b_p * torch.sin(v)) / nrm,
        st["theta_a"], st["clamp"], u_p)
    pdf_p = prob * torch.clamp(
        poly_eval(c, theta_p) * (a_p * torch.cos(theta_p)
                                 + b_p * torch.sin(theta_p)), min=0.0) / nrm

    u_u = torch.clamp((u - prob) / torch.clamp(1.0 - prob, min=1e-12), 0.0,
                      1.0)
    theta_u = pn_invert(st["a_o"], st["b_o"], st["clamp"], st["theta_b"], u_u)
    pdf_u = (1.0 - prob) * torch.abs(st["a_o"] * torch.cos(theta_u)
                                     + st["b_o"] * torch.sin(theta_u))
    theta = torch.where(take_poly, theta_p, theta_u)
    pdf = torch.where(take_poly, pdf_p, pdf_u)
    return torch.minimum(torch.maximum(theta, st["theta_a"]), st["theta_b"]), pdf


def pn_taylor_pdf(c, st, theta):
    """Angular pdf (pdf_normalized)."""
    in_dom = (theta >= st["theta_a"]) & (theta <= st["theta_b"])
    nrm = torch.clamp(st["norm_poly"], min=1e-30)
    pdf_p = st["prob_poly"] * torch.clamp(
        poly_eval(c, theta) * (st["a_p"] * torch.cos(theta)
                               + st["b_p"] * torch.sin(theta)), min=0.0) / nrm
    pdf_u = (1.0 - st["prob_poly"]) * torch.abs(
        st["a_o"] * torch.cos(theta) + st["b_o"] * torch.sin(theta))
    pdf = torch.where(theta <= st["clamp"], pdf_p, pdf_u)
    return torch.where(in_dom & st["valid"], pdf, 0.0)

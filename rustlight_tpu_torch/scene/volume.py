"""Homogeneous participating medium and phase functions; port of
rustlight_tpu/scene/volume.py.

Distance sampling follows the reference's spectral channel selection: the
uniform picks an RGB channel, t ~ exp(sigma_t[c]), and the weight is
transmittance * sigma_s / pdf with the pdf averaged over the channels. Both
the surface-clamped ("real") and the unclamped ("continued") distances are
returned. `make_volume` builds the medium in numpy; `volume_to` puts its
sigmas and phase g on a device as float32 tensors, so that no bounce reads
the host.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..utils.frame import make_frame, to_world
from ..utils.vec import dot

_INV_4PI = 1.0 / (4.0 * math.pi)


class HomogeneousVolume(NamedTuple):
    sigma_a: Any   # [3]
    sigma_s: Any   # [3]
    phase_g: Any   # scalar; 0 => isotropic

    @property
    def sigma_t(self):
        return self.sigma_a + self.sigma_s


def make_volume(sigma_s, sigma_a=(0.0, 0.0, 0.0), g: float = 0.0
                ) -> HomogeneousVolume:
    return HomogeneousVolume(sigma_a=np.asarray(sigma_a, np.float32),
                             sigma_s=np.asarray(sigma_s, np.float32),
                             phase_g=np.float32(g))


def volume_to(vol, device) -> HomogeneousVolume:
    """Upload a numpy medium (this module's or the JAX package's, read by
    attribute) to `device`: sigmas [3] and a 0-d phase g, float32."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return HomogeneousVolume(sigma_a=t(vol.sigma_a), sigma_s=t(vol.sigma_s),
                             phase_g=t(vol.phase_g))


# ------------------------------------------------------------ phase function

def phase_eval(g, wi, wo):
    """Phase value (scalar, gray); wi and wo both point away from the
    scatter point, as the reference's eval takes wi.dot(wo)."""
    cos = dot(wi, wo)
    tmp = 1.0 + g * g + 2.0 * g * cos
    hg = _INV_4PI * (1.0 - g * g) / (tmp * torch.sqrt(torch.clamp(tmp,
                                                                  min=1e-12)))
    return torch.where(torch.abs(g) < 1e-6, _INV_4PI, hg)


def phase_pdf(g, wi, wo):
    return phase_eval(g, wi, wo)


def phase_sample(g, d_in, u):
    """Outgoing direction for the incoming d_in (pointing toward the
    previous vertex); perfect importance sampling, weight 1.
    Returns (d [n, 3], weight [n, 3], pdf [n])."""
    iso = torch.abs(g) < 1e-6
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u[..., 0])
    cos_hg = (1.0 + g * g - sqr * sqr) / (2.0 * torch.where(iso, 1.0, g))
    cos_iso = 1.0 - 2.0 * u[..., 0]
    cos_t = torch.where(iso, cos_iso, cos_hg)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u[..., 1]
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                         cos_t], dim=-1)
    d = to_world(make_frame(-d_in), local)
    pdf = phase_pdf(g, d_in, d)
    return d, torch.ones_like(d), pdf


# --------------------------------------------------------- distance sampling

class SampledDistance(NamedTuple):
    t: Any            # [n] real distance (clamped at the surface)
    w: Any            # [n, 3] Tr * sigma_s / pdf, or Tr / pdf if exited
    continued_t: Any  # [n] unclamped distance
    continued_w: Any  # [n, 3]
    pdf: Any          # [n]
    exited: Any       # [n] bool: the distance passed the surface hit


def volume_sample_distance(vol: HomogeneousVolume, tfar, u) -> SampledDistance:
    """Spectral channel-select free flight: comp = int(u * 3) truncated,
    u2 = u * 3 - comp reused for the exponential draw."""
    sigma_t = vol.sigma_t
    sigma_s = vol.sigma_s
    comp = torch.clamp((u * 3.0).to(torch.int32), 0, 2)
    u2 = u * 3.0 - comp.to(torch.float32)
    s_c = sigma_t[comp.long()]
    t = -torch.log(torch.clamp(1.0 - u2, min=1e-20)) / torch.clamp(s_c,
                                                                   min=1e-20)
    exited = t >= tfar
    t_min = torch.minimum(t, tfar)
    tr = torch.exp(-(t_min[:, None] * sigma_t))
    ctr = torch.exp(-(t[:, None] * sigma_t))
    pdf_exit = torch.mean(tr, dim=-1)
    pdf_inside = torch.mean(sigma_t * tr, dim=-1)
    pdf = torch.where(exited, pdf_exit, pdf_inside)
    w = (torch.where(exited[:, None], tr, sigma_s * tr)
         / torch.clamp(pdf, min=1e-30)[:, None])
    cw = ((sigma_s * ctr)
          / torch.clamp(torch.mean(sigma_t * ctr, dim=-1), min=1e-30)[:, None])
    return SampledDistance(t=t_min, w=w, continued_t=t, continued_w=cw,
                           pdf=pdf, exited=exited)


def transmittance(vol: HomogeneousVolume, dist):
    """exp(-sigma_t * dist); dist [n] -> [n, 3]."""
    return torch.exp(-(vol.sigma_t * dist[..., None]))


def distance_pdf(vol: HomogeneousVolume, dist, end_on_surface):
    tr = torch.exp(-(vol.sigma_t * dist[..., None]))
    return torch.where(end_on_surface, torch.mean(tr, dim=-1),
                       torch.mean(vol.sigma_t * tr, dim=-1))

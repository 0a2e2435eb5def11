"""Fresnel terms, vectorized; port of rustlight_tpu/bsdfs/fresnel.py
(reference: src/bsdfs/utils.rs:76-130)."""
from __future__ import annotations

import torch

# Named IORs (reference src/bsdfs/glass.rs:6-34, the Mitsuba table): scene
# files may give a dielectric's IOR by material name.
NAMED_IOR = {
    "vacuum": 1.0,
    "helium": 1.000036,
    "hydrogen": 1.000132,
    "air": 1.000277,
    "carbon dioxide": 1.00045,
    "water": 1.3330,
    "acetone": 1.36,
    "ethanol": 1.361,
    "carbon tetrachloride": 1.461,
    "glycerol": 1.4729,
    "benzene": 1.501,
    "silicone oil": 1.52045,
    "bromine": 1.661,
    "water ice": 1.31,
    "fused quartz": 1.458,
    "pyrex": 1.470,
    "acrylic glass": 1.49,
    "polypropylene": 1.49,
    "bk7": 1.5046,
    "sodium chloride": 1.544,
    "amber": 1.55,
    "pet": 1.5750,
    "diamond": 2.419,
}


def resolve_ior(value, default: float) -> float:
    """A number or numeric string -> float; a material name -> its
    NAMED_IOR entry (case-insensitive); None or a non-positive number ->
    default. An unknown name raises ValueError."""
    if value is None:
        return float(default)
    if isinstance(value, (int, float)):
        return float(value) if value > 0 else float(default)
    s = str(value).strip()
    try:
        v = float(s)
        return v if v > 0 else float(default)
    except ValueError:
        key = s.lower()
        if key not in NAMED_IOR:
            raise ValueError(f"unknown named IOR {s!r} (glass.rs:6-34 "
                             f"table: {sorted(NAMED_IOR)})") from None
        return NAMED_IOR[key]


def fresnel_dielectric(cos_i, eta):
    """Unpolarized dielectric Fresnel.

    cos_i: signed cosine w.r.t. the normal; eta = int_ior/ext_ior (a tensor
    of cos_i's shape, or a float). Returns (F, cos_theta_t) where cos_theta_t
    is negative when entering from the front side.
    """
    eta = torch.as_tensor(eta, dtype=cos_i.dtype, device=cos_i.device)
    scale = torch.where(cos_i > 0.0, 1.0 / eta, eta)
    cos_t_sqr = 1.0 - (1.0 - cos_i * cos_i) * scale * scale
    tir = cos_t_sqr <= 0.0

    cos_ia = torch.abs(cos_i)
    cos_t = torch.sqrt(torch.clamp(cos_t_sqr, min=0.0))
    rs = (cos_ia - eta * cos_t) / (cos_ia + eta * cos_t)
    rp = (eta * cos_ia - cos_t) / (eta * cos_ia + cos_t)
    f = 0.5 * (rs * rs + rp * rp)
    cos_t_signed = torch.where(cos_i > 0.0, -cos_t, cos_t)

    f = torch.where(tir, 1.0, f)
    cos_t_signed = torch.where(tir, 0.0, cos_t_signed)
    # index-matched interface: fully transmissive
    transparent = eta == 1.0
    f = torch.where(transparent, 0.0, f)
    cos_t_signed = torch.where(transparent, -cos_i, cos_t_signed)
    return f, cos_t_signed


def fresnel_conductor(cos_i, eta, k):
    """Conductor Fresnel; eta/k are [..., 3] RGB, cos_i [...]. Returns [..., 3]."""
    c2 = (cos_i * cos_i)[..., None]
    s2 = 1.0 - c2
    s4 = s2 * s2
    t1 = eta * eta - k * k - s2
    a2pb2 = torch.sqrt(torch.clamp(t1 * t1 + 4.0 * k * k * eta * eta, min=0.0))
    a = torch.sqrt(torch.clamp((a2pb2 + t1) * 0.5, min=0.0))
    term1 = a2pb2 + c2
    term2 = a * 2.0 * torch.sqrt(c2)
    rs2 = (term1 - term2) / (term1 + term2)
    term3 = a2pb2 * c2 + s4
    term4 = term2 * s2
    rp2 = rs2 * (term3 - term4) / (term3 + term4)
    return 0.5 * (rp2 + rs2)


def schlick_fresnel(rs, cos_theta):
    """rs [..., 3], cos_theta [...] -> [..., 3] (reference substrate.rs:15-19)."""
    return rs + (1.0 - rs) * (1.0 - cos_theta[..., None]) ** 5

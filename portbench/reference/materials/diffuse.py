"""Lambertian reflection: albedo kd, f = kd / pi on the side the ray came
from, sampled by a cosine-weighted direction."""
from __future__ import annotations

import math

import torch

from ..scene import cosine_hemisphere

INV_PI = 1.0 / math.pi


def params(spec: dict) -> list:
    return [float(x) for x in spec["albedo"]]


def evaluate(p, wi, wo):
    fr = (wi[:, 2] > 0.0) & (wo[:, 2] > 0.0)
    cos_o = torch.clamp(wo[:, 2], min=0.0)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    return (torch.where(fr[:, None], p[:, :3] * (cos_o * INV_PI)[:, None],
                        zero),
            torch.where(fr, cos_o * INV_PI, zero))


def sample(p, wi, u):
    u = torch.stack([torch.clamp(u[:, 0], 0.0, 1.0 - 1e-7), u[:, 1]], -1)
    wo = cosine_hemisphere(u)
    ok = wi[:, 2] > 0.0
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    return (wo, torch.where(ok[:, None], p[:, :3], zero),
            torch.clamp(wo[:, 2], min=0.0) * INV_PI, torch.zeros_like(ok), ok)

"""Primary-sample-space mutations (Kelemen-style); port of
rustlight_tpu/samplers/pss.py.

dv = s2 * exp(r2 * log(s1 / s2)) applied with a random sign and wrapped
around on [0, 1); elementwise over [chains, dims].
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class KelemenParams(NamedTuple):
    s1: float = 1.0 / 1024.0
    s2: float = 1.0 / 64.0


def kelemen_mutate(v, r, params: KelemenParams = KelemenParams()):
    """v, r of one shape in [0, 1). Returns mutated values in [0, 1)."""
    # a Python float, rounded to float32 where it meets the tensor, as in
    # the reference
    log_ratio = -math.log(params.s2 / params.s1)
    add = r < 0.5
    r2 = torch.where(add, r * 2.0, 2.0 * (r - 0.5))
    dv = params.s2 * torch.exp(r2 * log_ratio)
    vp = torch.where(add, v + dv, v - dv)
    vp = torch.where(vp >= 1.0, vp - 1.0, vp)
    vp = torch.where(vp < 0.0, vp + 1.0, vp)
    return torch.where(vp >= 1.0, 0.0, vp)

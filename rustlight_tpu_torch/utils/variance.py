"""Welford online mean/variance estimator; port of
rustlight_tpu/utils/variance.py.

The state is a tuple of tensors, so a whole image of estimators updates in
one vectorized `variance_add`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class VarianceEstimator(NamedTuple):
    mean: Any   # running mean (any array shape)
    m2: Any     # sum of squared deviations
    n: Any      # sample count (scalar or per element)


def variance_init(zeros) -> VarianceEstimator:
    """`zeros`: a zero tensor of the accumulated shape."""
    return VarianceEstimator(mean=zeros, m2=zeros, n=zeros * 0)


def variance_add(est: VarianceEstimator, x) -> VarianceEstimator:
    """One Welford step."""
    n = est.n + 1
    delta = x - est.mean
    mean = est.mean + delta / n
    m2 = est.m2 + delta * (x - mean)
    return VarianceEstimator(mean=mean, m2=m2, n=n)


def variance_value(est: VarianceEstimator, eps: float = 0.0):
    """Unbiased sample variance M2 / (n - 1); `eps` where n <= 1."""
    return torch.where(est.n > 1, est.m2 / torch.clamp(est.n - 1, min=1),
                       eps)

"""Ambient occlusion (`IntegratorAO`) on the per-pass route."""
from rustlight_tpu_torch.integrators import IntegratorAO

from ..port import film as render  # noqa: F401  the renderer's normal entry


def make(params: dict):
    return IntegratorAO(**params)

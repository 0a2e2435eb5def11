"""The path tracer (`IntegratorPathTracing`): the persistent route
(`compute_block`) or the per-pass route (`compute_pixel`)."""
from rustlight_tpu_torch.integrators import IntegratorPathTracing

from ..port import film as render  # noqa: F401  the renderer's normal entry


def make(params: dict):
    return IntegratorPathTracing(**params)

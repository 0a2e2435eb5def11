"""The light tracer and the path tracer in a medium on the card against
the CPU; no JAX import, so that it runs on a machine with a card:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_light_cuda.py

It skips without a card.
"""
import numpy as np
import pytest
import torch

from rustlight_tpu_torch.integrators import (IntegratorLightTracing,
                                             IntegratorPathTracing, render,
                                             render_splat)
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.scene import make_volume

PIX_FRAC, PIX_RTOL, MEAN_RTOL = 0.99, 1e-3, 1e-4
W = H = 16
MEDIUM = dict(sigma_s=(0.0025,) * 3)   # tools/regression.py's cbox_medium


@pytest.mark.cuda
def test_card_renders_the_light_tracer_and_the_medium_like_the_cpu():
    """The light tracer and the path tracer in the regression rows' medium,
    cbox 16x16, 2 spp, on the card against the CPU: PIX_FRAC of the pixels
    within PIX_RTOL, means within MEAN_RTOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sc = cornell_box(W, H)
    sc.volume = make_volume(**MEDIUM)
    for integ, run in (
            (IntegratorLightTracing(max_depth=8, hard_cap=8), render_splat),
            (IntegratorPathTracing(max_depth=8, hard_cap=8), render)):
        imgs = [run(sc.compile(device=dev), integ, 2, seed=0)["primal"]
                for dev in ("cuda", "cpu")]
        rel = np.abs(imgs[0] - imgs[1]) / np.maximum(np.abs(imgs[1]), 1e-4)
        assert (rel.max(-1) <= PIX_RTOL).mean() >= PIX_FRAC
        assert abs(imgs[0].mean() - imgs[1].mean()) <= MEAN_RTOL * imgs[1].mean()

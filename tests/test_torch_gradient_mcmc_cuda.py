"""The gradient-domain tracers and PSSMLT on the card against the CPU; no
JAX import, so that it runs on a machine with a card:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_gradient_mcmc_cuda.py

It skips without a card. The bounds are phase 24's of chip_smoke.py: for
each of primal, gradient_x and gradient_y at least PIX_FRAC of the pixels
within PIX_RTOL (relative, floor 1e-4) and the means within MEAN_RTOL (of
the mean absolute value for a gradient); for PSSMLT at least
DECISION_FRAC of the (chain, step) decisions equal and, on the pixels that
no diverged chain splatted (a chain diverges at its first step whose
decision or whose proposal's tf differs), every pixel within PIX_RTOL.
"""
import numpy as np
import pytest
import torch

from rustlight_tpu_torch.integrators import IntegratorPathTracing
from rustlight_tpu_torch.integrators.gradient import (
    IntegratorGradientPath, IntegratorGradientPathReconnect)
from rustlight_tpu_torch.integrators.mcmc import IntegratorPSSMLT
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.utils import rng as trng

PIX_FRAC, PIX_RTOL, MEAN_RTOL = 0.999, 1e-3, 1e-4
DECISION_FRAC = 0.999
W = H = 16


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [IntegratorGradientPath,
                                 IntegratorGradientPathReconnect])
def test_card_renders_a_gradient_pass_like_the_cpu(cls):
    """One pass (stream_fold(make_stream(0), 0)) at cbox 16x16, max_depth
    6."""
    _need_card()
    outs = []
    for dev in ("cuda", "cpu"):
        sd = cornell_box(W, H).compile(device=dev)
        stream = trng.stream_fold(trng.make_stream(0, dev), 0)
        outs.append([x.cpu().numpy() for x in
                     cls(max_depth=6).one_pass(sd, stream)[:3]])
    for k, (a, b) in enumerate(zip(*outs)):
        assert np.all(np.isfinite(a))
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-4)
        assert (rel.max(-1) <= PIX_RTOL).mean() >= PIX_FRAC
        scale = np.abs(b).mean() if k else b.mean()
        assert abs(a.mean() - b.mean()) <= MEAN_RTOL * scale


@pytest.mark.cuda
def test_card_runs_pssmlt_like_the_cpu():
    """1,024 chains, 4 steps at cbox 16x16, max_depth 4."""
    _need_card()
    run = []
    for dev in ("cuda", "cpu"):
        integ = IntegratorPSSMLT(IntegratorPathTracing(max_depth=4,
                                                       hard_cap=4),
                                 nb_chains=1024, nb_samples_norm=2048)
        integ.record_accepts = True
        img = integ.render(cornell_box(W, H).compile(device=dev), 16,
                           seed=0)["primal"]
        run.append((img, integ.accepts, integ.visits, integ.tfs))
    (a, acc_a, vis_a, tf_a), (b, acc_b, vis_b, tf_b) = run
    assert np.all(np.isfinite(a)) and b.mean() > 0
    assert (acc_a == acc_b).mean() >= DECISION_FRAC
    # a chain diverges at its first step whose decision or proposal's tf
    # differs (its seed's tf first); its splats from there are excused
    off = np.abs(tf_a - tf_b) > PIX_RTOL * np.maximum(np.abs(tf_b), 1e-4)
    diff = (acc_a != acc_b) | off[:, 1:]
    diff[:, 0] |= off[:, 0]
    keep = np.ones(W * H, bool)
    for r, lane in zip(*np.nonzero(diff.any(1))):
        t = int(np.argmax(diff[r, :, lane]))
        keep[vis_a[r, t:, lane]] = False
        keep[vis_b[r, t:, lane]] = False
    rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-4)).max(-1).reshape(-1)
    assert keep.any() and rel[keep].max() <= PIX_RTOL

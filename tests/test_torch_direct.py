"""The port's direct-lighting integrator against the JAX package's.

IntegratorDirect(1, 1).compute_pixel of both packages on the same
Cornell-box tables (the JAX package's compiled numpy scene, cbox 16x16,
samples 0 and 1 of seed 0; one JAX jit for both). The threefry streams are
bit-exact and the draw order is the reference's, so every lane traces the
same rays unless a float difference flips a branch. Tolerance: at least
PIX_FRAC of the pixels within PIX_RTOL (relative, with a 1e-4 floor), the
means within MEAN_RTOL.

The regression row `cbox_direct` (tools/regression.py: 128x128, 32 spp,
seed 0, the per-pass route) of the port on the CPU is held to the JAX
package's committed 32-spp render of that row, regress/
cbox_direct_direct.exr, under the same tolerance, and its metrics against
regress/refs/cbox_direct.exr to the stored row of regress/results.json
within METRIC_RTOL.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.integrators import IntegratorDirect as JaxDirect
from rustlight_tpu.integrators.common import _pixel_grid
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.utils import rng as jrng
from rustlight_tpu_torch.integrators import IntegratorDirect, render
from rustlight_tpu_torch.integrators import direct as tdirect
from rustlight_tpu_torch.models import cornell_box, furnace_scene
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng
from rustlight_tpu_torch.utils.image import read_exr
from rustlight_tpu_torch.utils.metrics import metric_scalar

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PIX_FRAC, PIX_RTOL, MEAN_RTOL = 0.999, 1e-3, 1e-4
METRIC_RTOL = 1e-3
W = H = 16


def _agree(got, ref):
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-4)
    assert np.all(np.isfinite(got)) and ref.mean() > 0.05
    assert (rel.max(-1) <= PIX_RTOL).mean() >= PIX_FRAC
    assert abs(got.mean() - ref.mean()) <= MEAN_RTOL * ref.mean()


def _port_pixel(sd, k, integ=None):
    pix = torch.as_tensor(_pixel_grid(sd.camera.width, sd.camera.height))
    stream = trng.stream_fold(trng.make_stream(0, "cpu"), k)
    return (integ or IntegratorDirect(1, 1)).compute_pixel(sd, pix,
                                                           stream).numpy()


@pytest.mark.slow
def test_compute_pixel_matches_jax():
    jsd = jax_cornell_box(W, H).compile()
    pix = jnp.asarray(_pixel_grid(W, H))
    run = jax.jit(lambda s: JaxDirect(1, 1).compute_pixel(jsd, pix, s))
    sd = from_numpy_scene(jsd.host.data, "cpu")
    for k in range(2):
        ref = np.asarray(run(jrng.stream_fold(jrng.make_stream(0), k)))
        got = _port_pixel(sd, k)
        assert got.shape == ref.shape == (W * H, 3)
        _agree(got, ref)


@pytest.mark.slow
def test_regression_row_matches_the_stored_render():
    sd = cornell_box(128, 128).compile(device="cpu")
    img = render(sd, IntegratorDirect(1, 1), spp=32, seed=0)["primal"]
    stored = read_exr(ROOT / "regress" / "cbox_direct_direct.exr")
    _agree(img, stored)
    ref = read_exr(ROOT / "regress" / "refs" / "cbox_direct.exr")
    row = json.loads((ROOT / "regress" / "results.json").read_text())[
        "cbox_direct/direct"]
    for m in ("l1", "l2", "mape", "dssim"):
        assert abs(metric_scalar(ref, img, m) - row[m]) <= METRIC_RTOL * row[m]


def test_draw_order(monkeypatch):
    """The reference's draws, in its order: u_pix, then (u_sel, u_pos) per
    light sample, then u_b per BSDF sample."""
    seen = []

    def rec(fn, tag):
        def wrapped(stream, shape=()):
            seen.append((tag, tuple(shape)))
            return fn(stream, shape)
        return wrapped
    monkeypatch.setattr(tdirect, "stream_next", rec(trng.stream_next, "1d"))
    monkeypatch.setattr(tdirect, "stream_next2d",
                        rec(trng.stream_next2d, "2d"))
    sd = cornell_box(4, 4).compile(device="cpu")
    out = _port_pixel(sd, 0, IntegratorDirect(nb_bsdf_samples=3,
                                              nb_light_samples=2))
    assert np.all(np.isfinite(out))
    assert [t for t, _ in seen] == ["2d"] + ["1d", "2d"] * 2 + ["2d"] * 3
    assert {s for _, s in seen} == {(16,)}


@pytest.mark.parametrize("b, l", [(0, 1), (2, 3), (1, 2)])
def test_strategy_counts_agree_in_the_mean(b, l):
    """Light-only and mixed sample counts estimate the same image: means
    within 5% of the 1/1 render at 16 spp (BSDF-only sampling of the small
    light is too noisy for that at this size; the JAX parity test covers
    it)."""
    sd = cornell_box(16, 16).compile(device="cpu")
    base = render(sd, IntegratorDirect(1, 1), spp=16, seed=0)["primal"]
    img = render(sd, IntegratorDirect(b, l), spp=16, seed=0)["primal"]
    assert img.shape == (16, 16, 3) and np.all(np.isfinite(img))
    assert abs(img.mean() - base.mean()) <= 0.05 * base.mean()


def test_environment_terms_give_the_furnace():
    """The env terms: a diffuse sphere of albedo 0.5 under a unit constant
    environment. Escaped camera rays see 1; on the sphere every direction
    escapes, so BSDF sampling alone (escaped rays) and combined with light
    sampling (the env atom, MIS'd by the power heuristic) estimate 0.5:
    means within 0.02 over the sphere's center patch at 16 spp."""
    sd = furnace_scene(16, 16, albedo=0.5).compile(device="cpu")
    for b, l in ((1, 1), (1, 0)):
        img = render(sd, IntegratorDirect(b, l), spp=16, seed=0)["primal"]
        assert np.all(img[0, 0] == 1.0), (b, l, img[0, 0])
        assert abs(img[6:10, 6:10].mean() - 0.5) < 0.02, (b, l)

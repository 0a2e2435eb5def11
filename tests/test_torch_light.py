"""The port's light tracer and its splat film against the JAX package's.

  - camera.sample_direct on 4,096 world points (seed 8; in front, behind
    and beside the Cornell box's camera): importance and pixel within
    FLOAT_RTOL (relative, absolute floor FLOAT_ATOL);
  - emitters.sample_position and sample_emission_direction on the
    Cornell box's emitter tables, 4,096 lanes: kind, atom and valid equal,
    floats within FLOAT_RTOL;
  - IntegratorLightTracing(max_depth=8, hard_cap=8).trace_paths on cbox
    16x16 (256 paths of stream_fold(make_stream(0), 0), with and without
    the regression rows' medium): pixel ids equal on every splat, values
    within SPLAT_RTOL (relative, absolute floor 1e-6);
  - render_splat at 16x16, 2 spp, seed 0, with and without the medium: at
    least PIX_FRAC of the pixels within PIX_RTOL, means within MEAN_RTOL.

Each JAX-side result is made once, in a module fixture; its four jitted
JAX functions take about 20 s to compile, so the two tests that use it are
`slow`. tests/test_torch_light_cuda.py renders the light tracer and the
medium path tracer on the card against the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.integrators import IntegratorLightTracing as JaxLight
from rustlight_tpu.integrators.common import render_splat as jax_render_splat
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.scene import camera as jcam
from rustlight_tpu.scene import emitters as jem
from rustlight_tpu.scene import make_volume as jax_make_volume
from rustlight_tpu.utils import rng as jrng
from rustlight_tpu_torch.integrators import (IntegratorLightTracing,
                                             render_splat)
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.scene import camera as tcam
from rustlight_tpu_torch.scene import emitters as tem
from rustlight_tpu_torch.scene import make_volume
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-6
SPLAT_RTOL = 1e-4
PIX_FRAC, PIX_RTOL, MEAN_RTOL = 0.99, 1e-3, 1e-4
W = H = 16
N_PATHS = 256
MEDIUM = dict(sigma_s=(0.0025,) * 3)   # tools/regression.py's cbox_medium


def _close(got, ref, rtol=FLOAT_RTOL, atol=FLOAT_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _jax_scene(medium):
    sc = jax_cornell_box(W, H)
    if medium:
        sc.volume = jax_make_volume(**MEDIUM)
    return sc.compile()


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's trace_paths and render_splat, with and without the
    medium: {medium: (scene, pids, values, image)}."""
    out = {}
    integ = JaxLight(max_depth=8, hard_cap=8)
    for medium in (False, True):
        jsd = _jax_scene(medium)
        pids, vals = jax.jit(lambda s: integ.trace_paths(jsd, N_PATHS, s))(
            jrng.stream_fold(jrng.make_stream(0), 0))
        img = jax_render_splat(jsd, integ, 2, seed=0)["primal"]
        out[medium] = (jsd, np.asarray(pids), np.asarray(vals), img)
    return out


def test_sample_direct_matches_jax():
    jsd = jax_cornell_box(W, H).compile()
    cam = tcam.camera_to(jsd.host.data.camera, "cpu")
    rng = np.random.default_rng(8)
    p = rng.uniform(-800.0, 800.0, (4096, 3)).astype(np.float32)
    p += np.asarray(jsd.host.data.camera.position) * rng.random((4096, 1))
    w, pixel = tcam.sample_direct(cam, torch.as_tensor(p))
    wj, pixj = jcam.sample_direct(jsd.camera, jnp.asarray(p))
    _close(w, wj)
    np.testing.assert_array_equal(w.numpy() > 0, np.asarray(wj) > 0)
    ok = w.numpy() > 0
    assert 100 < ok.sum() < 4000
    _close(pixel.numpy()[ok], np.asarray(pixj)[ok])


def test_sample_position_and_emission_direction_match_jax():
    jsd = jax_cornell_box(W, H).compile()
    sd = from_numpy_scene(jsd.host.data, "cpu")
    rng = np.random.default_rng(9)
    u_sel = rng.random(4096, dtype=np.float32)
    u_pos = rng.random((4096, 2), dtype=np.float32)
    u_dir = rng.random((4096, 2), dtype=np.float32)
    ps = tem.sample_position(sd.emitters, sd.geom, torch.as_tensor(u_sel),
                             torch.as_tensor(u_pos))
    pj = jem.sample_position(jsd.emitters, jsd.geom, jnp.asarray(u_sel),
                             jnp.asarray(u_pos))
    for f in ("kind", "atom", "valid"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                      np.asarray(getattr(pj, f)))
    for f in ("p", "n", "pdf_area", "weight"):
        _close(getattr(ps, f), getattr(pj, f))
    assert ps.valid.numpy().all()
    d, pdf, w = tem.sample_emission_direction(sd.emitters, ps,
                                              torch.as_tensor(u_dir))
    dj, pdfj, wj = jem.sample_emission_direction(jsd.emitters, pj,
                                                 jnp.asarray(u_dir))
    _close(d, dj)
    _close(pdf, pdfj)
    _close(w, wj)


@pytest.mark.slow
@pytest.mark.parametrize("medium", [False, True], ids=["plain", "medium"])
def test_trace_paths_matches_jax(jax_side, medium):
    jsd, pids_j, vals_j, _ = jax_side[medium]
    sd = from_numpy_scene(jsd.host.data, "cpu")
    pids, vals = IntegratorLightTracing(max_depth=8, hard_cap=8).trace_paths(
        sd, N_PATHS, trng.stream_fold(trng.make_stream(0, "cpu"), 0))
    assert pids.shape == (9 * N_PATHS,) and vals.shape == (9 * N_PATHS, 3)
    assert pids.dtype == torch.int32
    np.testing.assert_array_equal(pids.numpy(), pids_j)
    _close(vals, vals_j, rtol=SPLAT_RTOL)
    assert (vals_j > 0).any(axis=-1).sum() > N_PATHS // 4


@pytest.mark.slow
@pytest.mark.parametrize("medium", [False, True], ids=["plain", "medium"])
def test_render_splat_matches_jax(jax_side, medium):
    jsd, _, _, ref = jax_side[medium]
    sd = from_numpy_scene(jsd.host.data, "cpu")
    img = render_splat(sd, IntegratorLightTracing(max_depth=8, hard_cap=8),
                       2, seed=0)["primal"]
    assert img.shape == ref.shape == (H, W, 3) and img.dtype == np.float32
    assert np.all(np.isfinite(img)) and ref.mean() > 0.003
    rel = np.abs(img - ref) / np.maximum(np.abs(ref), 1e-4)
    assert (rel.max(-1) <= PIX_RTOL).mean() >= PIX_FRAC
    assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * ref.mean()


def test_light_tracer_options():
    """In the medium: render_surface=False (render_volume off) splats
    nothing; render_volume splats the medium vertices; min_depth=1 drops
    the emitter vertex and leaves the bounces' splats as they were."""
    sc = cornell_box(8, 8)
    sc.volume = make_volume(**MEDIUM)
    sd = sc.compile(device="cpu")
    stream = trng.stream_fold(trng.make_stream(0, "cpu"), 0)

    def trace(**kw):
        return IntegratorLightTracing(max_depth=4, hard_cap=4, **kw
                                      ).trace_paths(sd, 64, stream)
    pids, vals = trace()
    assert (vals[:64] > 0).any()
    _, vals_off = trace(render_surface=False)
    assert not (vals_off > 0).any()
    _, vals_vol = trace(render_surface=False, render_volume=True)
    assert (vals_vol[64:] > 0).any() and not (vals_vol[:64] > 0).any()
    _, vals_min = trace(min_depth=1)
    assert not (vals_min[:64] > 0).any()
    np.testing.assert_array_equal(vals_min[64:].numpy(), vals[64:].numpy())


class _Splats:
    """A splatting integrator whose pass p splats value p + 1 into pixel p,
    a NaN, a negative and an infinite value elsewhere, and 0 into pixel 0."""

    def __init__(self):
        self.passes = []

    def trace_paths(self, scene, n, stream):
        p = len(self.passes)
        self.passes.append((n, stream))
        vals = torch.zeros((n, 3))
        vals[0] = p + 1.0
        vals[1, 0], vals[2, 1], vals[3, 2] = float("nan"), -1.0, float("inf")
        pids = torch.zeros(n, dtype=torch.int32)
        pids[0], pids[1:4] = p, 5
        return pids, vals


def test_render_splat_sums_the_passes():
    """spp passes of w*h paths on stream_fold(make_stream(seed), p), bad
    splats zeroed, the sum scaled by w*h / paths."""
    from types import SimpleNamespace
    scene = SimpleNamespace(camera=SimpleNamespace(width=4, height=2),
                            device=torch.device("cpu"))
    integ = _Splats()
    img = render_splat(scene, integ, 3, seed=4)["primal"]
    base = trng.make_stream(4, "cpu")
    assert integ.passes == [(8, trng.stream_fold(base, p)) for p in range(3)]
    want = np.zeros((8, 3), np.float32)
    want[:3] = np.arange(1, 4, dtype=np.float32)[:, None] / 3.0
    np.testing.assert_allclose(img.reshape(8, 3), want, rtol=1e-6)


METRIC_RTOL = 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("name, tech", [("cbox_path", "light"), ("cbox_medium", "light")])
def test_regression_rows_match_the_stored_rows(name, tech):
    """The row at tools/regression.py's settings (cornell_box(128, 128), in
    the medium for cbox_medium, IntegratorLightTracing(max_depth=8,
    hard_cap=8), 32 spp, seed 0, render_splat): each metric against
    regress/refs/<name>.exr within METRIC_RTOL of regress/results.json's."""
    import json
    from pathlib import Path
    from rustlight_tpu_torch.utils.image import read_exr
    from rustlight_tpu_torch.utils.metrics import metric_scalar
    root = Path(__file__).resolve().parents[1] / "regress"
    sc = cornell_box(128, 128)
    if name == "cbox_medium":
        sc.volume = make_volume(**MEDIUM)
    img = render_splat(sc.compile(device="cpu"),
                       IntegratorLightTracing(max_depth=8, hard_cap=8), 32,
                       seed=0)["primal"]
    ref = read_exr(root / "refs" / f"{name}.exr")
    stored = json.loads((root / "results.json").read_text())[f"{name}/{tech}"]
    for m in ("l1", "l2", "mape", "dssim"):
        assert abs(metric_scalar(ref, img, m) - stored[m]) <= (
            METRIC_RTOL * stored[m]), m

"""The port's path tracer against the JAX package's, sample for sample.

IntegratorPathTracing.compute_block of both packages on the same Cornell-box
tables (cbox 16x16, 2 spp, max_depth 6, seed 0; JAX jitted on the CPU). The
threefry streams are bit-exact and the draw order is the reference's, so
every lane traces the same path unless a float difference flips a branch
(a Russian-roulette or light-selection comparison landing within an ulp,
or a hit at a triangle edge). Tolerance: at least PIX_FRAC of the pixels
within PIX_RTOL (relative, with a 1e-4 floor) and the image means within
MEAN_RTOL.

The per-pass route's compute_pixel (cbox 16x16, one sample: the plain
scene, the regression rows' medium, `naive` on phong blocks, single
scattering in the medium), compute_block in the medium (2 spp) and the
variance AOVs (8x8, 4 spp) are held to the JAX package's under the same
bounds; their jitted JAX functions take 5-8 s each to compile, so those
tests are `slow`. The draw order with a medium, the loop shape of
compute_pixel and the variance AOVs' arithmetic are checked on the port
alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu import bsdfs as jbsdfs
from rustlight_tpu.integrators import IntegratorPathTracing as JaxPath
from rustlight_tpu.integrators.common import _pixel_grid
from rustlight_tpu.integrators.common import render as jax_render
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.scene import make_volume as jax_make_volume
from rustlight_tpu.utils import rng as jrng
from rustlight_tpu_torch import cli
from rustlight_tpu_torch.integrators import IntegratorPathTracing, render
from rustlight_tpu_torch.integrators import path as tpath
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.scene import make_volume
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng
from rustlight_tpu_torch.utils.film import write_pfm

torch.set_num_threads(2)

PIX_FRAC, PIX_RTOL, MEAN_RTOL = 0.99, 1e-3, 1e-4
W = H = 16
SPP = 2
MEDIUM = dict(sigma_s=(0.0025,) * 3)   # tools/regression.py's cbox_medium
# compute_pixel's cases: (medium, phong blocks, integrator keywords)
PIXEL_CASES = {
    "plain": (False, False, dict(max_depth=6)),
    "medium": (True, False, dict(max_depth=8, hard_cap=8)),
    "naive": (False, True, dict(max_depth=6, strategy="naive")),
    "single": (True, False, dict(max_depth=2, hard_cap=2, min_depth=1,
                                 single_scattering=True)),
}


def _port_block(sd, spp=SPP, **kw):
    pix = torch.as_tensor(_pixel_grid(sd.camera.width, sd.camera.height))
    stream = trng.stream_fold(trng.make_stream(0, "cpu"), 0)
    return IntegratorPathTracing(max_depth=6, **kw).compute_block(
        sd, pix, stream, spp).numpy()


def test_compute_block_matches_jax():
    jsd = jax_cornell_box(W, H).compile()
    pix = jnp.asarray(_pixel_grid(W, H))
    integ = JaxPath(max_depth=6)
    ref = np.asarray(jax.jit(lambda s: integ.compute_block(jsd, pix, s, SPP))(
        jrng.stream_fold(jrng.make_stream(0), 0)))
    got = _port_block(from_numpy_scene(jsd.host.data, "cpu"))
    assert got.shape == ref.shape == (W * H, 3)
    assert np.all(np.isfinite(got)) and ref.mean() > 0.05
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-4)
    assert (rel.max(-1) <= PIX_RTOL).mean() >= PIX_FRAC
    assert abs(got.mean() - ref.mean()) <= MEAN_RTOL * ref.mean()


def test_port_compiled_scene_renders_like_the_uploaded_jax_scene():
    """The port's own Scene.compile path feeds the same tables."""
    a = _port_block(cornell_box(8, 8).compile(device="cpu"), spp=1)
    b = _port_block(from_numpy_scene(jax_cornell_box(8, 8).compile().host.data,
                                     "cpu"), spp=1)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("check_every", [1, 3])
def test_loop_shape_does_not_change_the_result(monkeypatch, check_every):
    """Chunks of iterations between host checks only add no-op iterations
    after the last sample; the accumulators are those of a check before
    every iteration."""
    sd = cornell_box(8, 8).compile(device="cpu")
    base = _port_block(sd)
    monkeypatch.setattr(tpath, "CHECK_EVERY", check_every)
    np.testing.assert_array_equal(base, _port_block(sd))


@pytest.mark.parametrize("nee_rr, order", [
    ("default", ["2d", "1d", "2d", "2d", "1d"]),
    (0.25, ["2d", "1d", "2d", "1d", "2d", "1d"]),
])
def test_draw_order_per_iteration(monkeypatch, nee_rr, order):
    """The reference's draws, in its order, every iteration: u_pix, u_sel,
    u_pos, u_nrr (only with NEE Russian roulette, off by default on the
    dense tier), u_bsdf, u_rr."""
    seen = []

    def rec(fn, tag):
        def wrapped(stream, shape=()):
            seen.append((tag, tuple(shape)))
            return fn(stream, shape)
        return wrapped
    monkeypatch.setattr(tpath, "stream_next", rec(trng.stream_next, "1d"))
    monkeypatch.setattr(tpath, "stream_next2d", rec(trng.stream_next2d, "2d"))
    monkeypatch.setattr(tpath, "CHECK_EVERY", 1)
    sd = cornell_box(4, 4).compile(device="cpu")
    out = _port_block(sd, spp=1, nee_rr=nee_rr)
    assert np.all(np.isfinite(out))
    k = len(order)
    assert len(seen) % k == 0 and len(seen) >= k
    assert [t for t, _ in seen] == order * (len(seen) // k)
    assert {s for _, s in seen} == {(16,)}


def test_render_averages_and_guards():
    sd = cornell_box(8, 8).compile(device="cpu")
    film = render(sd, IntegratorPathTracing(max_depth=6), spp=SPP, seed=0)
    img = film["primal"]
    assert img.shape == (8, 8, 3) and img.dtype == np.float32
    np.testing.assert_allclose(img.reshape(-1, 3), _port_block(sd) / SPP,
                               rtol=1e-6)
    # the per-pass route averages compute_pixel over stream_fold(base, s)
    per_pass = render(sd, IntegratorPathTracing(max_depth=6), spp=SPP,
                      seed=0, persistent=False)["primal"]
    want = sum(_port_pixel(sd, k, IntegratorPathTracing(max_depth=6))
               for k in range(SPP)) / SPP
    np.testing.assert_allclose(per_pass.reshape(-1, 3), want, rtol=1e-6)
    # a sampler name that is not ported, and the stratified sampler on the
    # persistent route, are refused
    with pytest.raises(ValueError):
        render(sd, IntegratorPathTracing(max_depth=6), spp=1,
               sampler="sobol")
    with pytest.raises(ValueError):
        render(sd, IntegratorPathTracing(max_depth=6), spp=1,
               sampler="stratified", persistent=True)


def test_cli_renders_a_pfm(tmp_path):
    from rustlight_tpu.utils.image import read_pfm
    out = tmp_path / "cbox.pfm"
    assert cli.main(["cbox", "-n", "2", "-s", "0.0625", "-o", str(out),
                     "--device", "cpu", "path", "-m", "6"]) == 0
    img = read_pfm(out)
    assert img.shape == (32, 32, 3) and np.all(np.isfinite(img))
    assert img.mean() > 0.05
    write_pfm(tmp_path / "again.pfm", img)
    np.testing.assert_array_equal(read_pfm(tmp_path / "again.pfm"), img)


@pytest.mark.parametrize("argv", [["cbox", "-a", "2", "path"],
                                  ["cbox", "--guiding", "path"],
                                  ["cbox", "-t", "1", "path"]])
def test_cli_refuses_what_is_not_ported(argv, tmp_path):
    """-a, --guiding and -t were refused until the meta integrators,
    guiding and the mesh were ported: they now render cbox 8x8 on the CPU
    (-t 1 on one device; tests/test_torch_cli.py renders -t 2 over two
    gloo ranks)."""
    out = tmp_path / "x.pfm"
    assert cli.main(argv[:-1] + ["-s", "0.015625", "-o", str(out), "--device",
                                 "cpu", "path", "-m", "2"]) == 0
    from rustlight_tpu_torch.utils.image import read_pfm
    img = read_pfm(out)
    assert img.shape == (8, 8, 3) and np.all(np.isfinite(img))


def _port_pixel(sd, k, integ):
    pix = torch.as_tensor(_pixel_grid(sd.camera.width, sd.camera.height))
    stream = trng.stream_fold(trng.make_stream(0, "cpu"), k)
    return integ.compute_pixel(sd, pix, stream).numpy()


def _jax_scene(w, h, medium=False, phong=False):
    sc = jax_cornell_box(w, h, mat_overrides={"blocks": jbsdfs.phong(
        kd=(0.2,) * 3, ks=(0.5,) * 3, exponent=50.0, weight_specular=0.5)}
        if phong else None)
    if medium:
        sc.volume = jax_make_volume(**MEDIUM)
    return sc.compile()


def _agree(got, ref, floor_mean=0.0):
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    assert ref.mean() > floor_mean
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-4)
    assert (rel.max(-1) <= PIX_RTOL).mean() >= PIX_FRAC
    assert abs(got.mean() - ref.mean()) <= MEAN_RTOL * ref.mean()


@pytest.fixture(scope="module")
def jax_pixel():
    """The JAX package's compute_pixel, one sample (stream_fold(seed 0, 0))
    on cbox 16x16, per case of PIXEL_CASES, each made once on first use:
    case -> (numpy scene, radiance)."""
    made = {}

    def get(case):
        if case not in made:
            medium, phong, kw = PIXEL_CASES[case]
            jsd = _jax_scene(W, H, medium, phong)
            pix = jnp.asarray(_pixel_grid(W, H))
            integ = JaxPath(**kw)
            ref = jax.jit(lambda s: integ.compute_pixel(jsd, pix, s))(
                jrng.stream_fold(jrng.make_stream(0), 0))
            made[case] = (jsd.host.data, np.asarray(ref))
        return made[case]
    return get


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(PIXEL_CASES))
def test_compute_pixel_matches_jax(jax_pixel, case):
    host, ref = jax_pixel(case)
    got = _port_pixel(from_numpy_scene(host, "cpu"), 0,
                      IntegratorPathTracing(**PIXEL_CASES[case][2]))
    _agree(got, ref, floor_mean=1e-3)


@pytest.mark.slow
def test_compute_block_with_a_medium_matches_jax():
    jsd = _jax_scene(W, H, medium=True)
    pix = jnp.asarray(_pixel_grid(W, H))
    integ = JaxPath(max_depth=8, hard_cap=8)
    ref = np.asarray(jax.jit(lambda s: integ.compute_block(jsd, pix, s, SPP))(
        jrng.stream_fold(jrng.make_stream(0), 0)))
    sd = from_numpy_scene(jsd.host.data, "cpu")
    got = IntegratorPathTracing(max_depth=8, hard_cap=8).compute_block(
        sd, torch.as_tensor(_pixel_grid(W, H)),
        trng.stream_fold(trng.make_stream(0, "cpu"), 0), SPP).numpy()
    _agree(got, ref, floor_mean=1e-3)


@pytest.mark.slow
def test_variance_aovs_match_jax():
    jsd = _jax_scene(8, 8)
    ref = jax_render(jsd, JaxPath(max_depth=6), 4, seed=0, variance=True)
    film = render(from_numpy_scene(jsd.host.data, "cpu"),
                  IntegratorPathTracing(max_depth=6), 4, seed=0,
                  variance=True)
    assert set(film.buffers) == set(ref.buffers) == {"primal", "mean",
                                                     "variance"}
    for name in ("primal", "mean", "variance"):
        _agree(film[name], ref[name], floor_mean=1e-3)


def test_variance_aovs_are_the_per_sample_variance():
    """variance=True takes the per-pass route; `mean` is the primal and
    `variance` the unbiased variance of the per-sample radiance."""
    sd = cornell_box(8, 8).compile(device="cpu")
    integ = IntegratorPathTracing(max_depth=6)
    film = render(sd, integ, 4, seed=0, variance=True, spp_per_pass=2)
    samples = np.stack([_port_pixel(sd, k, integ) for k in range(4)])
    np.testing.assert_allclose(film["primal"].reshape(-1, 3),
                               samples.mean(0), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(film["mean"], film["primal"])
    np.testing.assert_allclose(film["variance"].reshape(-1, 3),
                               samples.var(0, ddof=1), rtol=1e-3, atol=1e-5)
    assert film["variance"].max() > 0


@pytest.mark.parametrize("check_every", [1, 3])
def test_compute_pixel_loop_shape_does_not_change_the_result(monkeypatch,
                                                             check_every):
    sc = cornell_box(8, 8)
    sc.volume = make_volume(**MEDIUM)
    sd = sc.compile(device="cpu")
    integ = IntegratorPathTracing(max_depth=8, hard_cap=8)
    base = _port_pixel(sd, 0, integ)
    monkeypatch.setattr(tpath, "CHECK_EVERY", check_every)
    np.testing.assert_array_equal(base, _port_pixel(sd, 0, integ))


@pytest.mark.parametrize("route", ["block", "pixel"])
def test_draw_order_with_a_medium(monkeypatch, route):
    """With a medium, u_med follows the trace on every iteration: u_pix
    (compute_block every iteration, compute_pixel once), u_med, u_sel,
    u_pos, u_bsdf, u_rr."""
    seen = []

    def rec(fn, tag):
        def wrapped(stream, shape=()):
            seen.append(tag)
            return fn(stream, shape)
        return wrapped
    monkeypatch.setattr(tpath, "stream_next", rec(trng.stream_next, "1d"))
    monkeypatch.setattr(tpath, "stream_next2d", rec(trng.stream_next2d, "2d"))
    monkeypatch.setattr(tpath, "CHECK_EVERY", 1)
    sc = cornell_box(4, 4)
    sc.volume = make_volume(**MEDIUM)
    sd = sc.compile(device="cpu")
    integ = IntegratorPathTracing(max_depth=3, hard_cap=3)
    step = ["1d", "1d", "2d", "2d", "1d"]
    if route == "block":
        _port_block(sd, spp=1, hard_cap=3)
        step = ["2d"] + step
    else:
        _port_pixel(sd, 0, integ)
        assert seen.pop(0) == "2d"
    assert len(seen) % len(step) == 0 and len(seen) >= len(step)
    assert seen == step * (len(seen) // len(step))


def test_strategy_must_be_known():
    with pytest.raises(ValueError, match="strategy"):
        IntegratorPathTracing(strategy="bdpt")


# tools/regression.py's integrators of the rows (:91-94, :127-129)
ROW_INTEGRATORS = {
    "path": lambda: IntegratorPathTracing(max_depth=8, hard_cap=8),
    "path-single": lambda: IntegratorPathTracing(
        max_depth=2, hard_cap=2, min_depth=1, single_scattering=True),
}
METRIC_RTOL = 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("name, tech", [("cbox_path", "path"), ("cbox_medium", "path"),
                                 ("cbox_medium_single", "path-single")])
def test_regression_rows_match_the_stored_rows(name, tech):
    """The row at tools/regression.py's settings (cornell_box(128, 128), in
    the medium for cbox_medium*, 32 spp, seed 0, the per-pass route as the
    stored row's): each metric against regress/refs/<name>.exr within
    METRIC_RTOL of regress/results.json's."""
    import json
    from pathlib import Path
    from rustlight_tpu_torch.utils.image import read_exr
    from rustlight_tpu_torch.utils.metrics import metric_scalar
    root = Path(__file__).resolve().parents[1] / "regress"
    sc = cornell_box(128, 128)
    if name != "cbox_path":
        sc.volume = make_volume(**MEDIUM)
    img = render(sc.compile(device="cpu"), ROW_INTEGRATORS[tech](), 32,
                 seed=0, persistent=False)["primal"]
    ref = read_exr(root / "refs" / f"{name}.exr")
    stored = json.loads((root / "results.json").read_text())[f"{name}/{tech}"]
    for m in ("l1", "l2", "mape", "dssim"):
        assert abs(metric_scalar(ref, img, m) - stored[m]) <= (
            METRIC_RTOL * stored[m]), m

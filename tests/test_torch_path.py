"""The port's path tracer against the JAX package's, sample for sample.

IntegratorPathTracing.compute_block of both packages on the same Cornell-box
tables (cbox 16x16, 2 spp, max_depth 6, seed 0; JAX jitted on the CPU). The
threefry streams are bit-exact and the draw order is the reference's, so
every lane traces the same path unless a float difference flips a branch
(a Russian-roulette or light-selection comparison landing within an ulp,
or a hit at a triangle edge). Tolerance: at least PIX_FRAC of the pixels
within PIX_RTOL (relative, with a 1e-4 floor) and the image means within
MEAN_RTOL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.integrators import IntegratorPathTracing as JaxPath
from rustlight_tpu.integrators.common import _pixel_grid
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.utils import rng as jrng
from rustlight_tpu_torch import cli
from rustlight_tpu_torch.integrators import IntegratorPathTracing, render
from rustlight_tpu_torch.integrators import path as tpath
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng
from rustlight_tpu_torch.utils.film import write_pfm

torch.set_num_threads(2)

PIX_FRAC, PIX_RTOL, MEAN_RTOL = 0.99, 1e-3, 1e-4
W = H = 16
SPP = 2


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
    for kw in ({"persistent": False}, {"variance": True},
               {"sampler": "stratified"}):
        with pytest.raises(NotImplementedError):
            render(sd, IntegratorPathTracing(max_depth=6), spp=1, **kw)


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


@pytest.mark.parametrize("argv", [["veach_mis", "path"], ["cbox", "direct"],
                                  ["cbox", "-r", "stratified", "path"]])
def test_cli_refuses_what_is_not_ported(argv):
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(argv)

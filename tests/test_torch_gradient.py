"""The port's gradient-domain path tracers against the JAX package's.

  - one pass (stream_fold(make_stream(0), 1)) of each shift on cbox 16x16
    at max_depth 3: the random-replay shift's (primal, gradient_x,
    gradient_y) and the reconnection shift's, with its very_direct; each
    within GRAD_RTOL relative or GRAD_ATOL absolute of the JAX package's
    (both sides replay the same streams, so lanes trace the same paths;
    the values are O(0.1-1), the gradients near 0 in flat regions). The
    JAX side is the integrator's own jitted pass, lowered once a module
    and compiled without LLVM's optimizations;
  - the three reconstructions on the same numpy-seeded buffers: uniform
    bit for bit (the same adds, in the same order), weighted and the
    bagging mean within RECONS_RTOL, the bagging variance and relerr
    (differences of close values) within VAR_RTOL of their scale;
  - _render_gradient_film on the same pass outputs: buffer rotation
    (pass s into s % nb), very_direct, each reconstruction, every buffer
    within RECONS_RTOL;
  - on the port alone: min_survival 1.0 equals no survival test, and 0.5
    weighs each lane by 1 / clip(lum / 0.1, 0.5, 1) or 0; the reconnection
    shift's half-vector replay (has_delta) selects nothing on cbox, which
    has no smooth material; its draw order; its loop shape (CHECK_EVERY) changes nothing; a
    mesh raises NotImplementedError;
  - `slow`: the rows cbox_path/gradient-path and gradient-path-explicit
    (tools/regression.py: max_depth 6, cornell_box(128, 128), 32 spp, seed
    0) against their stored metrics, the random-replay row within 1e-4
    relative, the reconnection row within RECONNECT_ROW_RTOL: its
    reconnection and shadow rays graze edges, so a pass differs from the
    JAX package's on about 12 of 16,384 lanes (the JAX package's own two
    compilations, at optimization level 0 and the default, differ on 44),
    and the Poisson solve spreads each; measured 2.0e-4 (dssim); the
    weighted and
    bagging reconstructions of both shifts rendered at 16x16, 4 spp,
    against the JAX package's render() (SWEEP_* bounds).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.integrators.common import _pixel_grid
from rustlight_tpu.integrators.gradient import (
    IntegratorGradientPath as JaxReplay,
    IntegratorGradientPathReconnect as JaxReconnect)
from rustlight_tpu.integrators.gradient import path as jgpath
from rustlight_tpu.integrators.gradient import recons as jrecons
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.utils import rng as jrng
from rustlight_tpu_torch.utils.vec import luminance
from rustlight_tpu_torch.integrators.gradient import (
    IntegratorGradientPath, IntegratorGradientPathReconnect)
from rustlight_tpu_torch.integrators.gradient import path as tgpath
from rustlight_tpu_torch.integrators.gradient import recons as trecons
from rustlight_tpu_torch.integrators.gradient import reconnect as treconnect
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-6
RECONS_RTOL, VAR_RTOL = 1e-5, 1e-3
RECONNECT_ROW_RTOL = 5e-4
SWEEP_PIX_FRAC, SWEEP_PIX_RTOL, SWEEP_MEAN_RTOL = 0.99, 1e-3, 1e-4
W = H = 16
DEPTH = 3
PASS = 1
_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _jax_pass(ji, jsd, *extra):
    pix = jnp.asarray(_pixel_grid(W, H))
    px, py = pix[:, 0], pix[:, 1]
    f = ji._make_pass(jsd, pix, px, py, py * W + px, W, H, W * H, *extra)
    args = (jrng.make_stream(0), jnp.int32(PASS))
    out = f.lower(*args).compile(_FAST_COMPILE)(*args)
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX scene's host tables and one pass of each shift."""
    jsd = jax_cornell_box(W, H).compile()
    ji = JaxReplay(max_depth=DEPTH)
    return jsd.host.data, {
        "replay": _jax_pass(ji, jsd, ji.pss_dims),
        # cbox has no smooth material: the half-vector replay selects no
        # lane (has_delta False, as the port's render picks it here; the
        # port's True and False passes are held equal below)
        "reconnect": _jax_pass(JaxReconnect(max_depth=DEPTH), jsd, False)}


def _port_pass(host, shift):
    sd = from_numpy_scene(host, "cpu")
    stream = trng.stream_fold(trng.make_stream(0, "cpu"), PASS)
    if shift == "replay":
        return IntegratorGradientPath(max_depth=DEPTH).one_pass(sd, stream)
    return IntegratorGradientPathReconnect(max_depth=DEPTH).one_pass(
        sd, stream, False)


def _close(got, ref, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shift", ["replay", "reconnect"])
def test_one_pass_matches_jax(jax_side, shift):
    host, ref = jax_side
    got = _port_pass(host, shift)
    assert len(got) == len(ref[shift])
    primal = ref[shift][0]
    assert primal.mean() > 0.02 and (primal > 0).any(-1).mean() > 0.8
    assert np.abs(ref[shift][1]).max() > 0.01   # gradients present
    for g, r in zip(got, ref[shift]):
        assert tuple(g.shape) == r.shape and torch.isfinite(g).all()
        _close(g.numpy(), r)


def test_half_vector_replay_selects_nothing_without_smooth_materials():
    """The reconnection shift's has_delta switch: on a scene with no
    smooth material the replay's lanes are never selected, so both passes
    are equal, bit for bit (render picks False there)."""
    sd = cornell_box(8, 8).compile(device="cpu")
    assert not sd.host.materials.smooth.any()
    stream = trng.make_stream(5, "cpu")
    integ = IntegratorGradientPathReconnect(max_depth=4)
    for a, b in zip(integ.one_pass(sd, stream, True),
                    integ.one_pass(sd, stream, False)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _buffers(k=4, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.random((k, 12, 16, 3), dtype=np.float32)
    gx = (rng.random((k, 12, 16, 3), dtype=np.float32) - 0.5) * 0.2
    gy = (rng.random((k, 12, 16, 3), dtype=np.float32) - 0.5) * 0.2
    return p, gx, gy


def test_uniform_reconstruction_matches_jax_bit_for_bit():
    p, gx, gy = _buffers(1)
    a = jrecons.uniform_poisson_reconstruction(
        jnp.asarray(p[0]), jnp.asarray(gx[0]), jnp.asarray(gy[0]))
    b = trecons.uniform_poisson_reconstruction(
        torch.as_tensor(p[0]), torch.as_tensor(gx[0]), torch.as_tensor(gy[0]))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("k, iterations", [(2, 50), (3, 7)])
def test_weighted_reconstruction_matches_jax(k, iterations):
    p, gx, gy = _buffers(k, seed=k)
    a = jrecons.weighted_poisson_reconstruction(
        *map(jnp.asarray, (p, gx, gy)), iterations=iterations)
    b = trecons.weighted_poisson_reconstruction(
        *map(torch.as_tensor, (p, gx, gy)), iterations=iterations)
    _close(b.numpy(), a, rtol=RECONS_RTOL, atol=0)


def test_bagging_reconstruction_matches_jax():
    p, gx, gy = _buffers(4)
    a = jrecons.bagging_poisson_reconstruction(*map(jnp.asarray, (p, gx, gy)))
    b = trecons.bagging_poisson_reconstruction(
        *map(torch.as_tensor, (p, gx, gy)))
    _close(b[0].numpy(), a[0], rtol=RECONS_RTOL, atol=0)
    for x, y in zip(b[1:], a[1:]):
        y = np.asarray(y)
        _close(x.numpy(), y, rtol=VAR_RTOL, atol=VAR_RTOL * np.abs(y).max())
    with pytest.raises(ValueError):
        trecons.bagging_poisson_reconstruction(
            *(torch.as_tensor(x[:1]) for x in (p, gx, gy)))


@pytest.mark.parametrize("recons", ["uniform", "weighted", "bagging"])
@pytest.mark.parametrize("vd", [False, True], ids=["replay", "reconnect"])
def test_gradient_film_matches_jax(recons, vd):
    """_render_gradient_film of both packages on the same pass outputs (5
    passes of numpy-seeded buffers, very_direct for the reconnection
    shift)."""
    rng = np.random.default_rng(3)
    outs = [[rng.random((W * H, 3), dtype=np.float32) - (0 if i in (0, 3)
                                                         else 0.5)
             for i in range(4 if vd else 3)] for _ in range(5)]
    nb = {"uniform": 1, "weighted": 2, "bagging": 4}[recons]
    ref = jgpath._render_gradient_film(
        None, 5, lambda s: [jnp.asarray(x) for x in outs[int(s)]], nb,
        recons, 50, W, H)
    sd = cornell_box(W, H).compile(device="cpu")
    got = tgpath._render_gradient_film(
        sd, 5, lambda s: [torch.as_tensor(x) for x in outs[s]], nb, recons,
        50, W, H)
    assert set(got.buffers) == set(ref.buffers)
    for k in ref.buffers:
        r = np.asarray(ref.buffers[k])
        tol = VAR_RTOL if k in ("primal_variance", "relerr") else RECONS_RTOL
        _close(got[k], r, rtol=tol, atol=tol * np.abs(r).max())


def test_min_survival_weights_the_lanes():
    sd = cornell_box(8, 8).compile(device="cpu")
    stream = trng.stream_fold(trng.make_stream(0, "cpu"), 0)
    plain = IntegratorGradientPath(max_depth=DEPTH).one_pass(sd, stream)
    one = IntegratorGradientPath(max_depth=DEPTH,
                                 min_survival=1.0).one_pass(sd, stream)
    for a, b in zip(plain, one):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # 0.5: lane weights 1/prob or 0, from the uniform drawn after u
    integ = IntegratorGradientPath(max_depth=DEPTH, min_survival=0.5)
    got = integ.one_pass(sd, stream)
    u, s2 = trng.stream_next(stream, (64, integ.pss_dims))
    u_s, _ = trng.stream_next(s2, (64,))
    pix = torch.as_tensor(_pixel_grid(8, 8))
    lb = integ._eval(sd, pix, u)
    prob = torch.clamp(luminance(lb) / 0.1, 0.5, 1.0)
    wts = torch.where((prob >= 1.0) | (u_s < prob), 1.0 / prob, 0.0)
    assert (wts == 0).any() and (wts > 1).any()
    # the x gradient at lane (y, x) is its own +x shift's 0.5 (lo - lb) w
    # minus the -x shift of lane (y, x + 1), weighted by that lane's w:
    # zero where both lanes failed the survival test
    dead = (wts == 0).reshape(8, 8)
    gx0, gx = plain[1].reshape(8, 8, 3), got[1].reshape(8, 8, 3)
    both = dead[:, :-1] & dead[:, 1:]
    assert both.any() and torch.all(gx[:, :-1][both] == 0)
    assert torch.isfinite(got[0]).all() and not torch.equal(gx, gx0)


def test_reconnect_draw_order(monkeypatch):
    """u_pix (n, 2), then a bounce: u_sel (n,), u_pos (n, 2), u_b (n, 2),
    u_rr (n,)."""
    seen = []
    nxt, nxt2 = trng.stream_next, trng.stream_next2d

    def rec(fn, tag):
        def f(stream, shape=()):
            seen.append((tag, tuple(shape)))
            return fn(stream, shape)
        return f
    monkeypatch.setattr(treconnect, "stream_next", rec(nxt, "1"))
    monkeypatch.setattr(treconnect, "stream_next2d", rec(nxt2, "2"))
    sd = cornell_box(4, 4).compile(device="cpu")
    IntegratorGradientPathReconnect(max_depth=3).one_pass(
        sd, trng.make_stream(0, "cpu"))
    assert seen == [("2", (16,))] + [("1", (16,)), ("2", (16,)),
                                     ("2", (16,)), ("1", (16,))] * 2


@pytest.mark.parametrize("check_every", [1, 3])
def test_reconnect_loop_shape_does_not_change_the_result(monkeypatch,
                                                         check_every):
    sd = cornell_box(8, 8).compile(device="cpu")
    stream = trng.make_stream(2, "cpu")
    integ = IntegratorGradientPathReconnect(max_depth=6)
    ref = integ.one_pass(sd, stream)
    monkeypatch.setattr(treconnect, "CHECK_EVERY", check_every)
    for a, b in zip(integ.one_pass(sd, stream), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("cls", [IntegratorGradientPath,
                                 IntegratorGradientPathReconnect])
def test_mesh_of_one_renders_the_single_device_film(cls):
    """Each rank traces its row band with the single-device draws of its
    lanes: a mesh of one renders the single-device film bit for bit
    (tests/test_torch_parallel.py holds 2 and 3 ranks to it)."""
    from rustlight_tpu_torch.parallel import Mesh
    sd = cornell_box(4, 4).compile(device="cpu")
    ref = cls(max_depth=2).render(sd, 1)
    got = cls(max_depth=2).render(sd, 1, mesh=Mesh())
    assert sorted(got.buffers) == sorted(ref.buffers)
    for k in ref.buffers:
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("cls, recons", [
    (IntegratorGradientPath, "uniform"),
    (IntegratorGradientPathReconnect, "bagging")])
def test_render_film_buffers(cls, recons):
    sd = cornell_box(8, 8).compile(device="cpu")
    film = cls(max_depth=3, recons=recons).render(sd, 4, seed=0)
    want = {"primal", "primal_raw", "very_direct", "gradient_x",
            "gradient_y"} | ({"primal_variance", "relerr"}
                             if recons == "bagging" else set())
    assert set(film.buffers) == want
    for v in film.buffers.values():
        assert v.shape == (8, 8, 3) and np.all(np.isfinite(v))
    assert film["primal"].mean() > 0.02


@pytest.mark.slow
@pytest.mark.parametrize("tech, cls, rtol", [
    ("gradient-path", IntegratorGradientPathReconnect, RECONNECT_ROW_RTOL),
    ("gradient-path-explicit", IntegratorGradientPath, 1e-4)],
    ids=["gradient-path", "gradient-path-explicit"])
def test_regression_rows_match_the_stored_rows(tech, cls, rtol):
    import json
    from pathlib import Path
    from rustlight_tpu_torch.utils.image import read_exr
    from rustlight_tpu_torch.utils.metrics import metric_scalar
    root = Path(__file__).resolve().parents[1] / "regress"
    img = cls(max_depth=6).render(cornell_box(128, 128).compile(device="cpu"),
                                  32, seed=0)["primal"]
    ref = read_exr(root / "refs" / "cbox_path.exr")
    stored = json.loads((root / "results.json").read_text())[
        f"cbox_path/{tech}"]
    for m in ("l1", "l2", "mape", "dssim"):
        assert abs(metric_scalar(ref, img, m) - stored[m]) <= (
            rtol * stored[m]), m


@pytest.mark.slow
@pytest.mark.parametrize("recons", ["weighted", "bagging"])
@pytest.mark.parametrize("shift", ["replay", "reconnect"])
def test_reconstruction_sweep_matches_jax(shift, recons):
    """The JAX package's render() here compiles with its default options
    (fused multiply-adds), so a few reconnection lanes flip (see the
    rows); each buffer is held as tests/test_torch_path.py holds a
    render: SWEEP_PIX_FRAC of the pixels within SWEEP_PIX_RTOL (relative,
    floored at 1e-3 of the buffer's largest value), means within
    SWEEP_MEAN_RTOL of the mean absolute value."""
    jsd = jax_cornell_box(W, H).compile()
    jcls, tcls = ((JaxReplay, IntegratorGradientPath) if shift == "replay"
                  else (JaxReconnect, IntegratorGradientPathReconnect))
    ref = jcls(max_depth=DEPTH, recons=recons).render(jsd, 4, seed=0)
    got = tcls(max_depth=DEPTH, recons=recons).render(
        from_numpy_scene(jsd.host.data, "cpu"), 4, seed=0)
    for k in ("primal", "gradient_x", "gradient_y"):
        r, g = np.asarray(ref.buffers[k]), got[k]
        rel = np.abs(g - r) / np.maximum(np.abs(r), 1e-3 * np.abs(r).max())
        assert (rel.max(-1) <= SWEEP_PIX_RTOL).mean() >= SWEEP_PIX_FRAC, k
        assert abs(g.mean() - r.mean()) <= SWEEP_MEAN_RTOL * np.abs(r).mean()

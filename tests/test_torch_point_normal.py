"""The port's point-normal family against the JAX package's.

  - utils/solvers.py and every function of point_normal_poly.py on 4,096
    lanes of seeded numpy inputs (seed 15), under POLY_FRAC / POLY_RTOL;
  - every distance sampler of point_normal.py, one case a strategy (and the
    Bezier warp), on 4,096 rays in a Cornell box in a medium with g = 0.3:
    the sampled distance, its pdf and its valid mask, and the strategy's
    pdf at 4,096 other distances, under SAMPLE_FRAC / SAMPLE_RTOL;
  - compute_pixel of IntegratorPointNormal(strategies=("tr",
    "equiangular")), the regression row's integrator, on cbox 8x8 in the
    samplers' medium, one sample: within PIXEL_RTOL.

The JAX side of each group is one jitted function (compiled without
LLVM's optimizations, whose fused multiply-adds would round a zero-width
normalization to noise) in a module fixture. The
JAX package samples inline in compute_pixel; `_jax_sample` calls its
functions in the same order (rustlight_tpu/integrators/point_normal.py,
the strategy branches of compute_pixel). `-m slow`: compute_pixel with all
eleven strategies, with the `phase` connection, and the regression row
cbox_medium_single/point-normal at 128x128, 32 spp, against its stored
metrics within 1e-4 relative.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.integrators import point_normal as jpn
from rustlight_tpu.integrators import point_normal_poly as jpp
from rustlight_tpu.integrators.common import _pixel_grid
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.scene import make_volume as jax_make_volume
from rustlight_tpu.utils import rng as jrng
from rustlight_tpu.utils import solvers as jsolv
from rustlight_tpu_torch.integrators import IntegratorPointNormal, render
from rustlight_tpu_torch.integrators import point_normal as tpn
from rustlight_tpu_torch.integrators import point_normal_poly as tpp
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.scene import make_volume
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng
from rustlight_tpu_torch.utils import solvers as tsolv

torch.set_num_threads(2)
# the JAX side's jitted references compile without LLVM's optimizations:
# about half the compile time
_FAST_COMPILE = {"xla_backend_optimization_level": 0}

N = 4096
# the functions of solvers.py and point_normal_poly.py: discrete results
# equal; of each float result at least POLY_FRAC of the lanes within
# POLY_RTOL (relative, absolute floor 1e-6) and its sum over the lanes
# within POLY_RTOL. The samplers: valid masks equal on every lane; t, its
# pdf and the pdf at t_other within SAMPLE_RTOL on SAMPLE_FRAC of the
# lanes and within 10 x SAMPLE_RTOL on POLY_FRAC of them; their sums
# within POLY_RTOL. The lanes outside are float32 knife edges of the shared
# algorithm, where libm and XLA round a sin, cos or tan apart: cancellation
# in the closed-form cdf_pn under a fixed 20-step Newton inversion, a root
# near a double root, tan near pi/2 on rays that miss.
POLY_FRAC, POLY_RTOL = 0.99, 1e-4
SAMPLE_FRAC, SAMPLE_RTOL = 0.97, 1e-3
PIXEL_RTOL = 1e-4
MEDIUM = dict(sigma_s=(0.0025,) * 3)   # tools/regression.py's cbox_medium
# the samplers' medium: colored, absorbing, forward scattering
SAMPLER_MEDIUM = dict(sigma_s=(0.004, 0.005, 0.006),
                      sigma_a=(0.001, 0.001, 0.002), g=0.3)
WARP_CASES = ("warp", "warp_bezier")    # the warps T, P and N chained
SAMPLER_CASES = tuple(s for s in tpn._ALL_STRATEGIES if s != "warp") + (
    WARP_CASES)


def _close(got, ref, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# --------------------------------------------------- solvers and polynomials

def _poly_inputs():
    rng = np.random.default_rng(15)
    f = lambda *s: rng.uniform(-1.0, 1.0, s).astype(np.float32)  # noqa: E731
    theta_a = rng.uniform(-1.4, 0.2, N).astype(np.float32)
    theta_b = np.minimum(theta_a + rng.uniform(0.05, 2.5, N),
                         1.5).astype(np.float32)
    return dict(
        quad=(f(N), f(N), f(N)),
        cubic=(f(N) * (rng.random(N) > 0.1), f(N), f(N), f(N)),
        target=rng.random(N).astype(np.float32),
        d_l=rng.uniform(1.0, 400.0, N).astype(np.float32),
        x=rng.uniform(-1.5, 1.5, N).astype(np.float32),
        a=f(N), b=f(N), u=rng.random(N).astype(np.float32),
        theta_a=theta_a, theta_b=theta_b,
        clamp=rng.uniform(-1.5, 1.5, N).astype(np.float32),
        o=rng.uniform(0.0, 550.0, (N, 3)).astype(np.float32),
        d=(lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True))(
            rng.normal(size=(N, 3))).astype(np.float32),
        p_l=rng.uniform(200.0, 350.0, (N, 3)).astype(np.float32),
        n_l=np.tile(np.float32([0.0, -1.0, 0.0]), (N, 1)),
        delta=rng.uniform(-300.0, 300.0, N).astype(np.float32))


def _poly_suite(m, solv, xp, x):
    """Every function of solvers.py and point_normal_poly.py on the inputs
    `x` (arrays of `xp`), through module `m` and solvers `solv`."""
    out = {}
    out["solve_quadratic"] = solv.solve_quadratic(*x["quad"])
    out["solve_cubic"] = solv.solve_cubic(*x["cubic"])
    out["newton_bisect"] = (solv.newton_bisect(
        lambda v: v * v * v, lambda v: 3.0 * v * v, xp.zeros_like(x["u"]),
        xp.ones_like(x["u"]), x["target"]),)
    g, st = 0.3, 0.007
    c_ph, c_tr = m.poly6_phase(g), m.poly6_tr(x["d_l"], st)
    out["poly6"] = tuple(c_ph) + tuple(c_tr)
    out["poly_eval_cdf"] = (m.poly_eval(c_tr, x["x"]), m.poly_cdf(c_tr, x["x"]),
                            m.poly_eval(c_ph, x["x"]), m.poly_cdf(c_ph, x["x"]))
    out["poly_cdf_pn"] = (m.poly_cdf_pn(c_tr, x["a"], x["b"], x["theta_a"],
                                        x["theta_b"]),)
    out["clamp_angles"] = (m.clamp_angle_tr(st, x["d_l"]),
                           m.clamp_angle_phase(x["a"]))
    ts = m.taylor_setup(c_tr, x["theta_a"], x["theta_b"], x["clamp"])
    th, pdf = m.taylor_sample(c_tr, ts, x["u"])
    out["taylor"] = (tuple(ts[k] for k in sorted(ts)), (th, pdf),
                     (m.taylor_pdf(c_tr, ts, x["x"]),), ts["prob_poly"])
    a0, b0 = m.pn_coeffs(x["o"], x["d"], x["p_l"], x["n_l"], x["delta"],
                         x["d_l"])
    nrm = m.pn_norm(a0, b0, x["theta_a"], x["theta_b"])
    safe = xp.where(xp.abs(nrm) > 1e-20, nrm, 1.0)
    out["pn"] = (a0, b0, nrm, m.pn_invert(a0 / safe, b0 / safe, x["theta_a"],
                                          x["theta_b"], x["u"]))
    ps = m.pn_taylor_setup(c_ph, a0, b0, x["theta_a"], x["theta_b"],
                           x["clamp"])
    th, pdf = m.pn_taylor_sample(c_ph, ps, x["u"])
    out["pn_taylor"] = (tuple(ps[k] for k in sorted(ps)), (th, pdf),
                        (m.pn_taylor_pdf(c_ph, ps, x["x"]),), ps["prob_poly"])
    return out


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


@pytest.fixture(scope="module")
def poly_side():
    """(port's results, JAX's results) of `_poly_suite` on the same inputs;
    the JAX side gets copies and is read back before the port runs."""
    x = _poly_inputs()
    jx = jax.tree_util.tree_map(lambda v: jnp.array(v, copy=True), x)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda a: _poly_suite(jpp, jsolv, jnp, a),
        compiler_options=_FAST_COMPILE)(jx))
    got = _poly_suite(tpp, tsolv, torch,
                      {k: tuple(map(_t, v)) if isinstance(v, tuple) else _t(v)
                       for k, v in x.items()})
    return got, ref


def _frac_close(got, ref, rtol, atol=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return (np.abs(got - ref) <= rtol * np.abs(ref) + atol) | (
        np.isnan(got) & np.isnan(ref))


def _sums_close(got, ref, rtol=POLY_RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    fin = np.isfinite(ref)
    assert abs(got[fin].sum() - ref[fin].sum()) <= rtol * np.abs(ref[fin]).sum()


@pytest.mark.parametrize("name", ["solve_quadratic", "solve_cubic",
                                  "newton_bisect", "poly6", "poly_eval_cdf",
                                  "poly_cdf_pn", "clamp_angles", "taylor",
                                  "pn", "pn_taylor"])
def test_solvers_and_polynomials_match_jax(poly_side, name):
    got, ref = poly_side
    gl_all, rl_all = _leaves(got[name]), _leaves(ref[name])
    assert len(gl_all) == len(rl_all)
    for gl, rl in zip(gl_all, rl_all):
        gl = gl.numpy() if isinstance(gl, torch.Tensor) else np.asarray(gl)
        gl = np.broadcast_to(gl, rl.shape)
        if rl.dtype == bool or np.issubdtype(rl.dtype, np.integer):
            np.testing.assert_array_equal(gl.astype(rl.dtype), rl)
            continue
        assert _frac_close(gl, rl, POLY_RTOL).mean() >= POLY_FRAC
        _sums_close(gl, rl)
    if name == "solve_cubic":
        assert 0.1 < (ref[name][1] == 3).mean() < 0.9
    if name in ("taylor", "pn_taylor"):
        # both branches of the mixture are drawn on many lanes
        prob = ref[name][3]
        assert 0.1 < ((prob > 0.0) & (prob < 1.0)).mean()


# ------------------------------------------------------------------ samplers

def _sampler_inputs():
    """Rays from inside the box, a tenth of them missing (tmax 1e7, as
    compute_pixel sets it), points on the light, and distances t_other in
    [0, tmax] where each strategy's pdf is evaluated (the MIS weights take
    them there)."""
    rng = np.random.default_rng(16)
    d = rng.normal(size=(N, 3))
    x = dict(
        o=rng.uniform(10.0, 540.0, (N, 3)).astype(np.float32),
        d=(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32),
        tmax=np.where(rng.random(N) < 0.1, 1e7,
                      rng.uniform(5.0, 900.0, N)).astype(np.float32),
        p_l=np.stack([rng.uniform(213.0, 343.0, N), np.full(N, 548.79),
                      rng.uniform(227.0, 332.0, N)], -1).astype(np.float32),
        n_l=np.tile(np.float32([0.0, -1.0, 0.0]), (N, 1)),
        u=rng.random(N).astype(np.float32),
        u_other=rng.random(N).astype(np.float32))
    x["t_other"] = (x.pop("u_other") * x["tmax"]).astype(np.float32)
    return x


def _jax_sample(vol, name, ji, u_t, tmax, eq, eqc, wparams, setups):
    """The JAX package's strategy branches of compute_pixel, in its order:
    (t, pdf, valid)."""
    delta, d_l, ta, tb = eq
    _, _, ta_c, tb_c, valid_c = eqc

    def to_dist(theta, pdf_ang, valid):
        tt = d_l * jnp.tan(theta)
        t_s = jnp.clip(tt + delta, 0.0, tmax)
        pdf_s = pdf_ang * d_l / jnp.maximum(d_l ** 2 + tt ** 2, 1e-30)
        t_eq, pdf_eq = jpn._equiangular_sample(u_t, delta, d_l, ta, tb, tmax)
        t = jnp.where(valid, t_s, t_eq)
        pdf = jnp.where(valid, pdf_s, pdf_eq)
        return t, pdf, pdf > 0.0

    if name == "tr":
        from rustlight_tpu.scene.volume import volume_sample_distance
        sd = volume_sample_distance(vol, tmax, u_t)
        return sd.t, sd.pdf, ~sd.exited
    if name == "equiangular":
        t, pdf = jpn._equiangular_sample(u_t, delta, d_l, ta, tb, tmax)
        return t, pdf, pdf > 0.0
    if name == "warp":
        x, pdf_ang = ji._warp_chain_sample(wparams, u_t)
        theta = ta + x * (tb - ta)
        tt = d_l * jnp.tan(theta)
        t = jnp.clip(tt + delta, 0.0, tmax)
        jac = d_l / jnp.maximum(d_l ** 2 + tt ** 2, 1e-30)
        pdf = pdf_ang / jnp.maximum(tb - ta, 1e-12) * jac
        return t, pdf, pdf > 0.0
    if name in jpn._TAYLOR:
        c, st = setups[name]
        return to_dist(*jpp.taylor_sample(c, st, u_t), st["valid"])
    if name in jpn._PN_TAYLOR:
        c, st = setups[name]
        return to_dist(*jpp.pn_taylor_sample(c, st, u_t), st["valid"])
    if name in jpn._BEST:
        c, st, wp = setups[name]
        if name == "pn_best":
            theta1, pdf_ang = jpp.pn_taylor_sample(c, st, u_t)
            dom_a, dom_b = ta_c, tb_c
        else:
            theta1, pdf_ang = jpp.taylor_sample(c, st, u_t)
            dom_a, dom_b = ta, tb
        theta, pdf_ang = ji._best_compose_sample(theta1, pdf_ang, wp, dom_a,
                                                 dom_b)
        return to_dist(theta, pdf_ang, st["valid"])
    if name == "pn":
        a_n, b_n, ok = setups["pn"]
        theta = jpp.pn_invert(a_n, b_n, ta_c, tb_c, u_t)
        pdf_ang = jnp.abs(a_n * jnp.cos(theta) + b_n * jnp.sin(theta))
        return to_dist(theta, pdf_ang, ok)
    t, pdf = jpn._equiangular_sample(u_t, delta, d_l, ta_c, tb_c, tmax)
    return t, pdf, valid_c & (pdf > 0.0)


def _integrator(m, case):
    """All strategies with linear warps; the Bezier warp case alone."""
    if case == "warp_bezier":
        return m.IntegratorPointNormal(strategies=("warp",), warps="TPN",
                                       warps_strategy="bezier")
    return m.IntegratorPointNormal(strategies=tpn._ALL_STRATEGIES,
                                   warps="TPN")


def _setup(m, sd, ji, x):
    """eq, eqc, the warp parameters and the product setups of module `m`."""
    ls0 = SimpleNamespace(p=x["p_l"], n=x["n_l"])
    eq = m._equiangular_params(x["o"], x["d"], x["p_l"], x["tmax"])
    delta, d_l, ta, tb = eq
    eqc = (delta, d_l) + tuple(m._equiangular_clamp(
        x["o"], x["d"], x["p_l"], x["n_l"], x["tmax"], ta, tb, delta, d_l))
    return (eq, eqc, ji._warp_params(sd, x["o"], x["d"], ls0, eq),
            ji._product_setups(sd, x["o"], x["d"], ls0, eq, eqc))


def _sampler_scene():
    sc = jax_cornell_box(8, 8)
    sc.volume = jax_make_volume(**SAMPLER_MEDIUM)
    return sc.compile()


@pytest.fixture(scope="module")
def sampler_side():
    """The JAX package's scene's host tables, the inputs, case -> ((t, pdf,
    valid) of the sample, the pdf at t_other), and under "pixel" the
    radiance of compute_pixel of PIXEL_CASES["row"] on the scene's 8x8
    film, one sample: one jitted function."""
    jsd = _sampler_scene()
    x = _sampler_inputs()
    pix = jnp.asarray(_pixel_grid(8, 8))

    def suite(a, stream):
        out = {"pixel": jpn.IntegratorPointNormal(
            **PIXEL_CASES["row"]).compute_pixel(jsd, pix, stream)}
        for cases in ([c for c in SAMPLER_CASES if c != "warp_bezier"],
                      ["warp_bezier"]):
            ji = _integrator(jpn, cases[0])
            eq, eqc, wp, setups = _setup(jpn, jsd, ji, a)
            for case in cases:
                name = "warp" if case in WARP_CASES else case
                sample = _jax_sample(jsd.volume, name, ji, a["u"], a["tmax"],
                                     eq, eqc, wp, setups)
                pdf = ji._distance_pdfs(jsd, name, a["t_other"], a["o"],
                                        a["d"], None, a["tmax"], eq, eqc, wp,
                                        setups)
                out[case] = (sample, pdf)
        return out
    ref = jax.jit(suite, compiler_options=_FAST_COMPILE)(
        jax.tree_util.tree_map(lambda v: jnp.array(v, copy=True), x),
        jrng.stream_fold(jrng.make_stream(0), 0))
    return jsd.host.data, x, jax.tree_util.tree_map(np.asarray, ref)


@pytest.mark.parametrize("case", SAMPLER_CASES)
def test_distance_sampler_and_pdf_match_jax(sampler_side, case):
    host, x, ref = sampler_side
    sd = from_numpy_scene(host, "cpu")
    tx = {k: _t(v) for k, v in x.items()}
    ti = _integrator(tpn, case)
    name = "warp" if case in WARP_CASES else case
    eq, eqc, wp, setups = _setup(tpn, sd, ti, tx)
    t, pdf, valid = ti._sample(sd, name, tx["u"], eq, eqc, tx["tmax"], wp,
                               setups)
    pdf_o = ti._distance_pdfs(sd, name, tx["t_other"], eq, eqc, wp, setups)
    (rt, rpdf, rvalid), rpdf_o = ref[case]
    assert rvalid.mean() > 0.8
    np.testing.assert_array_equal(valid.numpy(), rvalid)
    for rtol, frac in ((SAMPLE_RTOL, SAMPLE_FRAC), (10 * SAMPLE_RTOL,
                                                    POLY_FRAC)):
        ok = (_frac_close(t, rt, rtol) & _frac_close(pdf, rpdf, rtol, 1e-9)
              & _frac_close(pdf_o, rpdf_o, rtol, 1e-9))
        assert ok.mean() >= frac, (rtol, ok.mean())
    for got, want in ((t, rt), (pdf, rpdf), (pdf_o, rpdf_o)):
        _sums_close(got.numpy(), want)


# ----------------------------------------------------------- compute_pixel

PIXEL_CASES = {
    "row": dict(strategies=("tr", "equiangular")),
    "all": dict(strategies=tpn._ALL_STRATEGIES, warps="TP",
                warps_strategy="bezier"),
    "phase": dict(strategies=("equiangular", "best", "pn_taylor_tr"),
                  connection="phase", use_aa=False),
}


def _jax_pixel(case, w=8, h=8):
    sc = jax_cornell_box(w, h)
    sc.volume = jax_make_volume(**MEDIUM)
    jsd = sc.compile()
    pix = jnp.asarray(_pixel_grid(w, h))
    ji = jpn.IntegratorPointNormal(**PIXEL_CASES[case])
    ref = jax.jit(lambda s: ji.compute_pixel(jsd, pix, s),
                  compiler_options=_FAST_COMPILE)(
        jrng.stream_fold(jrng.make_stream(0), 0))
    return jsd.host.data, np.asarray(ref)


def _port_pixel(host, case, w=8, h=8):
    sd = from_numpy_scene(host, "cpu")
    pix = torch.as_tensor(_pixel_grid(w, h))
    return IntegratorPointNormal(**PIXEL_CASES[case]).compute_pixel(
        sd, pix, trng.stream_fold(trng.make_stream(0, "cpu"), 0)).numpy()


def test_compute_pixel_matches_jax(sampler_side):
    host, _, ref = sampler_side
    ref = ref["pixel"]
    got = _port_pixel(host, "row")
    assert ref.mean() > 0 and (ref > 0).any(-1).mean() > 0.9
    _close(got, ref, rtol=PIXEL_RTOL, atol=1e-7)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["all", "phase"])
def test_compute_pixel_every_strategy_matches_jax(case):
    host, ref = _jax_pixel(case, 16, 16)
    got = _port_pixel(host, case, 16, 16)
    assert ref.mean() > 0
    _close(got, ref, rtol=PIXEL_RTOL, atol=1e-7)


def test_unknown_strategy_or_connection_is_refused():
    with pytest.raises(ValueError, match="strategy"):
        IntegratorPointNormal(strategies=("kulla",))
    with pytest.raises(ValueError, match="connection"):
        IntegratorPointNormal(connection="bsdf")
    with pytest.raises(ValueError, match="medium"):
        IntegratorPointNormal().compute_pixel(
            cornell_box(4, 4).compile(device="cpu"),
            torch.zeros((1, 2), dtype=torch.int32),
            trng.make_stream(0, "cpu"))


@pytest.mark.slow
def test_regression_row_matches_the_stored_row():
    """cbox_medium_single/point-normal at tools/regression.py's settings
    (cornell_box(128, 128) in the medium, 32 spp, seed 0, the per-pass
    route): each metric within 1e-4 of regress/results.json's."""
    import json
    from pathlib import Path
    from rustlight_tpu_torch.utils.image import read_exr
    from rustlight_tpu_torch.utils.metrics import metric_scalar
    root = Path(__file__).resolve().parents[1] / "regress"
    sc = cornell_box(128, 128)
    sc.volume = make_volume(**MEDIUM)
    img = render(sc.compile(device="cpu"), IntegratorPointNormal(
        strategies=("tr", "equiangular")), 32, seed=0)["primal"]
    ref = read_exr(root / "refs" / "cbox_medium_single.exr")
    stored = json.loads((root / "results.json").read_text())[
        "cbox_medium_single/point-normal"]
    for m in ("l1", "l2", "mape", "dssim"):
        assert abs(metric_scalar(ref, img, m) - stored[m]) <= (
            1e-4 * stored[m]), m

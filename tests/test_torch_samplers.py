"""The port's samplers and its device build_distribution_1d against the
JAX package's.

Bit for bit (the same numpy-seeded inputs through both):
  - samplers/stratified.py: `randint` (jax.random.randint's algorithm: the
    key split fold-like, two 32-bit words a lane, the modular multiplier)
    for every span that _stratum takes at n4 in {1, 4, 16, 64, 256} and at
    spans that are not powers of two; `_stratum` through stratified_1d /
    stratified_2d (tables 7919 and 7920 apart) on pixel ids up to 512^2;
    stratified_jitter;
  - samplers/pss.py: kelemen_mutate on the wrap-around edges (v + dv >= 1,
    v - dv < 0, and v - dv + 1 rounding to 1, which becomes 0), with r
    where exp is exact (r = 0 and 0.5: dv = s2);
  - utils/distribution.py:build_distribution_1d: its cdf and func_int, on
    sparse pools of 1 to 70,000 entries and on an all-zero pool.

Not bit for bit: kelemen_mutate on random (v, r). Its exp is XLA:CPU's
polynomial in the JAX package and torch's in the port; the two round
differently (1 ulp on about a tenth of the arguments), which reaches the
mutated value on KELEMEN_ULP_FRAC of the lanes at most, by at most
KELEMEN_ATOL: one rounding of v +- dv, whose ulp is 2^-24 below 1 (many
ulps of a small result after the wrap v + dv - 1).

The stratified sampler end to end: render(sampler="stratified") of the
path tracer (max_depth 6) on cbox 16x16, 4 spp, seed 0 against the JAX
package's (its per-pass route, jitted without LLVM's optimizations): at
least PIX_FRAC of the pixels within PIX_RTOL (relative, floor 1e-4), means
within MEAN_RTOL, as tests/test_torch_path.py holds the path tracer.
`slow`: the regression row cbox_ao/ao (tools/regression.py: IntegratorAO()
on cornell_box(128, 128), 32 spp, seed 0) against its stored metrics
within 1e-4 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.integrators import IntegratorPathTracing as JaxPath
from rustlight_tpu.integrators.common import render as jax_render
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.samplers import pss as jpss
from rustlight_tpu.samplers import stratified as jstrat
from rustlight_tpu.utils.distribution import (
    build_distribution_1d as jax_build_distribution_1d)
from rustlight_tpu_torch.integrators import (IntegratorAO,
                                             IntegratorPathTracing, render)
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.samplers import pss as tpss
from rustlight_tpu_torch.samplers import stratified as tstrat
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils.distribution import build_distribution_1d

torch.set_num_threads(2)

PIX_FRAC, PIX_RTOL, MEAN_RTOL = 0.99, 1e-3, 1e-4
KELEMEN_ULP_FRAC, KELEMEN_ATOL = 0.01, 2.0 ** -24
N4S = (1, 4, 16, 64, 256)
_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, (int(k[0]), int(k[1]))


def _pixel_ids():
    rng = np.random.default_rng(5)
    return np.concatenate([[0, 1, 511, 512 * 512 - 1],
                           rng.integers(0, 512 * 512, 2000)]).astype(np.int32)


@pytest.mark.parametrize("span", sorted({n for n4 in N4S
                                         for n in (n4, n4 // 2)}
                                        | {3, 7, 1000, 12345, 2 ** 31 - 1}))
def test_randint_matches_jax(span):
    jk, tk = _key(11)
    for data in (0, 1, 7919):
        a = jax.random.randint(jax.random.fold_in(jk, data), (3000,), 0, span)
        b = tstrat.randint(tstrat.fold_in(tk, data), 3000, span, "cpu")
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n4", N4S)
@pytest.mark.parametrize("which", ["1d", "2d"])
def test_stratified_dims_match_jax(n4, which):
    """_stratum through stratified_1d / stratified_2d at spp = n4 and at
    an spp that rounds up to it, every dim below NB_DIM, first and last
    pass."""
    jk, tk = _key(2)
    pid = _pixel_ids()
    rng = np.random.default_rng(n4)
    u = rng.random((pid.size, 2), dtype=np.float32)
    if which == "1d":
        u = u[:, 0]
    jf = jstrat.stratified_1d if which == "1d" else jstrat.stratified_2d
    tf = tstrat.stratified_1d if which == "1d" else tstrat.stratified_2d
    for spp in {n4, max(1, n4 - 1)}:
        for dim in range(tstrat.NB_DIM):
            for p in {0, spp - 1}:
                a = jf(jk, jnp.asarray(pid), p, spp, dim, jnp.asarray(u))
                b = tf(tk, torch.as_tensor(pid), p, spp, dim,
                       torch.as_tensor(u))
                np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_stratum_tables_are_apart():
    """1D dim k and 2D dim k use different permutations (tags 7919 and
    7920), as the reference shuffles its tables independently."""
    _, tk = _key(0)
    pid = torch.as_tensor(_pixel_ids())
    s1 = tstrat._stratum(tk, pid, 3, 0, 256, 7919)
    s2 = tstrat._stratum(tk, pid, 3, 0, 256, 7920)
    assert (s1 != s2).float().mean() > 0.9


@pytest.mark.parametrize("spp, pass_idx", [(4, 0), (16, 9), (64, 63)])
def test_stratified_jitter_matches_jax(spp, pass_idx):
    jk, tk = _key(7)
    pid = _pixel_ids()
    a = jstrat.stratified_jitter(jk, jnp.asarray(pid), pass_idx, spp)
    b = tstrat.stratified_jitter(tk, torch.as_tensor(pid), pass_idx, spp)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_kelemen_mutate_edges_match_jax():
    s2 = np.float32(1 / 64)
    v = np.array([0.0, 1e-9, 0.5, 1 - s2, 1 - s2 / 2, 0.999999, s2 / 2,
                  s2, 2 ** -6 - 2 ** -31, 2 ** -6 - 2 ** -30, 1e-30,
                  np.nextafter(np.float32(1), np.float32(0))], np.float32)
    for r0 in (0.0, 0.5):
        r = np.full_like(v, r0)
        a = np.asarray(jpss.kelemen_mutate(jnp.asarray(v), jnp.asarray(r)))
        b = tpss.kelemen_mutate(torch.as_tensor(v), torch.as_tensor(r))
        np.testing.assert_array_equal(a, b.numpy())
        assert b.min() >= 0.0 and b.max() < 1.0
    # v - dv + 1 rounds to 1: the result is 0
    assert float(tpss.kelemen_mutate(torch.tensor([2 ** -6 - 2 ** -31]),
                                     torch.tensor([0.5]))) == 0.0


def test_kelemen_mutate_random_within_an_ulp():
    rng = np.random.default_rng(1)
    v = rng.random(100_000, dtype=np.float32)
    r = rng.random(100_000, dtype=np.float32)
    a = np.asarray(jpss.kelemen_mutate(jnp.asarray(v), jnp.asarray(r)))
    b = tpss.kelemen_mutate(torch.as_tensor(v), torch.as_tensor(r)).numpy()
    diff = a != b
    assert diff.mean() <= KELEMEN_ULP_FRAC
    assert np.abs(a - b).max() <= KELEMEN_ATOL
    assert b.min() >= 0.0 and b.max() < 1.0


@pytest.mark.parametrize("n", [1, 7, 16, 17, 256, 1000, 16384, 70_000])
def test_build_distribution_1d_matches_jax(n):
    rng = np.random.default_rng(n)
    f = (rng.random(n) * (rng.random(n) < 0.3)).astype(np.float32)
    a = jax_build_distribution_1d(jnp.asarray(f))
    b = build_distribution_1d(torch.as_tensor(f))
    np.testing.assert_array_equal(np.asarray(a.cdf), b.cdf.numpy())
    assert float(a.func_int) == float(b.func_int)


def test_build_distribution_1d_all_zero_matches_jax():
    a = jax_build_distribution_1d(jnp.zeros(300))
    b = build_distribution_1d(torch.zeros(300))
    np.testing.assert_array_equal(np.asarray(a.cdf), b.cdf.numpy())
    assert b.cdf[-1] == 1.0 and b.cdf[:-1].abs().max() == 0.0


def _fast_jit(f=None, **kw):
    kw.setdefault("compiler_options", _FAST_COMPILE)
    if f is None:
        return functools.partial(_fast_jit, **kw)
    return _JIT(f, **kw)


_JIT = jax.jit


def test_stratified_render_matches_jax(monkeypatch):
    """render(sampler="stratified") of the path tracer, cbox 16x16, 4 spp,
    against the JAX package's per-pass route (compiled without LLVM's
    optimizations)."""
    jsd = jax_cornell_box(16, 16).compile()
    monkeypatch.setattr(jax, "jit", _fast_jit)
    ref = jax_render(jsd, JaxPath(max_depth=6), 4, seed=0,
                     sampler="stratified", spp_per_pass=4)["primal"]
    monkeypatch.undo()
    sd = from_numpy_scene(jsd.host.data, "cpu")
    got = render(sd, IntegratorPathTracing(max_depth=6), 4, seed=0,
                 sampler="stratified", spp_per_pass=4)["primal"]
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    assert ref.mean() > 0.05
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-4)
    assert (rel.max(-1) <= PIX_RTOL).mean() >= PIX_FRAC
    assert abs(got.mean() - ref.mean()) <= MEAN_RTOL * ref.mean()
    # it is not the independent sampler's image
    indep = render(sd, IntegratorPathTracing(max_depth=6), 4, seed=0,
                   spp_per_pass=4, persistent=False)["primal"]
    assert np.abs(indep - got).max() > 1e-3


def test_stratified_sampler_guards():
    sd = cornell_box(4, 4).compile(device="cpu")
    with pytest.raises(ValueError):
        render(sd, IntegratorPathTracing(max_depth=2), 1, sampler="sobol")
    with pytest.raises(ValueError):
        render(sd, IntegratorPathTracing(max_depth=2), 1,
               sampler="stratified", persistent=True)
    # an integrator with compute_pixel only takes the stratified passes too
    img = render(sd, IntegratorAO(), 4, sampler="stratified")["primal"]
    assert img.shape == (4, 4, 3) and np.all(np.isfinite(img))


@pytest.mark.slow
def test_ao_regression_row_matches_the_stored_row():
    """cbox_ao/ao at tools/regression.py's settings: each metric against
    regress/refs/cbox_ao.exr within 1e-4 of regress/results.json's."""
    import json
    from pathlib import Path
    from rustlight_tpu_torch.utils.image import read_exr
    from rustlight_tpu_torch.utils.metrics import metric_scalar
    root = Path(__file__).resolve().parents[1] / "regress"
    img = render(cornell_box(128, 128).compile(device="cpu"), IntegratorAO(),
                 32, seed=0)["primal"]
    ref = read_exr(root / "refs" / "cbox_ao.exr")
    stored = json.loads((root / "results.json").read_text())["cbox_ao/ao"]
    for m in ("l1", "l2", "mape", "dssim"):
        assert abs(metric_scalar(ref, img, m) - stored[m]) <= (
            1e-4 * stored[m]), m

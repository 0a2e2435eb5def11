"""The port's PSSMLT and ERPT against the JAX package's.

On cbox 16x16 with the path tracer at max_depth = hard_cap = 3 (22
primary-sample dims a chain), seed 0:

  - PSSMLT's seed selection, bit for bit: the port's build_distribution_1d
    and searchsorted(right) - 1 over the JAX package's pool of tf give the
    JAX package's seed indices; the port's own pool (its tf within an ulp
    or so of JAX's) gives them too;
  - the acceptance masks, bit for bit, of every (chain, step) decision of
    PSSMLT (CHAINS chains, 4 steps) and of ERPT (one chain slot a pixel, 4
    steps; every lane's decisions, spawned or not). The JAX side's masks come from the chain step replayed with
    the JAX package's own pieces (its jitted _sample_fn, _uniform on
    stream_fold(base, 77), kelemen_mutate, and the acceptance
    ua < min(1, tf_p / tf)), from its seeds;
  - the films of both renders (the JAX package's render(), its jits
    compiled without LLVM's optimizations) within FILM_RTOL of the film's
    scale: tf differs by ulps, so a splat's weight does too;
  - on the port alone: the chain step's draw order, a zero normalization
    raises RuntimeError, a mesh raises NotImplementedError;
  - `slow`: the rows cbox_path/pssmlt and cbox_path/erpt
    (tools/regression.py: 65,536 chains, 16,384 normalization samples;
    nb_mc 2, 16 chain samples; cornell_box(128, 128), 32 spp, seed 0)
    against their stored metrics within ROW_RTOL relative; ERPT without
    stratification and with two Poisson slots, and PSSMLT with only large
    steps, against the JAX package's renders.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.integrators import IntegratorPathTracing as JaxPath
from rustlight_tpu.integrators.mcmc import (IntegratorERPT as JaxERPT,
                                            IntegratorPSSMLT as JaxPSSMLT)
from rustlight_tpu.integrators.mcmc.pssmlt import _uniform as jax_uniform
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.samplers.pss import kelemen_mutate as jax_kelemen
from rustlight_tpu.utils import rng as jrng
from rustlight_tpu.utils.distribution import (
    build_distribution_1d as jax_build_distribution_1d)
from rustlight_tpu_torch.integrators import IntegratorPathTracing
from rustlight_tpu_torch.integrators.mcmc import (IntegratorERPT,
                                                  IntegratorPSSMLT)
from rustlight_tpu_torch.integrators.mcmc import pssmlt as tpssmlt
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng
from rustlight_tpu_torch.utils.distribution import build_distribution_1d

torch.set_num_threads(2)

W = H = 16
DEPTH = 3
# one chain a pixel, so that PSSMLT's and ERPT's chain steps share one
# jitted JAX _sample_fn ([256, 22]); 2 seed batches, 4 steps
CHAINS, NORM, SPP = W * H, 2 * W * H, 4
ERPT = dict(nb_mc=1, chain_samples=4, nb_samples_norm=256)
ERPT_SPP = 4
FILM_RTOL = 1e-4
# the rows' metrics against the stored ones: ERPT's within 1e-4 (found:
# 4.2e-8 on the CPU), PSSMLT's within 1e-3 (found: 3.5e-4 on the CPU,
# 1.4e-4 on the card): with 65,536 chains an ulp flips some decisions and
# those chains then wander apart
ROW_RTOL = {"pssmlt": 1e-3, "erpt": 1e-4}
_FAST_COMPILE = {"xla_backend_optimization_level": 0}
_JIT = jax.jit


def _fast_jit(f=None, **kw):
    kw.setdefault("compiler_options", _FAST_COMPILE)
    if f is None:
        return functools.partial(_fast_jit, **kw)
    return _JIT(f, **kw)


def _jax_pssmlt():
    return JaxPSSMLT(JaxPath(max_depth=DEPTH, hard_cap=DEPTH),
                     nb_chains=CHAINS, nb_samples_norm=NORM)


def _jax_chain_masks(sample, u, tf, steps, stream, large_prob=None):
    """The Metropolis decisions of the JAX package's chain step, replayed
    with its pieces: (ul, uf,) um, ua a step from `stream`."""
    masks = []
    for _ in range(steps):
        n, d = u.shape
        if large_prob is not None:
            ul, stream = jax_uniform(stream, (n,))
            uf, stream = jax_uniform(stream, (n, d))
        um, stream = jax_uniform(stream, (n, d))
        ua, stream = jax_uniform(stream, (n,))
        u_prop = jax_kelemen(u, um)
        if large_prob is not None:
            u_prop = jnp.where((ul < large_prob)[:, None], uf, u_prop)
        tf_p = sample(u_prop)[2]
        a = jnp.minimum(1.0, tf_p / jnp.maximum(tf, 1e-30))
        accept = ua < jnp.where(tf_p > 0.0, a, 0.0)
        u = jnp.where(accept[:, None], u_prop, u)
        tf = jnp.where(accept, tf_p, tf)
        masks.append(np.asarray(accept))
    return np.stack(masks)


@pytest.fixture(scope="module")
def jax_side(monkeypatch_module):
    jsd = jax_cornell_box(W, H).compile()
    monkeypatch_module.setattr(jax, "jit", _fast_jit)
    out = {"host": jsd.host.data}
    # PSSMLT: the render, its seed pool and its chain decisions
    ji = _jax_pssmlt()
    sample_fn = ji._sample_fn
    sample = _fast_jit(lambda u: sample_fn(jsd, u))
    # the render calls _sample_fn eagerly once on the seeds: jitted here
    ji._sample_fn = lambda scene, u: (
        sample_fn(scene, u) if isinstance(u, jax.core.Tracer) else sample(u))
    out["pssmlt"] = np.asarray(ji.render(jsd, SPP, seed=0)["primal"])
    base = jrng.make_stream(0)
    pool_u, pool_tf = [], []
    for i in range(NORM // CHAINS):
        u, _ = jax_uniform(jrng.stream_fold(base, 1000 + i),
                           (CHAINS, ji.pss_dims))
        pool_u.append(u)
        pool_tf.append(sample(u)[2])
    pool_u, pool_tf = jnp.concatenate(pool_u), jnp.concatenate(pool_tf)
    cdf = jax_build_distribution_1d(pool_tf).cdf
    idv = (jnp.arange(CHAINS, dtype=jnp.float32) + 0.5) / CHAINS
    sidx = jnp.clip(jnp.searchsorted(cdf, idv, side="right") - 1, 0,
                    pool_tf.shape[0] - 1)
    out["pool_tf"], out["sidx"] = np.asarray(pool_tf), np.asarray(sidx)
    out["pssmlt_masks"] = _jax_chain_masks(
        sample, pool_u[sidx], pool_tf[sidx], SPP * W * H // CHAINS,
        jrng.stream_fold(base, 77), large_prob=ji.large_prob)
    # ERPT: the render, and its one chain's decisions (stratified pixels)
    je = JaxERPT(JaxPath(max_depth=DEPTH, hard_cap=DEPTH), **ERPT)
    out["erpt"] = np.asarray(je.render(jsd, ERPT_SPP, seed=0)["primal"])
    # ERPT's _sample_fn is PSSMLT's (the pixel from u[:, 0:2], the path
    # from column 2) over the same inner tracer: the jitted one serves
    sample_e = sample
    stream = jrng.stream_fold(base, 0)
    u, stream = jax_uniform(stream, (W * H, je.pss_dims))
    lane = jnp.arange(W * H)
    u = u.at[:, 0].set((u[:, 0] + (lane % W).astype(jnp.float32)) / W)
    u = u.at[:, 1].set((u[:, 1] + (lane // W).astype(jnp.float32)) / H)
    tf0 = sample_e(u)[2]
    _, stream = jax_uniform(stream, (W * H,))          # u_spawn
    out["erpt_masks"] = _jax_chain_masks(sample_e, u, tf0,
                                         ERPT["chain_samples"], stream)
    monkeypatch_module.undo()
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def port_side(jax_side):
    sd = from_numpy_scene(jax_side["host"], "cpu")
    tp = IntegratorPSSMLT(IntegratorPathTracing(max_depth=DEPTH,
                                                hard_cap=DEPTH),
                          nb_chains=CHAINS, nb_samples_norm=NORM)
    tp.record_accepts = True
    te = IntegratorERPT(IntegratorPathTracing(max_depth=DEPTH,
                                              hard_cap=DEPTH), **ERPT)
    te.record_accepts = True
    return {"sd": sd, "pssmlt_integ": tp, "erpt_integ": te,
            "pssmlt": tp.render(sd, SPP, seed=0)["primal"],
            "erpt": te.render(sd, ERPT_SPP, seed=0)["primal"]}


def test_seed_selection_matches_jax(jax_side, port_side):
    """The seed indices from the JAX package's pool, and from the port's."""
    cdf = build_distribution_1d(torch.tensor(jax_side["pool_tf"])).cdf
    idv = (torch.arange(CHAINS, dtype=torch.float32) + 0.5) / CHAINS
    sidx = torch.clamp(torch.searchsorted(cdf, idv, right=True) - 1, 0,
                       NORM - 1)
    np.testing.assert_array_equal(sidx.numpy(), jax_side["sidx"])
    tp = port_side["pssmlt_integ"]
    b, _, _, own = tp.seed_chains(port_side["sd"],
                                  trng.make_stream(0, "cpu"))
    np.testing.assert_array_equal(own.numpy(), jax_side["sidx"])
    assert b == pytest.approx(float(jax_side["pool_tf"].mean()), rel=1e-5)


@pytest.mark.parametrize("which", ["pssmlt", "erpt"])
def test_acceptance_masks_match_jax(jax_side, port_side, which):
    ref = jax_side[f"{which}_masks"]
    integ = port_side[f"{which}_integ"]
    assert integ.accepts.shape[0] == 1
    assert integ.visits.shape == integ.tfs.shape == (1, 5) + ref.shape[1:]
    got = integ.accepts[0]
    assert got.shape == ref.shape == (4, CHAINS if which == "pssmlt"
                                      else W * H)
    assert 0.05 < ref.mean() < 0.95
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("which, covered", [("pssmlt", 0.5), ("erpt", 0.2)])
def test_film_matches_jax(jax_side, port_side, which, covered):
    """`covered`: the share of pixels the chains reach (ERPT spawns 0.75
    chains a pixel on average here)."""
    ref, got = jax_side[which], port_side[which]
    assert got.shape == ref.shape == (H, W, 3) and np.all(np.isfinite(got))
    assert ref.mean() > 0.02 and (ref > 0).any(-1).mean() > covered
    np.testing.assert_allclose(got, ref, rtol=FILM_RTOL,
                               atol=FILM_RTOL * np.abs(ref).max())


def test_chain_step_draw_order(monkeypatch):
    """Seeds on stream_fold(base, 1000 + i) (c, d); a chain step: ul (c,),
    uf (c, d), um (c, d), ua (c,)."""
    seen = []
    nxt = trng.stream_next

    def rec(stream, shape=()):
        seen.append(tuple(shape))
        return nxt(stream, shape)
    monkeypatch.setattr(tpssmlt, "stream_next", rec)
    sd = cornell_box(4, 4).compile(device="cpu")
    integ = IntegratorPSSMLT(IntegratorPathTracing(max_depth=2, hard_cap=2),
                             nb_chains=8, nb_samples_norm=8)
    integ.render(sd, 1, seed=0)
    d = integ.pss_dims
    assert seen == [(8, d)] + [(8,), (8, d), (8, d), (8,)] * 2


@pytest.mark.parametrize("cls", [IntegratorPSSMLT, IntegratorERPT])
def test_zero_normalization_raises(cls):
    sd = cornell_box(4, 4).compile(device="cpu")

    class Dark(IntegratorPathTracing):
        def compute_pixel(self, scene, pix, stream):
            return torch.zeros((pix.shape[0], 3))
    kw = dict(nb_chains=8) if cls is IntegratorPSSMLT else {}
    with pytest.raises(RuntimeError):
        cls(Dark(max_depth=2), nb_samples_norm=16, **kw).render(sd, 1)


@pytest.mark.parametrize("cls", [IntegratorPSSMLT, IntegratorERPT])
def test_mesh_of_one_draws_from_the_rank_stream(cls):
    """On a mesh, rank d's chains draw from stream_fold(stream_fold(base,
    d), 77) (PSSMLT) or stream_fold(stream_fold(base, d), round) (ERPT):
    a mesh of one renders the single-device film of that stream, with the
    seeds and the normalization drawn as on one device."""
    from rustlight_tpu_torch.parallel import Mesh
    sd = cornell_box(4, 4).compile(device="cpu")
    base = trng.make_stream(2, "cpu")
    d_base = trng.stream_fold(base, 0)
    if cls is IntegratorPSSMLT:
        m = cls(IntegratorPathTracing(max_depth=2), nb_chains=8,
                nb_samples_norm=16)
        b, u0, tf0, _ = m.seed_chains(sd, base)
        img = m.evolve(sd, u0, tf0, trng.stream_fold(d_base, 77),
                       2 * 16 // 8).reshape(4, 4, 3).numpy()
        want = img * (b / img.mean())
    else:
        m = cls(IntegratorPathTracing(max_depth=2), chain_samples=2,
                nb_samples_norm=16)
        b = m.normalization(sd, base)
        lane = torch.arange(16)
        want = m._round(sd, trng.stream_fold(d_base, 0),
                        (lane % 4).float(), (lane // 4).float(), b,
                        1 / 2, None).reshape(4, 4, 3).numpy()
    np.testing.assert_array_equal(m.render(sd, 2, seed=2, mesh=Mesh())[
        "primal"], want)


@pytest.mark.slow
@pytest.mark.parametrize("tech", ["pssmlt", "erpt"])
def test_regression_rows_match_the_stored_rows(tech):
    import json
    from pathlib import Path
    from rustlight_tpu_torch.utils.image import read_exr
    from rustlight_tpu_torch.utils.metrics import metric_scalar
    root = Path(__file__).resolve().parents[1] / "regress"
    if tech == "pssmlt":
        integ = IntegratorPSSMLT(IntegratorPathTracing(max_depth=8,
                                                       hard_cap=8),
                                 nb_samples_norm=16384, nb_chains=65536)
    else:
        integ = IntegratorERPT(IntegratorPathTracing(max_depth=6, hard_cap=6),
                               nb_mc=2, chain_samples=16,
                               nb_samples_norm=16384)
    img = integ.render(cornell_box(128, 128).compile(device="cpu"), 32,
                       seed=0)["primal"]
    ref = read_exr(root / "refs" / "cbox_path.exr")
    stored = json.loads((root / "results.json").read_text())[
        f"cbox_path/{tech}"]
    for m in ("l1", "l2", "mape", "dssim"):
        assert abs(metric_scalar(ref, img, m) - stored[m]) <= (
            ROW_RTOL[tech] * stored[m]), m


@pytest.mark.slow
@pytest.mark.parametrize("case", ["erpt-unstratified-2slots",
                                  "pssmlt-large-steps"])
def test_option_sweep_matches_jax(case):
    jsd = jax_cornell_box(W, H).compile()
    sd = from_numpy_scene(jsd.host.data, "cpu")
    if case.startswith("erpt"):
        kw = dict(ERPT, stratified=False, poisson_slots=2)
        ref = JaxERPT(JaxPath(max_depth=DEPTH, hard_cap=DEPTH), **kw).render(
            jsd, ERPT_SPP, seed=0)["primal"]
        got = IntegratorERPT(IntegratorPathTracing(max_depth=DEPTH,
                                                   hard_cap=DEPTH),
                             **kw).render(sd, ERPT_SPP, seed=0)["primal"]
    else:
        kw = dict(nb_chains=256, nb_samples_norm=512, large_prob=1.0)
        ref = JaxPSSMLT(JaxPath(max_depth=DEPTH, hard_cap=DEPTH),
                        **kw).render(jsd, 4, seed=0)["primal"]
        got = IntegratorPSSMLT(IntegratorPathTracing(max_depth=DEPTH,
                                                     hard_cap=DEPTH),
                               **kw).render(sd, 4, seed=0)["primal"]
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=FILM_RTOL,
                               atol=FILM_RTOL * np.abs(ref).max())

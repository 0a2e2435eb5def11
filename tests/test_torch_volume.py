"""The port's homogeneous medium against the JAX package's, lane for lane.

scene/volume.py of both packages on the same numpy inputs (seed 5, 4,096
lanes): phase_eval / phase_pdf / phase_sample for g in {-0.5, 0, 0.7},
volume_sample_distance with tfar including the infinite medium's 1e8 (a
gray medium and a colored one, whose channel pick matters), transmittance
and distance_pdf. The discrete field `exited` must be equal on every lane;
floats within FLOAT_RTOL relative with an absolute floor of FLOAT_ATOL
(both packages evaluate log/exp/sin/cos with their own vector libraries).

Beside them: the medium crossing from the JAX package's compiled scene
(`from_numpy_scene`), utils/variance.py's Welford estimator, and
utils/film.py's splat_add / accumulate_safe against the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.scene import volume as jvol
from rustlight_tpu.utils import film as jfilm
from rustlight_tpu.utils import variance as jvar
from rustlight_tpu_torch.scene import volume as tvol
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import film as tfilm
from rustlight_tpu_torch.utils import variance as tvar

FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-6
N = 4096
GS = (-0.5, 0.0, 0.7)
MEDIA = {"gray": dict(sigma_s=(0.0025,) * 3),
         "colored": dict(sigma_s=(0.01, 0.02, 0.004),
                         sigma_a=(0.002, 0.0, 0.006), g=0.3)}


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(5)
    tfar = rng.uniform(0.5, 2000.0, N).astype(np.float32)
    tfar[::4] = 1e8    # rays that miss: the infinite medium
    return dict(u=rng.random(N, dtype=np.float32),
                u2=rng.random((N, 2), dtype=np.float32),
                tfar=tfar, wi=_unit(rng, N), wo=_unit(rng, N),
                dist=rng.uniform(0.0, 3000.0, N).astype(np.float32),
                surf=rng.random(N) < 0.5)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=FLOAT_RTOL, atol=FLOAT_ATOL)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _media(name):
    jv = jvol.make_volume(**MEDIA[name])
    return jv, tvol.volume_to(jv, "cpu")


@pytest.mark.parametrize("g", GS)
def test_phase_functions_match_jax(lanes, g):
    gj, gt = np.float32(g), torch.tensor(g, dtype=torch.float32)
    wi, wo, u2 = lanes["wi"], lanes["wo"], lanes["u2"]
    _close(tvol.phase_eval(gt, _t(wi), _t(wo)),
           jvol.phase_eval(gj, jnp.asarray(wi), jnp.asarray(wo)))
    _close(tvol.phase_pdf(gt, _t(wi), _t(wo)),
           jvol.phase_pdf(gj, jnp.asarray(wi), jnp.asarray(wo)))
    d, w, pdf = tvol.phase_sample(gt, _t(wi), _t(u2))
    dj, wj, pdfj = jvol.phase_sample(gj, jnp.asarray(wi), jnp.asarray(u2))
    _close(d, dj)
    _close(w, wj)
    _close(pdf, pdfj)
    # the sampled directions are unit
    np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=-1), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("medium", sorted(MEDIA))
def test_distance_sampling_matches_jax(lanes, medium):
    jv, tv = _media(medium)
    got = tvol.volume_sample_distance(tv, _t(lanes["tfar"]), _t(lanes["u"]))
    ref = jvol.volume_sample_distance(jv, jnp.asarray(lanes["tfar"]),
                                      jnp.asarray(lanes["u"]))
    np.testing.assert_array_equal(got.exited.numpy(), np.asarray(ref.exited))
    for f in ("t", "w", "continued_t", "continued_w", "pdf"):
        _close(getattr(got, f), getattr(ref, f))
    # the infinite medium scatters almost surely
    assert not got.exited.numpy()[::4].any()
    assert got.exited.numpy().any() and not got.exited.numpy().all()


@pytest.mark.parametrize("medium", sorted(MEDIA))
def test_transmittance_and_distance_pdf_match_jax(lanes, medium):
    jv, tv = _media(medium)
    dist = lanes["dist"]
    _close(tvol.transmittance(tv, _t(dist)),
           jvol.transmittance(jv, jnp.asarray(dist)))
    _close(tvol.distance_pdf(tv, _t(dist), _t(lanes["surf"])),
           jvol.distance_pdf(jv, jnp.asarray(dist), jnp.asarray(lanes["surf"])))


def test_scene_medium_crosses_from_the_jax_scene():
    sc = jax_cornell_box(8, 8)
    sc.volume = jvol.make_volume(**MEDIA["colored"])
    sd = from_numpy_scene(sc.compile().host.data, "cpu")
    v = sd.volume
    assert v.sigma_s.dtype == torch.float32 and v.phase_g.shape == ()
    np.testing.assert_array_equal(v.sigma_s.numpy(), sc.volume.sigma_s)
    np.testing.assert_array_equal(v.sigma_a.numpy(), sc.volume.sigma_a)
    assert float(v.phase_g) == float(sc.volume.phase_g)
    assert from_numpy_scene(jax_cornell_box(8, 8).compile().host.data,
                            "cpu").volume is None


@pytest.mark.parametrize("n_samples", [1, 7])
def test_welford_matches_jax(n_samples):
    """After one sample both give eps; after seven, the unbiased variance."""
    rng = np.random.default_rng(6)
    data = rng.normal(size=(n_samples, 5, 3)).astype(np.float32)
    ref = jvar.variance_init(np.zeros((5, 3), np.float32))
    est = tvar.variance_init(torch.zeros((5, 3)))
    assert float(tvar.variance_value(est, eps=2.0).mean()) == 2.0
    for x in data:
        ref = jvar.variance_add(ref, x)
        est = tvar.variance_add(est, torch.as_tensor(x))
    np.testing.assert_allclose(tvar.variance_value(est, eps=2.0).numpy(),
                               jvar.variance_value(ref, eps=2.0), rtol=1e-6)
    want = data.var(0, ddof=1) if n_samples > 1 else np.full((5, 3), 2.0)
    np.testing.assert_allclose(tvar.variance_value(est, eps=2.0).numpy(),
                               want, rtol=1e-5)


def test_splat_add_and_accumulate_safe_match_jax():
    rng = np.random.default_rng(7)
    h, w = 6, 5
    film = rng.random((h, w, 3), dtype=np.float32)
    ids = rng.integers(0, h * w, 200).astype(np.int32)
    vals = rng.normal(size=(200, 3)).astype(np.float32)
    vals[::17, 1] = np.nan
    vals[::23, 2] = np.inf
    safe = tfilm.accumulate_safe(_t(vals))
    np.testing.assert_array_equal(
        safe.numpy(), np.asarray(jfilm.accumulate_safe(jnp.asarray(vals))))
    got = tfilm.splat_add(torch.tensor(film).reshape(h * w, 3), _t(ids),
                          safe).reshape(h, w, 3)
    ref = jfilm.splat_add(jnp.asarray(film), jnp.asarray(ids),
                          jfilm.accumulate_safe(jnp.asarray(vals)), width=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)

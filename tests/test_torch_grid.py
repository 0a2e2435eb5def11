"""The port's sphere-grid scene and its path render against the JAX
package's.

`sphere_grid(3000, 16, 16)` (4,862 triangles, 14 walk clusters) must
compile to the very tables of the JAX package's scene (exact equality of
every column, dtypes included, the walk tables converted to the port's
layout). IntegratorPathTracing.compute_block of both packages then renders
it at 2 spp, depth 5, seed 0: the JAX package on the CPU traces through its
clustered XLA intersector, the port through the plain versions of its walk
kernels; both resolve the NEE Russian-roulette default to 0.25 on this
scene. The threefry streams are bit-exact and the hits agree except on
ties, so every lane traces the same path unless a float difference flips a
branch. Tolerance, as tests/test_torch_path.py: at least PIX_FRAC of the
pixels within PIX_RTOL (relative, 1e-4 floor), the means within MEAN_RTOL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.integrators import IntegratorPathTracing as JaxPath
from rustlight_tpu.integrators.common import _pixel_grid
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.models.presets import sphere_grid as jax_sphere_grid
from rustlight_tpu.utils import rng as jrng
from rustlight_tpu_torch.accel.walk import WalkTables, walk_tables_from_numpy
from rustlight_tpu_torch.integrators import IntegratorPathTracing
from rustlight_tpu_torch.models import cornell_box, sphere_grid
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

PIX_FRAC, PIX_RTOL, MEAN_RTOL = 0.99, 1e-3, 1e-4
N_TRIS, W, H, SPP, DEPTH = 3000, 16, 16, 2, 5


@pytest.fixture(scope="module")
def jax_scene():
    return jax_sphere_grid(N_TRIS, W, H).compile()


def _assert_tables_equal(jtab, ttab, fields):
    for f in fields:
        if f == "kinds":   # the port's set of the atom kinds present
            assert ttab.kinds == set(np.asarray(jtab.atom_kind).tolist())
            continue
        a, b = getattr(jtab, f), getattr(ttab, f)
        if f in ("atom_cdf", "env_cdf"):
            for g in b._fields:
                np.testing.assert_array_equal(getattr(a, g), getattr(b, g))
            continue
        if a is None and b is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("group", ["geom", "walk", "materials", "emitters",
                                   "camera"])
def test_sphere_grid_tables_equal_jax(jax_scene, group):
    jhost = jax_scene.host.data
    thost = sphere_grid(N_TRIS, W, H).compile(device="cpu").host
    assert thost.geom.n_tris == jhost.geom.n_tris == 4862
    if group == "walk":
        jw, tw = walk_tables_from_numpy(jhost.geom.walk), thost.geom.walk
        assert (tw.n_tris, tw.n_clusters, tw.n_real) == (
            jw.n_tris, jw.n_clusters, jw.n_real) == (4862, 128, 14)
        _assert_tables_equal(jw, tw, [f for f in WalkTables._fields
                                      if f not in ("n_tris", "n_clusters",
                                                   "n_real")])
        return
    jtab, ttab = getattr(jhost, group), getattr(thost, group)
    _assert_tables_equal(jtab, ttab, [f for f in ttab._fields if f != "walk"])


def test_nee_rr_default_follows_the_tier(jax_scene):
    """0.25 on walk scenes, off on the dense tier, as the reference."""
    grid = from_numpy_scene(jax_scene.host.data, "cpu")
    cbox = cornell_box(4, 4).compile(device="cpu")
    integ = IntegratorPathTracing(max_depth=DEPTH)
    assert integ._nee_rr_for(grid) == 0.25
    assert integ._nee_rr_for(cbox) is None
    jinteg = JaxPath(max_depth=DEPTH)
    assert jinteg._nee_rr_for(jax_scene) == 0.25
    assert jinteg._nee_rr_for(jax_cornell_box(4, 4).compile()) is None
    assert IntegratorPathTracing(nee_rr=None)._nee_rr_for(grid) is None
    assert IntegratorPathTracing(nee_rr=0.5)._nee_rr_for(cbox) == 0.5


def test_compute_block_matches_jax(jax_scene):
    pix = jnp.asarray(_pixel_grid(W, H))
    integ = JaxPath(max_depth=DEPTH)
    ref = np.asarray(jax.jit(
        lambda s: integ.compute_block(jax_scene, pix, s, SPP))(
            jrng.stream_fold(jrng.make_stream(0), 0)))
    sd = from_numpy_scene(jax_scene.host.data, "cpu")
    assert sd.geom.walk is not None and sd.geom.walk.n_real == 14
    got = IntegratorPathTracing(max_depth=DEPTH).compute_block(
        sd, torch.as_tensor(_pixel_grid(W, H)),
        trng.stream_fold(trng.make_stream(0, "cpu"), 0), SPP).numpy()
    assert got.shape == ref.shape == (W * H, 3)
    assert np.all(np.isfinite(got)) and ref.mean() > 0.05
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-4)
    assert (rel.max(-1) <= PIX_RTOL).mean() >= PIX_FRAC
    assert abs(got.mean() - ref.mean()) <= MEAN_RTOL * ref.mean()

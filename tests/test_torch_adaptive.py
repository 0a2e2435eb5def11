"""The port's render_adaptive and render_feature_aovs
(rustlight_tpu_torch/integrators/common.py) against the JAX package's.

  - render_adaptive on cbox 16x16, 16 spp (a pilot of 8, then 2,048
    adaptive samples in 8 passes of 256 lanes), the path tracer at depth
    3: the per-pixel counts and the `spp` AOV equal, the image within
    1e-5, the budget exact; a budget the pilot uses up returns the pilot's
    film; a mesh raises NotImplementedError;
  - render_feature_aovs on cbox 16x16 with glass blocks (albedo 1 on the
    smooth material and the light), 4 spp: albedo, normal and depth within
    1e-5.

The JAX side's jits compile at `xla_backend_optimization_level` 0.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from rustlight_tpu.bsdfs import glass as jax_glass
from rustlight_tpu.integrators import IntegratorPathTracing as JaxPath
from rustlight_tpu.integrators.common import (
    render_adaptive as jax_render_adaptive,
    render_feature_aovs as jax_render_feature_aovs)
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu_torch.integrators import IntegratorPathTracing
from rustlight_tpu_torch.integrators.common import (render_adaptive,
                                                    render_feature_aovs)
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.scene.scene import from_numpy_scene

torch.set_num_threads(2)

W = H = 16
SPP, DEPTH, SEED = 16, 3, 2
AOV_SPP = 4
TOL = 1e-5
_FAST = {"xla_backend_optimization_level": 0}
_JIT = jax.jit


def _fast_jit(f=None, **kw):
    kw.setdefault("compiler_options", _FAST)
    if f is None:
        return functools.partial(_fast_jit, **kw)
    return _JIT(f, **kw)


@pytest.fixture(scope="module")
def jax_side():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", _fast_jit)
        jsd = jax_cornell_box(W, H).compile()
        film = jax_render_adaptive(jsd, JaxPath(max_depth=DEPTH,
                                                hard_cap=DEPTH), SPP,
                                   seed=SEED)
        gsd = jax_cornell_box(W, H, mat_overrides={
            "blocks": jax_glass()}).compile()
        aovs = jax_render_feature_aovs(gsd, spp=AOV_SPP, seed=1)
    return {"host": jsd.host.data, "glass": gsd.host.data,
            "film": {k: np.array(v) for k, v in film.buffers.items()},
            "aovs": {k: np.array(v) for k, v in aovs.items()}}


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def port_film(jax_side):
    sd = from_numpy_scene(jax_side["host"], "cpu")
    return render_adaptive(sd, IntegratorPathTracing(max_depth=DEPTH,
                                                     hard_cap=DEPTH), SPP,
                           seed=SEED)


def test_adaptive_counts_equal_jax(jax_side, port_film):
    ref = jax_side["film"]["spp"]
    got = port_film["spp"]
    assert got.dtype == np.float32 and got.shape == (H, W, 1)
    np.testing.assert_array_equal(got, ref)
    # the budget is exact, and the noise moved the counts off uniform
    assert int(got.sum()) == SPP * W * H
    assert got.min() >= 8 and got.max() > 2 * SPP


def test_adaptive_image_matches_jax(jax_side, port_film):
    ref = jax_side["film"]["primal"]
    got = port_film["primal"]
    assert got.dtype == np.float32 and ref.mean() > 0.02
    assert sorted(port_film.buffers) == sorted(jax_side["film"]) == [
        "primal", "spp"]
    _close(got, ref)


def test_adaptive_pilot_only_returns_the_pilot():
    """spp <= 8: the pilot takes the whole budget, and the film is the
    pilot's per-pass render with its variance AOVs."""
    sd = cornell_box(4, 4).compile(device="cpu")
    film = render_adaptive(sd, IntegratorPathTracing(max_depth=2), 8)
    assert sorted(film.buffers) == ["mean", "primal", "variance"]


def test_adaptive_over_a_mesh_of_one():
    """A mesh of one takes the sharded route: its pilot and passes draw
    from streams folded with the rank, so the image is not the
    single-device one, while the budget stays exact."""
    from rustlight_tpu_torch.parallel import Mesh
    sd = cornell_box(4, 4).compile(device="cpu")
    integ = IntegratorPathTracing(max_depth=2)
    film = render_adaptive(sd, integ, 16, mesh=Mesh())
    assert sorted(film.buffers) == ["primal", "spp"]
    assert film["spp"].sum() == 16 * 16 and film["spp"].min() >= 8
    assert np.all(np.isfinite(film["primal"]))
    assert not np.array_equal(film["primal"],
                              render_adaptive(sd, integ, 16)["primal"])


@pytest.mark.parametrize("name", ["albedo", "normal", "depth"])
def test_feature_aovs_match_jax(jax_side, name):
    sd = from_numpy_scene(jax_side["glass"], "cpu")
    got = render_feature_aovs(sd, spp=AOV_SPP, seed=1)
    ref = jax_side["aovs"][name]
    assert sorted(got) == ["albedo", "depth", "normal"]
    assert got[name].dtype == np.float32 and got[name].shape == (H, W, 3)
    assert np.abs(ref).max() > 0
    if name == "albedo":
        # the glass blocks and the light report 1, a miss 0
        assert (ref == 1.0).all(-1).any() and (ref < 1.0).any()
    _close(got[name], ref)

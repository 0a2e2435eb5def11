"""The port's path guiding (rustlight_tpu_torch/integrators/guiding.py and
the guided branches of the path tracer's compute_pixel) against the JAX
package's.

  - voxel_of / bin_of ids equal, guide_pdf / guide_sample within 1e-6, on
    seeded points (some outside the grid), directions and a seeded table;
    deposit's tables within 1e-6;
  - one guided compute_pixel(collect=True) on cbox and on cbox in a medium,
    each with a seeded non-empty g = 8 table: radiance per lane and the
    deposits within 1e-5 (the JAX side is render_guided's own jitted pass);
  - render_guided, 3 passes from a cold table: image and table within
    1e-5;
  - on the port alone: the guided draw order, the table persisting across
    IntegratorGuidedPath.render calls, the "guide-grid mismatch"
    ValueError, a mesh raising NotImplementedError, and the row-wise
    prefix sum against a sequential one;
  - `slow`: the guided render's mean against the plain path tracer's, and
    guiding beating BSDF sampling at equal spp on door_box (the JAX
    package's tests/test_guiding.py:54-87).

The JAX side's jits compile at `xla_backend_optimization_level` 0.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.integrators import IntegratorPathTracing as JaxPath
from rustlight_tpu.integrators import common as jcommon
from rustlight_tpu.integrators import guiding as JG
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.scene import make_volume as jax_make_volume
from rustlight_tpu.utils import rng as jrng
from rustlight_tpu_torch.integrators import IntegratorPathTracing, render
from rustlight_tpu_torch.integrators import guiding as G
from rustlight_tpu_torch.integrators.common import _pixel_grid
from rustlight_tpu_torch.integrators import path as tpath
from rustlight_tpu_torch.integrators.guiding import (IntegratorGuidedPath,
                                                     render_guided)
from rustlight_tpu_torch.models import cornell_box, door_box
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

W = H = 16
DEPTH = 4
GRID = 8
PASSES = 3
TOL = 1e-5
_FAST = {"xla_backend_optimization_level": 0}
_JIT = jax.jit


def _fast_jit(f=None, **kw):
    kw.setdefault("compiler_options", _FAST)
    if f is None:
        return functools.partial(_fast_jit, **kw)
    return _JIT(f, **kw)


def _seeded_table(seed, g=GRID):
    rng = np.random.default_rng(seed)
    return rng.gamma(0.3, 2.0, (g ** 3, G.N_BINS)).astype(np.float32)


def _jax_scene(medium):
    sc = jax_cornell_box(W, H)
    if medium:
        sc.volume = jax_make_volume(sigma_s=(0.0025,) * 3)
    return sc.compile()


def _jax_pass(jsd, integ):
    """render_guided's jitted pass for (jsd, integ): (sd, grid, stream) ->
    (radiance with non-finite or negative lanes zeroed, deposits)."""
    keys = [k for k in jcommon._BLOCK_CACHE
            if k[-1] == "guided" and k[0] == id(jsd) and k[1] == id(integ)]
    return jcommon._BLOCK_CACHE[keys[0]]


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", _fast_jit)
        for medium in (False, True):
            jsd = _jax_scene(medium)
            integ = JaxPath(max_depth=DEPTH, hard_cap=DEPTH)
            film, grid = JG.render_guided(jsd, integ, PASSES, seed=3, g=GRID,
                                          return_grid=True)
            if not medium:
                out["film"] = np.asarray(film.buffers["primal"])
                out["table"] = np.asarray(grid.table)
            seeded = grid.replace(table=jnp.asarray(_seeded_table(1)))
            rad, dep = _jax_pass(jsd, integ)(
                jsd, seeded, jrng.stream_fold(jrng.make_stream(5), 0))
            out[medium] = (jsd.host.data, np.asarray(rad), np.asarray(dep))
    return out


def _port_scene(jax_side, medium):
    return from_numpy_scene(jax_side[medium][0], "cpu")


def _close(got, ref, tol):
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _points(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-50.0, 610.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p, d


def _grids(g=GRID, seed=1):
    lo = np.array([-1.0, -2.0, -3.0], np.float32)
    inv = np.float32(1.0) / np.array([560.0, 550.0, 562.0], np.float32)
    table = _seeded_table(seed, g)
    jg = JG.GuideGrid(g=g, lo=jnp.asarray(lo), inv_extent=jnp.asarray(inv),
                      table=jnp.asarray(table))
    tg = G.GuideGrid(g=g, lo=torch.as_tensor(lo), inv_extent=torch.as_tensor(
        inv), table=torch.as_tensor(table))
    return jg, tg


def test_voxel_and_bin_ids_equal():
    p, d = _points(8192, 2)
    # the poles and the seam of phi, where the bins' edges lie
    d[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [1, -1e-8, 0]]
    jg, tg = _grids()
    np.testing.assert_array_equal(
        G.voxel_of(tg, torch.as_tensor(p)).numpy(),
        np.asarray(JG.voxel_of(jg, jnp.asarray(p))))
    np.testing.assert_array_equal(G.bin_of(torch.as_tensor(d)).numpy(),
                                  np.asarray(JG.bin_of(jnp.asarray(d))))


def test_guide_pdf_and_sample_match_jax():
    p, d = _points(8192, 3)
    jg, tg = _grids()
    vox = np.array(JG.voxel_of(jg, jnp.asarray(p)))
    u = np.random.default_rng(4).random((8192, 2)).astype(np.float32)
    tv = torch.as_tensor(vox)
    _close(G.guide_pdf(tg, tv, torch.as_tensor(d)).numpy(),
           np.asarray(JG.guide_pdf(jg, jnp.asarray(vox), jnp.asarray(d))),
           1e-6)
    td, tp = G.guide_sample(tg, tv, torch.as_tensor(u))
    jd, jp = JG.guide_sample(jg, jnp.asarray(vox), jnp.asarray(u))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    _close(tp.numpy(), np.asarray(jp), 1e-6)


def test_deposit_matches_jax():
    p, d = _points(8192, 5)
    jg, tg = _grids()
    rng = np.random.default_rng(6)
    value = rng.gamma(0.5, 1.0, 8192).astype(np.float32)
    value[::97] = np.nan              # dropped lanes carry anything
    ok = (rng.random(8192) < 0.7) & np.isfinite(value)
    acc = _seeded_table(7).reshape(-1)
    ref = np.asarray(JG.deposit(jnp.asarray(acc), jg, jnp.asarray(p),
                                jnp.asarray(d), jnp.asarray(value),
                                jnp.asarray(ok)))
    got = G.deposit(torch.as_tensor(acc), tg, torch.as_tensor(p),
                    torch.as_tensor(d), torch.as_tensor(value),
                    torch.as_tensor(ok)).numpy()
    assert got.shape == ref.shape and not np.array_equal(ref, acc)
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("medium", [False, True], ids=["cbox", "cbox_medium"])
def test_guided_compute_pixel_matches_jax(jax_side, medium):
    _, ref_rad, ref_dep = jax_side[medium]
    sd = _port_scene(jax_side, medium)
    grid = G.make_guide_grid(sd, GRID)
    grid.table = torch.as_tensor(_seeded_table(1))
    pix = torch.as_tensor(_pixel_grid(W, H))
    integ = IntegratorPathTracing(max_depth=DEPTH, hard_cap=DEPTH)
    rad, dep = integ.compute_pixel(sd, pix, trng.stream_fold(
        trng.make_stream(5, "cpu"), 0), guide=grid, collect=True)
    ok = torch.all(torch.isfinite(rad), -1) & torch.all(rad >= 0, -1)
    rad = torch.where(ok[:, None], rad, 0.0).numpy()
    assert ref_rad.mean() > 0.01 and (ref_dep > 0).sum() > 100
    _close(rad, ref_rad, TOL)
    _close(dep.numpy(), ref_dep, TOL)


def test_render_guided_matches_jax(jax_side):
    sd = _port_scene(jax_side, False)
    film, grid = render_guided(
        sd, IntegratorPathTracing(max_depth=DEPTH, hard_cap=DEPTH), PASSES,
        seed=3, g=GRID, return_grid=True)
    assert film["primal"].dtype == np.float32
    _close(film["primal"], jax_side["film"], TOL)
    _close(grid.table.numpy(), jax_side["table"], TOL)


def test_guided_draw_order(monkeypatch):
    """A guided iteration draws u_sel (n,), u_pos (n, 2), u_bsdf (n, 2), then
    u_gsel (n,) and u_gdir (n, 2), then u_rr (n,); u_pix (n, 2) once first.
    Without a guide the iteration draws no u_gsel / u_gdir."""
    seen = []
    one, two = tpath.stream_next, tpath.stream_next2d

    def rec1(stream, shape=()):
        seen.append(("1", tuple(shape)))
        return one(stream, shape)

    def rec2(stream, shape=()):
        seen.append(("2", tuple(shape)))
        return two(stream, shape)
    monkeypatch.setattr(tpath, "stream_next", rec1)
    monkeypatch.setattr(tpath, "stream_next2d", rec2)
    sd = cornell_box(4, 4).compile(device="cpu")
    pix = torch.as_tensor(_pixel_grid(4, 4))
    integ = IntegratorPathTracing(max_depth=2, hard_cap=2)
    base = trng.make_stream(0, "cpu")
    integ.compute_pixel(sd, pix, base, guide=G.make_guide_grid(sd, 4),
                        collect=True)
    n = (16,)
    it = [("1", n), ("2", n), ("2", n), ("1", n), ("2", n), ("1", n)]
    assert seen == [("2", n)] + it * 2
    seen.clear()
    integ.compute_pixel(sd, pix, base)
    assert seen == [("2", n)] + [it[i] for i in (0, 1, 2, 5)] * 2


def test_compute_pixel_without_a_guide_is_unchanged():
    """guide=None keeps the draws and the result of the unguided tracer; a
    guide without collect returns the radiance alone."""
    sd = cornell_box(8, 8).compile(device="cpu")
    pix = torch.as_tensor(_pixel_grid(8, 8))
    integ = IntegratorPathTracing(max_depth=3, hard_cap=3)
    s = trng.make_stream(2, "cpu")
    a = integ.compute_pixel(sd, pix, s)
    b = integ.compute_pixel(sd, pix, s, guide=None, collect=True)
    assert torch.equal(a, b)
    c = integ.compute_pixel(sd, pix, s, guide=G.make_guide_grid(sd, 4))
    assert c.shape == a.shape and not torch.equal(a, c)


def test_row_cumsum_is_a_prefix_sum():
    row = torch.as_tensor(np.random.default_rng(8).gamma(
        0.3, 2.0, (64, G.N_BINS)).astype(np.float32))
    np.testing.assert_allclose(G._row_cumsum(row).numpy(),
                               np.cumsum(row.numpy().astype(np.float64), 1),
                               rtol=1e-5)


def test_table_persists_across_renders():
    sd = cornell_box(8, 8).compile(device="cpu")

    def gi():
        return IntegratorGuidedPath(IntegratorPathTracing(max_depth=3), g=4)
    g = gi()
    g.render(sd, spp=1, seed=0)
    warm = g.render(sd, spp=1, seed=1)["primal"]
    cold = gi().render(sd, spp=1, seed=1)["primal"]
    assert not np.array_equal(warm, cold)
    assert g.state_dict()["table"].shape == (4 ** 3, G.N_BINS)


def test_state_g_mismatch_refused():
    sd = door_box(8, 6).compile(device="cpu")
    g = IntegratorGuidedPath(IntegratorPathTracing(max_depth=2), g=4)
    assert g.state_dict() is None
    g.render(sd, spp=1, seed=0)
    other = IntegratorGuidedPath(IntegratorPathTracing(max_depth=2), g=2)
    with pytest.raises(ValueError, match="guide-grid mismatch"):
        other.load_state_dict(g.state_dict(), sd)


def test_mesh_of_one_folds_the_rank_into_each_pass():
    """On a mesh, pass j of rank d draws from stream_fold(stream_fold(
    base, j), d): a mesh of one renders the passes of that stream and
    trains the same table, through render_guided and the self-driving
    IntegratorGuidedPath alike."""
    from rustlight_tpu_torch.parallel import Mesh
    sd = cornell_box(4, 4).compile(device="cpu")
    integ = IntegratorPathTracing(max_depth=2)
    grid = G.make_guide_grid(sd, 4)
    base = trng.make_stream(1, "cpu")
    pix = torch.as_tensor(_pixel_grid(4, 4))
    acc = 0.0
    for j in range(2):
        rad, grid = G.guided_pass(sd, integ, grid, pix, trng.stream_fold(
            trng.stream_fold(base, j), 0), 0.8)
        acc = acc + rad
    film, got = render_guided(sd, integ, 2, seed=1, g=4, mesh=Mesh(),
                              return_grid=True)
    np.testing.assert_array_equal(film["primal"],
                                  (acc.numpy() / 2).reshape(4, 4, 3))
    np.testing.assert_array_equal(got.table.numpy(), grid.table.numpy())
    gp = IntegratorGuidedPath(integ, g=4)
    np.testing.assert_array_equal(gp.render(sd, 2, seed=1, mesh=Mesh())[
        "primal"], film["primal"])


@pytest.mark.slow
def test_unbiased_on_cbox():
    """The guided mean is the plain path tracer's within MC tolerance (the
    mixture keeps every direction's pdf exact for any table)."""
    sd = cornell_box(24, 24).compile(device="cpu")
    integ = IntegratorPathTracing(max_depth=4, hard_cap=4)
    ref = render(sd, integ, spp=192, seed=9,
                 persistent=False)["primal"].mean()
    gu = render_guided(sd, integ, spp=48, seed=1)["primal"].mean()
    assert abs(gu - ref) / ref < 0.06, (gu, ref)


@pytest.mark.slow
def test_door_scene_improves():
    """Equal spp on the door scene: guiding beats BSDF sampling in l1
    against a 1,024-spp reference, at a sane brightness."""
    sd = door_box(40, 30).compile(device="cpu")
    integ = IntegratorPathTracing(max_depth=6, hard_cap=6)
    ref = render(sd, integ, spp=1024, seed=99, persistent=False)["primal"]
    un = render(sd, integ, spp=64, seed=1, persistent=False)["primal"]
    gu = render_guided(sd, integ, spp=64, seed=1, g=16)["primal"]
    l1u = np.abs(un - ref).mean()
    l1g = np.abs(gu - ref).mean()
    assert l1g < l1u, (l1g, l1u)
    assert 0.5 < gu.mean() / ref.mean() < 2.0, (gu.mean(), ref.mean())

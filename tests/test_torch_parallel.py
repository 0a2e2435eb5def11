"""The port's rendering over a device mesh (rustlight_tpu_torch/parallel/
and the `mesh` branches of its integrators) against the JAX package's
shard_map renders and against the port's own single-process renders.

One spawn of three gloo ranks on the CPU (torch threads 1 a rank) runs
every sharded render of the port, the two-rank ones in a subgroup of ranks
0 and 1; one module fixture makes the JAX package's results once, on the
virtual CPU devices that tests/conftest.py forces, at make_device_mesh(2).
All on cbox 16x16, depth 3.

  - against JAX: the chunked P1 render with its variance AOVs
    (render_variance_sharded: its primal is render_sharded's chunked
    route's), render_splat_sharded and the guided render (image and
    table), within the single-device parity tests' tolerances;
  - against the port's single-process renders of each shard (a Mesh
    without a process group is a view of one shard): the persistent P1
    route (the shards concatenated), PSSMLT (the chain shards' films
    summed, then rescaled), ERPT (the padded lane shards' rounds summed)
    and an adaptive pass (adaptive_step_sharded), bit for bit;
  - gradient-domain (both shifts) and SMCMC (both inits, both
    reconstructions) over 2 and 3 ranks (uneven row bands) against the
    port's single-device render, within the JAX package's
    tests/test_parallel.py tolerance (rtol 2e-4, atol 1e-5); SMCMC's
    vertical exchange sends boundary rows only (its element count);
  - the collectives against numpy on 7 rows over 3 ranks, rank 0's stop
    decisions under -a Ns / -e, and a rank that raises failing
    run_on_mesh at once.

`slow`: render_adaptive, PSSMLT and ERPT over the mesh against the JAX
package's mesh renders.
"""
import functools
import threading
import time

import numpy as np
import pytest
import torch

from rustlight_tpu_torch.integrators import (IntegratorLightTracing,
                                             IntegratorPathTracing)
from rustlight_tpu_torch.integrators.common import _pixel_grid, render_adaptive
from rustlight_tpu_torch.integrators.gradient import (
    IntegratorGradientPath, IntegratorGradientPathReconnect)
from rustlight_tpu_torch.integrators.guiding import render_guided
from rustlight_tpu_torch.integrators.mcmc import (IntegratorERPT,
                                                  IntegratorPSSMLT,
                                                  IntegratorSMCMC)
from rustlight_tpu_torch.integrators.mcmc.smcmc import SCHEDULE
from rustlight_tpu_torch.integrators.meta import (IntegratorAverage,
                                                  IntegratorEqualTime)
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.parallel import (Mesh, adaptive_step_sharded,
                                          gather_rows, halo_rows,
                                          render_sharded,
                                          render_splat_sharded,
                                          render_variance_sharded,
                                          run_on_mesh, sum_over_ranks)
from rustlight_tpu_torch.parallel.mesh import gather_objects
from rustlight_tpu_torch.parallel.render import _padded_grid
from rustlight_tpu_torch.utils.film import accumulate_safe
from rustlight_tpu_torch.utils.rng import make_stream, stream_fold

W = H = 16
DEPTH = 3
SEED = 3
P1_SPP, P1_CHUNK = 4, 2
GUIDE_SPP, GUIDE_G = 2, 8
TOL = 1e-5                       # the guided and adaptive parity tests'
PIX_FRAC, PIX_RTOL, MEAN_RTOL = 0.99, 1e-3, 1e-4   # the path tests'
MESH_RTOL, MESH_ATOL = 2e-4, 1e-5   # tests/test_parallel.py's
MLT = dict(nb_chains=64, nb_samples_norm=256)
ERPT = dict(nb_mc=2, chain_samples=4, nb_samples_norm=256)
ADAPT_SPP = 16
GDPT_SPP, SMCMC_SPP = 2, 8
ROWS = 7


def _integ():
    return IntegratorPathTracing(max_depth=DEPTH, hard_cap=DEPTH)


def _scene():
    return cornell_box(W, H).compile(device="cpu")


def _gdpt():
    return {"explicit": IntegratorGradientPath(max_depth=DEPTH,
                                               hard_cap=DEPTH),
            "reconnect": IntegratorGradientPathReconnect(max_depth=DEPTH)}


def _smcmc():
    return {"mcmc-irls": IntegratorSMCMC(_integ(), recons="irls",
                                         init="mcmc"),
            "independent-naive": IntegratorSMCMC(_integ(), recons="naive",
                                                 init="independent",
                                                 init_spp=2)}


def _v_steps(spp):
    return sum(1 for s in range(spp) if SCHEDULE[s % len(SCHEDULE)]
               and SCHEDULE[s % len(SCHEDULE)][0] == "v")


class _Passes:
    """A self-driving stub whose every pass sums a value over the mesh (a
    collective, as every sharded render has) and sleeps longer on rank 1,
    so that ranks deciding from their own clocks would part."""

    averaging = True

    def __init__(self):
        self.passes = 0

    def render(self, scene, spp, seed=0, mesh=None):
        from rustlight_tpu_torch.utils.film import Film
        time.sleep(0.002 if mesh.rank == 0 else 0.02)
        v = sum_over_ranks(mesh, torch.ones(1))
        self.passes += 1
        film = Film(2, 2)
        film.buffers["primal"] = np.full((2, 2, 3), float(v), np.float32)
        return film


def _gradient_and_smcmc(mesh, scene):
    out = {}
    for name, g in _gdpt().items():
        out["gdpt", name] = {k: v for k, v in g.render(
            scene, GDPT_SPP, seed=SEED, mesh=mesh).buffers.items()}
    for name, s in _smcmc().items():
        out["smcmc", name] = s.render(scene, SMCMC_SPP, seed=SEED,
                                      mesh=mesh)["primal"]
        out["moved", name] = s.exchange_moved
    return out


def _three_ranks(mesh):
    """The spawn's ranks: the three-rank cases, then the two-rank ones in
    a subgroup of ranks 0 and 1. Rank 0's results."""
    import torch.distributed as dist
    scene = _scene()
    out = {}
    # the collectives on ROWS rows over 3 uneven bands
    lo, hi = mesh.band(ROWS)
    x = torch.arange(ROWS * 3, dtype=torch.float32).reshape(ROWS, 3)[lo:hi]
    out["gather"] = gather_rows(mesh, x).numpy()
    out["sum"] = sum_over_ranks(mesh, x[:1] * 0 + mesh.rank + 1).numpy()
    out["roll"] = {k: gather_rows(mesh, halo_rows(mesh, x, k)).numpy()
                   for k in (1, -1, 2)}
    out["bool"] = gather_rows(mesh, x > 7.0).numpy()
    # rank 0's clock stops -a Ns and -e for every rank
    stub = _Passes()
    IntegratorAverage(stub, timeout_s=0.05, mesh=mesh).render(scene)
    eq = IntegratorEqualTime(_Passes(), target_s=0.05, mesh=mesh)
    eq.render(scene)
    out["passes"] = gather_objects(mesh, (stub.passes, eq.achieved_spp))
    out[3] = _gradient_and_smcmc(mesh, scene)

    group = dist.new_group([0, 1])
    if mesh.rank == 2:
        return None
    m2 = Mesh(mesh.rank, 2, mesh.device, group, mesh.backend)
    out[2] = _gradient_and_smcmc(m2, scene)
    integ = _integ()
    out["p1_chunked"] = render_sharded(scene, integ, P1_SPP, mesh=m2,
                                       seed=SEED, spp_per_pass=P1_CHUNK,
                                       persistent=False)["primal"]
    out["p1_block"] = render_sharded(scene, integ, P1_SPP, mesh=m2,
                                     seed=SEED)["primal"]
    var = render_variance_sharded(scene, integ, P1_SPP, mesh=m2, seed=SEED,
                                  spp_per_pass=P1_CHUNK)
    out["variance"] = {k: var[k] for k in ("primal", "variance")}
    lt = IntegratorLightTracing(max_depth=DEPTH, hard_cap=DEPTH)
    out["splat"] = render_splat_sharded(scene, lt, n_paths=2 * W * H,
                                        mesh=m2, seed=SEED)["primal"]
    film, grid = render_guided(scene, _integ(), GUIDE_SPP, seed=SEED,
                               g=GUIDE_G, return_grid=True, mesh=m2)
    out["guided"] = (film["primal"], grid.table.numpy())
    out["pssmlt"] = IntegratorPSSMLT(_integ(), **MLT).render(
        scene, 1, seed=SEED, mesh=m2)["primal"]
    out["erpt"] = IntegratorERPT(_integ(), **ERPT).render(
        scene, 4, seed=SEED, mesh=m2)["primal"]
    out["adaptive"] = {k: v for k, v in render_adaptive(
        scene, _integ(), ADAPT_SPP, seed=SEED, mesh=m2).buffers.items()}
    pix, pid = _adaptive_lanes()
    out["adaptive_step"] = adaptive_step_sharded(
        scene, _integ(), m2, W * H, pix, pid, make_stream(SEED, "cpu"),
        5).numpy()
    return out


def _adaptive_lanes():
    """An adaptive pass's lanes: a seeded pixel list of w * h lanes (even:
    two shards), the last 40 padding lanes that splat past the film."""
    rng = np.random.default_rng(4)
    n = W * H
    pix = _pixel_grid(W, H)[rng.integers(0, n, n)]
    pid = (pix[:, 1] * W + pix[:, 0]).astype(np.int32)
    pid[-40:] = n
    return torch.as_tensor(pix), torch.as_tensor(pid)


@pytest.fixture(scope="module")
def _spawn():
    """The ranks' spawn, started in a thread so that the JAX side renders
    meanwhile."""
    box = {}

    def run():
        try:
            box["out"] = run_on_mesh(3, _three_ranks, device="cpu",
                                     timeout=300.0, threads=1)
        except BaseException as e:   # noqa: BLE001 (raised by `ranks`)
            box["err"] = e
    thread = threading.Thread(target=run)
    thread.start()
    yield thread, box
    thread.join()


@pytest.fixture(scope="module")
def ranks(_spawn, jax_side):
    """Rank 0's results (joined after the JAX side is made)."""
    thread, box = _spawn
    thread.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.fixture(scope="module")
def single():
    """The port's single-process renders, one torch thread, as each rank."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene = _scene()
        out = {"scene": scene}
        for name, g in _gdpt().items():
            out["gdpt", name] = g.render(scene, GDPT_SPP, seed=SEED).buffers
        for name, s in _smcmc().items():
            out["smcmc", name] = s.render(scene, SMCMC_SPP,
                                          seed=SEED)["primal"]
        yield out
    finally:
        torch.set_num_threads(threads)


_FAST = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module")
def jax_side(_spawn):
    """The JAX package's shard_map renders at make_device_mesh(2)."""
    import jax
    from rustlight_tpu.integrators import IntegratorLightTracing as JLight
    from rustlight_tpu.integrators import IntegratorPathTracing as JPath
    from rustlight_tpu.integrators import guiding as JG
    from rustlight_tpu.models import cornell_box as jcbox
    from rustlight_tpu.parallel import (make_device_mesh,
                                        render_splat_sharded as j_splat,
                                        render_variance_sharded as j_var)
    jit = jax.jit

    def fast_jit(f=None, **kw):
        kw.setdefault("compiler_options", _FAST)
        if f is None:
            return functools.partial(fast_jit, **kw)
        return jit(f, **kw)
    mesh = make_device_mesh(2)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", fast_jit)
        jsd = jcbox(W, H).compile()
        integ = JPath(max_depth=DEPTH, hard_cap=DEPTH)
        var = j_var(jsd, integ, P1_SPP, mesh=mesh, seed=SEED,
                    spp_per_pass=P1_CHUNK)
        out["variance"] = {k: np.asarray(var.buffers[k])
                           for k in ("primal", "variance")}
        lt = JLight(max_depth=DEPTH, hard_cap=DEPTH)
        out["splat"] = np.asarray(j_splat(jsd, lt, n_paths=2 * W * H,
                                          mesh=mesh, seed=SEED)["primal"])
        film, grid = JG.render_guided(jsd, JPath(max_depth=DEPTH,
                                                 hard_cap=DEPTH),
                                      GUIDE_SPP, seed=SEED, g=GUIDE_G,
                                      return_grid=True, mesh=mesh)
        out["guided"] = (np.asarray(film.buffers["primal"]),
                         np.asarray(grid.table))
    return out


def _close(got, ref, tol):
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _images_agree(got, ref):
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-4)
    assert (rel.max(-1) <= PIX_RTOL).mean() >= PIX_FRAC
    assert abs(got.mean() - ref.mean()) <= MEAN_RTOL * ref.mean()


# ---- the collectives and run_on_mesh


def test_collectives_match_numpy(ranks):
    x = np.arange(ROWS * 3, dtype=np.float32).reshape(ROWS, 3)
    np.testing.assert_array_equal(ranks["gather"], x)
    np.testing.assert_array_equal(ranks["sum"], np.full((1, 3), 6.0))
    for k, got in ranks["roll"].items():
        np.testing.assert_array_equal(got, np.roll(x, k, 0))
    assert ranks["bool"].dtype == bool
    np.testing.assert_array_equal(ranks["bool"], x > 7.0)


def test_bands_are_array_split():
    m = Mesh(1, 3)
    assert m.bands(7) == [(0, 3), (3, 5), (5, 7)]
    assert m.band(7) == (3, 5) and m.shard(9) == (3, 6)
    with pytest.raises(ValueError):
        m.shard(7)


def test_rank_zero_decides_when_to_stop(ranks):
    (a0, e0), (a1, e1), (a2, e2) = ranks["passes"]
    assert a0 == a1 == a2 >= 1 and e0 == e1 == e2 >= 1


def _boom(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    gather_rows(mesh, torch.zeros(2))


def test_no_card_raises_unless_the_cpu_is_named(monkeypatch):
    """make_device_mesh, default_backend and dryrun_multichip never fall
    back to the CPU: without a card they raise, and they run where the CPU
    is named."""
    from rustlight_tpu_torch.parallel.dryrun import dryrun_multichip
    from rustlight_tpu_torch.parallel.mesh import (default_backend,
                                                   make_device_mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (make_device_mesh, default_backend,
                 lambda: dryrun_multichip(1),
                 lambda: run_on_mesh(1, _boom)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert make_device_mesh(device="cpu").device == torch.device("cpu")
    assert make_device_mesh(1, device="cpu").size == 1
    assert default_backend("cpu") == "gloo"
    got = dryrun_multichip(1, device="cpu")
    assert got["moved"] == 0 and all(np.isfinite(v) and v > 0
                                     for v in got["means"].values())


def test_a_failing_rank_fails_the_call():
    t0 = time.time()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        run_on_mesh(2, _boom, device="cpu", timeout=120.0, threads=1)
    assert time.time() - t0 < 60.0


# ---- against the JAX package's shard_map renders


def test_chunked_p1_and_variance_match_jax(ranks, jax_side):
    ref = jax_side["variance"]
    _images_agree(ranks["p1_chunked"], ref["primal"])
    _images_agree(ranks["variance"]["primal"], ref["primal"])
    np.testing.assert_array_equal(ranks["variance"]["primal"],
                                  ranks["p1_chunked"])
    v, vr = ranks["variance"]["variance"], ref["variance"]
    assert abs(v.mean() - vr.mean()) <= 1e-3 * vr.mean()


def test_splat_matches_jax(ranks, jax_side):
    _images_agree(ranks["splat"], jax_side["splat"])


def test_guided_matches_jax(ranks, jax_side):
    img, table = ranks["guided"]
    _close(img, jax_side["guided"][0], TOL)
    _close(table, jax_side["guided"][1], TOL)


# ---- against the port's single-process renders of each shard


def _views(n):
    return [Mesh(d, n) for d in range(n)]


def test_persistent_p1_is_the_shards_concatenated(ranks, single):
    scene, integ = single["scene"], _integ()
    pix = torch.as_tensor(_padded_grid(W, H, 2))
    base = make_stream(SEED, "cpu")
    parts = [accumulate_safe(integ.compute_block(
        scene, pix[m.shard(pix.shape[0])[0]:m.shard(pix.shape[0])[1]],
        stream_fold(stream_fold(base, m.rank), 0), P1_SPP))
        for m in _views(2)]
    want = (torch.cat(parts)[:W * H].reshape(H, W, 3) / P1_SPP).numpy()
    np.testing.assert_array_equal(ranks["p1_block"], want)


def test_pssmlt_is_the_chain_shards_summed(ranks, single):
    scene = single["scene"]
    mlt = IntegratorPSSMLT(_integ(), **MLT)
    base = make_stream(SEED, "cpu")
    c = MLT["nb_chains"]
    b, u0, tf0, _ = mlt.seed_chains(scene, base, c)
    steps = max(1, W * H // c)
    film = None
    for m in _views(2):
        lo, hi = m.shard(c)
        part = mlt.evolve(scene, u0[lo:hi], tf0[lo:hi], stream_fold(
            stream_fold(base, m.rank), 77), steps)
        film = part if film is None else film + part
    img = film.reshape(H, W, 3).numpy()
    np.testing.assert_array_equal(ranks["pssmlt"], img * (b / img.mean()))


def test_erpt_is_the_lane_shards_summed(ranks, single):
    scene = single["scene"]
    e = IntegratorERPT(_integ(), **ERPT)
    base = make_stream(SEED, "cpu")
    b = e.normalization(scene, base)
    cpp = max(1, 4 - e.nb_mc) / e.chain_samples
    lane = torch.arange(W * H)
    px, py = (lane % W).float(), (lane // W).float()
    acc = torch.zeros((W * H, 3))
    for r in range(e.nb_mc):
        film = None
        for m in _views(2):
            lo, hi = m.shard(W * H)
            part = e._round(scene, stream_fold(stream_fold(base, m.rank), r),
                            px[lo:hi], py[lo:hi], b, cpp, None,
                            torch.ones(hi - lo, dtype=torch.bool))
            film = part if film is None else film + part
        acc = acc + film
    np.testing.assert_array_equal(ranks["erpt"],
                                  acc.reshape(H, W, 3).numpy())


def test_adaptive_pass_is_the_shards_summed(ranks, single):
    scene = single["scene"]
    pix, pid = _adaptive_lanes()
    base = make_stream(SEED, "cpu")
    parts = [adaptive_step_sharded(scene, _integ(), m, W * H, pix, pid,
                                   base, 5) for m in _views(2)]
    np.testing.assert_array_equal(ranks["adaptive_step"],
                                  (parts[0] + parts[1]).numpy())
    film = ranks["adaptive"]
    # the budget is exact: the pilot of 8 and the extra samples
    assert film["spp"].sum() == ADAPT_SPP * W * H
    assert film["spp"].min() >= 8 and np.all(np.isfinite(film["primal"]))


# ---- the GSPMD families against the port's single-device render


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("shift", ["explicit", "reconnect"])
def test_gradient_over_ranks_matches_one_device(ranks, single, n, shift):
    got, ref = ranks[n]["gdpt", shift], single["gdpt", shift]
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=MESH_RTOL,
                                   atol=MESH_ATOL, err_msg=k)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("case", ["mcmc-irls", "independent-naive"])
def test_smcmc_over_ranks_matches_one_device(ranks, single, n, case):
    np.testing.assert_allclose(ranks[n]["smcmc", case],
                               single["smcmc", case], rtol=MESH_RTOL,
                               atol=MESH_ATOL)


@pytest.mark.parametrize("n", [2, 3])
def test_smcmc_exchange_sends_boundary_rows_only(ranks, n):
    d = IntegratorSMCMC(_integ()).pss_dims
    # u [w, d], ua, tf and tf_p [w]: one row of each to each neighbour a
    # vertical step
    row = W * (d + 3)
    for case in ("mcmc-irls", "independent-naive"):
        assert ranks[n]["moved", case] == _v_steps(SMCMC_SPP) * 2 * row
        assert ranks[n]["moved", case] < W * H * d // n


# ---- slow: the JAX package's mesh renders of the other families


@pytest.mark.slow
def test_adaptive_pssmlt_erpt_match_jax_mesh_renders(ranks):
    import jax
    from rustlight_tpu.integrators import IntegratorPathTracing as JPath
    from rustlight_tpu.integrators.common import render_adaptive as j_adapt
    from rustlight_tpu.integrators.mcmc import (IntegratorERPT as JERPT,
                                                IntegratorPSSMLT as JMLT)
    from rustlight_tpu.models import cornell_box as jcbox
    from rustlight_tpu.parallel import make_device_mesh
    mesh = make_device_mesh(2)
    jsd = jcbox(W, H).compile()

    def jpath():
        return JPath(max_depth=DEPTH, hard_cap=DEPTH)
    with jax.default_device(jax.devices()[0]):
        ad = j_adapt(jsd, jpath(), ADAPT_SPP, seed=SEED, mesh=mesh)
        mlt = JMLT(jpath(), **MLT).render(jsd, 1, seed=SEED, mesh=mesh)
        erpt = JERPT(jpath(), **ERPT).render(jsd, 4, seed=SEED, mesh=mesh)
    np.testing.assert_array_equal(ranks["adaptive"]["spp"],
                                  np.asarray(ad.buffers["spp"]))
    _close(ranks["adaptive"]["primal"], np.asarray(ad.buffers["primal"]),
           TOL)
    for got, ref in ((ranks["pssmlt"], mlt["primal"]),
                     (ranks["erpt"], erpt["primal"])):
        ref = np.asarray(ref)
        assert abs(got.mean() - ref.mean()) <= 1e-3 * ref.mean()

"""The port's SMCMC against the JAX package's.

On cbox 16x16 with the path tracer at max_depth = hard_cap = 3 (20
primary-sample dims a tile chain), seed 0, SPP = 8 steps (one whole
schedule MCMC / H0 / MCMC / V0 / MCMC / H1 / MCMC / V1), INIT_SPP = 2
attempts a tile in the independent init (the JAX package's jit traces
one path tracer an attempt):

  - the JAX side is one IntegratorSMCMC whose executables are cached on
    it (compiled without LLVM's optimizations): a render with the
    independent init and the naive reconstruction, a second one that
    continues its chains (keep_chains), then one with the mcmc init and
    the IRLS reconstruction (the init's executable dropped, the schedule's
    reused). While they run, `jax.lax.fori_loop` is wrapped so that a
    `jax.debug.callback` hands the host every loop's state before its
    first iteration and after each: the tile chains' carry and stream
    after every schedule step, and the roaming chains of the mcmc init
    after every move; and `jax.lax.switch` traces the schedule's four
    identical MCMC branches once;
  - the initial carries (the independent and the mcmc init): the states
    within U_ATOL (a Kelemen mutation's ulp), tf and the accumulators
    within STEP_RTOL, the stream's counter equal, and the roaming chains'
    decisions (a chain moved where its state changed) equal on every
    (chain, step);
  - each kind of step (MCMC, H0, V0, H1, V1) on the JAX package's own carry
    before it: the decisions equal on every tile, the states within
    U_ATOL, tf and the accumulators within STEP_RTOL;
  - the reservoir update (smcmc.py:334-346 of the JAX package, replayed
    through XLA) on planted duplicate visits and a planted key tie: equal;
    the tie goes to the highest chain index in both;
  - `irls_reconstruction` (float64 torch, its terms batched) against
    `_irls_reconstruction` (float64 numpy) on seeded accumulators: within
    IRLS_RTOL;
  - the renders (independent, naive), (mcmc, irls) and the continued
    keep_chains render within RENDER_RTOL on every pixel;
  - `state_dict` / `load_state_dict`: a run interrupted after its first
    render and resumed in a new instance equals the uninterrupted run bit
    for bit; the JAX package's dumped state continues in the port as in
    the JAX package;
  - on the port alone: the record's shapes, a mesh raises
    NotImplementedError, an unknown init or reconstruction ValueError;
  - `slow`: the row cbox_path/smcmc at tools/regression.py's settings
    against its stored metrics within ROW_RTOL.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.integrators import IntegratorPathTracing as JaxPath
from rustlight_tpu.integrators.common import _BLOCK_CACHE
from rustlight_tpu.integrators.mcmc import IntegratorSMCMC as JaxSMCMC
from rustlight_tpu.integrators.mcmc.smcmc import (
    _irls_reconstruction as jax_irls)
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu_torch.integrators import IntegratorPathTracing
from rustlight_tpu_torch.integrators.mcmc import IntegratorSMCMC
from rustlight_tpu_torch.integrators.mcmc import smcmc as tsm
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

W = H = 16
DEPTH = 3
SPP = 8
INIT_SPP = 2
# tf, col and the accumulators of a step or an init against the JAX
# package's (relative, absolute floor 1e-6): the path tracer differs by
# ulps between XLA and torch (found: 6e-7)
STEP_RTOL = 1e-5
# primary samples: a Kelemen mutation's exp rounds apart by an ulp between
# XLA and torch (samplers/pss.py), so a mutated state is equal within 2^-24
U_ATOL = 2.0 ** -24
# a whole render's pixels (relative to the image's largest value)
RENDER_RTOL = 1e-5
# the IRLS solve, float64 on both sides, summed in other orders
IRLS_RTOL = 1e-6
# the regression row's metrics against the stored ones
ROW_RTOL = 1e-4
_FAST_COMPILE = {"xla_backend_optimization_level": 0}
_JIT = jax.jit
_FORI = jax.lax.fori_loop
_SINK = {"records": None}


def _fast_jit(f=None, **kw):
    kw.setdefault("compiler_options", _FAST_COMPILE)
    if f is None:
        return functools.partial(_fast_jit, **kw)
    return _JIT(f, **kw)


def _record(i, *leaves):
    _SINK["records"].append((int(i), [np.asarray(x) for x in leaves]))


def _recording_fori(lo, hi, body, init):
    """fori_loop that hands the host its state before the first iteration
    (index lo - 1) and after each."""
    jax.debug.callback(_record, lo - 1, *jax.tree.leaves(init))

    def wrapped(i, state):
        out = body(i, state)
        jax.debug.callback(_record, i, *jax.tree.leaves(out))
        return out
    return _FORI(lo, hi, wrapped, init)


_SWITCH = jax.lax.switch
# the schedule's branches MCMC / H0 / MCMC / V0 / MCMC / H1 / MCMC / V1:
# the four MCMC branches are the same function, traced once here
_UNIQUE = (0, 1, 3, 5, 7)
_BRANCH_OF = (0, 1, 0, 2, 0, 3, 0, 4)


def _dedup_switch(index, branches, *operands):
    """lax.switch over the schedule's distinct branches only."""
    if len(branches) != len(_BRANCH_OF):
        return _SWITCH(index, branches, *operands)
    which = jnp.asarray(_BRANCH_OF, jnp.int32)[index]
    return _SWITCH(which, [branches[i] for i in _UNIQUE], *operands)


def _split(records):
    """The evolve loop's states (11 leaves: the carry's 9 and the stream's
    key and counter) and the roaming chains' (10 leaves), by index."""
    ev = {i: x for i, x in records if len(x) == 11}
    ro = {i: x for i, x in records if len(x) == 10}
    return ev, ro


@pytest.fixture(scope="module")
def jax_side():
    jsd = jax_cornell_box(W, H).compile()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "jit", _fast_jit)
    mp.setattr(jax.lax, "fori_loop", _recording_fori)
    mp.setattr(jax.lax, "switch", _dedup_switch)
    out = {"host": jsd.host.data}
    try:
        g = JaxSMCMC(JaxPath(max_depth=DEPTH, hard_cap=DEPTH),
                     recons="naive", keep_chains=True, init_spp=INIT_SPP)
        _SINK["records"] = []
        out["naive"] = np.asarray(g.render(jsd, SPP, seed=0)["primal"])
        out["naive_steps"], _ = _split(_SINK["records"])
        out["state"] = g.state_dict()
        _SINK["records"] = []
        out["continued"] = np.asarray(g.render(jsd, SPP, seed=1)["primal"])
        # the mcmc init and IRLS on the same instance: the schedule's
        # executable does not depend on them, the init's is dropped
        g._chain_state = None
        g.init, g.recons = "mcmc", "irls"
        for k in [k for k in _BLOCK_CACHE
                  if isinstance(k, tuple) and k[-1] == "smcmc-init"]:
            _BLOCK_CACHE.pop(k)
        _SINK["records"] = []
        out["irls"] = np.asarray(g.render(jsd, SPP, seed=0)["primal"])
        out["mcmc_steps"], out["roaming"] = _split(_SINK["records"])
    finally:
        mp.undo()
        _SINK["records"] = None
    return out


def _port(**kw):
    return IntegratorSMCMC(IntegratorPathTracing(max_depth=DEPTH,
                                                 hard_cap=DEPTH),
                           **{"init_spp": INIT_SPP, **kw})


@pytest.fixture(scope="module")
def port_side(jax_side):
    sd = from_numpy_scene(jax_side["host"], "cpu")
    out = {"sd": sd}
    g = _port(recons="naive", keep_chains=True)
    out["naive"] = g.render(sd, SPP, seed=0)["primal"]
    out["state"] = g.state_dict()
    out["continued"] = g.render(sd, SPP, seed=1)["primal"]
    gi = _port(recons="irls", init="mcmc")
    gi.record_accepts = True
    out["irls"] = gi.render(sd, SPP, seed=0)["primal"]
    out["irls_integ"] = gi
    return out


def _carry(leaves, device="cpu"):
    return tsm.Carry(*(torch.as_tensor(x, device=device)
                       for x in leaves[:9]))


def _stream(leaves):
    key, counter = leaves[9], leaves[10]
    return trng.RngStream(key=(int(key[0]), int(key[1])),
                          counter=int(counter), device=torch.device("cpu"))


def _close(got, ref, rtol=STEP_RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


def _same_carry(got: tsm.Carry, ref_leaves):
    """States within U_ATOL, counts equal, floats within STEP_RTOL."""
    u, tf, col, wgt, acc_v, acc_mc, nb_s, b_acc, nb_u = ref_leaves[:9]
    np.testing.assert_allclose(got.u.numpy(), u, rtol=0.0, atol=U_ATOL)
    np.testing.assert_array_equal(got.nb_s.numpy(), nb_s)
    np.testing.assert_array_equal(got.nb_u.numpy(), nb_u)
    for name, ref in (("tf", tf), ("col", col), ("wgt", wgt),
                      ("acc_v", acc_v), ("acc_mc", acc_mc),
                      ("b_acc", b_acc)):
        _close(getattr(got, name).numpy(), ref)


@pytest.mark.parametrize("init", ["independent", "mcmc"])
def test_init_matches_jax(jax_side, port_side, init):
    steps = jax_side["naive_steps" if init == "independent"
                     else "mcmc_steps"]
    g = _port(init=init)
    g.record_accepts = True
    lay = tsm.make_layout(W, H, "cpu")
    base = trng.stream_fold(trng.make_stream(0, "cpu"), 31337)
    carry, stream = g.init_carry(port_side["sd"], lay, base)
    _same_carry(carry, steps[-1])
    assert stream.key == _stream(steps[-1]).key
    assert stream.counter == int(steps[-1][10])
    if init == "mcmc":
        ro = jax_side["roaming"]
        # a roaming chain moved where its primary samples changed
        moved = np.stack([np.any(ro[k][5] != ro[k - 1][5], axis=1)
                          for k in range(g.init_chain_length)])
        np.testing.assert_array_equal(g.init_accepts, moved)
        assert 0.05 < moved.mean() < 0.95, moved.mean()


# (schedule step, its kind)
_STEPS = [(0, "mcmc"), (1, "h0"), (3, "v0"), (5, "h1"), (7, "v1")]


@pytest.mark.parametrize("s,kind", _STEPS, ids=[k for _, k in _STEPS])
def test_step_matches_jax(jax_side, port_side, s, kind):
    steps = jax_side["naive_steps"]
    before, after = steps[s - 1], steps[s]
    sched = tsm.SCHEDULE[s]
    lay = tsm.make_layout(W, H, "cpu")
    carry, stream, acc, _ = _port().mcmc_step(
        port_side["sd"], lay, _carry(before), _stream(before),
        **({} if sched is None else dict(exchange_axis=sched[0],
                                         offset=sched[1])))
    _same_carry(carry, after)
    assert stream.counter == int(after[10])
    # every tile decided as the JAX package's: its state moved or stayed
    moved = np.any(after[0] != before[0], axis=1)
    np.testing.assert_array_equal(
        np.any(carry.u.numpy() != before[0], axis=1), moved)
    # a state moves where its chain accepts, or where a chain without
    # light borrows its partner's in an exchange
    acc = acc.numpy()
    assert moved.any() and moved[acc].all()
    assert (before[1][moved & ~acc] <= 0.0).all()


def _jax_reservoir(n, pid, key, ur, nb_visit, tiles, chains):
    """The JAX package's reservoir lines (smcmc.py:335-346), through XLA."""
    t_u, t_tf, t_col = tiles
    ch_u, ch_tf, ch_col = chains

    @jax.jit
    def f(pid, key, ur, nb_visit, t_u, t_tf, t_col, ch_u, ch_tf, ch_col):
        visits = jnp.zeros(n).at[pid].add(1.0)
        nb_new = nb_visit + visits
        keymax = jnp.full(n, -1.0).at[pid].max(key)
        winner = key == keymax[pid]
        repl = (visits > 0.0) & (ur < visits / jnp.maximum(nb_new, 1.0))
        sel = winner & repl[pid] & (ch_tf > 0.0)
        tgt = jnp.where(sel, pid, n)
        return (t_u.at[tgt].set(ch_u, mode="drop"),
                t_tf.at[tgt].set(ch_tf, mode="drop"),
                t_col.at[tgt].set(ch_col, mode="drop"), nb_new)
    return [np.asarray(x) for x in f(pid, key, ur, nb_visit, t_u, t_tf,
                                     t_col, ch_u, ch_tf, ch_col)]


def test_reservoir_update_planted_matches_jax():
    """Duplicate visits, a tie of keys within one tile, a visitor without
    light, and tiles visited for the first time and again."""
    n, m, d = 12, 10, 3
    rng = np.random.default_rng(7)
    pid = np.array([1, 1, 1, 4, 4, 7, 7, 9, 9, 9], np.int32)
    key = rng.random(m).astype(np.float32)
    key[[3, 4]] = 0.9                   # tile 4: two winners
    key[[7, 8, 9]] = [0.2, 0.95, 0.95]  # tile 9: a tie for the largest
    ur = np.zeros(n, np.float32)        # every visited tile replaces
    nb_visit = np.array([0, 0, 0, 0, 1, 0, 0, 5, 0, 0, 0, 0], np.float32)
    tiles = (rng.random((n, d)).astype(np.float32),
             rng.random(n).astype(np.float32),
             rng.random((n, 5, 3)).astype(np.float32))
    ch_tf = rng.random(m).astype(np.float32) + 0.1
    ch_tf[5] = 0.0                       # tile 7's largest key: no light
    key[5] = 0.99
    chains = (rng.random((m, d)).astype(np.float32), ch_tf,
              rng.random((m, 5, 3)).astype(np.float32))
    ref = _jax_reservoir(n, pid, key, ur, nb_visit, tiles, chains)
    t = torch.as_tensor
    got_tiles, got_nb = tsm.reservoir_update(
        n, t(pid).long(), t(key), t(ur), t(nb_visit),
        tuple(map(t, tiles)), tuple(map(t, chains)))
    for a, b in zip(list(got_tiles) + [got_nb], ref):
        np.testing.assert_array_equal(a.numpy(), b)
    # the tie goes to the highest chain index, the others stay
    np.testing.assert_array_equal(ref[0][4], chains[0][4])
    np.testing.assert_array_equal(ref[0][9], chains[0][9])
    np.testing.assert_array_equal(ref[0][7], tiles[0][7])
    np.testing.assert_array_equal(ref[0][0], tiles[0][0])


def test_irls_matches_jax():
    """Seeded accumulators, some tiles without splats or large steps."""
    rng = np.random.default_rng(3)
    w, h = 12, 10
    n = w * h
    lay = tsm.make_layout(w, h, "cpu")
    acc_v = rng.gamma(2.0, 0.5, (n, 5, 3)).astype(np.float32)
    acc_mc = rng.gamma(2.0, 0.3, (n, 5, 3)).astype(np.float32)
    nb_s = rng.integers(0, 9, n).astype(np.int32)
    nb_u = rng.integers(0, 4, n).astype(np.int32)
    b_acc = (rng.random(n) * nb_u).astype(np.float32)
    cv, cp = lay.cross_valid.numpy(), lay.cross_pid.numpy()
    ref = jax_irls(acc_v, acc_mc, nb_s, b_acc, nb_u, cv, cp, w, h)
    t = torch.as_tensor
    got = tsm.irls_reconstruction(t(acc_v), t(acc_mc), t(nb_s), t(b_acc),
                                  t(nb_u), lay.cross_valid, lay.cross_pid,
                                  w, h)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, rtol=IRLS_RTOL, atol=1e-9)
    assert ref.max() > 0


@pytest.mark.parametrize("which", ["naive", "irls", "continued"])
def test_render_matches_jax(jax_side, port_side, which):
    """(independent, naive), (mcmc, irls), and the keep_chains render
    that continues the first."""
    ref, got = jax_side[which], port_side[which]
    assert got.shape == ref.shape == (H, W, 3)
    assert np.all(np.isfinite(got)) and ref.mean() > 0
    _close(got, ref, rtol=RENDER_RTOL, atol=RENDER_RTOL * ref.max())


def test_record_shapes(port_side):
    g = port_side["irls_integ"]
    assert g.accepts.shape == (1, SPP, W * H) and g.accepts.dtype == bool
    assert g.tfs.shape == (1, SPP + 1, W * H)
    m = max(W * H * g.init_spp_mcmc // g.init_chain_length, 64)
    assert g.init_accepts.shape == (g.init_chain_length, m)


def test_state_dict_round_trip(jax_side, port_side):
    """Interrupted after the first render and resumed in a new instance:
    the uninterrupted run's image bit for bit. The JAX package's dumped
    state (its leaves are the port's) continues as in the JAX package."""
    sd = port_side["sd"]
    dumped = port_side["state"]
    assert set(dumped) == set(jax_side["state"])
    for k in dumped:
        assert dumped[k].dtype == np.asarray(jax_side["state"][k]).dtype, k
    g = _port(recons="naive", keep_chains=True)
    g.load_state_dict(dumped, sd)
    resumed = g.render(sd, SPP, seed=1)["primal"]
    np.testing.assert_array_equal(resumed, port_side["continued"])
    gj = _port(recons="naive", keep_chains=True)
    gj.load_state_dict(jax_side["state"], sd)
    _close(gj.render(sd, SPP, seed=1)["primal"], jax_side["continued"],
           rtol=RENDER_RTOL, atol=RENDER_RTOL * jax_side["continued"].max())
    with pytest.raises(ValueError):
        _port(pss_dims=7).load_state_dict(dumped, sd)


def test_refusals(port_side):
    from rustlight_tpu_torch.parallel import Mesh
    # the chain-by-chain record is single-device
    rec = _port()
    rec.record_accepts = True
    with pytest.raises(ValueError):
        rec.render(port_side["sd"], 1, mesh=Mesh())
    with pytest.raises(ValueError):
        _port(init="warm")
    with pytest.raises(ValueError):
        _port(recons="poisson")


@pytest.mark.slow
def test_regression_row_matches_the_stored_row():
    """cbox_path/smcmc (tools/regression.py:111-113: cornell_box(128, 128),
    32 spp, seed 0, the path tracer at max_depth = hard_cap = 6, recons
    naive) against regress/results.json within ROW_RTOL relative (found:
    7.8e-6, dssim)."""
    import json
    from pathlib import Path
    from rustlight_tpu_torch.models import cornell_box
    from rustlight_tpu_torch.utils.image import read_exr
    from rustlight_tpu_torch.utils.metrics import metric_scalar
    root = Path(__file__).resolve().parents[1] / "regress"
    integ = IntegratorSMCMC(IntegratorPathTracing(max_depth=6, hard_cap=6),
                            recons="naive")
    img = integ.render(cornell_box(128, 128).compile(device="cpu"), 32,
                       seed=0)["primal"]
    ref = read_exr(root / "refs" / "cbox_path.exr")
    stored = json.loads((root / "results.json").read_text())[
        "cbox_path/smcmc"]
    for m in ("l1", "l2", "mape", "dssim"):
        assert abs(metric_scalar(ref, img, m) - stored[m]) <= (
            ROW_RTOL * stored[m]), m

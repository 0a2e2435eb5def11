"""The port's meta-integrators (rustlight_tpu_torch/integrators/meta.py) and
Film averaging against the JAX package's.

  - the four Film methods (register, accumulate, scale, average_with) bit
    for bit against the JAX package's Film;
  - both packages' IntegratorAverage and IntegratorEqualTime driving the
    same stub integrator (its film a function of the seed and of the number
    of passes it rendered before, its state_dict that number): the same
    films, dumps, `_time.csv` pass column and resume outcomes, for the
    behaviours of the JAX package's tests/test_cli.py:133-327 (an endless
    run bounded by max_passes, resume bit for bit, a completed run adding
    no pass, zero-padded dump names, a misaligned state falling back to the
    film, the rewind when a crash fell between the film's save and the
    state's, a non-averaging integrator resuming from its state alone or
    starting clean without it, the ValueError for an endless run without
    dumps, a time budget);
  - the port against itself: an -a run resumed from its dumps equal bit
    for bit to the uninterrupted run for the path tracer, the guided path
    tracer (g = 8) and SMCMC with kept chains, at 8x8 on the CPU;
  - a mesh raising NotImplementedError.
"""
import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest

from rustlight_tpu.integrators import meta as jmeta
from rustlight_tpu.utils import film as jfilm
from rustlight_tpu.utils.image import read_pfm as jax_read_pfm
from rustlight_tpu_torch.integrators import IntegratorPathTracing
from rustlight_tpu_torch.integrators import meta as tmeta
from rustlight_tpu_torch.integrators.guiding import IntegratorGuidedPath
from rustlight_tpu_torch.integrators.mcmc import IntegratorSMCMC
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.utils import film as tfilm
from rustlight_tpu_torch.utils.image import read_pfm

W, H = 6, 4
SCENE = SimpleNamespace(camera=SimpleNamespace(width=W, height=H))
PACKAGES = {"jax": (jmeta, jfilm.Film), "port": (tmeta, tfilm.Film)}


class _Stub:
    """A self-driving integrator: pass `seed` renders a film of uniforms
    from (seed, passes rendered before) times spp; with `stateful`, the
    count is its state (state_dict / load_state_dict)."""

    def __init__(self, film_cls, averaging=True, stateful=False):
        self.film_cls = film_cls
        self.averaging = averaging
        self.n = 0
        self.stateful = stateful
        self.seeds = []
        if stateful:
            self.state_dict = lambda: {"n": np.asarray(self.n)}
            self.load_state_dict = self._load

    def _load(self, d, scene):
        self.n = int(d["n"])

    def render(self, scene, spp, seed=0):
        self.seeds.append(seed)
        rng = np.random.default_rng([seed + 7,
                                     self.n if self.stateful else 0])
        self.n += 1
        film = self.film_cls(scene.camera.width, scene.camera.height)
        film.buffers["primal"] = (rng.random((H, W, 3), dtype=np.float32)
                                  * np.float32(spp))
        return film


def _both(fn):
    """fn(meta module, Film class, tag) for both packages: {tag: result}."""
    return {tag: fn(m, f, tag) for tag, (m, f) in PACKAGES.items()}


def _equal(out):
    a, b = out["jax"], out["port"]
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_film_methods_match_jax():
    rng = np.random.default_rng(0)
    x, y = (rng.random((H, W, 3), dtype=np.float32) * 3 for _ in range(2))
    z = rng.random((H, W, 2), dtype=np.float32)

    def run(m, Film, tag):
        a, b = Film(W, H), Film(W, H)
        a.register()
        a.register("aux", 2)
        a.accumulate("primal", x)
        a.accumulate("aux", z)
        a.accumulate("aux", z.astype(np.float64))
        a.scale(0.3, "aux")
        a.scale(1.7)
        b.buffers = {"primal": y, "aux": z * 2}
        a.average_with(b, 3)
        a.average_with(b, 7)
        return a.buffers
    out = _both(run)
    assert sorted(out["port"]) == ["aux", "primal"]
    for k in out["jax"]:
        assert out["port"][k].dtype == out["jax"][k].dtype == np.float32
        np.testing.assert_array_equal(out["port"][k], out["jax"][k])


def _average(tmp_path, tag, m, Film, name, seed=5, stub_kw=None, **kw):
    stub = _Stub(Film, **(stub_kw or {}))
    base = str(tmp_path / tag / name)
    os.makedirs(tmp_path / tag, exist_ok=True)
    film = m.IntegratorAverage(stub, spp_per_pass=2, dump_base=base,
                               **kw).render(SCENE, seed=seed)
    return film, stub, base


def _read(tag, path):
    return (jax_read_pfm if tag == "jax" else read_pfm)(path)


def _csv_passes(base):
    with open(f"{base}_time.csv") as f:
        rows = [ln.strip().split(",") for ln in f]
    assert all(float(t) >= 0 for t, _ in rows)
    return [int(i) for _, i in rows]


def test_average_passes_dumps_and_time_csv_match_jax(tmp_path):
    def run(m, Film, tag):
        film, stub, base = _average(tmp_path, tag, m, Film, "a", nb_passes=3)
        dumps = [_read(tag, f"{base}_{k}.pfm") for k in (1, 2, 3)]
        return (film["primal"], np.stack(dumps), stub.seeds,
                _csv_passes(base))
    out = _both(run)
    for i in range(4):
        _equal({k: v[i] for k, v in out.items()})
    assert out["port"][2] == [5, 6, 7] and out["port"][3] == [1, 2, 3]
    np.testing.assert_array_equal(out["port"][1][-1], out["port"][0])


def test_endless_average_bounded_by_max_passes(tmp_path):
    def run(m, Film, tag):
        meta = m.IntegratorAverage(_Stub(Film), dump_base=str(
            tmp_path / f"{tag}_o"), max_passes=3)
        assert meta.infinite
        film = meta.render(SCENE, seed=0)
        assert all((tmp_path / f"{tag}_o_{i}.pfm").exists() for i in (1, 2,
                                                                      3))
        return film["primal"]
    _equal(_both(run))


def test_endless_average_without_dumps_raises():
    for m, Film in PACKAGES.values():
        with pytest.raises(ValueError, match="runs forever"):
            m.IntegratorAverage(_Stub(Film)).render(SCENE)


@pytest.mark.parametrize("stateful", [False, True], ids=["plain", "state"])
def test_resume_is_bit_exact_and_matches_jax(tmp_path, stateful):
    kw = dict(stub_kw=dict(stateful=stateful))

    def run(m, Film, tag):
        full, _, _ = _average(tmp_path, tag, m, Film, "full", nb_passes=4,
                              **kw)
        _average(tmp_path, tag, m, Film, "res", nb_passes=2, **kw)
        assert (tmp_path / tag / "res_state.npz").exists() == stateful
        cont, stub, base = _average(tmp_path, tag, m, Film, "res",
                                    nb_passes=4, resume=True, **kw)
        np.testing.assert_array_equal(cont["primal"], full["primal"])
        np.testing.assert_array_equal(_read(tag, f"{base}_4.pfm"),
                                      full["primal"])
        return cont["primal"], stub.seeds, _csv_passes(base)
    out = _both(run)
    for i in range(3):
        _equal({k: v[i] for k, v in out.items()})
    assert out["port"][1:] == ([7, 8], [3, 4])


def test_resume_of_a_completed_run_adds_no_pass(tmp_path):
    def run(m, Film, tag):
        _average(tmp_path, tag, m, Film, "d", nb_passes=2)
        done, stub, base = _average(tmp_path, tag, m, Film, "d", nb_passes=2,
                                    resume=True)
        assert not os.path.exists(f"{base}_3.pfm") and stub.seeds == []
        return done["primal"], _csv_passes(base)
    out = _both(run)
    _equal({k: v[0] for k, v in out.items()})
    assert out["port"][1] == []


def test_resume_loads_zero_padded_dump_names(tmp_path):
    def run(m, Film, tag):
        _, _, base = _average(tmp_path, tag, m, Film, "z", nb_passes=2)
        os.rename(f"{base}_2.pfm", f"{base}_002.pfm")
        os.remove(f"{base}_1.pfm")
        stub = _Stub(Film)
        meta = m.IntegratorAverage(stub, spp_per_pass=2, nb_passes=3,
                                   dump_base=base, resume=True)
        got = meta._find_resume()
        assert got is not None and got[1] == 2
        film = meta.render(SCENE, seed=5)
        assert os.path.exists(f"{base}_3.pfm") and stub.seeds == [7]
        return got[0]["primal"], film["primal"]
    out = _both(run)
    for i in range(2):
        _equal({k: v[i] for k, v in out.items()})


def test_resume_misaligned_state_falls_back_to_the_film(tmp_path, caplog):
    """A state from pass 3 with only the pass-1 dump left: the state is
    skipped (with a warning), the run continues from the film."""
    kw = dict(stub_kw=dict(stateful=True))

    def run(m, Film, tag):
        _, _, base = _average(tmp_path, tag, m, Film, "m", nb_passes=3, **kw)
        os.remove(f"{base}_2.pfm")
        os.remove(f"{base}_3.pfm")
        with caplog.at_level(logging.WARNING):
            film, stub, _ = _average(tmp_path, tag, m, Film, "m",
                                     nb_passes=2, resume=True, **kw)
        assert "does not align" in caplog.text
        caplog.clear()
        assert stub.seeds == [6] and stub.n == 1   # the state restarted
        return film["primal"]
    _equal(_both(run))


def test_resume_rewinds_to_the_state_after_a_crash(tmp_path):
    """A crash between the pass-3 film's save and the state's: the state
    says pass 2, the newest dump is pass 3; the run rewinds to pass 2 and
    renders pass 3 again, equal to the uninterrupted run."""
    kw = dict(stub_kw=dict(stateful=True))

    def run(m, Film, tag):
        full, _, _ = _average(tmp_path, tag, m, Film, "f", nb_passes=4, **kw)
        _, _, base = _average(tmp_path, tag, m, Film, "c", nb_passes=2, **kw)
        state = open(f"{base}_state.npz", "rb").read()
        _average(tmp_path, tag, m, Film, "c", nb_passes=3, resume=True, **kw)
        open(f"{base}_state.npz", "wb").write(state)
        film, stub, _ = _average(tmp_path, tag, m, Film, "c", nb_passes=4,
                                 resume=True, **kw)
        assert stub.seeds == [7, 8]
        np.testing.assert_array_equal(film["primal"], full["primal"])
        return film["primal"]
    _equal(_both(run))


def test_non_averaging_resume(tmp_path, caplog):
    """A non-averaging integrator replaces the film each pass: resumed from
    its state alone it continues the passes; without a state it starts
    clean with a warning."""
    kw = dict(stub_kw=dict(averaging=False, stateful=True))

    def run(m, Film, tag):
        full, _, _ = _average(tmp_path, tag, m, Film, "full", nb_passes=3,
                              **kw)
        _average(tmp_path, tag, m, Film, "res", nb_passes=1, **kw)
        cont, stub, _ = _average(tmp_path, tag, m, Film, "res", nb_passes=3,
                                 resume=True, **kw)
        assert stub.seeds == [6, 7]
        np.testing.assert_array_equal(cont["primal"], full["primal"])
        with caplog.at_level(logging.WARNING):
            clean, stub, _ = _average(
                tmp_path, tag, m, Film, "none", nb_passes=1, resume=True,
                stub_kw=dict(averaging=False))
        assert "--resume ignored" in caplog.text and stub.seeds == [5]
        caplog.clear()
        return cont["primal"], clean["primal"]
    out = _both(run)
    for i in range(2):
        _equal({k: v[i] for k, v in out.items()})


def test_time_budgets(tmp_path):
    """-a Ns and -e: the set-up pass (seed - 1) off the clock, then passes
    until the budget; equal time reports achieved_spp."""
    for tag, (m, Film) in PACKAGES.items():
        stub = _Stub(Film)
        meta = m.IntegratorAverage(stub, spp_per_pass=2, timeout_s=0.05,
                                   dump_base=str(tmp_path / f"{tag}_t"))
        meta.render(SCENE, seed=5)
        assert stub.seeds[:2] == [4, 5]
        assert _csv_passes(str(tmp_path / f"{tag}_t")) == list(
            range(1, len(stub.seeds)))
        stub = _Stub(Film)
        eq = m.IntegratorEqualTime(stub, target_s=0.05, spp_per_pass=3)
        film = eq.render(SCENE, seed=5)
        assert stub.seeds[:2] == [4, 5]
        assert eq.achieved_spp == 3 * (len(stub.seeds) - 1) >= 3
        assert film["primal"].shape == (H, W, 3)


def test_mesh_warning_and_rank_zero_stop_decisions(caplog, tmp_path,
                                                    monkeypatch):
    """A self-driving render without a `mesh` argument warns and renders
    on one device, as the JAX package's; on a mesh, every stop decision is
    rank 0's (here scripted: continue, continue, stop), whatever this
    rank's clock says, and a rank other than 0 writes no file."""
    from rustlight_tpu_torch import parallel
    from rustlight_tpu_torch.parallel import Mesh
    stub = _Stub(tfilm.Film)
    with caplog.at_level(logging.WARNING):
        film = tmeta._render_once(SCENE, stub, 1, 0, mesh=Mesh())
    assert "does not support a device mesh" in caplog.text
    assert stub.seeds == [0] and film["primal"].shape == (H, W, 3)

    for make in (
            lambda s, m: tmeta.IntegratorEqualTime(s, target_s=0.0,
                                                   mesh=m),
            lambda s, m: tmeta.IntegratorAverage(
                s, timeout_s=0.0, mesh=m,
                dump_base=str(tmp_path / "r1"))):
        said = iter([False, False, True])
        monkeypatch.setattr(parallel, "agree", lambda mesh, v: next(said))
        stub = _Stub(tfilm.Film)
        make(stub, Mesh(1, 2)).render(SCENE, seed=5)
        # the set-up pass, then three passes
        assert stub.seeds == [4, 5, 6, 7]
    assert list(tmp_path.iterdir()) == []


def _path():
    return IntegratorPathTracing(max_depth=3, hard_cap=3)


@pytest.mark.parametrize("make, spp", [
    (_path, 1),
    (lambda: IntegratorGuidedPath(_path(), g=8), 1),
    (lambda: IntegratorSMCMC(_path(), recons="naive", keep_chains=True,
                             init_spp=2), 2)], ids=["path", "guided",
                                                    "smcmc"])
def test_port_resume_is_bit_exact(tmp_path, make, spp):
    sd = cornell_box(8, 8).compile(device="cpu")

    def avg(name, n, resume=False):
        return tmeta.IntegratorAverage(
            make(), spp_per_pass=spp, nb_passes=n, resume=resume,
            dump_base=str(tmp_path / name)).render(sd, seed=5)["primal"]
    full = avg("full", 3)
    avg("res", 1)
    cont = avg("res", 3, resume=True)
    assert full.mean() > 0.01
    np.testing.assert_array_equal(cont, full)
    np.testing.assert_array_equal(read_pfm(tmp_path / "res_3.pfm"), full)

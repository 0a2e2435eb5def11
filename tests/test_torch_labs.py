"""The port's last eight laboratory tools (rustlight_tpu_torch/tools/perf/:
sortkey_lab, grouping_lab, greedy_onchip, k_sweep, k_sweep_bench,
prim_gather_scale, e2e_131k, e2e_4p9M).

  - Every host function of sortkey_lab and grouping_lab equals its
    counterpart in the JAX repo's tools/perf/sortkey_lab.py and
    grouping_lab.py (loaded by path; numpy only, no JAX) on seeded inputs
    of a few thousand rays: bools, keys, orders and unions exactly; the
    incidence matrix also through its torch form.
  - Each lab's main runs with --device cpu at a tiny size, writes its
    record where --out says with `card` null, and writes nothing under
    tools/perf/regress/ or gallery/.
A test marked `cuda` holds the K = 128 kernels to their plain versions on
a card; it imports no JAX.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rustlight_tpu_torch.accel import walk as tw
from rustlight_tpu_torch.tools.perf import (common, e2e_131k, e2e_4p9M,
                                            greedy_onchip, grouping_lab,
                                            k_sweep, k_sweep_bench,
                                            prim_gather_scale, sortkey_lab)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "tools" / "perf"
N = 2048
SMALL = ["--device", "cpu", "--tris", "3000", "--theta", "10", "--runs", "1"]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  REF / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    """The JAX repo's two labs; grouping_lab imports sortkey_lab by name."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(REF))
        return _load("sortkey_lab"), _load("grouping_lab")


@pytest.fixture(scope="module")
def lab():
    """A small sphere grid's cluster boxes and the labs' two wavefronts."""
    geom, ext = common.lab_scene(3000, 10)
    host = tw.build_walk_tables(geom)
    lo, hi = sortkey_lab.cluster_boxes(host)
    rng = np.random.default_rng(3)
    waves = dict(sortkey_lab.lab_wavefronts(rng, N, ext))
    return host, lo, hi, waves


@pytest.mark.parametrize("wave", ["coherent", "divergent"])
def test_sortkey_functions_equal_reference(ref, lab, wave):
    rs, _ = ref
    host, lo, hi, waves = lab
    o, d = waves[wave]
    o64, d64 = o.astype(np.float64), d.astype(np.float64)
    hits = sortkey_lab.ray_cluster_hits(lo, hi, o64, d64, chunk=500)
    want = rs.ray_cluster_hits(lo, hi, o64, d64, chunk=500)
    assert hits.dtype == want.dtype == bool and 0 < hits.mean() < 0.5
    np.testing.assert_array_equal(hits, want)
    np.testing.assert_array_equal(
        sortkey_lab.ray_cluster_hits(lo, hi, o64, d64, chunk=700,
                                     device=torch.device("cpu")), want)
    assert sortkey_lab.cluster_overlap_stats(lo, hi) == \
        rs.cluster_overlap_stats(lo, hi)
    wlo, whi = np.asarray(host.world_lo), np.asarray(host.world_hi)
    keys, want_keys = (m.keys_catalog(o, d, wlo, whi) for m in (sortkey_lab,
                                                                rs))
    assert list(keys) == list(want_keys)
    for name, key in keys.items():
        np.testing.assert_array_equal(key, want_keys[name], err_msg=name)
        order = np.argsort(key, kind="stable")
        for r in (32, 64):
            assert sortkey_lab.tile_union(hits, order, r) == \
                rs.tile_union(hits, order, r)
    q = np.random.default_rng(5).integers(0, 1 << 7, (N, 3))
    np.testing.assert_array_equal(sortkey_lab.morton(q, 7), rs.morton(q, 7))
    assert sortkey_lab.grouping_floor(hits) == rs.grouping_floor(hits)


@pytest.mark.parametrize("wave", ["coherent", "divergent"])
def test_grouping_functions_equal_reference(ref, lab, wave):
    _, rg = ref
    _, lo, hi, waves = lab
    o, d = (x.astype(np.float64) for x in waves[wave])
    hits = sortkey_lab.ray_cluster_hits(lo, hi, o, d)
    for got, want in zip(grouping_lab.entry_cluster(lo, hi, o, d, chunk=600),
                         rg.entry_cluster(lo, hi, o, d, chunk=600)):
        np.testing.assert_array_equal(got, want)
    orders = {
        "bitset": (grouping_lab.bitset_lexsort(hits),
                   rg.bitset_lexsort(hits)),
        "kmeans": (grouping_lab.kmeans_order(hits, 64, sample=1024),
                   rg.kmeans_order(hits, 64, sample=1024)),
        "greedy": (grouping_lab.greedy_union_order(hits, 64, max_scan=512),
                   rg.greedy_union_order(hits, 64, max_scan=512))}
    for name, (got, want) in orders.items():
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert sorted(got.tolist()) == list(range(N)), name
        assert grouping_lab.tile_union(hits, got) == \
            rg.tile_union(hits, want)
    # the greedy packing's union is at most the surrogate's
    assert (sortkey_lab.tile_union(hits, orders["greedy"][0])[0]
            <= sortkey_lab.grouping_floor(hits)[0])


def _snapshot():
    return {str(p): p.stat().st_mtime_ns
            for top in (REF / "regress", ROOT / "gallery")
            for p in sorted(top.rglob("*"))}


LABS = {
    "sortkey_lab": (sortkey_lab, ["--rays", "1024"]),
    "grouping_lab": (grouping_lab, ["--rays", "1024"]),
    "greedy_onchip": (greedy_onchip, ["--rays", "1024"]),
    "k_sweep": (k_sweep, ["--rays", "512", "--ks", "384,128"]),
    "k_sweep_bench": (k_sweep_bench, ["--rays", "512", "--ks", "768"]),
    "prim_gather_scale": (prim_gather_scale, [
        "--device", "cpu", "--nb", "64,128", "--res", "8", "--runs", "1"]),
    "e2e_131k": (e2e_131k, ["--device", "cpu", "--tris", "2000", "--res",
                            "12", "--spp", "1", "--runs", "1"]),
    "e2e_4p9M": (e2e_4p9M, ["--device", "cpu", "--tris", "3000", "--res",
                            "12", "--clusters", "16"]),
}


@pytest.mark.parametrize("name", list(LABS))
def test_lab_main_on_cpu(name, tmp_path):
    mod, argv = LABS[name]
    if mod not in (prim_gather_scale, e2e_131k, e2e_4p9M):
        argv = SMALL + argv
    if mod is e2e_4p9M:
        argv = argv + ["--png", str(tmp_path / "big.png")]
    before = _snapshot()
    out = tmp_path / f"{name}.json"
    ret = mod.main([*argv, "--out", str(out)])
    rec = json.loads(out.read_text())
    head = rec[0] if isinstance(rec, list) else rec
    assert head["card"] is None and head["device"] == "cpu"
    assert _snapshot() == before
    assert json.loads(json.dumps(ret)) == rec
    if mod is k_sweep:
        assert [r["K"] for r in rec[1:]] == [384, 128]
        assert all(r[w]["parity"] and r["route"] == "K3" for r in rec[1:]
                   for w in ("coherent", "divergent"))
        assert rec[2]["C"] > rec[1]["C"]
    if mod is greedy_onchip:
        a, b = rec["incidence sort (production)"], rec["greedy pre-permuted"]
        assert (a["hits"], a["chk"]) == (b["hits"], b["chk"])
    if mod is e2e_4p9M:
        assert (tmp_path / "big.png").stat().st_size > 0
        assert rec["clusters"] == 16 and rec["ao"]["spp"] == 4


def test_e2e_4p9m_holds_the_cluster_count(tmp_path):
    with pytest.raises(AssertionError, match="gives this scene 15"):
        e2e_4p9M.main(["--device", "cpu", "--tris", "3000", "--res", "8",
                       "--ao-spp", "0", "--clusters", "15", "--out",
                       str(tmp_path / "x.json")])


@pytest.mark.cuda
def test_cuda_k128_kernels_match_plain_versions():
    """On a card: the K = 128 library's walk kernels (K3/K4 both forms,
    K3w, K5, K9a) against their plain versions at K = 128, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from rustlight_tpu_torch.ops import walk_hier as wh
    from rustlight_tpu_torch.ops import walk_lab as wl
    from rustlight_tpu_torch.ops import walk_trace as wk
    geom, ext = common.lab_scene(20_000, 10)
    wt = tw.walk_tables_to(tw.build_walk_tables(geom, k=128), "cuda")
    rng = np.random.default_rng(4)
    o, d = common.to_device("cuda", *common.divergent_rays(rng, 8192, ext))
    srt = common.sorted_tiles(wt, o, d)
    one = wk.ONE_THREAD_FORM
    cases = (
        (lambda **k: wk.walk_closest(wt, *srt, **k),
         wk._walk_ref(wt, *srt, False)[0]),
        (lambda **k: wk.walk_anyhit(wt, *srt, **k),
         wk._walk_ref(wt, *srt, True)[0]),
        (lambda **k: wk.walk_closest(wt, *srt, wide=True, **k),
         wk._walk_ref(wt, *srt, False, True)[0]),
        (lambda **k: wh.walk_hier_closest(wt, *srt, **k),
         wh.walk_hier_closest_ref(wt, *srt)[:4]),
        (lambda **k: wl.walk_closest_counted(wt, *srt, **k),
         wl.walk_closest_counted_ref(wt, *srt)))
    for fn, plain in cases:
        for form in (None, one):
            got = fn(_form=form)
            got = got if isinstance(got, tuple) else (got,)
            for a, b in zip(got, plain):
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                assert torch.equal(a, b)

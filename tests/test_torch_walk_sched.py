"""The port's alternative walk schedules (accel/walk.py: WalkOptions; the
wide pop of ops/walk_trace.py, ops/walk_sub.py, ops/walk_sparse.py) against
the JAX package's.

On the 1,500-triangle soup and the 512 rays of tests/test_pallas_walk.py
(numpy, seed 7), the JAX package's resident tables go to the port through
walk_tables_from_numpy. For each case (the wide pop, the sub-tiled walk at
sub = 2, 4, 8, the sparse-visit walk, the inert-compacting key with every
second lane inert, and inc_sort=False):
  - the JAX function, its Pallas kernels run by the interpreter, against the
    port's plain version on the same rays, closest hit and any hit
    (tfar = 2.2): hit masks, triangle ids and occlusion equal, t within
    T_RTOL (relative) and u/v within UV_TOL of the magnitudes that cancel
    in u = o4.U + t d4.U (XLA on the CPU contracts products into FMAs and
    the port does not; terms near 50 cancel down to u in [0, 1], as in
    tests/test_torch_walk.py);
  - the port against its own dense plain version over all 1,500 triangles:
    the same arithmetic, so t/u/v within TOL (absolute).
The kernel-schedule cases run unsorted in both packages, so both see the
same tiles; the sort-key cases run sorted (the morton key is equal as
integers in both packages; the incidence key may move a lane across a bin
edge, which changes tiles, never results off exact ties, of which this soup
has none).
Further: the option rules raise where the reference silently drops an
option; `_sort_key` with tfar equals the reference's; the sparse-visit
plain version takes both of its branches; the options reach the dispatch
from Scene.compile, and every schedule renders sphere_grid(3000, 16, 16) to
the default schedule's image. Tests marked `cuda` hold the CUDA kernels to
their plain versions on a card (expected bit-identical).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustlight_tpu.accel.pallas_walk as W
from rustlight_tpu.scene.geometry import (
    TriMesh as JaxTriMesh, build_geometry_tables as jax_build_geometry)
from rustlight_tpu_torch.accel import intersect_rays, occluded_rays
from rustlight_tpu_torch.accel import walk as tw
from rustlight_tpu_torch.accel.walk import WalkOptions
from rustlight_tpu_torch.integrators import IntegratorPathTracing
from rustlight_tpu_torch.integrators.common import _pixel_grid
from rustlight_tpu_torch.models import sphere_grid
from rustlight_tpu_torch.ops import dense_trace as dt
from rustlight_tpu_torch.ops import walk_sparse as ws
from rustlight_tpu_torch.ops import walk_sub as wsub
from rustlight_tpu_torch.ops import walk_trace as wk
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

NR = 512
TOL = 1e-6
T_RTOL, UV_TOL = 1e-6, 1e-5
TFAR_OCC = 2.2
# case -> (keyword options of both packages' _walk_impl, sorted?, every
# second lane inert?)
CASES = {
    "wide": (dict(wide=True), False, False),
    "sub2": (dict(sub=2), False, False),
    "sub4": (dict(sub=4), False, False),
    "sub8": (dict(sub=8), False, False),
    "sparse": (dict(sparse=True), False, False),
    # as the reference's own test runs it: spread origins take the incidence
    # key, which ignores compact_inert (the reference's recorded fault)
    "compact_inert": (dict(compact_inert=True), True, True),
    "compact_inert_morton": (dict(compact_inert=True, inc_sort=False), True,
                             True),
    "inc_sort_off": (dict(inc_sort=False), True, False),
}


def _t(x, device="cpu"):
    return torch.as_tensor(np.asarray(x), device=device)


@pytest.fixture(scope="module")
def soup():
    """Geometry, both packages' tables and the rays of
    tests/test_pallas_walk.py:18-37."""
    rng = np.random.default_rng(7)
    nt = 1500
    c = rng.uniform(-1, 1, (nt, 3)).astype(np.float32)
    vs = [c + rng.normal(0, .06, (nt, 3)).astype(np.float32) for _ in range(3)]
    verts = np.concatenate(vs, 0).astype(np.float32)
    idx = np.arange(3 * nt).reshape(3, nt).T.astype(np.int32)
    o = rng.uniform(-2.5, -1.8, (NR, 3)).astype(np.float32)
    d = c[rng.integers(0, nt, NR)] - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jgeom = jax_build_geometry([JaxTriMesh(vertices=verts, indices=idx,
                                           material=0)], [-1])
    jwt = W.build_walk_tables(jgeom)
    assert jwt.resident and jwt.n_real == 6
    wt = tw.walk_tables_to(jwt, "cpu")
    rows = np.asarray(jgeom.inter_rows)
    return jwt, wt, rows, o, d.astype(np.float32)


def _ranges(inert: bool):
    """(tnear, tfar closest, tfar any hit) of a case."""
    tnear = np.full(NR, 1e-4, np.float32)
    live = (np.arange(NR) % 2 == 1) if inert else np.ones(NR, bool)
    return (tnear, np.where(live, np.inf, 0.0).astype(np.float32),
            np.where(live, TFAR_OCC, 0.0).astype(np.float32))


@pytest.fixture(scope="module")
def jax_results(soup):
    """Every case through the JAX package once, all outputs fetched at once
    (late fetches of interpret-mode outputs can stall on the CPU backend)."""
    jwt, _, _, o, d = soup
    out = {}
    for name, (kw, sort, inert) in CASES.items():
        tnear, tfar, tfar_occ = _ranges(inert)
        args = [jnp.asarray(x) for x in (o, d, tnear)]
        rh = W._walk_impl(jwt, *args, jnp.asarray(tfar), False,
                          interpret=True, sort_rays=sort, **kw)
        occ = W._walk_impl(jwt, *args, jnp.asarray(tfar_occ), True,
                           interpret=True, sort_rays=sort, **kw)
        out[name] = ([np.asarray(x) for x in (rh.t, rh.tri, rh.u, rh.v)],
                     np.asarray(occ))
    return out


def _port(wt, o, d, name):
    kw, sort, inert = CASES[name]
    tnear, tfar, tfar_occ = _ranges(inert)
    rh = tw._walk_impl(wt, _t(o), _t(d), _t(tnear), _t(tfar), False,
                       sort_rays=sort, **kw)
    occ = tw._walk_impl(wt, _t(o), _t(d), _t(tnear), _t(tfar_occ), True,
                        sort_rays=sort, **kw)
    assert torch.equal(rh.hit, rh.tri >= 0)
    return [x.numpy() for x in (rh.t, rh.tri, rh.u, rh.v)], occ.numpy()


def _assert_agree(ref, got, live, t_rtol=0.0, t_atol=TOL, uv_mag=None):
    """uv_mag (rows, o, d): hold u/v to UV_TOL of the cancelling magnitudes
    instead of TOL."""
    (t_r, i_r, u_r, v_r), occ_r = ref
    (t_g, i_g, u_g, v_g), occ_g = got
    hit = i_g >= 0
    np.testing.assert_array_equal(i_r, i_g)
    np.testing.assert_array_equal(np.isfinite(t_g), hit)
    np.testing.assert_array_equal(occ_r, occ_g)
    assert not hit[~live].any() and not occ_g[~live].any()
    assert hit[live].mean() > 0.5 and 0 < occ_g.sum() < live.sum()
    np.testing.assert_allclose(t_r[hit], t_g[hit], rtol=t_rtol, atol=t_atol)
    for k, (a, b) in enumerate(((u_r, u_g), (v_r, v_g)), start=1):
        bound = TOL
        if uv_mag is not None:
            rows, o, d = uv_mag
            r = rows[i_g[hit], k]
            bound = UV_TOL * (
                np.abs(o[hit] * r[:, :3]).sum(1) + np.abs(r[:, 3])
                + np.abs(t_g[hit, None] * d[hit] * r[:, :3]).sum(1))
        assert np.all(np.abs(a[hit] - b[hit]) <= bound)


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_matches_pallas_kernels(soup, jax_results, name):
    _, wt, rows, o, d = soup
    live = _ranges(CASES[name][2])[1] > 0
    _assert_agree(jax_results[name], _port(wt, o, d, name), live,
                  t_rtol=T_RTOL, t_atol=0.0, uv_mag=(rows, o, d))


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_matches_dense_plain_version(soup, name):
    _, wt, rows, o, d = soup
    tnear, tfar, tfar_occ = _ranges(CASES[name][2])
    args = [_t(x) for x in (rows, o, d, tnear)]
    ref = ([x.numpy() for x in dt.dense_closest_ref(*args, _t(tfar))],
           dt.dense_anyhit_ref(*args, _t(tfar_occ)).numpy())
    _assert_agree(ref, _port(wt, o, d, name), tfar > 0)


def _big(wt, cp):
    """The tables claiming cp clusters: enough for the option rules, which
    look at the counts only."""
    return wt._replace(n_clusters=cp)


@pytest.mark.parametrize("kw, cp, match", [
    (dict(sub=2), 1024, "640 clusters"),
    (dict(sparse=True), 1024, "640 clusters"),
    (dict(sub=2, wide=True), 128, "not with wide"),
    (dict(sparse=True, hier=True), 128, "not with hier"),
    (dict(sub=2, sparse=True), 128, "two schedules"),
    (dict(sub=3), 128, "sub must be"),
    (dict(sub=16), 128, "sub must be"),
    (dict(hier=True, wide=True), 128, "two routes"),
    (dict(hier=False, wide=False), 1 << 15, "packed entries"),
])
def test_options_that_cannot_apply_raise(soup, kw, cp, match):
    """The reference drops these silently and runs another kernel."""
    _, wt, _, o, d = soup
    tnear, tfar, _ = _ranges(False)
    with pytest.raises(ValueError, match=match):
        tw._walk_impl(_big(wt, cp), _t(o), _t(d), _t(tnear), _t(tfar), False,
                      **kw)


def test_option_resolution_follows_the_reference(soup):
    _, wt, _, _, _ = soup
    assert tw._resolve(wt, None, None, None, None) == (
        False, False, 1, False, False)
    assert tw._resolve(_big(wt, 1 << 15), None, None, None, None) == (
        True, False, 1, False, False)
    assert tw._resolve(_big(wt, 1 << 15), False, None, None, None) == (
        False, True, 1, False, False)
    opt = wt._replace(options=WalkOptions(sub=4))
    assert tw._resolve(opt, None, None, None, None) == (
        False, False, 4, False, False)
    assert tw._resolve(opt, None, None, 1, True) == (
        False, False, 1, True, False)
    assert WalkOptions() == (1, False, False, 8, None, None, False, False,
                             True)
    assert wsub.MAX_VMEM_CLUSTERS == W.MAX_VMEM_CLUSTERS == 640
    assert ws.SPARSE_CAP == W.SPARSE_CAP == 16


def test_sort_key_with_tfar_equals_jax(soup):
    jwt, wt, _, o, d = soup
    _, tfar, _ = _ranges(True)
    jmaj, jmin = W._sort_key(jwt, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(tfar))
    tmaj, tmin = tw._sort_key(wt, _t(o), _t(d), _t(tfar))
    np.testing.assert_array_equal(np.asarray(jmaj), tmaj.numpy())
    np.testing.assert_array_equal(np.asarray(jmin), tmin.numpy())
    inert = tfar <= 0
    assert tmaj.numpy()[inert].min() > tmaj.numpy()[~inert].max()
    # without tfar the key is the one the default schedule sorts by
    for a, b in zip(W._sort_key(jwt, jnp.asarray(o), jnp.asarray(d)),
                    tw._sort_key(wt, _t(o), _t(d))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_compact_inert_sorts_inert_lanes_last(soup):
    """With the morton key; under the incidence key the option is dropped,
    as in the reference."""
    _, wt, _, o, d = soup
    tnear, tfar, _ = _ranges(True)
    args = [_t(x) for x in (o, d, tnear, tfar)]
    srt = tw._prepare(wt, *args, compact_inert=True, inc_sort=False)
    assert not srt[3][NR // 2:].any() and srt[3][:NR // 2].all()
    mixed = tw._prepare(wt, *args, compact_inert=True, inc_sort=True)
    assert mixed[3][NR // 2:].any()
    assert torch.equal(mixed[4], tw._prepare(wt, *args)[4])


def test_sparse_plain_version_takes_both_branches(soup):
    _, wt, _, o, d = soup
    tnear, tfar, tfar_occ = _ranges(False)
    srt = tw._prepare(wt, *(_t(x) for x in (o, d, tnear, tfar)))[:4]
    *hit, visits, few, tested, flagged = ws.walk_sparse_closest_ref(wt, *srt)
    assert 0 < few < visits and flagged <= tested
    # a sparse visit tests at most SPARSE_CAP rays, a dense one all 64
    assert 64 * (visits - few) <= tested <= 64 * (visits - few) + 16 * few
    assert tested < 64 * visits == 64 * wk.walk_closest_ref(wt, *srt)[4]
    for a, b in zip(hit, wk.walk_closest_ref(wt, *srt)):
        assert torch.equal(a, b)
    _, visits_a, _, tested_a, _ = ws.walk_sparse_anyhit_ref(
        wt, *srt[:3], torch.minimum(srt[3], torch.tensor(TFAR_OCC)))
    assert 0 < tested_a <= 64 * visits_a


def test_sub_plain_version_is_the_walk_at_a_smaller_tile(soup):
    _, wt, _, o, d = soup
    tnear, tfar, _ = _ranges(False)
    srt = tw._prepare(wt, *(_t(x) for x in (o, d, tnear, tfar)))[:4]
    base = wk.walk_closest_ref(wt, *srt)
    last = base[4]
    for sub in wsub.SUBS:
        out = wsub.walk_sub_closest_ref(wt, *srt, sub)
        for a, b in zip(out[:4], base):
            assert torch.equal(a, b)
        # more groups, each with its own heap: more visits in all, fewer
        # rays tested in all
        assert out[4] >= last and out[4] * (64 // sub) <= base[4] * 64
        last = out[4]


@pytest.mark.parametrize("p", [2, 4, 8])
def test_sub_split_order_of_work_matches_pallas_kernels(soup, jax_results,
                                                        monkeypatch, p):
    """K6's split form's order of work (each group's walk with the split
    visit at p threads a ray, ops/walk_trace.py:_visit_closest_split /
    _visit_anyhit_split) gives the port's plain results bit for bit at
    every sub, and so agrees with the JAX package's Pallas kernels."""
    _, wt, rows, o, d = soup
    live = _ranges(False)[1] > 0
    want = {sub: _port(wt, o, d, f"sub{sub}") for sub in wsub.SUBS}
    monkeypatch.setattr(wk, "_visit_closest",
                        lambda rows, ids, csel, o, d, tnear, best, *_:
                        wk._visit_closest_split(rows, ids, csel, o, d, tnear,
                                                best, p))
    monkeypatch.setattr(wk, "_visit_anyhit",
                        lambda rows, csel, o, d, tnear, tfar, occ, *_:
                        wk._visit_anyhit_split(rows, csel, o, d, tnear, tfar,
                                               occ, p))
    for sub in wsub.SUBS:
        got = _port(wt, o, d, f"sub{sub}")
        for a, b in zip(got[0], want[sub][0]):
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
        np.testing.assert_array_equal(got[1], want[sub][1])
        _assert_agree(jax_results[f"sub{sub}"], got, live, t_rtol=T_RTOL,
                      t_atol=0.0, uv_mag=(rows, o, d))


@pytest.mark.parametrize("p", [4, 8])
def test_sparse_split_order_of_work_matches_pallas_kernels(
        soup, jax_results, monkeypatch, p):
    """K7's split form's order of work for the closest hit (a dense visit at
    p threads a ray, a sparse one at p x 64 / 16 lanes a flagged ray,
    ops/walk_sparse.py:_visit_closest_sparse_split) gives the port's plain
    results bit for bit, and so agrees with the JAX package's Pallas kernels
    (run once, in the module fixture)."""
    _, wt, rows, o, d = soup
    live = _ranges(False)[1] > 0
    want = _port(wt, o, d, "sparse")
    monkeypatch.setattr(
        wk, "_visit_closest",
        lambda rows, ids, csel, o, d, tnear, best, tested, *_:
        ws._visit_closest_sparse_split(rows, ids, csel, o, d, tnear, best,
                                       tested, p))
    got = _port(wt, o, d, "sparse")
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])
    _assert_agree(jax_results["sparse"], got, live, t_rtol=T_RTOL,
                  t_atol=0.0, uv_mag=(rows, o, d))


def test_wrappers_take_plain_versions_on_cpu(soup):
    _, wt, _, o, d = soup
    tnear, tfar, _ = _ranges(False)
    srt = tw._prepare(wt, *(_t(x) for x in (o, d, tnear, tfar)))[:4]
    for m in (wk, wsub, ws):
        m.reset_launches()
    with dt.counting_rays("cpu") as n_rays:
        outs = [wk.walk_closest(wt, *srt, wide=True),
                wsub.walk_sub_closest(wt, *srt, 4),
                ws.walk_sparse_closest(wt, *srt)]
        occs = [wk.walk_anyhit(wt, *srt, wide=True, heap="global"),
                wsub.walk_sub_anyhit(wt, *srt, 4),
                ws.walk_sparse_anyhit(wt, *srt)]
    assert int(n_rays) == 6 * NR
    assert not any(v for m in (wk, wsub, ws) for v in m.LAUNCHES.values())
    for out, occ in zip(outs, occs):
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)
        assert torch.equal(occ, occs[0])
    with pytest.raises(ValueError, match="heap"):
        wk.walk_closest(wt, *srt, wide=True, heap="registers")
    with pytest.raises(ValueError, match="sub must be"):
        wsub.walk_sub_closest(wt, *srt, 3)
    with pytest.raises(ValueError, match="640 clusters"):
        ws.walk_sparse_anyhit(_big(wt, 768), *srt)
    with pytest.raises(ValueError, match="2\\^14"):
        wk.walk_closest(_big(wt, 1 << 15), *srt)


@pytest.fixture(scope="module")
def grid_host():
    return sphere_grid(3000, 16, 16).compile(device="cpu").host


def _block(sd):
    return IntegratorPathTracing(max_depth=5).compute_block(
        sd, torch.as_tensor(_pixel_grid(16, 16)),
        trng.stream_fold(trng.make_stream(0, "cpu"), 0), 2).numpy()


@pytest.fixture(scope="module")
def default_block(grid_host):
    return _block(from_numpy_scene(grid_host, "cpu"))


@pytest.mark.parametrize("options", [
    WalkOptions(sub=2), WalkOptions(sparse=True), WalkOptions(pair=True),
    WalkOptions(hier=False, wide=True), WalkOptions(inc_sort=False)],
    ids=["sub2", "sparse", "pair", "wide", "inc_sort_off"])
def test_compute_block_per_schedule_equals_default(grid_host, default_block,
                                                   options):
    sd = from_numpy_scene(grid_host, "cpu", walk_options=options)
    assert sd.geom.walk.options == options and sd.geom.walk.n_real == 14
    got = _block(sd)
    assert np.all(np.isfinite(got)) and got.mean() > 0.05
    np.testing.assert_allclose(got, default_block, rtol=0, atol=1e-6)


def test_walk_options_reach_the_dispatch(grid_host, monkeypatch):
    """Scene.compile -> from_numpy_scene -> geometry_to -> walk_tables_to
    carry the options; intersect_rays / occluded_rays send `pair` tables to
    the pair walk and the others to the tile walk with their schedule."""
    sd = sphere_grid(3000, 16, 16).compile(
        device="cpu", walk_options=WalkOptions(sub=8, inc_sort=False))
    assert sd.geom.walk.options == WalkOptions(sub=8, inc_sort=False)
    assert from_numpy_scene(grid_host, "cpu").geom.walk.options == WalkOptions()
    seen = []
    monkeypatch.setattr(wsub, "_walk_ref", lambda *a, **k: (
        seen.append(k["tile"]), wk._walk_ref(*a, **k))[1])
    o = torch.zeros((128, 3)) + torch.tensor([1.5, 1.5, -2.0])
    d = torch.nn.functional.normalize(torch.randn(
        (128, 3), generator=torch.Generator().manual_seed(0)) * 0.2
        + torch.tensor([0.0, 0.0, 1.0]), dim=1)
    rh = intersect_rays(sd.geom, o, d)
    occ = occluded_rays(sd.geom, o, d, torch.full((128,), 1e-4),
                        torch.full((128,), float("inf")))
    assert seen == [8, 8] and torch.equal(rh.hit, occ) and rh.hit.any()
    pair = from_numpy_scene(grid_host, "cpu", WalkOptions(pair=True, km=3))
    import rustlight_tpu_torch.accel.pair_walk as pw
    calls, real = [], pw._entries_block
    monkeypatch.setattr(pw, "_entries_block", lambda *a: (
        calls.append(a[-1]), real(*a))[1])
    rp = intersect_rays(pair.geom, o, d)
    assert calls == [3]
    for a, b in zip(rp, rh):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sched", ["sub", "pair"])
def test_mxu_tritest_reaches_the_schedule_kernels(grid_host, monkeypatch,
                                                  sched):
    """`mxu_tritest` with `sub`, and with `pair`, reaches the `mxu` argument
    of that schedule's kernels (and of the pair walk's fallback, the tile
    walk), from Scene options through intersect_rays / occluded_rays."""
    import rustlight_tpu_torch.accel.pair_walk as pw
    opts = (WalkOptions(sub=4, mxu_tritest=True) if sched == "sub"
            else WalkOptions(pair=True, mxu_tritest=True))
    sd = from_numpy_scene(grid_host, "cpu", walk_options=opts)
    seen = []
    spies = ([(tw, ("walk_sub_closest", "walk_sub_anyhit"))] if sched == "sub"
             else [(pw, ("pair_closest", "pair_anyhit")),
                   (tw, ("walk_closest", "walk_anyhit"))])
    for mod, names in spies:
        for name in names:
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k: (
                seen.append((_n, k.get("mxu"))), _r(*a, **k))[1])
    o = torch.zeros((128, 3)) + torch.tensor([1.5, 1.5, -2.0])
    d = torch.nn.functional.normalize(torch.randn(
        (128, 3), generator=torch.Generator().manual_seed(0)) * 0.2
        + torch.tensor([0.0, 0.0, 1.0]), dim=1)
    rh = intersect_rays(sd.geom, o, d)
    occluded_rays(sd.geom, o, d, torch.full((128,), 1e-4),
                  torch.full((128,), float("inf")))
    assert {n for n, _ in seen} == {n for _, ns in spies for n in ns}
    assert rh.hit.any()
    assert all(mxu is True for _, mxu in seen)


def _cuda_soup(soup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    _, wt, _, o, d = soup
    wt = tw.walk_tables_to(wt, "cuda")
    tnear, tfar, tfar_occ = _ranges(False)
    args = [_t(x, "cuda") for x in (o, d, tnear)]
    return (wt, tw._prepare(wt, *args, _t(tfar, "cuda"))[:4],
            tw._prepare(wt, *args, _t(tfar_occ, "cuda"))[:4])


def _assert_kernel_pair(mod, names, closest, anyhit, closest_ref, anyhit_ref):
    before = dict(mod.LAUNCHES)
    out, occ = closest(), anyhit()
    torch.cuda.synchronize()
    for name in names:
        assert mod.LAUNCHES[name] == before[name] + 1
    for a, b in zip(out, closest_ref()):
        assert torch.equal(a, b)
    assert torch.equal(occ, anyhit_ref()[0])


@pytest.mark.cuda
@pytest.mark.parametrize("heap", ["shared", "global"])
def test_cuda_wide_kernels_match_plain_versions(soup, heap):
    wt, srt, srt_occ = _cuda_soup(soup)
    _assert_kernel_pair(
        wk, ("walk_closest_wide", "walk_anyhit_wide"),
        lambda: wk.walk_closest(wt, *srt, wide=True, heap=heap),
        lambda: wk.walk_anyhit(wt, *srt_occ, wide=True, heap=heap),
        lambda: wk.walk_closest_ref(wt, *srt, wide=True),
        lambda: wk.walk_anyhit_ref(wt, *srt_occ, wide=True))


@pytest.mark.cuda
@pytest.mark.parametrize("sub", [2, 4, 8])
def test_cuda_sub_kernels_match_plain_versions(soup, sub):
    wt, srt, srt_occ = _cuda_soup(soup)
    _assert_kernel_pair(
        wsub, ("walk_sub_closest", "walk_sub_anyhit"),
        lambda: wsub.walk_sub_closest(wt, *srt, sub),
        lambda: wsub.walk_sub_anyhit(wt, *srt_occ, sub),
        lambda: wsub.walk_sub_closest_ref(wt, *srt, sub),
        lambda: wsub.walk_sub_anyhit_ref(wt, *srt_occ, sub))


@pytest.mark.cuda
def test_cuda_sparse_kernels_match_plain_versions(soup):
    wt, srt, srt_occ = _cuda_soup(soup)
    _assert_kernel_pair(
        ws, ("walk_sparse_closest", "walk_sparse_anyhit"),
        lambda: ws.walk_sparse_closest(wt, *srt),
        lambda: ws.walk_sparse_anyhit(wt, *srt_occ),
        lambda: ws.walk_sparse_closest_ref(wt, *srt),
        lambda: ws.walk_sparse_anyhit_ref(wt, *srt_occ))

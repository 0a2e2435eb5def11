"""The port's pair walk (accel/pair_walk.py, ops/pair_trace.py) against the
JAX package's (rustlight_tpu/accel/pair_walk.py).

On the 1,500-triangle soup and the 512 rays of tests/test_pallas_walk.py
(numpy, seed 7), the JAX package's resident tables go to the port through
walk_tables_from_numpy. At km = 8 and at km = 2, which makes most rays
overflow their shortlist and re-trace through the tile walk:
  - intersect_pairs / occluded_pairs (tfar = 2.2) of the JAX package, its
    Pallas kernels run by the interpreter, against the port's on the same
    rays: hit masks, triangle ids and occlusion equal, t within T_RTOL
    (relative), u/v within UV_TOL of the magnitudes that cancel (XLA on the
    CPU contracts products into FMAs; the port does not);
  - the port against its own dense plain version over all 1,500 triangles:
    ids equal, t/u/v within TOL (absolute).
The shortlist is held to the reference's where a ray's entries are distinct
(lax.top_k takes the lowest index among equal entries, torch.topk promises
no order; the final hits do not depend on it). The pair kernels' plain
version is held to the dense plain version restricted to each pair's
cluster. A test marked `cuda` holds the CUDA kernels to their plain
versions on a card (expected bit-identical).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustlight_tpu.accel.pair_walk as JP
import rustlight_tpu.accel.pallas_walk as W
from rustlight_tpu.scene.geometry import (
    TriMesh as JaxTriMesh, build_geometry_tables as jax_build_geometry)
from rustlight_tpu_torch.accel import pair_walk as pw
from rustlight_tpu_torch.accel import walk as tw
from rustlight_tpu_torch.ops import dense_trace as dt
from rustlight_tpu_torch.ops import pair_trace as pt
from rustlight_tpu_torch.ops import walk_trace as wk

torch.set_num_threads(2)

NR = 512
TOL = 1e-6
T_RTOL, UV_TOL = 1e-6, 1e-5
TFAR_OCC = 2.2
KMS = (8, 2)


def _t(x, device="cpu"):
    return torch.as_tensor(np.asarray(x), device=device)


@pytest.fixture(scope="module")
def soup():
    """Geometry, both packages' tables and the rays of
    tests/test_pallas_walk.py:18-37, with its ranges."""
    rng = np.random.default_rng(7)
    nt = 1500
    c = rng.uniform(-1, 1, (nt, 3)).astype(np.float32)
    vs = [c + rng.normal(0, .06, (nt, 3)).astype(np.float32) for _ in range(3)]
    verts = np.concatenate(vs, 0).astype(np.float32)
    idx = np.arange(3 * nt).reshape(3, nt).T.astype(np.int32)
    o = rng.uniform(-2.5, -1.8, (NR, 3)).astype(np.float32)
    d = c[rng.integers(0, nt, NR)] - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jgeom = jax_build_geometry([JaxTriMesh(vertices=verts, indices=idx,
                                           material=0)], [-1])
    jwt = W.build_walk_tables(jgeom)
    wt = tw.walk_tables_to(jwt, "cpu")
    tnear = np.full(NR, 1e-4, np.float32)
    tfar = np.full(NR, np.inf, np.float32)
    tfar_occ = np.full(NR, TFAR_OCC, np.float32)
    return jwt, wt, np.asarray(jgeom.inter_rows), (o, d, tnear, tfar, tfar_occ)


@pytest.fixture(scope="module")
def jax_results(soup):
    """Both km through the JAX package once, all outputs fetched at once."""
    jwt, _, _, (o, d, tnear, tfar, tfar_occ) = soup
    args = [jnp.asarray(x) for x in (o, d, tnear)]
    out = {}
    for km in KMS:
        rh = JP._pairs_impl(jwt, *args, jnp.asarray(tfar), False, True, km)
        occ = JP._pairs_impl(jwt, *args, jnp.asarray(tfar_occ), True, True, km)
        out[km] = ([np.asarray(x) for x in (rh.t, rh.tri, rh.u, rh.v)],
                   np.asarray(occ))
    return out


def _port(wt, rays, km):
    o, d, tnear, tfar, tfar_occ = (_t(x) for x in rays)
    rh = pw.intersect_pairs(wt, o, d, tnear, tfar, km=km)
    occ = pw.occluded_pairs(wt, o, d, tnear, tfar_occ, km=km)
    assert torch.equal(rh.hit, rh.tri >= 0)
    return [x.numpy() for x in (rh.t, rh.tri, rh.u, rh.v)], occ.numpy()


def _assert_agree(ref, got, t_rtol=0.0, t_atol=TOL, uv_mag=None):
    (t_r, i_r, u_r, v_r), occ_r = ref
    (t_g, i_g, u_g, v_g), occ_g = got
    hit = i_g >= 0
    np.testing.assert_array_equal(i_r, i_g)
    np.testing.assert_array_equal(np.isfinite(t_g), hit)
    np.testing.assert_array_equal(occ_r, occ_g)
    assert hit.mean() > 0.5 and 0 < occ_g.sum() < NR
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


@pytest.mark.parametrize("km", KMS)
def test_pairs_match_pallas_kernels(soup, jax_results, km):
    _, wt, rows, rays = soup
    _assert_agree(jax_results[km], _port(wt, rays, km), t_rtol=T_RTOL,
                  t_atol=0.0, uv_mag=(rows, rays[0], rays[1]))


@pytest.mark.parametrize("km", KMS)
def test_pairs_match_dense_plain_version(soup, km):
    _, wt, rows, rays = soup
    o, d, tnear, tfar, tfar_occ = rays
    args = [_t(x) for x in (rows, o, d, tnear)]
    ref = ([x.numpy() for x in dt.dense_closest_ref(*args, _t(tfar))],
           dt.dense_anyhit_ref(*args, _t(tfar_occ)).numpy())
    _assert_agree(ref, _port(wt, rays, km))


@pytest.mark.parametrize("km", KMS)
def test_shortlist_equals_jax_where_entries_are_distinct(soup, km):
    jwt, wt, _, (o, d, tnear, tfar, _) = soup
    jc, jcut = JP._shortlist(jwt, *(jnp.asarray(x)
                                    for x in (o, d, tnear, tfar)), km)
    jc, jcut = np.asarray(jc), np.asarray(jcut)
    tc, tcut = pw._shortlist(wt, *(_t(x) for x in (o, d, tnear, tfar)), km)
    assert tc.dtype == torch.int32 and tc.shape == (NR, km)
    np.testing.assert_array_equal(jcut, tcut.numpy())
    ent = wk._ray_entries(wt.lo, wt.hi, _t(o)[None], wk._slab_inv(_t(d))[None],
                          _t(tnear)[None], _t(tfar)[None])[0].numpy()
    fin = np.sort(np.where(np.isfinite(ent), ent, np.nan), axis=1)
    distinct = ~(np.diff(fin, axis=1) == 0).any(axis=1)
    assert distinct.mean() > 0.9
    np.testing.assert_array_equal(jc[distinct], tc.numpy()[distinct])
    # the soup has 6 clusters: km = 8 lists them all, km = 2 overflows
    overflow = np.isfinite(tcut.numpy())
    assert (overflow.mean() > 0.5) if km == 2 else not overflow.any()
    entered = np.isfinite(ent[:, :wt.n_real]).sum(axis=1)
    np.testing.assert_array_equal((tc.numpy() == pw._BIGI).sum(axis=1),
                                  np.maximum(km - entered, 0))
    np.testing.assert_array_equal(overflow, entered > km)


def test_pair_plain_version_is_the_dense_test_of_one_cluster(soup):
    """Each pair against the dense plain version over its cluster's 384 rows
    only; inert ids (negative, pads, past the end) report a miss."""
    _, wt, _, (o, d, tnear, tfar, _) = soup
    rng = np.random.default_rng(3)
    m = 256
    lane = rng.integers(0, NR, m)
    cid = rng.integers(-2, wt.n_real + 3, m).astype(np.int32)
    cid[:8] = (-1, wt.n_real, wt.n_clusters - 1, pw._BIGI, 0, 0, 1, 2)
    tcap = np.where(np.arange(m) % 5 == 0, 3.0, np.inf).astype(np.float32)
    args = [_t(x) for x in (o[lane], d[lane], tnear[lane], tcap, cid)]
    t, tri, u, v, n_live = pt.pair_closest_ref(wt, *args)
    occ, n_live_a = pt.pair_anyhit_ref(wt, *args)
    live = (cid >= 0) & (cid < wt.n_real)
    assert n_live == n_live_a == live.sum() and 0 < live.sum() < m
    assert not (tri.numpy()[~live] >= 0).any() and not occ.numpy()[~live].any()
    rows = wt.rows.view(wt.n_clusters, 384, 3, 4)
    ids = wt.ids.view(wt.n_clusters, 384)
    hits = 0
    for k in np.nonzero(live)[0]:
        one = [x[k:k + 1] for x in args[:4]]
        rt, rj, ru, rv = dt.dense_closest_ref(rows[cid[k]], *one)
        found = bool(torch.isfinite(rt[0]))
        if found:
            hits += 1
            assert int(tri[k]) == int(ids[cid[k], rj[0]])
            assert (t[k], u[k], v[k]) == (rt[0], ru[0], rv[0])
        else:
            assert int(tri[k]) == -1 and float(t[k]) == float("inf")
        assert bool(occ[k]) == found
    assert hits > 10
    out = pt.pair_closest(wt, *args)
    for a, b in zip(out, (t, tri, u, v)):
        assert torch.equal(a, b)
    assert torch.equal(pt.pair_anyhit(wt, *args), occ)
    assert not any(pt.LAUNCHES.values())


def test_km_2_really_retraces(soup, monkeypatch):
    """The fallback walks the overflowing rays alone, unsorted, every other
    lane inert; at km = 8 no lane of this soup needs it."""
    _, wt, _, (o, d, tnear, tfar, _) = soup
    seen = []
    real = pw._walk_impl
    monkeypatch.setattr(pw, "_walk_impl", lambda wt, o, d, tn, tf, *a, **k: (
        seen.append((int((tf > 0).sum()), k.get("sort_rays"),
                     wt.options.pair)), real(wt, o, d, tn, tf, *a, **k))[1])
    wt = wt._replace(options=tw.WalkOptions(pair=True))
    args = [_t(x) for x in (o, d, tnear, tfar)]
    pw.intersect_pairs(wt, *args, km=2)
    pw.intersect_pairs(wt, *args, km=8)
    assert seen[0][0] > 0 and seen[1][0] == 0
    assert all(s[1:] == (False, False) for s in seen)


def test_pair_inputs_are_checked(soup):
    _, wt, _, (o, d, tnear, tfar, _) = soup
    args = [_t(x) for x in (o, d, tnear, tfar)]
    big = wt._replace(n_clusters=768)
    with pytest.raises(ValueError, match="640 clusters"):
        pw.intersect_pairs(big, *args)
    with pytest.raises(ValueError, match="km must"):
        pw.occluded_pairs(wt, *args, km=0)
    cid = torch.zeros(NR, dtype=torch.int32)
    with pytest.raises(ValueError, match="64-pair"):
        pt.pair_closest(wt, *(x[:100] for x in args), cid[:100])
    with pytest.raises(TypeError):
        pt.pair_anyhit(wt, *args, cid.long())


@pytest.mark.cuda
@pytest.mark.parametrize("km", KMS)
def test_cuda_pair_kernels_match_plain_versions(soup, km):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    _, wt, _, (o, d, tnear, tfar, tfar_occ) = soup
    wt = tw.walk_tables_to(wt, "cuda")
    o, d, tnear, tfar, tfar_occ = (_t(x, "cuda")
                                   for x in (o, d, tnear, tfar, tfar_occ))
    cids, _ = pw._shortlist(wt, o, d, tnear, tfar, km)
    rep = lambda x: x.repeat_interleave(km, dim=0).contiguous()
    pairs = [rep(o), rep(d), rep(tnear), rep(tfar), cids.reshape(-1)]
    before = dict(pt.LAUNCHES)
    out = pt.pair_closest(wt, *pairs)
    pairs[3] = rep(tfar_occ)
    occ = pt.pair_anyhit(wt, *pairs)
    torch.cuda.synchronize()
    assert pt.LAUNCHES["pair_closest"] == before["pair_closest"] + 1
    assert pt.LAUNCHES["pair_anyhit"] == before["pair_anyhit"] + 1
    assert torch.equal(occ, pt.pair_anyhit_ref(wt, *pairs)[0])
    pairs[3] = rep(tfar)
    for a, b in zip(out, pt.pair_closest_ref(wt, *pairs)):
        assert torch.equal(a, b)
    # and the whole pair walk, fallback included, against the tile walk
    rh = pw.intersect_pairs(wt, o, d, tnear, tfar, km=km)
    ref = tw._walk_impl(wt, o, d, tnear, tfar, False)
    for a, b in zip(rh, ref):
        assert torch.equal(a, b)

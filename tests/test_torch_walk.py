"""The port's tile walk (accel/bvh.py, accel/walk.py, ops/walk_trace.py)
against the JAX package's.

On the 1,500-triangle soup of tests/test_pallas_walk.py, the same numpy
inputs go to both packages:
  - the BVH (both builders) and the walk tables (the JAX package's resident
    and HBM layouts, converted) are EQUAL, array for array;
  - the morton sort key is equal as integers; the incidence key has equal
    overlap counts and an equal major key on at least INC_KEY_FRAC of the
    lanes (its centroid is an [N, C] @ [C, 3] product that the two
    packages may sum in another order, which can move a lane across a
    morton bin edge);
  - the plain walk versions, through `_walk_impl(sort_rays=False)`, match
    the TPU kernels K3 (resident tables) and K4 (HBM tables) run by
    Pallas's interpreter on the same tiles: hit masks and occlusion are
    equal, triangle ids equal except on near-ties (the two nearest valid t
    within TIE_RTOL), t within T_TOL of the magnitudes that cancel in
    t = -(o.N + N_w) / Nd, u and v within UV_TOL of the magnitudes that
    cancel in u = o4.U + t d4.U (XLA on the CPU contracts products into
    FMAs; the port does not; rays from 2.5 units away hitting triangles
    0.1 units wide cancel terms near 50 down to u in [0, 1]);
  - the port's intersect_rays/occluded_rays on a walk scene, sort
    included, match the JAX package's dense oracle under the same rules.
A test marked `cuda` holds the CUDA kernels to their plain versions on a
card (expected bit-identical).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustlight_tpu.accel.pallas_walk as W
from rustlight_tpu.accel.bvh import build_bvh as jax_build_bvh
from rustlight_tpu.accel.dense import _intersect_impl
from rustlight_tpu.scene.geometry import (
    TriMesh as JaxTriMesh, build_geometry_tables as jax_build_geometry)
from rustlight_tpu_torch.accel import intersect_rays, occluded_rays
from rustlight_tpu_torch.accel import walk as tw
from rustlight_tpu_torch.accel.bvh import build_bvh
from rustlight_tpu_torch.ops import dense_trace as dt
from rustlight_tpu_torch.ops import walk_trace as wk
from rustlight_tpu_torch.scene.geometry import (TriMesh, build_geometry_tables,
                                                geometry_to)

from walk_soup import N_RAYS, _rays, _sanitized, _soup_mesh, _t

torch.set_num_threads(2)

TIE_RTOL = 1e-5
T_TOL = 1e-5
UV_TOL = 1e-5
INC_KEY_FRAC = 0.999


@pytest.fixture(scope="module")
def soup():
    verts, idx, centers = _soup_mesh()
    jgeom = jax_build_geometry([JaxTriMesh(verts, idx)], [-1])
    tgeom = build_geometry_tables([TriMesh(verts, idx)], [-1])
    return jgeom, tgeom, centers


def _assert_agree(rows, o, d, tnear, tfar, ref, port):
    """ref/port: ((t, tri, u, v), occ) as numpy, for sanitized ranges."""
    (t_r, i_r, u_r, v_r), occ_r = ref
    (t_p, i_p, u_p, v_p), occ_p = port
    hit = i_p >= 0
    np.testing.assert_array_equal(i_r >= 0, hit)
    np.testing.assert_array_equal(np.isfinite(t_p), hit)
    np.testing.assert_array_equal(occ_r, occ_p)
    np.testing.assert_array_equal(occ_p, hit)    # same range, same answer
    assert not hit[~(tnear < tfar)].any()
    assert 0.1 < hit.mean() < 0.9, hit.mean()
    for lane in np.nonzero(i_r != i_p)[0]:
        tt, _, _, valid = dt._chunk_test(
            _t(rows), *(_t(x[lane:lane + 1]) for x in (o, d, tnear, tfar)))
        t2 = np.sort(tt[valid].numpy())
        assert len(t2) >= 2 and t2[1] - t2[0] <= TIE_RTOL * t2[0], lane
    same = hit & (i_r == i_p)
    n4 = rows[i_p[same], 0]
    mag = (np.abs(np.einsum("mk,mk->m", o[same], n4[:, :3]))
           + np.abs(n4[:, 3]) + np.abs(t_p[same]))
    nd = np.abs(np.einsum("mk,mk->m", d[same], n4[:, :3]))
    assert np.all(np.abs(t_r[same] - t_p[same]) * nd <= T_TOL * mag)
    for k, (a, b) in enumerate(((u_r, u_p), (v_r, v_p)), start=1):
        r = rows[i_p[same], k]
        mag_uv = (np.abs(o[same] * r[:, :3]).sum(1) + np.abs(r[:, 3])
                  + np.abs(t_p[same, None] * d[same] * r[:, :3]).sum(1))
        assert np.all(np.abs(a[same] - b[same]) <= UV_TOL * mag_uv)


@pytest.mark.parametrize("builder", ["binned", "sweep"])
def test_bvh_equals_jax(soup, builder):
    jgeom, tgeom, _ = soup
    jb = jax_build_bvh(jgeom, max_leaf=8, builder=builder)
    tb = build_bvh(tgeom, max_leaf=8, builder=builder)
    assert tb.n_nodes == jb.n_nodes and tb.leaf_size == jb.leaf_size == 8
    for f in ("bbox_lo", "bbox_hi", "skip", "prim_start", "prim_count",
              "inter_rows", "prim_index"):
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("layout", ["resident", "hbm"])
def test_walk_tables_equal_jax(soup, monkeypatch, layout):
    jgeom, tgeom, _ = soup
    if layout == "hbm":
        monkeypatch.setattr(W, "MAX_VMEM_CLUSTERS", 1)
    jwt = W.build_walk_tables(jgeom)
    assert jwt.resident == (layout == "resident")
    conv = tw.walk_tables_from_numpy(jwt)
    port = tgeom.walk
    assert port is not None and port.n_real == jwt.n_real == 6
    for f in tw.WalkTables._fields:
        a, b = getattr(conv, f), getattr(port, f)
        if isinstance(b, (int, tuple)):          # counts, schedule options
            assert a == b, f
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert port.rows.shape == (128 * 384, 3, 4)
    assert (port.ids >= 0).sum() == 1500


def test_sort_keys_match_jax(soup):
    jgeom, tgeom, centers = soup
    jwt = W.build_walk_tables(jgeom)
    wt = tw.walk_tables_to(tgeom.walk, "cpu")
    o, d, tnear, tfar = _rays(centers, seed=1)
    tnear, tfar = _sanitized(tnear, tfar)
    jm = W._sort_key(jwt, jnp.asarray(o), jnp.asarray(d))
    tm = tw._sort_key(wt, _t(o), _t(d))
    for a, b in zip(jm, tm):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jmaj, jcnt = W._incidence_key(jwt, *(jnp.asarray(x)
                                         for x in (o, d, tnear, tfar)))
    tmaj, tcnt = tw._incidence_key(wt, *(_t(x) for x in (o, d, tnear, tfar)))
    np.testing.assert_array_equal(np.asarray(jcnt), tcnt.numpy())
    assert tcnt.numpy()[tfar == 0].max() == 0 and tcnt.numpy().max() > 1
    same = np.asarray(jmaj) == tmaj.numpy()
    assert same.mean() >= INC_KEY_FRAC, same.mean()


@pytest.mark.parametrize("layout", ["resident", "hbm"])
def test_plain_walk_matches_pallas_kernels(soup, monkeypatch, layout):
    """K3 (resident) and K4 (HBM) in interpret mode against the plain
    versions, on the same unsorted tiles."""
    jgeom, tgeom, centers = soup
    if layout == "hbm":
        monkeypatch.setattr(W, "MAX_VMEM_CLUSTERS", 1)
    jwt = W.build_walk_tables(jgeom)
    wt = tw.walk_tables_to(tgeom.walk, "cpu")
    o, d, tnear, tfar = _rays(centers, seed=2)
    jargs = [jnp.asarray(x) for x in (o, d, tnear, tfar)]
    jr = W._walk_impl(jwt, *jargs, False, interpret=True, sort_rays=False)
    jocc = W._walk_impl(jwt, *jargs, True, interpret=True, sort_rays=False)
    targs = [_t(x) for x in (o, d, tnear, tfar)]
    tr = tw._walk_impl(wt, *targs, False, sort_rays=False)
    tocc = tw._walk_impl(wt, *targs, True, sort_rays=False)
    assert tr.t.shape == (N_RAYS,) and tocc.dtype == torch.bool
    _assert_agree(tgeom.inter_rows, o, d, *_sanitized(tnear, tfar),
                  ([np.asarray(x) for x in (jr.t, jr.tri, jr.u, jr.v)],
                   np.asarray(jocc)),
                  ([x.numpy() for x in (tr.t, tr.tri, tr.u, tr.v)],
                   tocc.numpy()))


@pytest.mark.parametrize("origins", ["spread", "point"])
def test_intersect_on_a_walk_scene_matches_dense_oracle(soup, origins):
    """Sorted by the incidence key (spread origins) or the morton key (a
    point origin), walked and put back in lane order."""
    jgeom, tgeom, centers = soup
    geom = geometry_to(tgeom, "cpu")
    assert geom.walk is not None and geom.walk.rows.device.type == "cpu"
    o, d, tnear, tfar = _rays(centers, seed=3)
    tnear, tfar = _sanitized(tnear, tfar)
    if origins == "point":
        o[:] = o[0]
    rh = intersect_rays(geom, _t(o), _t(d), _t(tnear), _t(tfar))
    occ = occluded_rays(geom, _t(o), _t(d), _t(tnear), _t(tfar))
    jargs = [jnp.asarray(x) for x in (o, d, tnear, tfar)]
    ref = _intersect_impl(jnp.asarray(jgeom.inter_rows), *jargs, False)
    ref_occ = _intersect_impl(jnp.asarray(jgeom.inter_rows), *jargs, True)
    np.testing.assert_array_equal(rh.hit.numpy(), rh.tri.numpy() >= 0)
    _assert_agree(tgeom.inter_rows, o, d, tnear, tfar,
                  ([np.asarray(x) for x in (ref.t, ref.tri, ref.u, ref.v)],
                   np.asarray(ref_occ)),
                  ([x.numpy() for x in (rh.t, rh.tri, rh.u, rh.v)],
                   occ.numpy()))


def test_sorted_walk_equals_unsorted_walk(soup):
    """Sorting changes which rays share a tile, never the answer (up to
    exact ties, of which this soup has none)."""
    _, tgeom, centers = soup
    wt = tw.walk_tables_to(tgeom.walk, "cpu")
    args = [_t(x) for x in _rays(centers, seed=4)]
    a = tw._walk_impl(wt, *args, False, sort_rays=True)
    b = tw._walk_impl(wt, *args, False, sort_rays=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(tw._walk_impl(wt, *args, True),
                       tw._walk_impl(wt, *args, True, sort_rays=False))


def test_wrappers_take_plain_versions_on_cpu(soup):
    _, tgeom, centers = soup
    wt = tw.walk_tables_to(tgeom.walk, "cpu")
    o, d, tnear, tfar = tw._prepare(wt, *(_t(x) for x in _rays(centers)),
                                    sort_rays=False)[:4]
    assert o.shape[0] == 1024 and not tfar[N_RAYS:].any()
    wk.reset_launches()
    with dt.counting_rays("cpu") as n_rays:
        closest = wk.walk_closest(wt, o, d, tnear, tfar)
        occ = wk.walk_anyhit(wt, o, d, tnear, tfar)
    assert wk.LAUNCHES == {"walk_closest": 0, "walk_anyhit": 0,
                           "walk_closest_wide": 0, "walk_anyhit_wide": 0,
                           "walk_closest_mma": 0, "walk_anyhit_mma": 0,
                           "walk_closest_wide_mma": 0,
                           "walk_anyhit_wide_mma": 0}
    assert int(n_rays) == 2 * int((tfar > 0).sum())
    t, tri, u, v, visits = wk.walk_closest_ref(wt, o, d, tnear, tfar)
    for a, b in zip(closest, (t, tri, u, v)):
        assert torch.equal(a, b)
    ref_occ, occ_visits = wk.walk_anyhit_ref(wt, o, d, tnear, tfar)
    assert torch.equal(occ, ref_occ)
    # every tile pops at least one pair; no tile pops more than Cp pairs
    assert 2 * 16 <= occ_visits <= visits <= 2 * 16 * wt.n_clusters


def test_walk_inputs_are_checked(soup):
    _, tgeom, centers = soup
    wt = tw.walk_tables_to(tgeom.walk, "cpu")
    o, d, tnear, tfar = tw._prepare(wt, *(_t(x) for x in _rays(centers)),
                                    sort_rays=False)[:4]
    with pytest.raises(ValueError, match="64-ray tiles"):
        wk.walk_closest(wt, o[:100], d[:100], tnear[:100], tfar[:100])
    with pytest.raises(TypeError):
        wk.walk_anyhit(wt, o.double(), d, tnear, tfar)
    with pytest.raises(ValueError):
        wk.walk_closest(wt._replace(ids=wt.ids[:-1]), o, d, tnear, tfar)
    with pytest.raises(ValueError):
        wk.walk_anyhit(wt, o, d.t().contiguous().t(), tnear, tfar)


def test_scenes_past_the_packed_budget_raise(soup, monkeypatch):
    """Past MAX_CLUSTERS (2^17, the two-level walk's ceiling, as in the
    reference) building or converting tables raises."""
    jgeom, tgeom, _ = soup
    monkeypatch.setattr(tw, "MAX_CLUSTERS", 64)
    with pytest.raises(NotImplementedError, match="K5"):
        tw.build_walk_tables(tgeom)
    with pytest.raises(NotImplementedError, match="K5"):
        tw.walk_tables_from_numpy(W.build_walk_tables(jgeom))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(soup):
    """On a card: the CUDA walk kernels against their plain versions on
    sorted, spread-origin tiles (expected bit-identical)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    _, tgeom, centers = soup
    wt = tw.walk_tables_to(tgeom.walk, "cuda")
    rays = [_t(x, "cuda") for x in _rays(centers, seed=5)]
    o, d, tnear, tfar, _ = tw._prepare(wt, *rays)
    before = dict(wk.LAUNCHES)
    closest = wk.walk_closest(wt, o, d, tnear, tfar)
    occ = wk.walk_anyhit(wt, o, d, tnear, tfar)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["walk_closest"] == before["walk_closest"] + 1
    assert wk.LAUNCHES["walk_anyhit"] == before["walk_anyhit"] + 1
    for a, b in zip(closest, wk.walk_closest_ref(wt, o, d, tnear, tfar)):
        assert torch.equal(a, b)
    assert torch.equal(occ, wk.walk_anyhit_ref(wt, o, d, tnear, tfar)[0])

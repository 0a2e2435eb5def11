"""The port's two-level walk (accel/walk.py super tables and route,
ops/walk_hier.py) against the JAX package's K5 and against the port's own
one-level and dense plain versions.

  - On the 1,500-triangle soup of tests/test_pallas_walk.py, the port's
    super tables equal the JAX package's (built on its HBM layout, as that
    file's hier tests do) field for field, and the plain two-level walk,
    forced with hier=True on the same unsorted tiles, matches the TPU kernel
    run by Pallas's interpreter: hit masks, ids and occlusion (tfar = 2.2)
    equal, t within T_RTOL (relative), u and v within UV_TOL of the
    magnitudes that cancel in u = o4.U + t d4.U (XLA on the CPU contracts
    products into FMAs and the port does not; rays from 2.5 units away
    hitting triangles 0.1 units wide cancel terms near 50).
  - On the tables of sphere_grid_mesh(122_000) (378 clusters, 3 supers), the
    plain two-level walk matches the one-level walk and the dense brute
    force on 512 rays, 256 from one point and 256 from spread points: hits,
    occlusion and t, u, v equal, triangle ids equal except on near-ties
    (two nearest valid t within TIE_RTOL), where the visit order picks the
    winner.
A test marked `cuda` holds the CUDA kernels to their plain versions on a
card (expected bit-identical).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustlight_tpu.accel.pallas_walk as W
from rustlight_tpu.scene.geometry import (
    TriMesh as JaxTriMesh, build_geometry_tables as jax_build_geometry)
from rustlight_tpu_torch.accel import walk as tw
from rustlight_tpu_torch.models.presets import sphere_grid_mesh
from rustlight_tpu_torch.ops import dense_trace as dt
from rustlight_tpu_torch.ops import native
from rustlight_tpu_torch.ops import walk_hier as wh
from rustlight_tpu_torch.ops import walk_trace as wk
from rustlight_tpu_torch.scene.geometry import TriMesh, build_geometry_tables

torch.set_num_threads(2)

T_RTOL, UV_TOL = 1e-6, 1e-5
TIE_RTOL = 1e-5
N_GRID_RAYS = 256      # per wavefront


def _soup():
    """The soup of tests/test_pallas_walk.py and its 512 rays, aimed from
    outside at the triangles' centres (the same generator calls)."""
    rng = np.random.default_rng(7)
    nt = 1500
    c = rng.uniform(-1, 1, (nt, 3)).astype(np.float32)
    vs = [c + rng.normal(0, .06, (nt, 3)).astype(np.float32) for _ in range(3)]
    verts = np.concatenate(vs, 0).astype(np.float32)
    idx = np.arange(3 * nt).reshape(3, nt).T.astype(np.int32)
    nr = 512
    o = rng.uniform(-2.5, -1.8, (nr, 3)).astype(np.float32)
    d = c[rng.integers(0, nt, nr)] - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return verts, idx, o, d.astype(np.float32)


@pytest.fixture(scope="module")
def soup():
    verts, idx, o, d = _soup()
    jgeom = jax_build_geometry([JaxTriMesh(verts, idx)], [-1])
    tgeom = build_geometry_tables([TriMesh(verts, idx)], [-1])
    return jgeom, tgeom, o, d


@pytest.fixture(scope="module")
def grid():
    mesh, gs = sphere_grid_mesh(122_000, n_theta=10)
    geom = build_geometry_tables([mesh], [-1])
    return geom, tw.walk_tables_to(geom.walk, "cpu"), gs * 3.0


def _t(x, device="cpu"):
    return torch.as_tensor(np.asarray(x), device=device)


def test_super_tables_equal_jax(soup, monkeypatch):
    jgeom, tgeom, _, _ = soup
    monkeypatch.setattr(W, "MAX_VMEM_CLUSTERS", 1)
    jwt = W.build_walk_tables(jgeom)
    port = tgeom.walk
    assert not jwt.resident and port.n_real == jwt.n_real == 6
    assert (port.n_sup, port.n_sup_pad) == (jwt.n_sup, jwt.n_sup_pad) == (1, 128)
    for f in ("slo", "shi"):
        a, b = np.asarray(getattr(jwt, f)), getattr(port, f)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, f
        for col in range(a.shape[1]):
            np.testing.assert_array_equal(a[:, col], b[:, col],
                                          err_msg=f"{f}[:, {col}]")
    conv = tw.walk_tables_from_numpy(jwt)
    assert (conv.n_sup, conv.n_sup_pad) == (1, 128)
    np.testing.assert_array_equal(conv.slo, port.slo)


def test_super_tables_union_real_children(grid):
    geom, _, _ = grid
    wt = geom.walk
    c = wt.n_real
    assert (wt.n_clusters, c, wt.n_sup, wt.n_sup_pad) == (384, 378, 3, 128)
    for s in range(wt.n_sup):
        r0, r1 = s * wh.SUP, min((s + 1) * wh.SUP, c)
        np.testing.assert_array_equal(wt.slo[:, s], wt.lo[:, r0:r1].min(1))
        np.testing.assert_array_equal(wt.shi[:, s], wt.hi[:, r0:r1].max(1))
    assert (wt.slo[:, wt.n_sup:] == tw._BIG).all()
    assert (wt.shi[:, wt.n_sup:] == tw._BIG).all()


def test_plain_hier_walk_matches_pallas_hier_kernel(soup, monkeypatch):
    """K5 in interpret mode against the plain version on the same tiles."""
    jgeom, tgeom, o, d = soup
    monkeypatch.setattr(W, "MAX_VMEM_CLUSTERS", 1)
    jwt = W.build_walk_tables(jgeom)
    wt = tw.walk_tables_to(tgeom.walk, "cpu")
    n = o.shape[0]
    tnear = np.full(n, 1e-4, np.float32)
    outs = {}
    for far in (np.inf, 2.2):
        tfar = np.full(n, far, np.float32)
        jargs = [jnp.asarray(x) for x in (o, d, tnear, tfar)]
        targs = [_t(x) for x in (o, d, tnear, tfar)]
        any_hit = far != np.inf
        outs[far] = (W._walk_impl(jwt, *jargs, any_hit, interpret=True,
                                  sort_rays=False, hier=True),
                     tw._walk_impl(wt, *targs, any_hit, sort_rays=False,
                                   hier=True))
    jr, tr = outs[np.inf]
    hit = tr.hit.numpy()
    np.testing.assert_array_equal(np.asarray(jr.hit), hit)
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(np.asarray(jr.tri), tr.tri.numpy())
    np.testing.assert_allclose(tr.t.numpy()[hit], np.asarray(jr.t)[hit],
                               rtol=T_RTOL, atol=0)
    rows = tgeom.inter_rows[tr.tri.numpy()[hit]]                 # [m, 3, 4]
    t = tr.t.numpy()[hit, None]
    for k, (a, b) in enumerate(((jr.u, tr.u), (jr.v, tr.v)), start=1):
        r = rows[:, k]
        mag = (np.abs(o[hit] * r[:, :3]).sum(1) + np.abs(r[:, 3])
               + np.abs(t * d[hit] * r[:, :3]).sum(1))
        assert np.all(np.abs(b.numpy()[hit] - np.asarray(a)[hit])
                      <= UV_TOL * mag)
    jocc, tocc = outs[2.2]
    np.testing.assert_array_equal(np.asarray(jocc), tocc.numpy())
    assert 0 < tocc.numpy().mean() < hit.mean()


def _grid_rays(ext, origins, seed=0):
    """Rays from one point outside the grid at random points in it, or
    from random points in it in random directions, a fifth with a bounded
    tfar and every seventh inert (tfar = 0)."""
    rng = np.random.default_rng(seed)
    n = N_GRID_RAYS
    if origins == "point":
        o = np.tile(np.array([ext / 2, ext / 2, -0.35 * ext], np.float32),
                    (n, 1))
        d = rng.uniform(0, ext, (n, 3)).astype(np.float32) - o
    else:
        o = rng.uniform(0, ext, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = np.arange(n)
    tnear = np.full(n, 1e-4, np.float32)
    tfar = np.full(n, np.inf, np.float32)
    tfar[k % 5 == 1] = rng.uniform(0.5, 4.0, (k % 5 == 1).sum())
    tfar[k % 7 == 3] = 0.0
    return [_t(x) for x in (o, d.astype(np.float32), tnear, tfar)]


def _near_ties(rows, o, d, tnear, tfar, lanes):
    t, _, _, valid = dt._chunk_test(rows, o[lanes], d[lanes], tnear[lanes],
                                    tfar[lanes])
    t2 = torch.topk(torch.where(valid, t, float("inf")), 2, dim=1,
                    largest=False).values
    return bool(torch.all(t2[:, 1] - t2[:, 0] <= TIE_RTOL * t2[:, 0]))


@pytest.mark.parametrize("origins", ["point", "spread"])
def test_plain_hier_walk_matches_flat_and_dense(grid, origins):
    geom, wt, ext = grid
    rays = _grid_rays(ext, origins)
    srt = tw._prepare(wt, *rays)[:4]
    hier = wh.walk_hier_closest_ref(wt, *srt)
    flat = wk.walk_closest_ref(wt, *srt)
    rows = _t(geom.inter_rows[:geom.n_tris])
    dense = dt.dense_closest_ref(rows, *srt)
    assert hier[4] > 0 and hier[5] > 0
    hit = hier[1] >= 0
    assert 0.2 < float(hit.float().mean()) < 0.95
    for other in (flat, dense):
        assert torch.equal(other[1] >= 0, hit)
        diff = torch.nonzero(other[1] != hier[1])[:, 0]
        assert _near_ties(rows, *srt, diff) if diff.numel() else True
        same = hit & (other[1] == hier[1])
        for a, b in zip(hier[:4], other[:4]):
            assert torch.equal(a[same], b[same])
    # same range, same answer: occlusion is the dense hit mask
    occ = wh.walk_hier_anyhit_ref(wt, *srt)
    assert torch.equal(occ[0], wk.walk_anyhit_ref(wt, *srt)[0])
    assert torch.equal(occ[0], hit) and occ[2] <= hier[5]


def test_hier_wrappers_take_plain_versions_on_cpu(grid):
    _, wt, ext = grid
    o, d, tnear, tfar = tw._prepare(wt, *_grid_rays(ext, "spread", seed=1),
                                    sort_rays=False)[:4]
    wh.reset_launches()
    with native.counting_rays("cpu") as n_rays:
        closest = wh.walk_hier_closest(wt, o, d, tnear, tfar)
        occ = wh.walk_hier_anyhit(wt, o, d, tnear, tfar)
    assert wh.LAUNCHES == {"walk_hier_closest": 0, "walk_hier_anyhit": 0,
                           "walk_hier_closest_mma": 0,
                           "walk_hier_anyhit_mma": 0}
    assert int(n_rays) == 2 * int((tfar > 0).sum())
    t, tri, u, v, opened, visits = wh.walk_hier_closest_ref(wt, o, d, tnear,
                                                            tfar)
    for a, b in zip(closest, (t, tri, u, v)):
        assert torch.equal(a, b)
    assert torch.equal(occ, wh.walk_hier_anyhit_ref(wt, o, d, tnear, tfar)[0])
    tiles = o.shape[0] // wk.RAY_TILE
    # every tile opens a super; none opens more than Sp
    assert tiles <= opened <= tiles * wt.n_sup_pad and visits >= 2 * tiles
    with pytest.raises(ValueError, match="supers"):
        wh.walk_hier_closest(wt._replace(n_sup=wt.n_sup + 1), o, d, tnear,
                             tfar)
    with pytest.raises(ValueError):
        wh.walk_hier_anyhit(wt._replace(slo=wt.slo[:, :-1]), o, d, tnear,
                            tfar)


def test_walk_route_and_sort_key_past_the_caps(grid, monkeypatch):
    """Past FLAT_MAX_CLUSTERS clusters `_walk_impl` takes the two-level walk;
    past _INC_SORT_MAX_C every wavefront takes the morton key."""
    _, wt, ext = grid
    rays = _grid_rays(ext, "spread", seed=2)
    calls = []
    for name in ("walk_hier_closest", "walk_hier_anyhit"):
        fn = getattr(tw, name)
        monkeypatch.setattr(tw, name, lambda *a, fn=fn, name=name, **kw: (
            calls.append(name), fn(*a, **kw))[1])
    flat = tw._walk_impl(wt, *rays, False)
    assert not calls
    monkeypatch.setattr(tw, "FLAT_MAX_CLUSTERS", wt.n_clusters - 1)
    hier = tw._walk_impl(wt, *rays, False)
    tw._walk_impl(wt, *rays, True)
    assert calls == ["walk_hier_closest", "walk_hier_anyhit"]
    assert torch.equal(flat.hit, hier.hit)
    o_safe = rays[0]
    inc = tw._prepare(wt, *rays)[4]
    kmaj, kmin = tw._sort_key(wt, o_safe, rays[1])
    morton = torch.sort((kmaj.long() << 32) | kmin.long(), stable=True).indices
    assert not torch.equal(inc, morton)
    monkeypatch.setattr(tw, "_INC_SORT_MAX_C", wt.n_clusters - 1)
    assert torch.equal(tw._prepare(wt, *rays)[4], morton)


@pytest.mark.cuda
def test_cuda_hier_kernels_match_plain_versions(grid):
    """On a card: the CUDA two-level walk kernels against their plain
    versions on sorted, spread-origin tiles (expected bit-identical)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    geom, _, ext = grid
    wt = tw.walk_tables_to(geom.walk, "cuda")
    rays = [x.cuda() for x in _grid_rays(ext, "spread", seed=3)]
    o, d, tnear, tfar, _ = tw._prepare(wt, *rays)
    before = dict(wh.LAUNCHES)
    closest = wh.walk_hier_closest(wt, o, d, tnear, tfar)
    occ = wh.walk_hier_anyhit(wt, o, d, tnear, tfar)
    torch.cuda.synchronize()
    assert wh.LAUNCHES["walk_hier_closest"] == before["walk_hier_closest"] + 1
    assert wh.LAUNCHES["walk_hier_anyhit"] == before["walk_hier_anyhit"] + 1
    for a, b in zip(closest, wh.walk_hier_closest_ref(wt, o, d, tnear, tfar)):
        assert torch.equal(a, b)
    assert torch.equal(occ, wh.walk_hier_anyhit_ref(wt, o, d, tnear, tfar)[0])

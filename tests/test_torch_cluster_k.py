"""The walk's cluster size K as a property of the walk tables
(accel/walk.py:build_walk_tables(k=), WalkTables.k, ops/walk_trace.py:
check_k) against the JAX package at K other than 384.

  - The port's tables at K in {128, 256, 768} equal the JAX package's
    built with its module global K patched (as tests/test_pallas_walk.py:
    test_hier_multi_super_traversal does; the JAX files are not edited),
    field by field, dtype by dtype and column by column, on the soup of
    tests/test_pallas_walk.py and on a small sphere grid.
  - The port's plain walks at K = 128, flat and two-level with supers of
    SUP = 4 clusters (the same patch on both sides), equal the JAX
    package's K3 / K5 run by Pallas's interpreter on the same unsorted
    tiles: hit masks, ids and occlusion exactly, t within rtol 1e-5 / atol
    1e-6 (the reference test's tolerance).
  - check_k refuses K = 64, 200 and a K past the static shared memory of
    the kernels; a K = 128 table handed to a library of K = 384 raises,
    as does a table whose rows do not hold its K.
The JAX sides run in module fixtures.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustlight_tpu.accel.pallas_walk as W
from rustlight_tpu.scene.geometry import (
    TriMesh as JaxTriMesh, build_geometry_tables as jax_build_geometry)
from rustlight_tpu_torch.accel import walk as tw
from rustlight_tpu_torch.models.presets import sphere_grid_mesh
from rustlight_tpu_torch.ops import walk_hier as wh
from rustlight_tpu_torch.ops import walk_trace as wk
from rustlight_tpu_torch.scene.geometry import TriMesh, build_geometry_tables

torch.set_num_threads(2)

KS = (128, 256, 768)
T_RTOL, T_ATOL = 1e-5, 1e-6
SUP4 = {"SUP": 4, "_CHILD_BITS": 2}


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


def _geoms(verts, idx):
    return (jax_build_geometry([JaxTriMesh(verts, idx)], [-1]),
            build_geometry_tables([TriMesh(verts, idx)], [-1]))


def _jax_tables(jgeom, k, **patch):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(W, "K", k)
        for name, value in patch.items():
            mp.setattr(W, name, value)
        return W.build_walk_tables(jgeom)


@pytest.fixture(scope="module")
def scenes():
    verts, idx, o, d = _soup()
    mesh, _ = sphere_grid_mesh(3000, n_theta=10)
    return {"soup": (*_geoms(verts, idx), o, d),
            "grid": _geoms(mesh.vertices, mesh.indices)}


def _walk_args(o, d, far):
    n = o.shape[0]
    return (o, d, np.full(n, 1e-4, np.float32), np.full(n, far, np.float32))


@pytest.fixture(scope="module")
def jax_walks(scenes):
    """The JAX package's walk at K = 128 on the soup's rays, unsorted, in
    interpret mode: {"flat": ..., "hier": ...}, each (RayHit, occlusion at
    tfar 2.2), as numpy."""
    jgeom, _, o, d = scenes["soup"]
    out = {}
    for route, patch in (("flat", {}),
                         ("hier", {"MAX_VMEM_CLUSTERS": 1, **SUP4})):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(W, "K", 128)
            for name, value in patch.items():
                mp.setattr(W, name, value)
            jwt = W.build_walk_tables(jgeom)
            hier = route == "hier"
            res = []
            for far in (np.inf, 2.2):
                args = [jnp.asarray(x) for x in _walk_args(o, d, far)]
                r = W._walk_impl(jwt, *args, far != np.inf, interpret=True,
                                 sort_rays=False, hier=hier)
                res.append(jax.tree_util.tree_map(np.asarray, r))
            out[route] = (jwt, *res)
    return out


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("scene", ["soup", "grid"])
def test_walk_tables_at_k_equal_jax(scenes, scene, k):
    jgeom, tgeom = scenes[scene][:2]
    jwt = _jax_tables(jgeom, k)
    port = tw.build_walk_tables(tgeom, k=k)
    conv = tw.walk_tables_from_numpy(jwt)
    assert port.k == conv.k == k and port.n_real == jwt.n_real > 1
    for f in tw.WalkTables._fields:
        a, b = getattr(conv, f), getattr(port, f)
        if isinstance(b, (int, tuple)):          # counts, options, K
            assert a == b, f
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        for col in range(b.shape[-1] if b.ndim == 2 else 1):
            np.testing.assert_array_equal(
                a[:, col] if b.ndim == 2 else a, b[:, col] if b.ndim == 2
                else b, err_msg=f"{f}, column {col}")
    assert port.rows.shape == (port.n_clusters * k, 3, 4)
    assert (port.ids >= 0).sum() == tgeom.n_tris
    # a cluster holds at most K triangles, and the build cuts at K
    per = (port.ids.reshape(port.n_clusters, k) >= 0).sum(1)
    assert per.max() <= k and per[:port.n_real].min() > 0
    up = tw.walk_tables_to(port, "cpu")
    assert up.k == k and tuple(up.rows.shape) == port.rows.shape


def _port_walk(tables, o, d, hier):
    wt = tw.walk_tables_to(tables, "cpu")
    out = []
    for far in (np.inf, 2.2):
        args = [torch.as_tensor(x) for x in _walk_args(o, d, far)]
        out.append(tw._walk_impl(wt, *args, far != np.inf, sort_rays=False,
                                 hier=hier))
    return out


@pytest.mark.parametrize("route", ["flat", "hier"])
def test_plain_walk_at_k128_matches_jax(scenes, jax_walks, route,
                                        monkeypatch):
    _, tgeom, o, d = scenes["soup"]
    jwt, jr, jocc = jax_walks[route]
    tables = tw.build_walk_tables(tgeom, k=128)
    if route == "hier":
        # supers of 4 clusters, as the JAX side's patched SUP
        for name, value in SUP4.items():
            monkeypatch.setattr(wh, name, value)
        monkeypatch.setattr(wh, "_CHILD_MASK", 3)
        monkeypatch.setattr(tw, "SUP", 4)
        ns, sp, slo, shi = tw._super_tables(tables.lo, tables.hi,
                                            tables.n_real)
        tables = tables._replace(n_sup=ns, n_sup_pad=sp, slo=slo, shi=shi)
        assert ns >= 3 and (ns, sp) == (jwt.n_sup, jwt.n_sup_pad)
        np.testing.assert_array_equal(tables.slo, np.asarray(jwt.slo))
        np.testing.assert_array_equal(tables.shi, np.asarray(jwt.shi))
    tr, tocc = _port_walk(tables, o, d, route == "hier")
    hit = tr.hit.numpy()
    np.testing.assert_array_equal(np.asarray(jr.hit), hit)
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(np.asarray(jr.tri), tr.tri.numpy())
    np.testing.assert_allclose(tr.t.numpy()[hit], np.asarray(jr.t)[hit],
                               rtol=T_RTOL, atol=T_ATOL)
    np.testing.assert_array_equal(np.asarray(jocc), tocc.numpy())
    assert 0 < tocc.numpy().mean() < hit.mean()


@pytest.mark.parametrize("k", [64, 200, 1024, 0, -128])
def test_check_k_refuses(scenes, k):
    with pytest.raises(ValueError, match=f"K = {k}"):
        wk.check_k(k)
    with pytest.raises(ValueError):
        tw.build_walk_tables(scenes["grid"][1], k=k)


def test_check_k_names_the_kernel_and_bytes():
    with pytest.raises(ValueError, match=r"walk_sparse_closest needs 52496 B"):
        wk.check_k(1024)
    assert [wk.check_k(k) for k in (128, 384, 896)] == [128, 384, 896]
    one = wk.ONE_THREAD_FORM
    assert wk.static_smem("walk_closest", one) == 20496     # K = 384
    assert wk.static_smem("walk_hier_closest", one, 768) == 36864 + 2832
    assert wk.static_smem("walk_closest", (8, False), 768) == 2128
    assert wk.launch_geometry("walk_anyhit", (8, True), 128, k=128) == (
        512, 2 * 128 * 48 + 4 * 128)


def test_tables_of_another_k_raise(scenes):
    wt = tw.walk_tables_to(tw.build_walk_tables(scenes["grid"][1], k=128),
                           "cpu")
    lib384 = types.SimpleNamespace(rl_kc=lambda: 384)
    with pytest.raises(ValueError, match="K = 128 handed to a library "
                                         "built for K = 384"):
        wk.load_for(wt, "walk_closest", lambda k: lib384)
    n = 64
    rays = [torch.zeros(n, 3), torch.ones(n, 3), torch.zeros(n),
            torch.ones(n)]
    with pytest.raises(ValueError, match="built for K = 384"):
        wk.launch_wide(lib384, False, wt, *rays, (8, False))
    with pytest.raises(ValueError, match="rows must be"):
        wk.walk_closest(wt._replace(k=384), *rays)

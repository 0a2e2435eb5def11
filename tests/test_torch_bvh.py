"""The port's skip-link BVH traversal (accel/bvh.py:intersect_bvh) against
the JAX package's (rustlight_tpu/accel/bvh.py:intersect_bvh).

The same numpy inputs, made from a seed, go to both: a 600-triangle soup of
tests/test_bvh.py's kind (centres in [-5, 5]^3, corners within 0.4) and rays
from a normal cloud around the origin, as that file's `_random_rays` (half of
them aimed at a triangle), for both builders. Hit masks and triangle ids must be equal, t within T_RTOL
(relative); u and v within UV_TOL of the magnitudes that cancel in u = o4.U +
t d4.U (the JAX leaf test is a matrix product on the CPU, the port's the
_dot4-ordered sum: another order of the same f32 roundings). Also: explicit
tnear / tfar ranges, CHECK_EVERY of 1, 3 and 8 giving one result, the port
against its own dense plain version over every triangle (the same
arithmetic: equal), the Cornell box, and empty input. A test marked `cuda`
runs the traversal on a card against the CPU's result.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.accel.bvh import (build_bvh as jax_build_bvh,
                                     intersect_bvh as jax_intersect_bvh)
from rustlight_tpu.scene.geometry import (
    TriMesh as JaxTriMesh, build_geometry_tables as jax_build_geometry)
from rustlight_tpu_torch.accel import bvh as tb
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.ops import dense_trace as dt
from rustlight_tpu_torch.scene.geometry import (TriMesh,
                                                build_geometry_tables)

torch.set_num_threads(2)

N_RAYS = 384
T_RTOL = 1e-6
UV_TOL = 1e-5


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _soup():
    rng = np.random.RandomState(7)
    nt = 600
    c = rng.uniform(-5, 5, (nt, 3)).astype(np.float32)
    v = (c[:, None, :] + rng.uniform(-0.4, 0.4, (nt, 3, 3))).astype(np.float32)
    idx = np.arange(3 * nt, dtype=np.int32).reshape(nt, 3)
    return v.reshape(-1, 3), idx, c


def _rays(centers, n=N_RAYS, radius=6.0, seed=3):
    """Origins from a normal cloud, as tests/test_bvh.py's _random_rays; half
    the directions random, half aimed at a triangle's centre."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * radius).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::2] = centers[rng.integers(0, len(centers), len(d[::2]))] - o[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


RANGES = {
    "default": (None, None),
    "explicit": (np.full(N_RAYS, 0.5, np.float32),
                 np.full(N_RAYS, 9.0, np.float32)),
    "per_lane": (np.linspace(0.0, 3.0, N_RAYS).astype(np.float32),
                 np.linspace(12.0, 3.0, N_RAYS).astype(np.float32)),
}


@pytest.fixture(scope="module")
def soup():
    verts, idx, centers = _soup()
    jgeom = jax_build_geometry([JaxTriMesh(vertices=verts, indices=idx,
                                           material=0)], [-1])
    tgeom = build_geometry_tables([TriMesh(verts, idx)], [-1])
    o, d = _rays(centers)
    return jgeom, tgeom, o, d


@pytest.fixture(scope="module")
def jax_hits(soup):
    """Every (builder, range) through the JAX traversal once."""
    jgeom, _, o, d = soup
    out = {}
    for builder in ("binned", "sweep"):
        bvh = jax_build_bvh(jgeom, max_leaf=8, builder=builder)
        for name, (tn, tf) in RANGES.items():
            rh = jax_intersect_bvh(
                bvh, jnp.asarray(o), jnp.asarray(d),
                None if tn is None else jnp.asarray(tn),
                None if tf is None else jnp.asarray(tf))
            out[builder, name] = [np.asarray(x) for x in
                                  (rh.t, rh.tri, rh.u, rh.v, rh.hit)]
    return out


def _port(tgeom, o, d, builder, rng_name, **kw):
    tn, tf = RANGES[rng_name]
    bvh = tb.bvh_tables_to(tb.build_bvh(tgeom, max_leaf=8, builder=builder),
                           "cpu")
    return tb.intersect_bvh(bvh, _t(o), _t(d),
                            None if tn is None else _t(tn),
                            None if tf is None else _t(tf), **kw)


@pytest.mark.parametrize("rng_name", list(RANGES))
@pytest.mark.parametrize("builder", ["binned", "sweep"])
def test_intersect_bvh_matches_jax(soup, jax_hits, builder, rng_name):
    jgeom, tgeom, o, d = soup
    t_j, i_j, u_j, v_j, hit_j = jax_hits[builder, rng_name]
    rh = _port(tgeom, o, d, builder, rng_name)
    hit = rh.hit.numpy()
    np.testing.assert_array_equal(hit, hit_j)
    np.testing.assert_array_equal(rh.tri.numpy(), i_j)
    assert rh.tri.dtype == torch.int32 and 0.05 < hit.mean() < 0.95
    assert np.all(np.isinf(rh.t.numpy()[~hit])) and np.all(i_j[~hit] == -1)
    np.testing.assert_allclose(rh.t.numpy()[hit], t_j[hit], rtol=T_RTOL)
    rows = np.asarray(jgeom.inter_rows)
    t = rh.t.numpy()
    for k, (a, b) in enumerate(((u_j, rh.u.numpy()), (v_j, rh.v.numpy())),
                               start=1):
        r = rows[i_j[hit], k]
        mag = (np.abs(o[hit] * r[:, :3]).sum(1) + np.abs(r[:, 3])
               + np.abs(t[hit, None] * d[hit] * r[:, :3]).sum(1))
        assert np.all(np.abs(a[hit] - b[hit]) <= UV_TOL * mag)
    tn, tf = RANGES[rng_name]
    if tn is not None:
        assert np.all((t[hit] > tn[hit]) & (t[hit] < tf[hit]))


@pytest.mark.parametrize("builder", ["binned", "sweep"])
def test_check_every_does_not_change_the_result(soup, builder):
    _, tgeom, o, d = soup
    ref, steps = None, {}
    for every in (1, 3, 8):
        stats = {}
        rh = _port(tgeom, o, d, builder, "per_lane", check_every=every,
                   stats=stats)
        steps[every] = stats["steps"]
        assert stats["steps"] % every == 0
        if ref is None:
            ref = rh
        for a, b in zip(rh, ref):
            assert torch.equal(a, b)
    # the exact step count, then the next multiples of 3 and of 8
    assert steps[1] <= steps[3] < steps[1] + 3
    assert steps[1] <= steps[8] < steps[1] + 8


@pytest.mark.parametrize("rng_name", list(RANGES))
def test_intersect_bvh_equals_dense_plain_version(soup, rng_name):
    """The leaf test is the dense tier's arithmetic: equal results."""
    _, tgeom, o, d = soup
    tn, tf = RANGES[rng_name]
    tn = np.full(N_RAYS, 1e-4, np.float32) if tn is None else tn
    tf = np.full(N_RAYS, np.inf, np.float32) if tf is None else tf
    rh = _port(tgeom, o, d, "binned", rng_name)
    rows = _t(tgeom.inter_rows[: tgeom.n_tris])
    t, idx, u, v = dt.dense_closest_ref(rows, _t(o), _t(d), _t(tn), _t(tf))
    assert torch.equal(rh.tri, idx) and torch.equal(rh.t, t)
    assert torch.equal(rh.u + 0.0, u) and torch.equal(rh.v + 0.0, v)


def test_intersect_bvh_on_the_cornell_box():
    geom = cornell_box(16, 16).compile(device="cpu").host.geom
    rng = np.random.default_rng(0)
    o = (np.array([278.0, 273.0, 100.0])
         + rng.normal(size=(256, 3)) * 200.0).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bvh = tb.bvh_tables_to(tb.build_bvh(geom), "cpu")
    rh = tb.intersect_bvh(bvh, _t(o), _t(d))
    rows = _t(np.asarray(geom.inter_rows)[: geom.n_tris])
    t, idx, _, _ = dt.dense_closest_ref(
        rows, _t(o), _t(d), torch.full((256,), 1e-4),
        torch.full((256,), float("inf")))
    assert torch.equal(rh.hit, torch.isfinite(t)) and rh.hit.float().mean() > 0.5
    torch.testing.assert_close(rh.t[rh.hit], t[rh.hit], rtol=1e-6, atol=0)
    # ids may differ only where two walls share an edge
    assert (rh.tri == idx).float().mean() > 0.98


def test_intersect_bvh_takes_no_rays_and_uploads_tables(soup):
    _, tgeom, _, _ = soup
    host = tb.build_bvh(tgeom)
    bvh = tb.bvh_tables_to(host, "cpu")
    assert bvh.n_nodes == host.n_nodes and bvh.leaf_size == 8
    for f in ("bbox_lo", "bbox_hi", "skip", "prim_start", "prim_count",
              "inter_rows", "prim_index"):
        assert isinstance(getattr(bvh, f), torch.Tensor)
        np.testing.assert_array_equal(getattr(bvh, f).numpy(),
                                      getattr(host, f))
    stats = {}
    rh = tb.intersect_bvh(bvh, torch.zeros((0, 3)), torch.zeros((0, 3)),
                          stats=stats)
    assert rh.t.shape == (0,) and rh.tri.dtype == torch.int32
    assert stats["steps"] == 0
    assert tb.CHECK_EVERY == 8


@pytest.mark.cuda
def test_cuda_intersect_bvh_matches_cpu(soup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, tgeom, o, d = soup
    host = tb.build_bvh(tgeom)
    ref = tb.intersect_bvh(tb.bvh_tables_to(host, "cpu"), _t(o), _t(d))
    got = tb.intersect_bvh(tb.bvh_tables_to(host, "cuda"), _t(o).cuda(),
                           _t(d).cuda())
    assert torch.equal(got.tri.cpu(), ref.tri)
    torch.testing.assert_close(got.t.cpu(), ref.t, rtol=1e-6, atol=0)

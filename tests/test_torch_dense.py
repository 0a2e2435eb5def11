"""Dense trace of the port against the JAX package.

The plain versions of the port's CUDA kernels (ops/dense_trace.py) against
the TPU kernels rustlight_tpu/ops/pallas_trace.py:_trace_kernel and
:_anyhit_kernel, run by pl.pallas_call(..., interpret=True) on the CPU,
and against the XLA dense intersector accel/dense.py:_intersect_impl, on the
Cornell box's rows and on a random triangle soup, with inert (tfar = 0) and
empty (tnear >= tfar) lanes. The same numpy rays feed both packages.

Tolerances (the two packages sum the same terms, but XLA may contract
products into FMAs and reorder the matmul form):
  - hit masks and occlusion are equal;
  - triangle ids are equal except on near-ties, where the two nearest valid
    t lie within TIE_RTOL of each other;
  - t: |dt| * |Nd| <= T_TOL * (|o.N| + |N_w| + |t|), i.e. agreement to
    T_TOL of the magnitudes that cancel in t = -(o.N + N_w) / Nd (a plain
    rtol on t would fail on rays that start near a plane);
  - u, v within UV_ATOL.
A test marked `cuda` holds the CUDA kernels to the plain versions on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rustlight_tpu.accel.dense import _intersect_impl
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.ops.pallas_trace import _anyhit_kernel, _trace_kernel
from rustlight_tpu.scene.geometry import (
    TriMesh as JaxTriMesh, build_geometry_tables as jax_build_geometry)
from rustlight_tpu_torch.accel import intersect_rays, visible
from rustlight_tpu_torch.ops import dense_trace as dt
from rustlight_tpu_torch.scene.geometry import TriMesh, build_geometry_tables

torch.set_num_threads(2)

N_RAYS = 2048
TIE_RTOL = 1e-5
T_TOL = 1e-5
UV_ATOL = 1e-5


def _rays(seed, lo, hi, n=N_RAYS):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = np.arange(n)
    span = float(np.linalg.norm(np.subtract(hi, lo)))
    tnear = np.full(n, 1e-4, np.float32)
    tfar = np.full(n, np.inf, np.float32)
    tfar[k % 5 == 1] = rng.uniform(0.05, 1.0, (k % 5 == 1).sum()) * span
    tfar[k % 7 == 3] = 0.0                                # inert lanes
    tnear[k % 11 == 5], tfar[k % 11 == 5] = 0.5 * span, 0.25 * span  # empty
    return o, d, tnear, tfar


def _soup_mesh(seed, n_tris):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(0.0, 1.0, (3 * n_tris, 3)).astype(np.float32)
    return verts, np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)


def _case(name):
    if name == "cbox":
        rows = jax_cornell_box(8, 8).compile().host.data.geom.inter_rows
        return rows, _rays(1, (-20.0, -20.0, -800.0), (576.0, 568.8, 559.2))
    n_tris = {"soup1000": 1000, "soup257": 257}[name]
    verts, idx = _soup_mesh(2, n_tris)
    rows = jax_build_geometry([JaxTriMesh(verts, idx)], [-1]).inter_rows
    return rows, _rays(3, (-0.2,) * 3, (1.2,) * 3)


def _pallas(rows, o, d, tnear, tfar):
    """The TPU kernels, run by Pallas's interpreter on the CPU."""
    n, n_tris = o.shape[0], rows.shape[0]
    rows_t = rows.transpose(1, 0, 2).reshape(3 * n_tris, 4).T
    o4 = np.concatenate([o, np.ones((n, 1), np.float32)], 1)
    d4 = np.concatenate([d, np.zeros((n, 1), np.float32)], 1)
    outs = tuple(jax.ShapeDtypeStruct((n,), t) for t in
                 (jnp.float32, jnp.int32, jnp.float32, jnp.float32))
    t, idx, u, v = pl.pallas_call(_trace_kernel, out_shape=outs,
                                  interpret=True)(rows_t, o4, d4, tnear, tfar)
    occ = pl.pallas_call(_anyhit_kernel,
                         out_shape=jax.ShapeDtypeStruct((n,), jnp.int32),
                         interpret=True)(rows_t, o4, d4, tnear, tfar)
    return [np.asarray(x) for x in (t, idx, u, v)], np.asarray(occ) > 0


def _xla(rows, o, d, tnear, tfar):
    rh = _intersect_impl(jnp.asarray(rows), o, d, tnear, tfar, False)
    occ = _intersect_impl(jnp.asarray(rows), o, d, tnear, tfar, True)
    return [np.asarray(x) for x in (rh.t, rh.tri, rh.u, rh.v)], np.asarray(occ)


def _port(rows, o, d, tnear, tfar):
    args = [torch.as_tensor(x) for x in (rows, o, d, tnear, tfar)]
    closest = [x.numpy() for x in dt.dense_closest_ref(*args)]
    return closest, dt.dense_anyhit_ref(*args).numpy()


def _assert_agree(rows, rays, ref, port):
    o, d, tnear, tfar = rays
    (t_r, i_r, u_r, v_r), occ_r = ref
    (t_p, i_p, u_p, v_p), occ_p = port
    hit = np.isfinite(t_p)
    np.testing.assert_array_equal(np.isfinite(t_r), hit)
    np.testing.assert_array_equal(occ_r, occ_p)
    np.testing.assert_array_equal(occ_p, hit)   # same range, same answer
    assert not hit[tfar == 0.0].any() and not hit[tnear >= tfar].any()
    np.testing.assert_array_equal(i_p[~hit], -1)
    assert hit.sum() > N_RAYS // 8, hit.sum()
    for lane in np.nonzero(i_r != i_p)[0]:
        tt, _, _, valid = dt._chunk_test(
            torch.as_tensor(rows), *(torch.as_tensor(x[lane:lane + 1])
                                     for x in (o, d, tnear, tfar)))
        t2 = np.sort(tt[valid].numpy())
        assert len(t2) >= 2 and t2[1] - t2[0] <= TIE_RTOL * t2[0], lane
    same = hit & (i_r == i_p)
    n4 = rows[i_p[same], 0]
    mag = (np.abs(np.einsum("mk,mk->m", o[same], n4[:, :3]))
           + np.abs(n4[:, 3]) + np.abs(t_p[same]))
    nd = np.abs(np.einsum("mk,mk->m", d[same], n4[:, :3]))
    assert np.all(np.abs(t_r[same] - t_p[same]) * nd <= T_TOL * mag)
    np.testing.assert_allclose(u_r[same], u_p[same], rtol=0, atol=UV_ATOL)
    np.testing.assert_allclose(v_r[same], v_p[same], rtol=0, atol=UV_ATOL)


@pytest.mark.parametrize("case", ["cbox", "soup1000", "soup257"])
def test_plain_versions_match_pallas_kernels(case):
    rows, rays = _case(case)
    _assert_agree(rows, rays, _pallas(rows, *rays), _port(rows, *rays))


@pytest.mark.parametrize("case", ["cbox", "soup1000"])
def test_plain_versions_match_xla_intersector(case):
    rows, rays = _case(case)
    _assert_agree(rows, rays, _xla(rows, *rays), _port(rows, *rays))


def test_port_soup_rows_equal_jax_rows():
    verts, idx = _soup_mesh(2, 257)
    jr = jax_build_geometry([JaxTriMesh(verts, idx)], [-1]).inter_rows
    tr = build_geometry_tables([TriMesh(verts, idx)], [-1]).inter_rows
    np.testing.assert_array_equal(jr, tr)
    assert tr.shape == (264, 3, 4)     # padded to a multiple of 8
    assert not tr[257:].any()          # pad rows are degenerate (never hit)


def test_wrappers_take_plain_versions_on_cpu():
    rows, (o, d, tnear, tfar) = _case("cbox")
    args = [torch.as_tensor(x) for x in (rows, o, d, tnear, tfar)]
    dt.reset_launches()
    with dt.counting_rays("cpu") as n_rays:
        t, idx, u, v = dt.dense_closest(*args)
        occ = dt.dense_anyhit(*args)
    assert dt.LAUNCHES == {"dense_closest": 0, "dense_anyhit": 0}
    assert int(n_rays) == 2 * int((args[4] > 0).sum())
    ref = dt.dense_closest_ref(*args)
    for a, b in zip((t, idx, u, v), ref):
        assert torch.equal(a, b)
    assert torch.equal(occ, dt.dense_anyhit_ref(*args))


def test_wrappers_check_their_inputs():
    rows, (o, d, tnear, tfar) = _case("cbox")
    args = [torch.as_tensor(x) for x in (rows, o, d, tnear, tfar)]
    with pytest.raises(TypeError):
        dt.dense_closest(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        dt.dense_anyhit(args[0], args[1][:, :2], *args[2:])
    with pytest.raises(ValueError):
        dt.dense_closest(args[0], args[1].t().contiguous().t(), *args[2:])
    with pytest.raises(ValueError):
        dt.dense_closest(*(a.to("meta") for a in args))


def test_accel_dense_matches_xla_intersect_and_visible():
    """accel/dense.py (default tnear/tfar, visible's shadow epsilons and the
    inert-lane mask) against the JAX package's accel/dense.py."""
    from rustlight_tpu.accel import dense as jdense
    jsd = jax_cornell_box(8, 8).compile()
    from rustlight_tpu_torch.scene.scene import from_numpy_scene
    tsd = from_numpy_scene(jsd.host.data, "cpu")
    o, d, _, _ = _rays(4, (10.0, 10.0, -700.0), (540.0, 540.0, 540.0))
    jr = jdense.intersect_rays(jsd.geom, jnp.asarray(o), jnp.asarray(d))
    tr = intersect_rays(tsd.geom, torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(np.asarray(jr.hit), tr.hit.numpy())
    np.testing.assert_array_equal(np.asarray(jr.tri), tr.tri.numpy())
    p1 = np.random.default_rng(5).uniform((0, 0, 0), (550, 548, 559),
                                          (N_RAYS, 3)).astype(np.float32)
    mask = np.arange(N_RAYS) % 3 != 0
    jv = jdense.visible(jsd.geom, jnp.asarray(o), jnp.asarray(p1),
                        mask=jnp.asarray(mask))
    tv = visible(tsd.geom, torch.as_tensor(o), torch.as_tensor(p1),
                 mask=torch.as_tensor(mask))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert tv.numpy()[~mask].all()          # masked lanes report visible
    assert not tv.numpy()[mask].all()       # and real lanes do get blocked


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On a card: the CUDA kernels against their plain versions (expected
    bit-identical; see csrc/dense_trace.cu), on the Cornell box, the soup
    and the planted boundary sets of ops/dense_trace.py:planted_sets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    planted = {name: (s[0], s[1:]) for name, s in dt.planted_sets().items()}
    for case in ("cbox", "soup1000", *planted):
        rows, rays = planted[case] if case in planted else _case(case)
        args = [torch.as_tensor(x, device="cuda") for x in (rows, *rays)]
        before = dict(dt.LAUNCHES)
        closest = dt.dense_closest(*args)
        occ = dt.dense_anyhit(*args)
        torch.cuda.synchronize()
        assert dt.LAUNCHES["dense_closest"] == before["dense_closest"] + 1
        assert dt.LAUNCHES["dense_anyhit"] == before["dense_anyhit"] + 1
        for a, b in zip(closest, dt.dense_closest_ref(*args)):
            assert torch.equal(a, b), case
        assert torch.equal(occ, dt.dense_anyhit_ref(*args)), case

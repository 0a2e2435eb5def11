"""The port's walk-tier laboratory (ops/walk_lab.py, the mxu form of the
triangle test in ops/walk_trace.py, accel/walk.py:build_walk_tables' build
variants, tools/perf/) against the JAX package's.

The same numpy inputs, made from a seed, go to both packages:
  - build_walk_tables(bvh=, builder=, repack_alpha=) gives the JAX package's
    tables, column by column and dtype by dtype, on sphere_grid_mesh at 27
    and 125 spheres and on the 1,500-triangle soup of
    tests/test_pallas_walk.py;
  - on the soup, with rays sorted and padded by the port's _prepare so both
    packages see the same tiles, the lab kernels of the JAX package's
    tools/perf/roofline.py run by Pallas's interpreter: the counted kernel's
    visits equal the plain counted walk's tile by tile and its hits equal
    the plain K3's; the floor kernel and the plain floor walk give equal
    ids and t within FLOOR_RTOL (XLA on the CPU may contract products into
    FMAs; the port does not); the FMA kernel and the plain chain agree
    within FMA_RTOL at 200 steps (an emulated fused step against whatever
    XLA fuses);
  - the plain mxu form against the JAX walk with MXU_TRITEST monkeypatched
    on (a ray count of its own, so the flag is live when the kernel traces),
    for the default walk, the wide pop, the two-level walk, the sub-tiled
    walk at sub = 2 and 8 and the pair walk at km = 8: hit masks and
    occlusion equal, ids equal except on near ties or edge grazes (at most
    0.1% of lanes), t within rtol 1e-5, atol 1e-6, as
    tests/test_pallas_walk.py:316-325 holds the reference to the dense
    oracle; and against the port's own default form under the same rule;
  - `_resolve` raises for mxu_tritest with sparse; K6 and K8 take the plain
    mxu form on the CPU;
  - the candidate forms' probes (ops/walk_lab.py:mma_form_lanes,
    mma_form_visits) take their plain versions on the CPU;
  - each tool's main() on the CPU on a small grid writes well-formed JSON
    and keeps device rates out of it.
Tests marked `cuda` hold each new kernel to its plain version on a card.
"""
import importlib.util
import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import rustlight_tpu.accel.pair_walk as JP
import rustlight_tpu.accel.pallas_walk as W
from rustlight_tpu.accel.bvh import build_bvh as jax_build_bvh
from rustlight_tpu.models.presets import sphere_grid_mesh as jax_grid_mesh
from rustlight_tpu.scene.geometry import (
    TriMesh as JaxTriMesh, build_geometry_tables as jax_build_geometry)
from rustlight_tpu_torch.accel import pair_walk as tpw
from rustlight_tpu_torch.accel import walk as tw
from rustlight_tpu_torch.accel.bvh import build_bvh
from rustlight_tpu_torch.accel.walk import WalkOptions
from rustlight_tpu_torch.models.presets import sphere_grid_mesh
from rustlight_tpu_torch.ops import dense_trace as dt
from rustlight_tpu_torch.ops import pair_trace as tpt
from rustlight_tpu_torch.ops import walk_hier as wh
from rustlight_tpu_torch.ops import walk_lab as wl
from rustlight_tpu_torch.ops import walk_sub as wsub
from rustlight_tpu_torch.ops import walk_trace as wk
from rustlight_tpu_torch.scene.geometry import (TriMesh,
                                                build_geometry_tables)
from rustlight_tpu_torch.tools.perf import roofline, trace_122k, tree_lab

torch.set_num_threads(2)

NR = 512
NR_MXU = 448            # a ray count no other test of the JAX walk uses
FLOOR_RTOL = 1e-6
FMA_RTOL = 1e-4
MXU_T_RTOL, MXU_T_ATOL, MXU_EDGE, TIE_RTOL = 1e-5, 1e-6, 1e-5, 1e-6
MXU_EXCUSED_FRAC = 1e-3
# the tensor-core products against the _dot4 ones, relative to each ray's
# largest product (chip_smoke.py phase 17 measured 2.1e-7 on an H100)
MMA_OPERAND_ERR = 5e-7
TFAR_OCC = 2.2
K, R = wk.K, wk.RAY_TILE


def _load_jax_roofline():
    """tools/perf/roofline.py of the JAX package (a script, not a module of
    a package): its three lab kernels."""
    path = Path(__file__).resolve().parent.parent / "tools/perf/roofline.py"
    spec = importlib.util.spec_from_file_location("jax_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _soup_mesh():
    rng = np.random.default_rng(7)
    nt = 1500
    c = rng.uniform(-1, 1, (nt, 3)).astype(np.float32)
    vs = [c + rng.normal(0, .06, (nt, 3)).astype(np.float32) for _ in range(3)]
    verts = np.concatenate(vs, 0).astype(np.float32)
    idx = np.arange(3 * nt).reshape(3, nt).T.astype(np.int32)
    o = rng.uniform(-2.5, -1.8, (NR, 3)).astype(np.float32)
    d = c[rng.integers(0, nt, NR)] - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return verts, idx, o, d.astype(np.float32)


@pytest.fixture(scope="module")
def soup():
    """Both packages' geometry and resident tables of the soup, its rays,
    and the rays as the port's walk sorts and pads them."""
    verts, idx, o, d = _soup_mesh()
    jgeom = jax_build_geometry([JaxTriMesh(vertices=verts, indices=idx,
                                           material=0)], [-1])
    jwt = W.build_walk_tables(jgeom)
    assert jwt.resident and jwt.n_real == 6
    wt = tw.walk_tables_to(jwt, "cpu")
    tnear, tfar = tw._default_range(_t(o), None, None)
    srt = tw._prepare(wt, _t(o), _t(d), tnear, tfar)[:4]
    return jgeom, jwt, wt, o, d, srt


# ------------------------------------------------------------ table builds

def _assert_tables_equal(jwt, port):
    conv = tw.walk_tables_from_numpy(jwt)
    for f in tw.WalkTables._fields:
        a, b = getattr(conv, f), getattr(port, f)
        if isinstance(b, (int, tuple)):
            assert a == b, f
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _both_geoms(scene):
    if scene == "soup":
        verts, idx, _, _ = _soup_mesh()
        return (jax_build_geometry([JaxTriMesh(verts, idx)], [-1]),
                build_geometry_tables([TriMesh(verts, idx)], [-1]))
    n_tris = {"grid27": 27 * 180, "grid125": 125 * 180}[scene]
    jmesh, jgs = jax_grid_mesh(n_tris, n_theta=10)
    mesh, gs = sphere_grid_mesh(n_tris, n_theta=10)
    assert jgs == gs == round((n_tris / 180) ** (1 / 3))
    return (jax_build_geometry([jmesh], [-1]),
            build_geometry_tables([mesh], [-1]))


@pytest.fixture(scope="module", params=["soup", "grid27", "grid125"])
def geoms(request):
    return _both_geoms(request.param)


@pytest.mark.parametrize("builder, alpha", [
    ("binned", None), ("sweep", None), ("binned", 1.0), ("binned", 0.8),
    ("sweep", 1.0), ("sweep", 0.8)])
def test_build_variants_equal_jax(geoms, builder, alpha):
    jgeom, tgeom = geoms
    jwt = W.build_walk_tables(jgeom, builder=builder, repack_alpha=alpha)
    _assert_tables_equal(jwt, tw.build_walk_tables(
        tgeom, builder=builder, repack_alpha=alpha))
    # a caller's BVH is shared, not rebuilt
    bvh = build_bvh(tgeom, max_leaf=8, builder=builder)
    _assert_tables_equal(jwt, tw.build_walk_tables(
        tgeom, bvh=bvh, builder="binned", repack_alpha=alpha))


def test_repack_alpha_cuts_where_boxes_grow(geoms):
    """A tighter alpha never merges more: clusters only increase, and the
    default build is the greedy one."""
    _, tgeom = geoms
    counts = [tw.build_walk_tables(tgeom, repack_alpha=a).n_real
              for a in (None, 1.0, 0.8, 0.5)]
    assert counts == sorted(counts)
    assert tw.build_walk_tables(tgeom).n_real == tgeom.walk.n_real == counts[0]
    with pytest.raises(ValueError, match="builder"):
        tw.build_walk_tables(tgeom, builder="median")


# --------------------------------------------------- the JAX lab kernels

@pytest.fixture(scope="module")
def jax_lab(soup):
    """The JAX package's three lab kernels run once by Pallas's interpreter
    on the soup's sorted tiles: (counted outputs, floor outputs at
    FLOOR_VISITS visits, the FMA block at 200 steps and its input)."""
    rf = _load_jax_roofline()
    _, jwt, _, _, _, srt = soup
    o_s, d_s, tn_s, tf_s = (jnp.asarray(x.numpy()) for x in srt)
    n = o_s.shape[0]
    cp = jwt.n_clusters
    g = n // R
    const = lambda shp: pl.BlockSpec(shp, lambda i: tuple(0 for _ in shp),
                                     memory_space=pltpu.VMEM)
    ray2 = pl.BlockSpec((R, 3), lambda i: (i, 0), memory_space=pltpu.VMEM)
    row = pl.BlockSpec((R, 1), lambda i: (i, 0), memory_space=pltpu.VMEM)
    in_specs = [const((3, cp)), const((3, cp)), const((4, cp, 3 * K)),
                const((cp, K)), ray2, ray2, row, row]
    f32 = lambda: jax.ShapeDtypeStruct((n, 1), jnp.float32)
    i32 = lambda: jax.ShapeDtypeStruct((n, 1), jnp.int32)
    args = (jwt.lo, jwt.hi, jwt.rows, jwt.ids, o_s, d_s, tn_s.reshape(n, 1),
            tf_s.reshape(n, 1))
    counted = pl.pallas_call(
        partial(rf._closest_kernel_counted, jwt.n_real, False), grid=(g,),
        in_specs=in_specs, out_specs=(row,) * 5,
        out_shape=(f32(), i32(), f32(), f32(), i32()),
        scratch_shapes=[pltpu.VMEM((1, cp), jnp.float32)],
        interpret=True)(*args)
    floor = pl.pallas_call(
        partial(rf._floor_kernel, FLOOR_VISITS), grid=(g,),
        in_specs=in_specs, out_specs=(row,) * 4,
        out_shape=(f32(), i32(), f32(), f32()), interpret=True)(*args)
    x = np.random.default_rng(11).uniform(0.5, 1.5, wl.FMA_SHAPE).astype(
        np.float32)
    blk = pl.BlockSpec(wl.FMA_SHAPE, lambda i: (0, 0),
                       memory_space=pltpu.VMEM)
    fma = pl.pallas_call(
        partial(rf._fma_kernel, 200), grid=(2,), in_specs=[blk],
        out_specs=blk,
        out_shape=jax.ShapeDtypeStruct(wl.FMA_SHAPE, jnp.float32),
        interpret=True)(jnp.asarray(x))
    return ([np.asarray(a)[:, 0] for a in counted],
            [np.asarray(a)[:, 0] for a in floor], np.asarray(fma), x)


FLOOR_VISITS = 9        # past the soup's 6 real clusters: pads are visited


def test_plain_counted_walk_matches_counted_kernel(soup, jax_lab):
    _, _, wt, _, _, srt = soup
    (t_j, i_j, _, _, nv_j), _, _, _ = jax_lab
    t, tri, u, v, nv = wl.walk_closest_counted(wt, *srt)
    assert nv.dtype == torch.int32 and nv.shape == tri.shape
    np.testing.assert_array_equal(nv.numpy(), nv_j)        # tile by tile
    per_tile = nv.view(-1, R)
    assert torch.equal(per_tile, per_tile[:, :1].expand(-1, R))
    assert 0 < int(per_tile[:, 0].min()) and int(per_tile[:, 0].max()) <= 6
    for a, b in zip((t, tri, u, v), wk.walk_closest(wt, *srt)):
        assert torch.equal(a, b)                           # K3's hits
    np.testing.assert_array_equal(tri.numpy(), i_j)
    hit = i_j >= 0
    assert hit.mean() > 0.5
    np.testing.assert_allclose(t.numpy()[hit], t_j[hit], rtol=1e-6)
    assert wl.walk_closest_counted_ref(wt, *srt)[4].sum() == nv.sum()


def test_plain_floor_walk_matches_floor_kernel(soup, jax_lab):
    _, _, wt, _, _, srt = soup
    _, (t_j, i_j, u_j, v_j), _, _ = jax_lab
    t, tri, u, v = wl.walk_floor(wt, *srt, FLOOR_VISITS)
    np.testing.assert_array_equal(tri.numpy(), i_j)
    hit = i_j >= 0
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(np.isfinite(t.numpy()), hit)
    np.testing.assert_allclose(t.numpy()[hit], t_j[hit], rtol=FLOOR_RTOL)
    # every real cluster visited once: the floor finds K3's hits
    for a, b in zip((t, tri), wk.walk_closest(wt, *srt)):
        assert torch.equal(a, b)
    # fewer visits than clusters: it finds fewer, and nothing at 0 visits
    few = wl.walk_floor(wt, *srt, 2)
    assert 0 < int((few[1] >= 0).sum()) < int(hit.sum())
    none = wl.walk_floor(wt, *srt, 0)
    assert not bool((none[1] >= 0).any()) and bool(torch.isinf(none[0]).all())
    with pytest.raises(ValueError, match="nv_total"):
        wl.walk_floor(wt, *srt, -1)


def test_plain_fma_chain_matches_fma_kernel(jax_lab):
    _, _, y_j, x = jax_lab
    y = wl.fma_peak(_t(x), 200, blocks=3)
    assert y.shape == wl.FMA_SHAPE and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_j, rtol=FMA_RTOL)
    # the chain by hand, in float64
    a, b = x.astype(np.float64), x.astype(np.float64) + 1.0
    for _ in range(200):
        a = a * float(np.float32(1.000001)) + 0.5
        b = b * float(np.float32(0.999999)) + 0.25
    np.testing.assert_allclose(y.numpy(), a + b, rtol=FMA_RTOL)
    assert torch.equal(wl.fma_peak(_t(x), 0), _t(x) + (_t(x) + 1.0))
    with pytest.raises(ValueError, match="f32"):
        wl.fma_peak(_t(x)[:32], 10)
    with pytest.raises(ValueError, match="blocks"):
        wl.fma_peak(_t(x), 10, blocks=0)


# ------------------------------------------------------- the mxu form

def _excused(rows, o, d, tnear, tfar, got, ref, lanes):
    """Per differing lane: an edge graze (u, v or u + v within MXU_EDGE of
    an edge in either result) or a near tie of the two nearest valid t."""
    out = []
    for lane in lanes:
        edge = False
        for _, tri, u, v in (got, ref):
            if tri[lane] >= 0:
                edge |= min(u[lane], v[lane],
                            1.0 - (u[lane] + v[lane])) < MXU_EDGE
        tt, _, _, valid = dt._chunk_test(
            _t(rows), *(_t(x[lane:lane + 1]) for x in (o, d, tnear, tfar)))
        t2 = np.sort(tt[valid].numpy())
        tie = len(t2) >= 2 and t2[1] - t2[0] <= TIE_RTOL * t2[0]
        out.append(edge or tie)
    return np.asarray(out, bool)


def _assert_mxu_agree(rows, o, d, tnear, tfar, ref, got):
    """ref/got: ((t, tri, u, v), occ) as numpy."""
    (t_r, i_r, u_r, v_r), occ_r = ref
    (t_g, i_g, u_g, v_g), occ_g = got
    n = len(i_r)
    lanes = np.nonzero((i_r != i_g) | (occ_r != occ_g))[0]
    assert len(lanes) <= MXU_EXCUSED_FRAC * n + 0.5, lanes
    assert _excused(rows, o, d, tnear, tfar, got[0], ref[0], lanes).all()
    same = (i_r == i_g) & (i_r >= 0)
    assert same.mean() > 0.5
    np.testing.assert_allclose(t_g[same], t_r[same], rtol=MXU_T_RTOL,
                               atol=MXU_T_ATOL)
    np.testing.assert_array_equal(np.isfinite(t_g), i_g >= 0)
    np.testing.assert_allclose(u_g[same], u_r[same], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(v_g[same], v_r[same], rtol=1e-4, atol=1e-4)


MXU_CASES = {"default": {}, "wide": dict(wide=True), "hier": dict(hier=True),
             "sub2": dict(sub=2), "sub8": dict(sub=8), "pair": dict(pair=True)}
PAIR_KM = 8


@pytest.fixture(scope="module")
def jax_mxu(soup):
    """The JAX walk with MXU_TRITEST on, its kernels run by the interpreter:
    {case: ((t, tri, u, v), occ)} on NR_MXU unsorted rays. The flag is read
    when the kernel traces, so the ray count is this fixture's own and the
    branch taken is asserted."""
    jgeom, jwt, _, o, d, _ = soup
    mp = pytest.MonkeyPatch()
    taken = []
    orig = W._test_rows
    mp.setattr(W, "MXU_TRITEST", True)
    mp.setattr(W, "_test_rows", lambda *a, **k: (
        taken.append(W.MXU_TRITEST), orig(*a, **k))[1])
    out = {}
    try:
        jo, jd = jnp.asarray(o[:NR_MXU]), jnp.asarray(d[:NR_MXU])
        tnear = jnp.full(NR_MXU, 1e-4)
        for name, kw in MXU_CASES.items():
            tables = jwt
            if name == "hier":          # the two-level walk takes HBM tables
                mp.setattr(W, "MAX_VMEM_CLUSTERS", 1)
                tables = W.build_walk_tables(jgeom)
            before = len(taken)
            if name == "pair":
                walk = lambda tfar, any_hit: JP._pairs_impl(
                    tables, jo, jd, tnear, tfar, any_hit, True, PAIR_KM)
            else:
                walk = lambda tfar, any_hit: W._walk_impl(
                    tables, jo, jd, tnear, tfar, any_hit, interpret=True,
                    sort_rays=False, **kw)
            rh = walk(jnp.full(NR_MXU, jnp.inf), False)
            occ = walk(jnp.full(NR_MXU, TFAR_OCC), True)
            out[name] = ([np.asarray(x) for x in (rh.t, rh.tri, rh.u, rh.v)],
                         np.asarray(occ))
            assert len(taken) > before and all(taken), name
    finally:
        mp.undo()
    return out


def _port_mxu(wt, o, d, mxu, pair=False, **kw):
    args = [_t(x[:NR_MXU]) for x in (o, d)]
    tnear = torch.full((NR_MXU,), 1e-4)
    if pair:
        pwt = wt._replace(options=WalkOptions(pair=True, mxu_tritest=mxu))
        walk = lambda tfar, any_hit: tpw._pairs_impl(
            pwt, *args, tnear, tfar, any_hit, PAIR_KM)
    else:
        walk = lambda tfar, any_hit: tw._walk_impl(
            wt, *args, tnear, tfar, any_hit, sort_rays=False,
            mxu_tritest=mxu, **kw)
    rh = walk(torch.full((NR_MXU,), float("inf")), False)
    occ = walk(torch.full((NR_MXU,), TFAR_OCC), True)
    return [x.numpy() for x in (rh.t, rh.tri, rh.u, rh.v)], occ.numpy()


@pytest.mark.parametrize("name", list(MXU_CASES))
def test_plain_mxu_form_matches_jax_mxu_walk(soup, jax_mxu, name):
    jgeom, _, wt, o, d, _ = soup
    rows = np.asarray(jgeom.inter_rows)
    tnear = np.full(NR_MXU, 1e-4, np.float32)
    tfar = np.full(NR_MXU, np.inf, np.float32)
    got = _port_mxu(wt, o, d, True, **MXU_CASES[name])
    _assert_mxu_agree(rows, o[:NR_MXU], d[:NR_MXU], tnear, tfar,
                      jax_mxu[name], got)
    # and against the port's own default form
    _assert_mxu_agree(rows, o[:NR_MXU], d[:NR_MXU], tnear, tfar,
                      _port_mxu(wt, o, d, False, **MXU_CASES[name]), got)


def test_mxu_form_is_matrix_products(soup, monkeypatch):
    """mxu=True goes through one torch.matmul per product, and is another
    rounding than the default form, not another result."""
    _, _, wt, _, _, srt = soup
    calls = []
    real = torch.matmul
    monkeypatch.setattr(torch, "matmul",
                        lambda a, b: (calls.append(b.shape), real(a, b))[1])
    wk.walk_closest(wt, *srt)
    assert not calls
    m = wk.walk_closest(wt, *srt, mxu=True)
    assert calls and all(s[-2:] == (4, 3 * K) for s in calls)
    assert len(calls) % 2 == 0
    k3 = wk.walk_closest(wt, *srt)
    assert torch.equal(m[1], k3[1]) and not torch.equal(m[0], k3[0])
    rows = wt.rows.view(-1, K, 3, 4)[0]
    for a, b in zip(wl.mma_products(rows, srt[0][:R], srt[1][:R]),
                    wl.dot4_products(rows, srt[0][:R], srt[1][:R])):
        assert a.shape == wl.FMA_SHAPE
        scale = b.abs().amax(dim=1, keepdim=True)
        assert float(((a - b).abs() / scale).max()) < 1e-6


def test_resolve_carries_mxu_and_refuses_sparse(soup):
    _, _, wt, o, d, _ = soup
    assert tw._resolve(wt, None, None, None, None) == (
        False, False, 1, False, False)
    assert tw._resolve(wt, None, None, None, None, True)[4] is True
    opt = wt._replace(options=WalkOptions(mxu_tritest=True))
    assert tw._resolve(opt, None, True, None, None) == (
        False, True, 1, False, True)
    assert tw._resolve(opt, None, None, None, None, False)[4] is False
    assert WalkOptions._fields[-2:] == ("mxu_tritest", "inc_sort")
    assert WalkOptions().mxu_tritest is False
    tnear, tfar = tw._default_range(_t(o), None, None)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tw._walk_impl(wt, _t(o), _t(d), tnear, tfar, False, sparse=True,
                      mxu_tritest=True)
    sparse_opt = wt._replace(options=WalkOptions(sparse=True,
                                                 mxu_tritest=True))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tw._walk_impl(sparse_opt, _t(o), _t(d), tnear, tfar, True)


def test_other_schedules_take_the_plain_mxu_form_on_cpu(soup):
    """On the CPU the plain versions of K6 and K8 take the mxu form, and
    agree with the default walk's ids."""
    _, _, wt, o, d, srt = soup
    k3 = wk.walk_closest(wt, *srt, mxu=True)
    sub = wsub.walk_sub_closest(wt, *srt, 4, mxu=True)
    assert torch.equal(sub[1], k3[1])
    np.testing.assert_allclose(sub[0].numpy(), k3[0].numpy(), rtol=1e-5)
    occ = wsub.walk_sub_anyhit(wt, *srt, 4, mxu=True)
    assert torch.equal(occ, wk.walk_anyhit(wt, *srt, mxu=True))
    pair = wt._replace(options=WalkOptions(pair=True, mxu_tritest=True))
    tnear, tfar = tw._default_range(_t(o), None, None)
    rp = tpw._pairs_impl(pair, _t(o), _t(d), tnear, tfar, False)
    rw = tw._walk_impl(wt, _t(o), _t(d), tnear, tfar, False, mxu_tritest=True)
    assert torch.equal(rp.tri, rw.tri)
    np.testing.assert_allclose(rp.t.numpy(), rw.t.numpy(), rtol=1e-5)
    hier = wh.walk_hier_closest(wt, *srt, mxu=True)
    assert torch.equal(hier[1], k3[1])


def test_lab_wrappers_take_plain_versions_on_cpu(soup):
    _, _, wt, _, _, srt = soup
    wl.reset_launches()
    wk.reset_launches()
    wl.walk_closest_counted(wt, *srt, mxu=True)
    wl.walk_floor(wt, *srt, 3, mxu=True)
    wl.fma_peak(torch.ones(wl.FMA_SHAPE), 3)
    wk.walk_anyhit(wt, *srt, mxu=True)
    wk.walk_closest(wt, *srt, wide=True, mxu=True)
    assert not any(wl.LAUNCHES.values()) and not any(wk.LAUNCHES.values())
    assert set(wl.LAUNCHES) == {
        "walk_closest_counted", "walk_floor", "fma_peak", "mma_products",
        "walk_closest_counted_mma", "walk_floor_mma", "mma_form_lanes",
        "mma_form_visits"}
    assert {k for k in wk.LAUNCHES if k.endswith("_mma")} == {
        "walk_closest_mma", "walk_anyhit_mma", "walk_closest_wide_mma",
        "walk_anyhit_wide_mma"}
    assert {k for k in wsub.LAUNCHES if k.endswith("_mma")} == {
        "walk_sub_closest_mma", "walk_sub_anyhit_mma"}
    assert {k for k in tpt.LAUNCHES if k.endswith("_mma")} == {
        "pair_closest_mma", "pair_anyhit_mma"}
    with pytest.raises(ValueError, match="2\\^14"):
        wl.walk_closest_counted(wt._replace(n_clusters=1 << 15), *srt)


def test_form_probes_take_plain_versions_on_cpu(soup):
    """The candidate forms' probes: on the CPU each lane's products are the
    _dot4 ones, so t = -no / nd is K3's t on its hit lanes, bit for bit."""
    jgeom, _, wt, _, _, srt = soup
    t, tri, _, _ = wk.walk_closest(wt, *srt)
    lanes = torch.nonzero(tri >= 0)[:, 0][:R * 2]
    rows = _t(jgeom.inter_rows)[tri[lanes].long()].contiguous()
    o, d = srt[0][lanes].contiguous(), srt[1][lanes].contiguous()
    wl.reset_launches()
    for form in range(len(wl.MMA_FORMS)):
        no, nd = wl.mma_form_lanes(form, rows, o, d)
        assert torch.equal(-no / nd, t[lanes])
    assert 0 <= wl.PRODUCTION_FORM < len(wl.MMA_FORMS)
    out = wl.mma_form_visits(wl.PRODUCTION_FORM, wt, *srt[:2], 3)
    assert out.shape == (srt[0].shape[0] // 32,) and torch.isfinite(out).all()
    assert not any(wl.LAUNCHES.values())
    with pytest.raises(ValueError, match="form"):
        wl.mma_form_lanes(len(wl.MMA_FORMS), rows, o, d)
    with pytest.raises(ValueError, match="tiles"):
        wl.mma_form_lanes(0, rows[:100], o[:100], d[:100])


# ------------------------------------------------------------- the tools

SMALL = ["--device", "cpu", "--rays", "4096", "--tris", "3000", "--theta",
         "10", "--runs", "1"]


def _run_tool(tool, tmp_path, *extra):
    out = tmp_path / "record.json"
    ret = tool.main([*SMALL, "--out", str(out), *extra])
    rec = json.loads(out.read_text())
    assert rec == json.loads(json.dumps(ret))
    return rec


@pytest.mark.parametrize("mxu", [False, True], ids=["dot4", "mxu"])
def test_roofline_tool_on_cpu(tmp_path, mxu, capsys):
    rec = _run_tool(roofline, tmp_path, "--fma-iters", "20",
                    *(["--mxu"] if mxu else []))
    assert rec["device"] == "cpu" and rec["card"] is None and rec["note"]
    assert rec["rays"] == 4096 and rec["clusters"] == 128 and rec["K"] == K
    assert rec["tris"] == 27 * 180 and rec["mxu"] is mxu
    assert 1 <= rec["visits_per_tile_mean"] <= rec["visits_per_tile_max"] <= 14
    assert rec["visits_total"] == round(rec["visits_per_tile_mean"] * 64)
    assert rec["floor_visits"] == round(rec["visits_per_tile_mean"])
    for k in ("production_ms", "production_walk_ms", "floor_ms", "fma_ms",
              "sched_overhead_x"):
        assert rec[k] > 0
    # rates are device metrics: a CPU run states none
    for k in ("fma_peak_gflops", "floor_gflops_fma_equiv",
              "floor_vs_peak_pct"):
        assert rec[k] is None
    assert ("mxu_operand_err" in rec) == mxu
    if mxu:
        assert 0 <= rec["mxu_operand_err"]["ao"] < 1e-6
    assert "production/floor" in capsys.readouterr().out


def test_tree_lab_tool_on_cpu(tmp_path):
    rec = _run_tool(tree_lab, tmp_path, "--variants",
                    "binned/greedy,binned/sa0.8,sweep/sa1.0")
    assert rec[0]["device"] == "cpu"
    rows = rec[1:]
    assert [r["variant"] for r in rows] == [
        "binned/greedy", "binned/sa0.8", "sweep/sa1.0"]
    for r in rows:
        assert 0.3 < r["fill"] <= 1.0 and r["cluster_sa"] > 0
        assert r["fill"] == round(27 * 180 / (r["clusters"] * K), 3)
        for name in ("coherent", "divergent"):
            s = r[name]
            assert s["parity"] is True and s["hits"] > 0 and s["ms"] > 0
            assert 1 <= s["visits_mean"] <= s["visits_max"] <= r["clusters"]
        assert r["coherent"]["hits"] == rows[0]["coherent"]["hits"]
    assert rows[1]["clusters"] >= rows[0]["clusters"]
    with pytest.raises(ValueError, match="unknown name"):
        tree_lab.main([*SMALL, "--variants", "median/greedy"])


def test_trace_122k_tool_on_cpu(tmp_path):
    rec = _run_tool(trace_122k, tmp_path)
    mxu = _run_tool(trace_122k, tmp_path, "--mxu")
    assert rec["device"] == "cpu" and rec["mxu"] is False and mxu["mxu"]
    for name in ("coherent", "divergent"):
        assert rec[name]["ms"] > 0 and rec[name]["hits"] > 0
        # the two forms see the same rays and find the same hits
        assert mxu[name]["hits"] == rec[name]["hits"]
        assert abs(mxu[name]["chk"] - rec[name]["chk"]) < 0.5
    # the ray sets follow three throw-away draws, as the reference's script:
    # the coherent set made here in that order finds the tool's hits
    rng = np.random.default_rng(3)
    gs49 = int(np.ceil((4_200_000 / 180) ** (1 / 3)))
    rng.uniform(0, gs49 * 3.0, (4096, 3))
    rng.uniform(0, gs49 * 3.0, (4096, 3))
    rng.normal(size=(4096, 3))
    mesh, gs = sphere_grid_mesh(3000, n_theta=10)
    ext = gs * 3.0
    o = np.tile(np.array([ext / 2, ext / 2, -0.35 * ext], np.float32),
                (4096, 1))
    dd = rng.uniform(0, ext, (4096, 3)).astype(np.float32) - o
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    wt = tw.walk_tables_to(build_geometry_tables([mesh], [-1]).walk, "cpu")
    rh = tw.intersect_walk(wt, _t(o), _t(dd))
    assert int(rh.hit.sum()) == rec["coherent"]["hits"]


def test_tools_refuse_a_card_that_is_not_there(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is there")
    for tool in (roofline, tree_lab, trace_122k):
        with pytest.raises(RuntimeError, match="is_available"):
            tool.main(["--rays", "64", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


# ------------------------------------------------------------ on the card

def _cuda_soup(soup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    _, _, wt, o, d, _ = soup
    wt = tw.walk_tables_to(wt, "cuda")
    o, d = _t(o).cuda(), _t(d).cuda()
    return wt, tw._prepare(wt, o, d, *tw._default_range(o, None, None))[:4]


@pytest.mark.cuda
def test_cuda_counted_kernel_matches_plain_and_k3(soup):
    wt, srt = _cuda_soup(soup)
    got = wl.walk_closest_counted(wt, *srt)
    torch.cuda.synchronize()
    assert wl.LAUNCHES["walk_closest_counted"] > 0
    for a, b in zip(got, wl.walk_closest_counted_ref(wt, *srt)):
        assert torch.equal(a, b)
    for a, b in zip(got[:4], wk.walk_closest(wt, *srt)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_floor_kernel_matches_plain(soup):
    wt, srt = _cuda_soup(soup)
    got = wl.walk_floor(wt, *srt, FLOOR_VISITS)
    torch.cuda.synchronize()
    assert wl.LAUNCHES["walk_floor"] > 0
    for a, b in zip(got, wl.walk_floor_ref(wt, *srt, FLOOR_VISITS)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_fma_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    x = torch.rand(wl.FMA_SHAPE, device="cuda") + 0.5
    y = wl.fma_peak(x, 4000, blocks=4)
    torch.cuda.synchronize()
    assert wl.LAUNCHES["fma_peak"] > 0
    torch.testing.assert_close(y, wl.fma_peak_ref(x, 4000), rtol=FMA_RTOL,
                               atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MXU_CASES))
def test_cuda_tensor_core_visit_matches_plain_mxu(soup, name):
    wt, srt = _cuda_soup(soup)
    torch.backends.cuda.matmul.allow_tf32 = False
    if name == "hier":
        got = wh.walk_hier_closest(wt, *srt, mxu=True)
        ref = wh.walk_hier_closest_ref(wt, *srt, mxu=True)
    else:
        wide = name == "wide"
        got = wk.walk_closest(wt, *srt, wide=wide, mxu=True)
        ref = wk.walk_closest_ref(wt, *srt, wide=wide, mxu=True)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1])        # the soup has no near ties
    hit = ref[1] >= 0
    torch.testing.assert_close(got[0][hit], ref[0][hit], rtol=MXU_T_RTOL,
                               atol=MXU_T_ATOL)
    rows = wt.rows.view(-1, K, 3, 4)[0].contiguous()
    o64, d64 = srt[0][:R].contiguous(), srt[1][:R].contiguous()
    for a, b in zip(wl.mma_products(rows, o64, d64),
                    wl.dot4_products(rows, o64, d64)):
        scale = b.abs().amax(dim=1, keepdim=True)
        assert float(((a - b).abs() / scale).max()) < MMA_OPERAND_ERR
    # the sub-tiled walk takes the tensor-core form on the card too
    before = wsub.LAUNCHES["walk_sub_closest_mma"]
    wsub.walk_sub_closest(wt, *srt, 2, mxu=True)
    assert wsub.LAUNCHES["walk_sub_closest_mma"] == before + 1


SCHED_MXU = {"sub2": 2, "sub4": 4, "sub8": 8, "pair8": 8, "pair2": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCHED_MXU))
def test_cuda_tensor_core_schedules_match_plain_mxu(soup, name):
    """K6 (sub 2, 4, 8) and K8 (km 8, 2) with the tensor-core visit against
    their plain mxu versions, as the default walk's above."""
    wt, srt = _cuda_soup(soup)
    torch.backends.cuda.matmul.allow_tf32 = False
    n = SCHED_MXU[name]
    if name.startswith("sub"):
        mod, args = wsub, (wt, *srt, n)
        kernels = (wsub.walk_sub_closest, wsub.walk_sub_anyhit)
        refs = (wsub.walk_sub_closest_ref, wsub.walk_sub_anyhit_ref)
        names = ("walk_sub_closest_mma", "walk_sub_anyhit_mma")
    else:
        cids, _ = tpw._shortlist(wt, *srt, n)
        rep = lambda x: x.repeat_interleave(n, dim=0).contiguous()
        mod, args = tpt, (wt, *(rep(x) for x in srt), cids.reshape(-1))
        kernels = (tpt.pair_closest, tpt.pair_anyhit)
        refs = (tpt.pair_closest_ref, tpt.pair_anyhit_ref)
        names = ("pair_closest_mma", "pair_anyhit_mma")
    before = dict(mod.LAUNCHES)
    got, occ = (k(*args, mxu=True) for k in kernels)
    torch.cuda.synchronize()
    assert all(mod.LAUNCHES[k] == before[k] + 1 for k in names)
    ref, occ_ref = (r(*args, mxu=True) for r in refs)
    assert torch.equal(got[1], ref[1])        # the soup has no near ties
    assert torch.equal(occ, occ_ref[0])
    hit = ref[1] >= 0
    torch.testing.assert_close(got[0][hit], ref[0][hit], rtol=MXU_T_RTOL,
                               atol=MXU_T_ATOL)

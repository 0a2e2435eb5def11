"""Scene, emitter, BSDF and MIS modules of the port against the JAX package.

The port's Cornell box must compile to the very tables of
rustlight_tpu.models.cornell_box(...).compile().host.data (exact equality of
every column, dtypes included). The device functions get the same numpy
inputs in both packages. Tolerances: integer and boolean outputs are equal;
floats agree to FLOAT_RTOL/FLOAT_ATOL (the packages evaluate the same
formulas; XLA may contract products into FMAs and uses its own sin/cos).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu import bsdfs as jbsdfs
from rustlight_tpu.accel.dense import RayHit as JaxRayHit, _intersect_impl
from rustlight_tpu.integrators.common import (mis_balance as jmis_balance,
                                              mis_power as jmis_power)
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.scene import camera as jcamera
from rustlight_tpu.scene import emitters as jemitters
from rustlight_tpu.scene import scene as jscene
from rustlight_tpu_torch import bsdfs as tbsdfs
from rustlight_tpu_torch.accel.dense import RayHit
from rustlight_tpu_torch.integrators.common import mis_balance, mis_power
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.scene import camera as tcamera
from rustlight_tpu_torch.scene import emitters as temitters
from rustlight_tpu_torch.scene import scene as tscene

torch.set_num_threads(2)

FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-5
N = 1024
BOX_LO, BOX_HI = (1.0, 1.0, 1.0), (550.0, 547.0, 558.0)


@pytest.fixture(scope="module")
def scenes():
    jsd = jax_cornell_box(16, 16).compile()
    return jsd, tscene.from_numpy_scene(jsd.host.data, "cpu")


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(a, b, rtol=FLOAT_RTOL, atol=FLOAT_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("group", ["geom", "materials", "emitters", "camera"])
def test_cbox_tables_equal_jax(group):
    jtab = getattr(jax_cornell_box(16, 16).compile().host.data, group)
    ttab = getattr(cornell_box(16, 16).compile(device="cpu").host, group)
    for f in ttab._fields:
        a, b = getattr(jtab, f), getattr(ttab, f)
        if f == "atom_cdf":
            for g in ("cdf", "func", "func_int"):
                np.testing.assert_array_equal(getattr(a, g), getattr(b, g))
            continue
        if a is None and b is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_compiled_scene_lives_on_the_given_device(scenes):
    sd = cornell_box(8, 8).compile(device="cpu")
    assert sd.device == torch.device("cpu")
    assert sd.geom.inter_rows.shape == (40, 3, 4)
    assert sd.materials.kd.device == sd.emitters.atom_cdf.cdf.device


def test_generate_rays(scenes):
    jsd, tsd = scenes
    px = np.random.default_rng(0).uniform(0, 16, (N, 2)).astype(np.float32)
    jo, jd = jcamera.generate_rays(jsd.camera, jnp.asarray(px))
    to, td = tcamera.generate_rays(tsd.camera, _t(px))
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    _close(jd, td, rtol=0, atol=1e-6)


def _rays_and_hits(jsd):
    """Camera rays plus rays from inside the box, and the JAX intersector's
    hits for them, as (o, d, numpy RayHit fields)."""
    rng = np.random.default_rng(1)
    px = rng.uniform(0, 16, (N // 2, 2)).astype(np.float32)
    co, cd = (np.asarray(x) for x in jcamera.generate_rays(jsd.camera,
                                                             jnp.asarray(px)))
    io = rng.uniform(BOX_LO, BOX_HI, (N // 2, 3)).astype(np.float32)
    o = np.concatenate([co, io]).astype(np.float32)
    d = np.concatenate([cd, _unit(rng, N // 2)]).astype(np.float32)
    rh = _intersect_impl(jsd.geom.inter_rows, o, d,
                         np.full(N, 1e-4, np.float32),
                         np.full(N, np.inf, np.float32), False)
    return o, d, {f: np.asarray(getattr(rh, f)) for f in JaxRayHit._fields}


def test_fill_hit(scenes):
    jsd, tsd = scenes
    o, d, rh = _rays_and_hits(jsd)
    jh = jax.jit(lambda o_, d_, rh_: jscene.fill_hit(jsd, o_, d_, rh_))(
        jnp.asarray(o), jnp.asarray(d), JaxRayHit(**rh))
    th = tscene.fill_hit(tsd, _t(o), _t(d), RayHit(**{k: _t(v) for k, v in rh.items()}))
    v = rh["hit"]
    assert v.mean() > 0.9
    for f in ("valid", "tri", "mat", "is_light"):
        np.testing.assert_array_equal(np.asarray(getattr(jh, f)),
                                      getattr(th, f).numpy(), err_msg=f)
    for f in ("n_g", "n_s", "uv", "wi"):
        _close(np.asarray(getattr(jh, f))[v], getattr(th, f).numpy()[v])
    _close(np.asarray(jh.p)[v], th.p.numpy()[v], rtol=1e-6, atol=1e-3)
    for k in range(3):
        _close(np.asarray(jh.frame[k])[v], th.frame[k].numpy()[v])


def test_sample_light(scenes):
    jsd, tsd = scenes
    rng = np.random.default_rng(2)
    p = rng.uniform(BOX_LO, BOX_HI, (N, 3)).astype(np.float32)
    u_sel = rng.uniform(size=N).astype(np.float32)
    u_pos = rng.uniform(size=(N, 2)).astype(np.float32)
    jl = jemitters.sample_light(jsd.emitters, jsd.geom, jnp.asarray(p),
                                jnp.asarray(u_sel), jnp.asarray(u_pos))
    tl = temitters.sample_light(tsd.emitters, tsd.geom, _t(p), _t(u_sel),
                                _t(u_pos))
    for f in ("valid", "is_delta", "tri"):
        np.testing.assert_array_equal(np.asarray(getattr(jl, f)),
                                      getattr(tl, f).numpy(), err_msg=f)
    assert tl.valid.numpy().mean() > 0.5
    _close(jl.p, tl.p, rtol=1e-6, atol=1e-3)
    for f in ("n", "d", "dist", "pdf", "weight"):
        _close(getattr(jl, f), getattr(tl, f))


def test_direct_pdf_and_emitted_radiance(scenes):
    jsd, tsd = scenes
    rng = np.random.default_rng(3)
    tri = rng.integers(-1, 40, N).astype(np.int32)
    tri[:64] = 18                      # a light triangle (cbox mesh 9)
    p_ref = rng.uniform(BOX_LO, BOX_HI, (N, 3)).astype(np.float32)
    p_hit = rng.uniform(BOX_LO, BOX_HI, (N, 3)).astype(np.float32)
    n_hit, d = _unit(rng, N), _unit(rng, N)
    jp = jemitters.direct_pdf_tri(jsd.emitters, jnp.asarray(tri),
                                  jnp.asarray(p_ref), jnp.asarray(p_hit),
                                  jnp.asarray(n_hit), jnp.asarray(d))
    tp = temitters.direct_pdf_tri(tsd.emitters, _t(tri), _t(p_ref), _t(p_hit),
                                  _t(n_hit), _t(d))
    _close(jp, tp)
    assert (tp.numpy() > 0).sum() > 10
    je = jemitters.emitted_radiance(jsd.emitters, jsd.geom, jnp.asarray(tri),
                                    jnp.asarray(d))
    te = temitters.emitted_radiance(tsd.emitters, tsd.geom, _t(tri), _t(d))
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    assert (te.numpy() > 0).any()


def test_diffuse_bsdf(scenes):
    jsd, tsd = scenes
    rng = np.random.default_rng(4)
    mat = rng.integers(0, 4, N).astype(np.int32)
    wi, wo = _unit(rng, N), _unit(rng, N)
    u = rng.uniform(size=(N, 2)).astype(np.float32)
    u[:8, 0] = np.float32(1.0) - np.float32(2.0 ** -24)   # the clip edge
    uv = rng.uniform(size=(N, 2)).astype(np.float32)
    jm, tm = jsd.materials, tsd.materials
    ja = [jnp.asarray(x) for x in (mat, uv, wi)]
    ta = [_t(x) for x in (mat, uv, wi)]
    _close(jbsdfs.bsdf_eval(jm, *ja, jnp.asarray(wo)),
           tbsdfs.bsdf_eval(tm, *ta, _t(wo)))
    _close(jbsdfs.bsdf_pdf(jm, *ja, jnp.asarray(wo)),
           tbsdfs.bsdf_pdf(tm, *ta, _t(wo)))
    js = jbsdfs.bsdf_sample(jm, *ja, jnp.asarray(u))
    ts = tbsdfs.bsdf_sample(tm, *ta, _t(u))
    for f in ("is_delta", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy(), err_msg=f)
    for f in ("wo", "weight", "pdf"):
        _close(getattr(js, f), getattr(ts, f))
    for fn in ("bsdf_is_smooth", "bsdf_two_sided"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jbsdfs, fn)(jm, jnp.asarray(mat))),
            getattr(tbsdfs, fn)(tm, _t(mat)).numpy())


def test_mis_heuristics():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 3, 256).astype(np.float32)
    b = rng.uniform(0, 3, 256).astype(np.float32)
    a[:4] = [0.0, np.inf, np.nan, 1.0]
    b[:4] = [1.0, 1.0, 1.0, np.inf]
    for jf, tf in ((jmis_balance, mis_balance), (jmis_power, mis_power)):
        np.testing.assert_allclose(np.asarray(jf(jnp.asarray(a), jnp.asarray(b))),
                                   tf(_t(a), _t(b)).numpy(), rtol=1e-6)


def test_offset_ray_origin():
    rng = np.random.default_rng(6)
    p = rng.uniform(-600, 600, (N, 3)).astype(np.float32)
    n, d = _unit(rng, N), _unit(rng, N)
    _close(jscene.offset_ray_origin(jnp.asarray(p), jnp.asarray(n),
                                    jnp.asarray(d)),
           tscene.offset_ray_origin(_t(p), _t(n), _t(d)), rtol=1e-6, atol=1e-4)


def test_unported_features_raise():
    from rustlight_tpu.bsdfs import phong
    from rustlight_tpu_torch.scene.geometry import (
        TriMesh, build_geometry_tables, geometry_to)
    jsd = jax_cornell_box(8, 8, mat_overrides={"blocks": phong()}).compile()
    with pytest.raises(NotImplementedError):
        tscene.from_numpy_scene(jsd.host.data, "cpu")
    from rustlight_tpu.scene import make_volume
    sc = jax_cornell_box(8, 8)
    sc.volume = make_volume((0.01, 0.01, 0.01))
    with pytest.raises(NotImplementedError):
        tscene.from_numpy_scene(sc.compile().host.data, "cpu")
    # above the dense tier, only the tile walk is ported: tables without
    # walk tables (the reference's clustered-only fallback) are refused
    verts = np.random.default_rng(0).uniform(0, 1, (3 * 1025, 3))
    geom = build_geometry_tables(
        [TriMesh(verts, np.arange(3 * 1025).reshape(1025, 3))], [-1])
    assert geom.walk is not None
    with pytest.raises(NotImplementedError):
        geometry_to(geom._replace(walk=None), "cpu")

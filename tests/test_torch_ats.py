"""The port's ATS light tree against the JAX package's.

Scenes: the Cornell box (its light quad: a tree of 3 nodes), the
two-light scene of tests/test_ats.py (4 triangles), examples/caustic.pbrt
through both packages' loaders (an example scene with an area light), and
the Cornell box with an emissive 8x8 UV sphere (128 triangles, the poles'
degenerate ones with zero flux: a tree of depth 9 with cone unions; at
splitting factor 0.5 every lane fills its 8 slots and overflows).

  - the tables, column by column and dtype by dtype, built by each
    package's `Scene.compile(use_ats=True)`; the port's upload of the JAX
    package's tables equal to them;
  - `ats_sample`, `ats_pdf` (with and without a normal), `ats_sample_ray`
    and `ats_sample_split` (splitting factors 0, 0.5 and 1; on the first
    N_SPLIT lanes: a lane may visit every node) on N lanes of seeded
    numpy inputs on the sphere and two-light scenes, through the
    JAX functions jitted: the triangle ids equal on every lane but at most
    ID_FRAC of them, where the descent's uniform lies within ID_ATOL of a
    node's split p_l (the port's descent checks which; the importance
    terms' arccos, cos and sqrt round apart between XLA and torch); the
    pdfs of the lanes with equal ids within PDF_RTOL; the split's slot
    validity and overflow equal;
  - the path tracer with ATS (max_depth 3, 2 spp) on the sphere scene at
    16x16 on both routes (the per-pass `compute_pixel` and the persistent
    `compute_block`) against the JAX package's renders: every pixel within
    RENDER_RTOL (relative to the image's largest value);
  - point-normal with `-k 0.5` (the splitting traversal) on the sphere
    scene in a medium (sigma_s 0.0025) at 16x16, one sample: within
    RENDER_RTOL;
  - on the port alone: the fixed-depth descent equals one run deeper (the
    reference's while_loop), a scene without surface emitters raises
    ValueError.
"""
import functools
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustlight_tpu.bsdfs as jbsdfs
import rustlight_tpu.models as jmodels
import rustlight_tpu.scene as jscene
import rustlight_tpu_torch.bsdfs as tbsdfs
import rustlight_tpu_torch.models as tmodels
import rustlight_tpu_torch.scene as tscene
from rustlight_tpu.integrators import (IntegratorPathTracing as JaxPath,
                                       IntegratorPointNormal as JaxPN)
from rustlight_tpu.integrators.common import _pixel_grid
from rustlight_tpu.integrators.common import render as jax_render
from rustlight_tpu.scene import ats as jats
from rustlight_tpu.scene.loaders import load_scene as jax_load_scene
from rustlight_tpu.utils import rng as jrng
from rustlight_tpu_torch.integrators import (IntegratorPathTracing,
                                             IntegratorPointNormal, render)
from rustlight_tpu_torch.scene import ats as tats
from rustlight_tpu_torch.scene.loaders import load_scene
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

N, N_SPLIT = 4096, 512
CAUSTIC = Path(__file__).resolve().parents[1] / "examples" / "caustic.pbrt"
# descents: the lanes whose ids differ may be at most ID_FRAC of them, and
# each must have its uniform within ID_ATOL of a node's split
ID_FRAC, ID_ATOL = 1e-3, 1e-5
PDF_RTOL = 1e-4
RENDER_RTOL = 1e-4
DEPTH = 3
_FAST = {"xla_backend_optimization_level": 0}
_JIT = jax.jit
JAX = SimpleNamespace(Scene=jscene.Scene, make_quad=jscene.make_quad,
                      make_sphere=jscene.make_sphere,
                      make_camera=jscene.make_camera, look_at=jscene.look_at,
                      diffuse=jbsdfs.diffuse,
                      cornell_box=jmodels.cornell_box, load=jax_load_scene,
                      make_volume=jscene.make_volume)
PORT = SimpleNamespace(Scene=tscene.Scene, make_quad=tscene.make_quad,
                       make_sphere=tscene.make_sphere,
                       make_camera=tscene.make_camera,
                       look_at=tscene.look_at, diffuse=tbsdfs.diffuse,
                       cornell_box=tmodels.cornell_box, load=load_scene,
                       make_volume=tscene.make_volume)


def _two_lights(pk):
    """tests/test_ats.py's scene: a floor, a bright light near the origin
    and a dim one far off."""
    sc = pk.Scene()
    m = sc.add_material(pk.diffuse((0.7, 0.7, 0.7)))
    sc.add_mesh(pk.make_quad((-10, 0, -10), (10, 0, -10), (10, 0, 10),
                             (-10, 0, 10), material=m))
    sc.add_mesh(pk.make_quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1),
                             material=m, emission=(50, 50, 50)))
    sc.add_mesh(pk.make_quad((7, 4, -1), (9, 4, -1), (9, 4, 1), (7, 4, 1),
                             material=m, emission=(1, 1, 1)))
    sc.camera = pk.make_camera(24, 24, fov=60.0, to_world=pk.look_at(
        (0, 3, -8), (0, 1, 0), (0, 1, 0)))
    return sc


def _sphere_light(pk, w=16, h=16):
    """The Cornell box with an emissive UV sphere."""
    sc = pk.cornell_box(w, h)
    sc.add_mesh(pk.make_sphere((278.0, 330.0, 280.0), 60.0,
                               emission=(4.0, 3.0, 2.0), n_theta=8, n_phi=8))
    return sc


SCENES = {
    "cbox": lambda pk: pk.cornell_box(16, 16),
    "two_lights": _two_lights,
    "caustic": lambda pk: pk.load(str(CAUSTIC)),
    "sphere_light": _sphere_light,
}


def _fast_jit(f=None, **kw):
    kw.setdefault("compiler_options", _FAST)
    if f is None:
        return functools.partial(_fast_jit, **kw)
    return _JIT(f, **kw)


def _inputs(seed, lo, hi):
    rng = np.random.default_rng(seed)
    unit = lambda v: (v / np.linalg.norm(v, axis=-1, keepdims=True)  # noqa
                      ).astype(np.float32)
    return dict(
        p=rng.uniform(lo, hi, (N, 3)).astype(np.float32),
        n=unit(rng.normal(size=(N, 3))), d=unit(rng.normal(size=(N, 3))),
        tmax=rng.uniform(0.5, 2.0, N).astype(np.float32) * (hi - lo),
        u=rng.random(N).astype(np.float32),
        u_stack=rng.random((N, 40)).astype(np.float32))


# the device functions' cases: (scene, input box)
FN_SCENES = {"sphere_light": (0.0, 550.0), "two_lights": (-6.0, 6.0)}
SPLITS = (0.0, 0.5, 1.0)


def _jax_functions(ats, x):
    a = {k: jnp.asarray(v) for k, v in x.items()}
    f = _JIT(lambda p, n, u: jats.ats_sample(ats, p, n, u),
             compiler_options=_FAST)
    tri, pdf = f(a["p"], a["n"], a["u"])
    g = _JIT(lambda t, p, n: jats.ats_pdf(ats, t, p, n),
             compiler_options=_FAST)
    out = {"sample": (tri, pdf), "pdf_n": g(tri, a["p"], a["n"]),
           "pdf": _JIT(lambda t, p: jats.ats_pdf(ats, t, p, None),
                       compiler_options=_FAST)(tri, a["p"]),
           "ray": _JIT(lambda o, d, tm, u: jats.ats_sample_ray(
               ats, o, d, tm, u), compiler_options=_FAST)(
                   a["p"], a["d"], a["tmax"], a["u"])}
    split = _JIT(lambda o, d, tm, u, us, sf: jats.ats_sample_split(
        ats, o, d, tm, u, us, sf, 8), compiler_options=_FAST)
    for sf in SPLITS:
        out[f"split{sf}"] = split(*(a[k][:N_SPLIT] for k in (
            "p", "d", "tmax", "u", "u_stack")), sf)
    return {k: jax.tree.map(np.asarray, v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_side():
    out = {"tables": {}, "fn": {}}
    for name, make in SCENES.items():
        out["tables"][name] = make(JAX).compile(use_ats=True).host.data
    for name, box in FN_SCENES.items():
        out["fn"][name] = _jax_functions(
            jax.device_put(out["tables"][name].ats), _inputs(5, *box))
    # renders on the sphere scene, with jax.jit compiled at level 0
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "jit", _fast_jit)
    try:
        jsd = _sphere_light(JAX).compile(use_ats=True)
        out["host"] = jsd.host.data
        integ = JaxPath(max_depth=DEPTH)
        for route, pers in (("pixel", False), ("block", True)):
            out[route] = np.asarray(jax_render(
                jsd, integ, spp=2, seed=0, persistent=pers)["primal"])
        sc = _sphere_light(JAX)
        sc.volume = JAX.make_volume(sigma_s=(0.0025,) * 3)
        msd = sc.compile(use_ats=True)
        out["medium_host"] = msd.host.data
        pn = JaxPN(strategies=("equiangular",), splitting=0.5)
        pix = jnp.asarray(_pixel_grid(16, 16))
        f = jax.jit(lambda st: pn.compute_pixel(msd, pix, st))
        out["pn"] = np.asarray(f(jrng.stream_fold(jrng.make_stream(0), 0)))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_tables_match_jax(jax_side, name):
    ref = jax_side["tables"][name].ats
    got = SCENES[name](PORT).compile(device="cpu", use_ats=True)
    host = got.host.ats
    assert (host.n_nodes, host.root) == (ref.n_nodes, ref.root)
    for col in tats.COLUMNS:
        a, b = getattr(host, col), np.asarray(getattr(ref, col))
        assert a.dtype == b.dtype and a.shape == b.shape, col
        np.testing.assert_array_equal(a, b, err_msg=col)
        np.testing.assert_array_equal(getattr(got.ats, col).numpy(), b,
                                      err_msg=col)
    up = from_numpy_scene(jax_side["tables"][name], "cpu").ats
    assert up.depth == host.depth == tats.tree_depth(ref.parent)
    for col in tats.COLUMNS:
        np.testing.assert_array_equal(getattr(up, col).numpy(),
                                      np.asarray(getattr(ref, col)))
    if name == "sphere_light":
        assert host.depth >= 6 and host.n_nodes > 200


def _port_functions(ats, x):
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    tri, pdf = tats.ats_sample(ats, t["p"], t["n"], t["u"])
    out = {"sample": (tri, pdf), "pdf_n": tats.ats_pdf(ats, tri, t["p"],
                                                       t["n"]),
           "pdf": tats.ats_pdf(ats, tri, t["p"], None),
           "ray": tats.ats_sample_ray(ats, t["p"], t["d"], t["tmax"],
                                      t["u"])}
    for sf in SPLITS:
        out[f"split{sf}"] = tats.ats_sample_split(
            ats, *(t[k][:N_SPLIT] for k in ("p", "d", "tmax", "u",
                                            "u_stack")), sf, 8)
    return {k: tuple(v.numpy() for v in r) if isinstance(r, tuple)
            else r.numpy() for k, r in out.items()}


def _near_split(ats, imp_fn, u, lanes):
    """Whether each lane's descent passes a node whose split p_l lies
    within ID_ATOL of its running uniform (the port's tables, float64
    bookkeeping of the same rule)."""
    out = []
    for lane in lanes:
        node, r, near = ats.root, float(u[lane]), False
        while int(ats.leaf_tri[node]) < 0:
            l, rt = int(ats.left[node]), int(ats.right[node])
            il, ir = imp_fn(lane, l), imp_fn(lane, rt)
            p_l = il / (il + ir) if il + ir > 0 else 0.5
            near |= abs(r - p_l) < ID_ATOL
            left = r < p_l
            r = (r / max(p_l, 1e-20) if left
                 else (r - p_l) / max(1 - p_l, 1e-20))
            r = min(max(r, 0.0), 1 - 1e-7)
            node = l if left else rt
        out.append(near)
    return np.asarray(out, bool)


def _imp_point(ats, x):
    def f(lane, node):
        return float(tats._node_importance(
            ats, torch.tensor([node]), torch.as_tensor(x["p"][lane:lane + 1]),
            torch.as_tensor(x["n"][lane:lane + 1]))[0])
    return f


def _imp_ray(ats, x):
    def f(lane, node):
        s = slice(lane, lane + 1)
        return float(tats._node_importance_ray(
            ats, torch.tensor([node]), torch.as_tensor(x["p"][s]),
            torch.as_tensor(x["d"][s]), torch.as_tensor(x["tmax"][s]))[0])
    return f


@pytest.mark.parametrize("scene", list(FN_SCENES))
def test_device_functions_match_jax(jax_side, scene):
    x = _inputs(5, *FN_SCENES[scene])
    ats = from_numpy_scene(jax_side["tables"][scene], "cpu").ats
    got, ref = _port_functions(ats, x), jax_side["fn"][scene]
    for key, imp in (("sample", _imp_point), ("ray", _imp_ray)):
        (tri, pdf), (rtri, rpdf) = got[key], ref[key]
        diff = np.nonzero(tri != rtri)[0]
        assert len(diff) <= ID_FRAC * N, (key, len(diff))
        assert _near_split(ats, imp(ats, x), x["u"], diff).all(), key
        same = tri == rtri
        np.testing.assert_allclose(pdf[same], rpdf[same], rtol=PDF_RTOL)
        assert (rtri >= 0).all() and (rpdf > 0).all()
    same = got["sample"][0] == ref["sample"][0]
    for key in ("pdf_n", "pdf"):
        np.testing.assert_allclose(got[key][same], ref[key][same],
                                   rtol=PDF_RTOL, atol=1e-12)
    # the parent walk's pdf is the descent's
    np.testing.assert_allclose(got["pdf_n"], got["sample"][1], rtol=PDF_RTOL)
    for sf in SPLITS:
        tri, pdf, valid, over = got[f"split{sf}"]
        rtri, rpdf, rvalid, rover = ref[f"split{sf}"]
        lanes = np.all(tri == rtri, axis=1)
        assert (~lanes).sum() <= ID_FRAC * N_SPLIT, (sf, (~lanes).sum())
        np.testing.assert_array_equal(valid[lanes], rvalid[lanes])
        np.testing.assert_array_equal(over, rover)
        np.testing.assert_allclose(pdf[lanes], rpdf[lanes], rtol=PDF_RTOL)
        if sf == 1.0:
            assert valid.sum(1).max() > 1    # the traversal split


@pytest.mark.parametrize("route", ["pixel", "block"])
def test_path_render_matches_jax(jax_side, route):
    sd = from_numpy_scene(jax_side["host"], "cpu")
    img = render(sd, IntegratorPathTracing(max_depth=DEPTH), 2, seed=0,
                 persistent=route == "block")["primal"]
    ref = jax_side[route]
    assert np.all(np.isfinite(img)) and ref.mean() > 0
    np.testing.assert_allclose(img, ref, rtol=RENDER_RTOL,
                               atol=RENDER_RTOL * ref.max())


def test_point_normal_splitting_matches_jax(jax_side):
    sd = from_numpy_scene(jax_side["medium_host"], "cpu")
    assert sd.ats is not None and sd.volume is not None
    pn = IntegratorPointNormal(strategies=("equiangular",), splitting=0.5)
    pix = torch.as_tensor(_pixel_grid(16, 16))
    li = pn.compute_pixel(sd, pix, trng.stream_fold(
        trng.make_stream(0, "cpu"), 0)).numpy()
    ref = jax_side["pn"]
    assert np.all(np.isfinite(li)) and ref.max() > 0
    np.testing.assert_allclose(li, ref, rtol=RENDER_RTOL,
                               atol=RENDER_RTOL * ref.max())


def test_fixed_depth_descent_is_the_while_loop(jax_side):
    """A descent run for depth levels equals one run three levels longer:
    a lane at its leaf stays there, as in the reference's while_loop."""
    ats = from_numpy_scene(jax_side["tables"]["sphere_light"], "cpu").ats
    x = _inputs(9, 0.0, 550.0)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    deeper = ats._replace(depth=ats.depth + 3)
    for a, b in zip(tats.ats_sample(ats, t["p"], t["n"], t["u"]),
                    tats.ats_sample(deeper, t["p"], t["n"], t["u"])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    tri = tats.ats_sample(ats, t["p"], t["n"], t["u"])[0]
    np.testing.assert_array_equal(tats.ats_pdf(ats, tri, t["p"], None),
                                  tats.ats_pdf(deeper, tri, t["p"], None))


def test_no_surface_emitter_raises():
    sc = PORT.cornell_box(8, 8)
    sc.meshes = [m for m in sc.meshes if not m.is_light]
    sc.point_lights.append(((278.0, 500.0, 280.0), (1e5, 1e5, 1e5)))
    with pytest.raises(ValueError, match="surface emitters"):
        sc.compile(device="cpu", use_ats=True)

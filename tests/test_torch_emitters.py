"""The port's emitter atoms and environment terms against the JAX package's.

Two scenes, the JAX package's compiled tables uploaded to the port: a
Cornell box whose light has texture emission (a 16x16 ramp atlas) plus a
point, a directional and a point-normal light under the textured
environment of examples/sky.exr (128x256); and the same box with HSV
emission under a constant environment. One jitted JAX call per scene (a
module fixture) computes, on 4,096 lanes made from a numpy seed:
sample_light, env_radiance, env_direction_pdf, sample_position,
sample_emission_direction, emitted_radiance at a random uv,
sample_continuous_2d and pdf_2d over the environment's CDF and
sample_continuous_1d over the atoms'; the port computes the same.

Bounds: discrete fields (atom, kind, is_delta, valid, triangle) equal;
continuous fields within FLOAT_TOL relative to the lane's largest
component, at least 1 (no exp, log or pow is involved). The environment
lookups take atan2 and acos, which libm and XLA may round apart in the
last ulp: a lane may then read the
neighbouring texel, and only where its continuous coordinate (u or v, in
[0, 1)) lies within BORDER of a texel border. Such lanes are counted and
excused; every other lane must read the same texel.

Renders through both packages (`slow`: each JAX function takes seconds to
compile): envglass, fog_box (the medium with its point light), caustic, the
point + directional scene of tests/test_oracle.py:250-268 and
furnace_scene, each at 16x12, 2 spp, seed 0: compute_block,
compute_pixel, direct and the light tracer. Bound: PIX_FRAC of the pixels
within PIX_RTOL (relative, 1e-4 floor), means within MEAN_RTOL. One
port-only render stays in tier 1: the white furnace at 24x24, 48 spp
(tests/test_integrators.py:25-35's patch and bounds).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.bsdfs import diffuse as jax_diffuse
from rustlight_tpu.integrators import (IntegratorDirect as JaxDirect,
                                       IntegratorLightTracing as JaxLight,
                                       IntegratorPathTracing as JaxPath)
from rustlight_tpu.integrators.common import render as jax_render
from rustlight_tpu.integrators.common import render_splat as jax_render_splat
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.models import furnace_scene as jax_furnace_scene
from rustlight_tpu.scene import emitters as je
from rustlight_tpu.scene import Scene as JaxScene
from rustlight_tpu.scene import look_at as jax_look_at
from rustlight_tpu.scene import make_camera as jax_make_camera
from rustlight_tpu.scene import make_quad as jax_make_quad
from rustlight_tpu.scene.camera import resize_camera as jax_resize_camera
from rustlight_tpu.scene.loaders import load_scene as jax_load_scene
from rustlight_tpu.utils import distribution as jdist
from rustlight_tpu.utils import image as jimage
from rustlight_tpu_torch.integrators import (IntegratorDirect,
                                             IntegratorLightTracing,
                                             IntegratorPathTracing, render,
                                             render_splat)
from rustlight_tpu_torch.models import furnace_scene
from rustlight_tpu_torch.scene import emitters as te
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import distribution as tdist

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N = 4096
FLOAT_TOL = 1e-5
BORDER = 1e-5
PIX_FRAC, PIX_RTOL, MEAN_RTOL = 0.999, 1e-3, 1e-4
BOX_LO, BOX_HI = (1.0, 1.0, 1.0), (550.0, 547.0, 558.0)


def _atom_scene(textured):
    """The Cornell box with every atom kind (see the module docstring)."""
    sc = jax_cornell_box(16, 16)
    for m in sc.meshes:
        if m.is_light:
            m.emission_kind = 2 if textured else 1
            m.emission_scale = 15.0
            m.emission_tex = 0
    yy, xx = np.mgrid[0:16, 0:16].astype(np.float32) / 15.0
    sc.textures = np.stack([xx, yy, 0.5 * (1 - xx)], -1)[None]
    sc.point_lights.append(((150.0, 400.0, 200.0), (4e4, 3e4, 2e4)))
    sc.directional_lights.append(((0.3, -1.0, 0.2), (0.6, 0.7, 0.8)))
    sc.point_normal_lights.append(((400.0, 300.0, 300.0), (-1.0, -0.2, 0.1),
                                   (3e4, 3e4, 3e4)))
    if textured:
        sc.env_image = jimage.load(ROOT / "examples" / "sky.exr")
    else:
        sc.env_constant = np.asarray([0.4, 0.5, 0.6], np.float32)
    return sc.compile()


def _lanes(seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tri = rng.integers(-1, 40, N).astype(np.int32)
    tri[: N // 4] = rng.integers(18, 20, N // 4)   # the light's triangles
    return dict(
        p=rng.uniform(BOX_LO, BOX_HI, (N, 3)).astype(np.float32),
        u_sel=rng.uniform(size=N).astype(np.float32),
        u_pos=rng.uniform(size=(N, 2)).astype(np.float32),
        u_dir=rng.uniform(size=(N, 2)).astype(np.float32),
        d=d, tri=tri, ix=rng.integers(0, 1 << 20, N).astype(np.int32),
        uv=rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32))


def _all(em, geom, dist, m, ns):
    """Every function under test on lanes `m`, through namespaces ns =
    (emitters module, distribution module): a flat dict of outputs."""
    emm, dm = ns
    ls = emm.sample_light(em, geom, m["p"], m["u_sel"], m["u_pos"])
    ps = emm.sample_position(em, geom, m["u_sel"], m["u_pos"])
    d, pdf, w = emm.sample_emission_direction(em, ps, m["u_dir"])
    out = {f"ls.{k}": v for k, v in ls._asdict().items()}
    out.update({f"ps.{k}": v for k, v in ps._asdict().items()})
    out.update({"dir.d": d, "dir.pdf": pdf, "dir.weight": w,
                "env_radiance": emm.env_radiance(em, m["d"]),
                "env_pdf": emm.env_direction_pdf(em, m["d"]),
                "le_uv": emm.emitted_radiance(em, geom, m["tri"], m["d"],
                                              uv=m["uv"]),
                "cont2d": dm.sample_continuous_2d(dist, m["u_pos"])})
    x, idx, du = dm.sample_continuous_1d(em.atom_cdf, m["u_sel"])
    h, w = dist.func.shape
    out.update({"cont1d.x": x, "cont1d.idx": idx, "cont1d.du": du,
                "pdf2d": dm.pdf_2d(dist, m["ix"] % w, m["ix"] % h)})
    return out


@pytest.fixture(scope="module", params=["textured", "constant"])
def atoms(request):
    """(scene name, JAX outputs, port outputs, lanes) from one jit."""
    jsd = _atom_scene(request.param == "textured")
    lanes = _lanes(7)

    @jax.jit
    def run(m):
        return _all(jsd.emitters, jsd.geom, jsd.emitters.env_cdf, m,
                    (je, jdist))
    ref = jax.tree_util.tree_map(
        np.asarray, run({k: jnp.asarray(v) for k, v in lanes.items()}))
    sd = from_numpy_scene(jsd.host.data, "cpu")
    tl = {k: torch.as_tensor(v) for k, v in lanes.items()}
    tl["tri"] = tl["tri"].long()
    tl["ix"] = tl["ix"].long()
    got = {k: v.numpy() for k, v in _all(sd.emitters, sd.geom,
                                         sd.emitters.env_cdf, tl,
                                         (te, tdist)).items()}
    return request.param, ref, got, lanes


def _far(got, ref):
    """Lanes outside FLOAT_TOL, relative to the lane's largest component
    (a point's coordinates are held to its distance from the origin)."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    scale = np.maximum(np.abs(ref).max(-1, keepdims=True), 1.0)
    return (~(np.abs(got - ref) <= FLOAT_TOL * scale)).any(-1)


def _border(d, shape):
    """Lanes whose environment coordinate u or v lies within BORDER of a
    texel border (float64 from the same direction)."""
    d = np.asarray(d, np.float64)
    theta = np.arccos(np.clip(d[:, 2], -1, 1))
    phi = np.mod(np.arctan2(d[:, 1], d[:, 0]), 2 * np.pi)
    h, w = shape
    near = np.zeros(len(d), bool)
    for c, n in ((phi / (2 * np.pi), w), (theta / np.pi, h)):
        x = c * n
        near |= np.abs(x - np.round(x)) < BORDER * n
    return near


DISCRETE = ("ls.is_delta", "ls.valid", "ls.tri", "ps.kind", "ps.atom",
            "ps.valid", "cont1d.idx")


def test_discrete_fields_equal(atoms):
    _, ref, got, _ = atoms
    for k in DISCRETE:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    kinds = set(ref["ps.kind"].tolist())
    assert kinds == {je.ATOM_TRI, je.ATOM_POINT, je.ATOM_DIR, je.ATOM_PN,
                     je.ATOM_ENV}, kinds
    # each kind was sampled by NEE on a good share of the lanes
    assert ref["ls.valid"].mean() > 0.5 and ref["ls.is_delta"].mean() > 0.1


@pytest.mark.parametrize("field", [
    "ls.p", "ls.n", "ls.d", "ls.dist", "ls.pdf", "ls.weight", "ps.p", "ps.n",
    "ps.pdf_area", "ps.weight", "dir.d", "dir.pdf", "dir.weight", "le_uv",
    "cont2d", "cont1d.x", "cont1d.du", "pdf2d"])
def test_continuous_fields_within_tolerance(atoms, field):
    _, ref, got, _ = atoms
    assert got[field].shape == ref[field].shape
    assert np.all(np.isfinite(got[field]))
    bad = _far(got[field], ref[field])
    assert not bad.any(), (field, int(bad.sum()))


@pytest.mark.parametrize("field", ["env_radiance", "env_pdf"])
def test_environment_lookups_read_the_same_texel(atoms, field):
    name, ref, got, lanes = atoms
    bad = _far(got[field], ref[field])
    if name == "constant":
        assert not bad.any()
        return
    excused = _border(lanes["d"], (128, 256))
    assert not (bad & ~excused).any(), int((bad & ~excused).sum())
    assert bad.sum() <= max(4, 0.002 * N), int(bad.sum())
    assert ref[field].std() > 0   # a textured map: the texel matters


def test_uv_emission_kinds_differ_from_the_mean(atoms):
    """The emission read at a hit's uv is not the table's mean Le."""
    name, ref, got, lanes = atoms
    on = (lanes["tri"] >= 18) & (lanes["tri"] <= 19)
    front = got["le_uv"][on].max(-1) > 0
    assert front.sum() > 64
    assert np.unique(np.round(got["le_uv"][on][front], 4), axis=0).shape[0] > 32


def test_furnace_is_analytic():
    """A diffuse sphere of albedo 0.5 in a unit furnace: each first bounce
    escapes, so the sphere's pixels are 0.5 and the background 1
    (tests/test_integrators.py:25-35, the same patch and bounds)."""
    sd = furnace_scene(24, 24, albedo=0.5).compile(device="cpu")
    assert sd.geom.walk is not None and sd.emitters.kinds == {te.ATOM_ENV}
    img = render(sd, IntegratorPathTracing(max_depth=6, rr_depth=None),
                 spp=48, seed=1)["primal"]
    assert abs(img[0, 0].mean() - 1.0) < 1e-3, img[0, 0]
    assert abs(img[8:16, 8:16].mean() - 0.5) < 0.015, img[8:16, 8:16].mean()


# ------------------------------------------------------- renders (slow)

def _point_dir_scene():
    """tests/test_oracle.py:250-268's floor and back wall under a point and
    a directional light."""
    sc = JaxScene()
    m = sc.add_material(jax_diffuse((0.6, 0.55, 0.5)))
    sc.add_mesh(jax_make_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5),
                              material=m))
    sc.add_mesh(jax_make_quad((-5, 0, -5), (-5, 4, -5), (5, 4, -5),
                              (5, 0, -5), material=m))
    sc.point_lights.append(((0.0, 3.0, 1.0), (8.0, 7.0, 6.0)))
    sc.directional_lights.append(((0.3, -1.0, 0.2), (0.6, 0.7, 0.8)))
    sc.camera = jax_make_camera(16, 12, fov=60.0, to_world=jax_look_at(
        (0, 2.5, 6), (0, 1, 0), (0, 1, 0)))
    return sc


def _render_scene(name):
    """The JAX host scene `name` at 16x12."""
    if name == "point_dir":
        return _point_dir_scene()
    if name == "furnace":
        return jax_furnace_scene(16, 12)
    sc = jax_load_scene(ROOT / "examples" / name)
    sc.camera = jax_resize_camera(sc.camera, 16, 12)
    return sc


RENDER_SCENES = ["envglass.xml", "fog_box.xml", "caustic.pbrt", "point_dir",
                 "furnace"]
INTEGRATORS = {
    "block": (lambda: JaxPath(max_depth=8), lambda: IntegratorPathTracing(
        max_depth=8), True),
    "pixel": (lambda: JaxPath(max_depth=8), lambda: IntegratorPathTracing(
        max_depth=8), False),
    "direct": (JaxDirect, IntegratorDirect, None),
    "light": (lambda: JaxLight(max_depth=8, hard_cap=8),
              lambda: IntegratorLightTracing(max_depth=8, hard_cap=8), None),
}


@pytest.mark.slow
@pytest.mark.parametrize("integ", sorted(INTEGRATORS))
@pytest.mark.parametrize("name", RENDER_SCENES)
def test_render_matches_jax(name, integ):
    jax_integ, port_integ, persistent = INTEGRATORS[integ]
    jsd = _render_scene(name).compile()
    sd = from_numpy_scene(jsd.host.data, "cpu")
    if integ == "light":
        ref = jax_render_splat(jsd, jax_integ(), 2, seed=0)["primal"]
        got = render_splat(sd, port_integ(), 2, seed=0)["primal"]
    else:
        ref = jax_render(jsd, jax_integ(), 2, seed=0,
                         persistent=persistent)["primal"]
        got = render(sd, port_integ(), 2, seed=0,
                     persistent=persistent)["primal"]
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (12, 16, 3) and np.all(np.isfinite(got))
    assert ref.mean() > 1e-3
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-4)
    assert (rel.max(-1) <= PIX_RTOL).mean() >= PIX_FRAC
    assert abs(got.mean() - ref.mean()) <= MEAN_RTOL * ref.mean()

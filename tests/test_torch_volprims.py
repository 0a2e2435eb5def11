"""The port's photon primitives (BRE, beams, planes, VRL) and single-
scattering photon planes against the JAX package's.

  - plane_single.extract_rect_lights on the port's compiled Cornell box and
    on the JAX package's (host tables): both equal to the JAX package's
    function, bit for bit;
  - IntegratorSinglePlane._gen_planes, the 256 planes of each type (UV,
    UT, VT) that compute_pixel draws on the box's light in the regression
    rows' medium: within FLOAT_RTOL (relative, absolute floor FLOAT_ATOL),
    light ids equal (UAlphaT's in the `slow` strategies' renders);
  - trace_volume_light_paths (21 paths, cap 6) and _collect for each mode
    on cbox 8x8 in the medium: vertex kinds and valid masks equal, floats
    within FLOAT_RTOL;
  - compute_pixel on cbox 8x8 in the medium, one sample: plane-single
    (256 planes, `average`) and its uncorrelated form, and the four
    primitives (nb_primitive 128, max_depth = hard_cap = 6, radius 8, as
    tools/regression.py's rows but fewer primitives): within PIXEL_RTOL;
  - `slow`: every strategy of plane-single against the JAX package, and
    the six regression rows cbox_medium_single/plane-single,
    plane-single-unc and cbox_medium_prims/{bre,beams,planes,vrl} at
    tools/regression.py's settings against their stored metrics within
    1e-4 relative.

The JAX side is one jitted function in a module fixture (compiled without
LLVM's optimizations: about half the compile time). The four primitives'
compute_pixel share one trace of the light paths: the JAX package's
trace_volume_light_paths is wrapped to trace once and hand the same record
to each (their arguments are equal), and the record is kept as an output,
as are the planes of plane-single's compute_pixel.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.integrators import IntegratorSinglePlane as JaxPlane
from rustlight_tpu.integrators import IntegratorVolPrimitives as JaxPrims
from rustlight_tpu.integrators import plane_single as jps
from rustlight_tpu.integrators import vol_primitives as jvp
from rustlight_tpu.integrators.common import _pixel_grid
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.scene import make_volume as jax_make_volume
from rustlight_tpu.utils import rng as jrng
from rustlight_tpu_torch.integrators import (IntegratorSinglePlane,
                                             IntegratorVolPrimitives, render)
from rustlight_tpu_torch.integrators import plane_single as tps
from rustlight_tpu_torch.integrators import vol_primitives as tvp
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.scene import make_volume
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-5
PIXEL_RTOL = 1e-4
W = H = 8
MEDIUM = dict(sigma_s=(0.0025,) * 3)   # tools/regression.py's cbox_medium
PRIMS = ("bre", "beams", "planes", "vrl")
PRIM_ARGS = dict(nb_primitive=128, max_depth=6, hard_cap=6, radius=8.0)
N_PATHS, CAP = 21, 6                    # 128 // 6 paths of 6 bounces
PLANE_ARGS = dict(nb_primitive=256, strategy="average")
_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _close(got, ref, rtol=FLOAT_RTOL, atol=FLOAT_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


def _jax_scene(w=W, h=H):
    sc = jax_cornell_box(w, h)
    sc.volume = jax_make_volume(**MEDIUM)
    return sc.compile()


def _stream():
    return trng.stream_fold(trng.make_stream(0, "cpu"), 0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's results on cbox 8x8 in the medium: host tables,
    the light-path record and each mode's primitives, each primitive's and
    each plane form's compute_pixel, and the planes of _gen_planes."""
    jsd = _jax_scene()
    pix = jnp.asarray(_pixel_grid(W, H))
    stream = jrng.stream_fold(jrng.make_stream(0), 0)
    trace = jvp.trace_volume_light_paths
    once = {}

    def trace_once(*args, **kw):
        if "rec" not in once:
            once["rec"] = trace(*args, **kw)
        return once["rec"]

    def prims(s):
        once.clear()
        with mock.patch.object(jvp, "trace_volume_light_paths", trace_once):
            li = {p: JaxPrims(primitives=p, **PRIM_ARGS).compute_pixel(
                jsd, pix, s) for p in PRIMS}
        rec = once["rec"]
        collected = {p: JaxPrims(primitives=p, **PRIM_ARGS)._collect(rec)
                     for p in PRIMS}
        return li, rec._replace(n_paths=0), collected

    planes = {}
    for unc in (False, True):
        planes[unc] = JaxPlane(uncorrelated=unc, **PLANE_ARGS)
        planes[unc].prepare(jsd)
    made = {}
    gen_planes = planes[False]._gen_planes

    def keep(scene, rl, kinds, count, s):
        made["planes"] = gen_planes(scene, rl, kinds, count, s)
        return made["planes"]
    planes[False]._gen_planes = keep

    def side(s):
        li, rec, collected = prims(s)
        li_planes = {unc: p.compute_pixel(jsd, pix, s)
                     for unc, p in planes.items()}
        return li, rec, collected, made["planes"][0], li_planes

    li, rec, collected, gen, li_planes = jax.jit(
        side, compiler_options=_FAST_COMPILE)(stream)
    return dict(host=jsd.host.data, li=_np(li), rec=_np(rec),
                collected=_np(collected), gen=_np(gen),
                li_planes=_np(li_planes))


def _sd(jax_side):
    return from_numpy_scene(jax_side["host"], "cpu")


def _pixel(sd, integ):
    pix = torch.as_tensor(_pixel_grid(W, H))
    if hasattr(integ, "prepare"):
        integ.prepare(sd)
    return integ.compute_pixel(sd, pix, _stream()).numpy()


def test_extract_rect_lights_matches_jax_bit_for_bit():
    jsd = _jax_scene()
    ref = jps.extract_rect_lights(jsd.host.data)
    sc = cornell_box(W, H)
    sc.volume = make_volume(**MEDIUM)
    for host in (jsd.host.data, sc.compile(device="cpu").host):
        got = tps.extract_rect_lights(host)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], ref[k])
    assert ref["o"].shape == (1, 3)


def test_gen_planes_match_jax(jax_side):
    """The pool of compute_pixel (`average`: UV, UT and VT planes, drawn on
    stream_fold(stream, 5) after u_pix)."""
    sd = _sd(jax_side)
    integ = IntegratorSinglePlane(**PLANE_ARGS)
    integ.prepare(sd)
    _, stream = trng.stream_next2d(_stream(), (W * H,))
    got, _ = integ._gen_planes(sd, integ._rect_lights(), [
        tps.PLANE_UV, tps.PLANE_UT, tps.PLANE_VT], 256,
        trng.stream_fold(stream, 5))
    assert sorted(got) == sorted(jax_side["gen"])
    for kind, ref in jax_side["gen"].items():
        np.testing.assert_array_equal(got[kind]["lid"].numpy(), ref["lid"])
        for f in ("o", "d0", "d1", "l0", "l1", "w"):
            _close(got[kind][f], ref[f])


@pytest.mark.parametrize("unc", [False, True], ids=["pool", "uncorrelated"])
def test_plane_single_compute_pixel_matches_jax(jax_side, unc):
    ref = jax_side["li_planes"][unc]
    got = _pixel(_sd(jax_side), IntegratorSinglePlane(uncorrelated=unc,
                                                      **PLANE_ARGS))
    assert ref.mean() > 0
    _close(got, ref, rtol=PIXEL_RTOL, atol=1e-8)


def test_light_paths_and_primitives_match_jax(jax_side):
    sd = _sd(jax_side)
    rec = tvp.trace_volume_light_paths(
        sd, N_PATHS, CAP, trng.stream_fold(_stream(), 4242), rr_depth=0,
        max_depth=6)
    ref = jax_side["rec"]
    for f in ("vkind", "evalid"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(),
                                      getattr(ref, f))
    kinds = set(ref.vkind.ravel().tolist())
    assert {tvp.V_LIGHT, tvp.V_SURFACE, tvp.V_VOLUME} <= kinds
    for f in ("vpos", "vflux", "vdin", "edir", "edist", "econt"):
        _close(getattr(rec, f), getattr(ref, f))
    for p in PRIMS:
        got = IntegratorVolPrimitives(primitives=p, **PRIM_ARGS)._collect(rec)
        want = jax_side["collected"][p]
        assert sorted(got) == sorted(want)
        for group in want:
            assert sorted(got[group]) == sorted(want[group])
            for f, v in want[group].items():
                g = got[group][f].numpy()
                if v.dtype == bool:
                    np.testing.assert_array_equal(g, v)
                    assert v.any()
                else:
                    _close(g, v)


@pytest.mark.parametrize("prim", PRIMS)
def test_primitives_compute_pixel_matches_jax(jax_side, prim):
    ref = jax_side["li"][prim]
    got = _pixel(_sd(jax_side), IntegratorVolPrimitives(primitives=prim,
                                                        **PRIM_ARGS))
    assert ref.mean() > 0
    _close(got, ref, rtol=PIXEL_RTOL, atol=1e-8)


def test_medium_and_bounces_are_required():
    sd = cornell_box(4, 4).compile(device="cpu")
    pix = torch.zeros((1, 2), dtype=torch.int32)
    for integ in (IntegratorVolPrimitives(), IntegratorSinglePlane()):
        with pytest.raises(ValueError, match="needs a medium"):
            if hasattr(integ, "prepare"):
                integ.prepare(sd)
            integ.compute_pixel(sd, pix, _stream())
    sc = cornell_box(4, 4)
    sc.volume = make_volume(**MEDIUM)
    with pytest.raises(ValueError, match="planes need at least 3 bounces"):
        IntegratorVolPrimitives(primitives="planes", max_depth=2).compute_pixel(
            sc.compile(device="cpu"), pix, _stream())
    with pytest.raises(ValueError, match="primitives"):
        IntegratorVolPrimitives(primitives="photons")
    with pytest.raises(ValueError, match="strategy"):
        IntegratorSinglePlane(strategy="mis")


@pytest.mark.slow
@pytest.mark.parametrize("strategy", tps.STRATEGIES)
def test_plane_single_strategies_match_jax(strategy):
    jsd = _jax_scene(16, 16)
    pix = _pixel_grid(16, 16)
    ji = JaxPlane(nb_primitive=128, strategy=strategy)
    ji.prepare(jsd)
    ref = np.asarray(jax.jit(lambda s: ji.compute_pixel(
        jsd, jnp.asarray(pix), s), compiler_options=_FAST_COMPILE)(
        jrng.stream_fold(jrng.make_stream(0), 0)))
    sd = from_numpy_scene(jsd.host.data, "cpu")
    ti = IntegratorSinglePlane(nb_primitive=128, strategy=strategy)
    ti.prepare(sd)
    got = ti.compute_pixel(sd, torch.as_tensor(pix), _stream()).numpy()
    assert ref.mean() > 0
    _close(got, ref, rtol=PIXEL_RTOL, atol=1e-8)


# tools/regression.py's rows (:77-88) and integrators (:130-139)
ROWS = {
    ("cbox_medium_single", "plane-single"): (lambda: IntegratorSinglePlane(
        nb_primitive=256, strategy="average"), 32),
    ("cbox_medium_single", "plane-single-unc"): (
        lambda: IntegratorSinglePlane(nb_primitive=256, strategy="average",
                                      uncorrelated=True), 32),
    **{("cbox_medium_prims", p): (
        (lambda p=p: IntegratorVolPrimitives(
            nb_primitive=1024, max_depth=6, hard_cap=6, primitives=p,
            radius=8.0)), 8) for p in PRIMS},
}


@pytest.mark.slow
@pytest.mark.parametrize("name, tech", sorted(ROWS))
def test_regression_rows_match_the_stored_rows(name, tech):
    """The row at tools/regression.py's settings (cornell_box(128, 128) in
    the medium, 32 spp or 8 for the primitives, seed 0, the per-pass
    route): each metric against regress/refs/<name>.exr within 1e-4 of
    regress/results.json's."""
    import json
    from pathlib import Path
    from rustlight_tpu_torch.utils.image import read_exr
    from rustlight_tpu_torch.utils.metrics import metric_scalar
    root = Path(__file__).resolve().parents[1] / "regress"
    make, spp = ROWS[(name, tech)]
    sc = cornell_box(128, 128)
    sc.volume = make_volume(**MEDIUM)
    img = render(sc.compile(device="cpu"), make(), spp, seed=0)["primal"]
    ref = read_exr(root / "refs" / f"{name}.exr")
    stored = json.loads((root / "results.json").read_text())[
        f"{name}/{tech}"]
    for m in ("l1", "l2", "mape", "dssim"):
        assert abs(metric_scalar(ref, img, m) - stored[m]) <= (
            1e-4 * stored[m]), m

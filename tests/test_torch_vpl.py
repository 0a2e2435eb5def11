"""The port's VPL integrator against the JAX package's.

  - IntegratorVPL(nb_vpl=64, max_depth=6, hard_cap=6) (9 light paths, 63
    VPL slots) on cbox 8x8 in the regression rows' medium, one sample
    (stream_fold(make_stream(0), 0)): the VplSet that compute_pixel
    shoots (on stream_fold(stream, 999)) against the one the JAX package's
    compute_pixel shoots, kinds and material ids equal, floats within
    FLOAT_RTOL (relative, absolute floor FLOAT_ATOL; uv at the surface
    VPLs, which alone read it); the radiance of compute_pixel within
    PIXEL_RTOL;
  - the same without the medium (`slow`: its JAX function takes about 6 s
    to compile);
  - the gather's chunking: any `vpl_chunk` gives the same radiance, and the
    draw order of compute_pixel with a medium;
  - `slow`: the regression row cbox_path/vpl (tools/regression.py:
    IntegratorVPL(nb_vpl=256, max_depth=6, hard_cap=6) on cornell_box(128,
    128), 32 spp, seed 0, the per-pass route) against its stored metrics
    within 1e-4 relative.

The JAX side is one jitted compute_pixel a scene (compiled without LLVM's
optimizations: about half the compile time), its VplSet kept as a second
output by wrapping the JAX integrator's generate_vpls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.integrators import IntegratorVPL as JaxVPL
from rustlight_tpu.integrators.common import _pixel_grid
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.scene import make_volume as jax_make_volume
from rustlight_tpu.utils import rng as jrng
from rustlight_tpu_torch.integrators import IntegratorVPL, render
from rustlight_tpu_torch.integrators import vpl as tvpl
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.scene import make_volume
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-5
PIXEL_RTOL = 1e-4
W = H = 8
MEDIUM = dict(sigma_s=(0.0025,) * 3)   # tools/regression.py's cbox_medium
SMALL = dict(nb_vpl=64, max_depth=6, hard_cap=6)
_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _close(got, ref, rtol=FLOAT_RTOL, atol=FLOAT_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def jax_side():
    """medium -> (the JAX scene's host tables, compute_pixel's radiance,
    its VplSet as numpy arrays), each made once on first use."""
    made = {}

    def get(medium):
        if medium not in made:
            sc = jax_cornell_box(W, H)
            if medium:
                sc.volume = jax_make_volume(**MEDIUM)
            jsd = sc.compile()
            ji = JaxVPL(**SMALL)
            shot = {}
            generate = ji.generate_vpls

            def keep(scene, stream):
                shot["vpls"] = generate(scene, stream)
                return shot["vpls"]
            ji.generate_vpls = keep
            pix = jnp.asarray(_pixel_grid(W, H))
            li, vpls = jax.jit(
                lambda s: (ji.compute_pixel(jsd, pix, s), shot["vpls"]),
                compiler_options=_FAST_COMPILE)(
                jrng.stream_fold(jrng.make_stream(0), 0))
            made[medium] = (jsd.host.data, np.asarray(li),
                            {k: np.asarray(v) for k, v in
                             vpls._asdict().items()})
        return made[medium]
    return get


def _stream():
    return trng.stream_fold(trng.make_stream(0, "cpu"), 0)


def _pixel(sd, integ):
    pix = torch.as_tensor(_pixel_grid(W, H))
    return integ.compute_pixel(sd, pix, _stream()).numpy()


def _check(jax_side, medium):
    host, li_ref, vpls_ref = jax_side(medium)
    sd = from_numpy_scene(host, "cpu")
    vpls = IntegratorVPL(**SMALL).generate_vpls(
        sd, trng.stream_fold(_stream(), 999))
    assert vpls.kind.shape == (63,) and vpls.norm == pytest.approx(
        float(vpls_ref["norm"]))
    for f in ("kind", "mat"):
        np.testing.assert_array_equal(getattr(vpls, f).numpy(), vpls_ref[f])
    kinds = set(vpls_ref["kind"].tolist())
    assert {tvpl.VPL_EMITTER, tvpl.VPL_SURFACE} <= kinds
    assert (tvpl.VPL_VOLUME in kinds) == medium
    for f in ("pos", "n", "frame_t", "frame_b", "wi", "radiance"):
        _close(getattr(vpls, f), vpls_ref[f])
    # uv is read at surface VPLs only; a slot whose ray missed (a volume
    # VPL in the infinite medium) carries the trace's u, v of a miss, which
    # the two packages leave apart
    surf = vpls_ref["kind"] == tvpl.VPL_SURFACE
    _close(vpls.uv.numpy()[surf], vpls_ref["uv"][surf])
    li = _pixel(sd, IntegratorVPL(**SMALL))
    assert li_ref.mean() > 0 and (li_ref > 0).any(-1).mean() > 0.9
    _close(li, li_ref, rtol=PIXEL_RTOL, atol=1e-7)


def test_generate_vpls_and_compute_pixel_in_a_medium_match_jax(jax_side):
    _check(jax_side, True)


@pytest.mark.slow
def test_generate_vpls_and_compute_pixel_match_jax(jax_side):
    _check(jax_side, False)


@pytest.mark.parametrize("medium", [False, True], ids=["plain", "medium"])
def test_chunking_does_not_change_the_radiance(medium):
    """The gather's chunks add their own sums; 63 VPLs in chunks of 16 (the
    reference's unit, padded with empty slots), 7 and 63 agree."""
    sc = cornell_box(W, H)
    if medium:
        sc.volume = make_volume(**MEDIUM)
    sd = sc.compile(device="cpu")
    imgs = [_pixel(sd, IntegratorVPL(vpl_chunk=c, **SMALL))
            for c in (16, 7, 63)]
    assert imgs[0].mean() > 0
    for img in imgs[1:]:
        _close(img, imgs[0], rtol=1e-5, atol=1e-7)


def test_draw_order_with_a_medium(monkeypatch):
    """compute_pixel draws generate_vpls' uniforms on stream_fold(stream,
    999) (u_sel, u_pos, u_dir, then u_med, u_b, u_rr a bounce), then u_pix
    (n, 2) and u_med (n,) on the pixel's stream."""
    seen = []
    nxt, nxt2 = trng.stream_next, trng.stream_next2d

    def rec(fn, tag):
        def f(stream, shape=()):
            seen.append((tag, tuple(shape), stream.counter))
            return fn(stream, shape)
        return f
    monkeypatch.setattr(tvpl, "stream_next", rec(nxt, "1"))
    monkeypatch.setattr(tvpl, "stream_next2d", rec(nxt2, "2"))
    sc = cornell_box(4, 4)
    sc.volume = make_volume(**MEDIUM)
    _pixel_4 = torch.as_tensor(_pixel_grid(4, 4))
    IntegratorVPL(nb_vpl=8, max_depth=2, hard_cap=2).compute_pixel(
        sc.compile(device="cpu"), _pixel_4, _stream())
    paths = [("1", (2,)), ("2", (2,)), ("2", (2,))] + [
        ("1", (2,)), ("2", (2,)), ("1", (2,))] * 2
    assert [s[:2] for s in seen] == paths + [("2", (16,)), ("1", (16,))]
    assert [s[2] for s in seen] == list(range(9)) + [0, 1]


@pytest.mark.slow
def test_regression_row_matches_the_stored_row():
    """cbox_path/vpl at tools/regression.py's settings: each metric against
    regress/refs/cbox_path.exr within 1e-4 of regress/results.json's."""
    import json
    from pathlib import Path
    from rustlight_tpu_torch.utils.image import read_exr
    from rustlight_tpu_torch.utils.metrics import metric_scalar
    root = Path(__file__).resolve().parents[1] / "regress"
    img = render(cornell_box(128, 128).compile(device="cpu"),
                 IntegratorVPL(nb_vpl=256, max_depth=6, hard_cap=6), 32,
                 seed=0)["primal"]
    ref = read_exr(root / "refs" / "cbox_path.exr")
    stored = json.loads((root / "results.json").read_text())["cbox_path/vpl"]
    for m in ("l1", "l2", "mape", "dssim"):
        assert abs(metric_scalar(ref, img, m) - stored[m]) <= (
            1e-4 * stored[m]), m

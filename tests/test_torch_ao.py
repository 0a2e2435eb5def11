"""The port's ambient-occlusion integrator and its per-pass render route
against the JAX package's.

The JAX package's compiled numpy scene goes to both packages
(`from_numpy_scene`): a sphere grid of 4,862 triangles (a walk scene: the
JAX package traces it through its clustered XLA intersector on the CPU, the
port through the plain versions of its walk kernels) and the Cornell box (the
dense tier). `render(sd, IntegratorAO(max_distance), spp=4, seed=0)` of
both must agree pixel for pixel: the threefry streams are bit-exact, so a
pixel can differ only where a near-tie hit flips an occlusion ray.
Tolerance: at most PIX_FRAC of the pixels differ, each by at most 1/spp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustlight_tpu.integrators import IntegratorAO as JaxAO
from rustlight_tpu.integrators import render as jax_render
from rustlight_tpu.models import cornell_box as jax_cornell_box
from rustlight_tpu.models.presets import sphere_grid as jax_sphere_grid
from rustlight_tpu.utils import rng as jrng
from rustlight_tpu_torch.accel import walk as tw
from rustlight_tpu_torch.integrators import IntegratorAO, render
from rustlight_tpu_torch.scene.scene import from_numpy_scene
from rustlight_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

RES, SPP = 16, 4
PIX_FRAC = 0.01
SCENES = {"grid": (lambda: jax_sphere_grid(3000, RES, RES), 2.0),
          "cbox": (lambda: jax_cornell_box(RES, RES), None)}


@pytest.fixture(scope="module")
def scenes():
    return {k: mk().compile() for k, (mk, _) in SCENES.items()}


def _port_ao(jsd, dist):
    sd = from_numpy_scene(jsd.host.data, "cpu")
    return render(sd, IntegratorAO(max_distance=dist), spp=SPP, seed=0)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_ao_matches_jax(scenes, name):
    jsd, dist = scenes[name], SCENES[name][1]
    ref = np.asarray(jax_render(jsd, JaxAO(max_distance=dist), spp=SPP,
                                seed=0)["primal"])
    img = _port_ao(jsd, dist)["primal"]
    assert img.shape == ref.shape == (RES, RES, 3) and img.dtype == np.float32
    assert 0.05 < ref.mean() < 0.95
    diff = np.abs(img - ref).max(-1)
    assert (diff > 0).mean() <= PIX_FRAC
    assert diff.max() <= 1.0 / SPP


def test_ao_on_the_hier_route_equals_the_flat_walk(scenes, monkeypatch):
    """The grid's AO render with the port forced onto the two-level walk."""
    jsd, dist = scenes["grid"], SCENES["grid"][1]
    flat = _port_ao(jsd, dist)["primal"]
    calls = []
    for name in ("walk_hier_closest", "walk_hier_anyhit"):
        fn = getattr(tw, name)
        monkeypatch.setattr(tw, name, lambda *a, fn=fn, name=name, **kw: (
            calls.append(name), fn(*a, **kw))[1])
    monkeypatch.setattr(tw, "FLAT_MAX_CLUSTERS", 0)
    hier = _port_ao(jsd, dist)["primal"]
    assert calls == ["walk_hier_closest", "walk_hier_anyhit"] * SPP
    np.testing.assert_array_equal(hier, flat)


class _JaxUniform:
    """A pixel's value is its sample's first uniform (JAX side)."""

    def compute_pixel(self, scene, pix, stream):
        u, _ = jrng.stream_next(stream, (pix.shape[0],))
        return jnp.broadcast_to(u[:, None], (pix.shape[0], 3))


class _PortUniform:
    """The same on the port's side; records the key of each sample."""

    def __init__(self):
        self.samples = []

    def compute_pixel(self, scene, pix, stream):
        self.samples.append(stream.key)
        u, _ = trng.stream_next(stream, (pix.shape[0],))
        return u[:, None].expand(-1, 3)


def test_per_pass_route_rounds_spp_up_to_whole_passes(scenes):
    """spp = 10 in passes of 8 renders samples 0..15 and divides by 16, as
    the JAX package's chunked route does."""
    jsd = scenes["cbox"]
    ref = np.asarray(jax_render(jsd, _JaxUniform(), spp=10, seed=3)["primal"])
    sd = from_numpy_scene(jsd.host.data, "cpu")
    integ = _PortUniform()
    img = render(sd, integ, spp=10, seed=3)["primal"]
    base = trng.make_stream(3, "cpu")
    assert integ.samples == [trng.stream_fold(base, s).key for s in range(16)]
    np.testing.assert_allclose(img, ref, rtol=1e-6)
    us = [trng.stream_next(trng.stream_fold(base, s), (RES * RES,))[0]
          for s in range(16)]
    np.testing.assert_allclose(img[..., 0].reshape(-1),
                               (torch.stack(us).sum(0) / 16).numpy(),
                               rtol=1e-6)
    assert not np.allclose(img[..., 0].reshape(-1),
                           (torch.stack(us[:10]).sum(0) / 10).numpy())
    two = render(sd, _PortUniform(), spp=2, seed=3, spp_per_pass=1)["primal"]
    np.testing.assert_allclose(two[..., 0].reshape(-1),
                               (torch.stack(us[:2]).sum(0) / 2).numpy(),
                               rtol=1e-6)


def test_per_pass_route_zeroes_bad_samples(scenes):
    sd = from_numpy_scene(scenes["cbox"].host.data, "cpu")

    class Bad:
        calls = 0

        def compute_pixel(self, scene, pix, stream):
            li = torch.ones((pix.shape[0], 3))
            if Bad.calls == 1:
                li[0, 1] = float("nan")
                li[1, 2] = -1.0
            Bad.calls += 1
            return li

    img = render(sd, Bad(), spp=4, seed=0)["primal"].reshape(-1, 3)
    np.testing.assert_array_equal(img[:2], np.full((2, 3), 0.75, np.float32))
    np.testing.assert_array_equal(img[2:], np.ones_like(img[2:]))


@pytest.mark.parametrize("flags", [["-d", "2"], ["-d", "inf", "-c"]])
def test_cli_renders_ao(tmp_path, flags):
    from rustlight_tpu.utils.image import read_pfm
    from rustlight_tpu_torch import cli
    out = tmp_path / "ao.pfm"
    assert cli.main(["cbox", "-n", "2", "-s", "0.0625", "-o", str(out),
                     "--device", "cpu", "ao", *flags]) == 0
    img = read_pfm(out)
    assert img.shape == (32, 32, 3) and np.all(np.isfinite(img))
    assert set(np.unique(img)) <= {0.0, 0.5, 1.0} and 0 < img.mean() < 1
    args = cli.build_parser().parse_args(["cbox", "ao", *flags])
    integ = cli.build_integrator(args)
    assert isinstance(integ, IntegratorAO)
    assert integ.max_distance == (None if "inf" in flags else 2.0)
    assert integ.normal_correction == ("-c" in flags)

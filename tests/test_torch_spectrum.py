"""The port's utils/spectrum.py against the JAX package's: the CIE tables
and the four conversions on seeded spectra (with and without `lambdas` and
`illuminant`), bit for bit."""
import numpy as np
import pytest

from rustlight_tpu.utils import spectrum as jspec
from rustlight_tpu_torch.utils import spectrum as tspec

TABLES = ["CIE_LAMBDA", "CIE_X", "CIE_Y", "CIE_Z", "D65", "XYZ_TO_RGB",
          "RGB_TO_XYZ"]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal(name):
    _same(getattr(tspec, name), getattr(jspec, name))


def _spectra(seed):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.0, 2.0, 36).astype(np.float32)
    lam = np.sort(rng.uniform(360.0, 760.0, 23)).astype(np.float32)
    sampled = rng.uniform(0.0, 1.5, 23).astype(np.float32)
    ill = rng.uniform(20.0, 120.0, 36).astype(np.float32)
    return values, lam, sampled, ill


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conversions_equal(seed):
    values, lam, sampled, ill = _spectra(seed)
    _same(tspec.spectrum_to_xyz(values), jspec.spectrum_to_xyz(values))
    _same(tspec.spectrum_to_xyz(sampled, lam),
          jspec.spectrum_to_xyz(sampled, lam))
    for kw in ({}, {"illuminant": True}, {"illuminant": ill}):
        _same(tspec.spectrum_to_rgb(values, **kw),
              jspec.spectrum_to_rgb(values, **kw))
        _same(tspec.spectrum_to_rgb(sampled, lambdas=lam, **kw),
              jspec.spectrum_to_rgb(sampled, lambdas=lam, **kw))
    rgb = np.random.default_rng(seed + 10).uniform(0, 1, (5, 3)).astype(
        np.float32)
    _same(tspec.rgb_to_xyz(rgb), jspec.rgb_to_xyz(rgb))
    _same(tspec.xyz_to_rgb(rgb), jspec.xyz_to_rgb(rgb))


def test_d65_white_and_roundtrip():
    """tests/test_foundations.py's spectrum checks, on the port's module."""
    xyz = tspec.spectrum_to_xyz(np.ones(36))
    assert abs(xyz[1] - 1.0) < 1e-5
    rgb = tspec.spectrum_to_rgb(np.ones(36), illuminant=True)
    np.testing.assert_allclose(rgb, 1.0, atol=2e-3)
    c = np.array([0.2, 0.5, 0.8], np.float32)
    np.testing.assert_allclose(tspec.xyz_to_rgb(tspec.rgb_to_xyz(c)), c,
                               atol=1e-5)

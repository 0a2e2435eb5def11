"""CIE color-matching tables and spectral->RGB conversion; the port's own
copy of rustlight_tpu/utils/spectrum.py (numpy only, the same tables and
the same results on numpy inputs).

Reference: src/color.rs:20-1519 carries the Mitsuba-ported CIE X/Y/Z curves
and the D65 illuminant as dead-code arrays (1nm resolution, no functions) —
a placeholder for spectral rendering. Here the same data lives at 10nm
resolution (CIE 1931 2-degree standard observer, 380-730nm) together with
working conversions, so spectral emission/reflectance data can actually be
folded to the framework's linear-sRGB color pipeline. No module of the port
takes torch tensors here, so the functions take and return numpy arrays.
"""
from __future__ import annotations

import numpy as np

# CIE 1931 2° standard observer, 380..730nm step 10nm (36 samples)
CIE_LAMBDA = np.arange(380.0, 740.0, 10.0, dtype=np.float32)

CIE_X = np.array([
    0.001368, 0.004243, 0.014310, 0.043510, 0.134380, 0.283900, 0.348280,
    0.336200, 0.290800, 0.195360, 0.095640, 0.032010, 0.004900, 0.009300,
    0.063270, 0.165500, 0.290400, 0.433450, 0.594500, 0.762100, 0.916300,
    1.026300, 1.062200, 1.002600, 0.854450, 0.642400, 0.447900, 0.283500,
    0.164900, 0.087400, 0.046770, 0.022700, 0.011359, 0.005790, 0.002899,
    0.001440], np.float32)

CIE_Y = np.array([
    0.000039, 0.000120, 0.000396, 0.001210, 0.004000, 0.011600, 0.023000,
    0.038000, 0.060000, 0.090980, 0.139020, 0.208020, 0.323000, 0.503000,
    0.710000, 0.862000, 0.954000, 0.994950, 0.995000, 0.952000, 0.870000,
    0.757000, 0.631000, 0.503000, 0.381000, 0.265000, 0.175000, 0.107000,
    0.061000, 0.032000, 0.017000, 0.008210, 0.004102, 0.002091, 0.001047,
    0.000520], np.float32)

CIE_Z = np.array([
    0.006450, 0.020050, 0.067850, 0.207400, 0.645600, 1.385600, 1.747060,
    1.772110, 1.669200, 1.287640, 0.812950, 0.465180, 0.272000, 0.158200,
    0.078250, 0.042160, 0.020300, 0.008750, 0.003900, 0.002100, 0.001650,
    0.001100, 0.000800, 0.000340, 0.000190, 0.000050, 0.000020, 0.000000,
    0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000, 0.000000,
    0.000000], np.float32)

# CIE D65 relative spectral power distribution, same sampling
D65 = np.array([
    49.9755, 54.6482, 82.7549, 91.4860, 93.4318, 86.6823, 104.8650,
    117.0080, 117.8120, 114.8610, 115.9230, 108.8110, 109.3540, 107.8020,
    104.7900, 107.6890, 104.4050, 104.0460, 100.0000, 96.3342, 95.7880,
    88.6856, 90.0062, 89.5991, 87.6987, 83.2886, 83.6992, 80.0268,
    80.2146, 82.2778, 78.2842, 69.7213, 71.6091, 74.3490, 61.6040,
    69.8856], np.float32)

# linear sRGB (D65 white) <-> CIE XYZ
XYZ_TO_RGB = np.array([[3.2404542, -1.5371385, -0.4985314],
                       [-0.9692660, 1.8760108, 0.0415560],
                       [0.0556434, -0.2040259, 1.0572252]], np.float32)
RGB_TO_XYZ = np.linalg.inv(XYZ_TO_RGB).astype(np.float32)


def spectrum_to_xyz(values, lambdas=None) -> np.ndarray:
    """Integrate a radiance spectrum against the CMFs (Riemann sum over the
    10nm grid; `values` resampled from `lambdas` if given). Normalized so a
    flat spectrum of 1 has Y = 1."""
    values = np.asarray(values, np.float32)
    if lambdas is not None:
        values = np.interp(CIE_LAMBDA, np.asarray(lambdas, np.float32),
                           values).astype(np.float32)
    norm = CIE_Y.sum()
    return np.stack([(values * c).sum() / norm for c in (CIE_X, CIE_Y, CIE_Z)])


def xyz_to_rgb(xyz) -> np.ndarray:
    return np.asarray(xyz, np.float32) @ XYZ_TO_RGB.T


def rgb_to_xyz(rgb) -> np.ndarray:
    return np.asarray(rgb, np.float32) @ RGB_TO_XYZ.T


def spectrum_to_rgb(values, lambdas=None, illuminant=None) -> np.ndarray:
    """Reflectance (with `illuminant`, default D65) or emission spectrum to
    linear sRGB."""
    values = np.asarray(values, np.float32)
    if lambdas is not None:
        values = np.interp(CIE_LAMBDA, np.asarray(lambdas, np.float32),
                           values).astype(np.float32)
    if illuminant is not None:
        ill = D65 if illuminant is True else np.asarray(illuminant, np.float32)
        values = values * ill / (ill * CIE_Y).sum() * CIE_Y.sum()
    return xyz_to_rgb(spectrum_to_xyz(values))

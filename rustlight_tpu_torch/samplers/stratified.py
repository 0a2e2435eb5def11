"""Stratified sampling over the sample-pass axis; port of
rustlight_tpu/samplers/stratified.py.

Pass s of pixel p lands in stratum perm_{p,dim}(s) of Z_n4 (1D) or of a
sqrt(n4) x sqrt(n4) grid (2D), with n4 = spp rounded up to a power of 4 and
perm_{p,dim}(s) = (a s + b + p) mod n4 for odd a: a bijection on Z_{4^k}, so
each pixel sees every stratum of every stratified dimension once across its
passes. a and b are drawn per (pixel, dimension) with jax.random.randint's
algorithm, reproduced bit for bit (`randint`).
"""
from __future__ import annotations

import torch

from ..utils.rng import fold_in, random_bits, uniform

# the reference CLI: StratifiedSampler::create(nb_samples, 4)
NB_DIM = 4
# the permutation families of the 1D and the 2D tables, drawn apart
_TABLE_1D, _TABLE_2D = 7919, 7920


def _round_up_pow4(n: int) -> int:
    v = 1
    while v < n:
        v *= 4
    return v


def randint(key, n: int, maxval: int, device) -> torch.Tensor:
    """jax.random.randint(key, (n,), 0, maxval) for int32, as int64.

    jax splits the key in two (fold-like under partitionable threefry:
    sub-key i = fold_in(key, i)), draws 32 random bits a lane from each
    (`hi`, `lo`) and folds the 64 bits into the span with the multiplier
    2^32 mod span, itself computed in uint32 as ((2^16 mod span)^2 mod
    2^32) mod span: ((hi mod span) * m + lo mod span) mod span, every step
    wrapping at 2^32. A span of 0 or less draws 0."""
    span = maxval if maxval > 0 else 1
    hi = random_bits(fold_in(key, 0), n, device)
    lo = random_bits(fold_in(key, 1), n, device)
    mult = ((2 ** 16 % span) ** 2 & 0xFFFFFFFF) % span
    off = (torch.remainder(hi, span) * mult) & 0xFFFFFFFF
    off = ((off + torch.remainder(lo, span)) & 0xFFFFFFFF) % span
    return off


def _stratum(key, pixel_ids, pass_idx: int, dim: int, n4: int, table: int):
    """perm_{pixel,dim}(pass_idx) in Z_n4 ([n] int64); `table` tags the 1D
    (7919) and the 2D (7920) permutation families, which must not share a
    permutation."""
    kd = fold_in(fold_in(key, table), dim)
    n, dev = pixel_ids.shape[0], pixel_ids.device
    b = randint(fold_in(kd, 1), n, n4, dev)
    a = 2 * randint(fold_in(kd, 2), n, n4 // 2, dev) + 1
    # int32 wraps in the reference; n4 divides 2^32, so the residue is the
    # same
    return torch.remainder(a * pass_idx + b + pixel_ids.to(torch.int64), n4)


def stratified_1d(key, pixel_ids, pass_idx: int, spp: int, dim: int, u):
    """Stratify a fresh uniform u [n] into the lane's pass stratum."""
    n4 = _round_up_pow4(max(spp, 1))
    s = _stratum(key, pixel_ids, pass_idx, dim, n4, _TABLE_1D)
    return (s.to(torch.float32) + u) / n4


def stratified_2d(key, pixel_ids, pass_idx: int, spp: int, dim: int, u):
    """Stratify fresh uniforms u [n, 2] on a sqrt(n4) x sqrt(n4) grid."""
    n4 = _round_up_pow4(max(spp, 1))
    side = int(n4 ** 0.5)
    s = _stratum(key, pixel_ids, pass_idx, dim, n4, _TABLE_2D)
    sxy = torch.stack([torch.remainder(s, side), s // side], dim=-1)
    return (sxy.to(torch.float32) + u) / side


def stratified_jitter(key, pixel_ids, pass_idx: int, spp: int):
    """Stratified 2D pixel jitter (2D dimension 0)."""
    u = uniform(fold_in(key, pass_idx), (pixel_ids.shape[0], 2),
                pixel_ids.device)
    return stratified_2d(key, pixel_ids, pass_idx, spp, 0, u)

"""The port's threefry streams are bit-exact with the JAX package's.

rustlight_tpu_torch/utils/rng.py against rustlight_tpu/utils/rng.py (jax's
default threefry2x32, partitionable mode): keys, fold_in and the uniforms
of stream_next/stream_next2d must be EQUAL, bit for bit, since every
sample-for-sample comparison of the port rests on them.
"""
import jax
import numpy as np
import pytest
import torch

from rustlight_tpu.utils import rng as jrng
from rustlight_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

SEEDS = [0, 1, 7, 123456789, 2 ** 31 - 1, 2 ** 32 + 5]


def test_partitionable_threefry_is_the_default():
    # the port reproduces this mode only
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_make_stream_key(seed):
    key = np.asarray(jrng.make_stream(seed).key)
    assert trng.make_stream(seed, "cpu").key == tuple(int(k) for k in key)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("data", [0, 1, 3, 2 ** 31 + 11])
def test_stream_fold(seed, data):
    js = jrng.stream_fold(jrng.make_stream(seed), data)
    ts = trng.stream_fold(trng.make_stream(seed, "cpu"), data)
    assert ts.key == tuple(int(k) for k in np.asarray(js.key))
    assert ts.counter == 0


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 - 1])
@pytest.mark.parametrize("n", [1, 257, 1024])
def test_stream_next_and_next2d(seed, n):
    js = jrng.stream_fold(jrng.make_stream(seed), 2)
    ts = trng.stream_fold(trng.make_stream(seed, "cpu"), 2)
    # interleave 1D and 2D draws so the counters advance as in the integrator
    for _ in range(3):
        a, js = jrng.stream_next(js, (n,))
        b, ts = trng.stream_next(ts, (n,))
        assert b.dtype == torch.float32 and tuple(b.shape) == (n,)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        a, js = jrng.stream_next2d(js, (n,))
        b, ts = trng.stream_next2d(ts, (n,))
        assert tuple(b.shape) == (n, 2)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert ts.counter == int(js.counter) == 6


def test_uniform_range():
    u, _ = trng.stream_next2d(trng.make_stream(3, "cpu"), (4096,))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


# ---------------------------------------------------------------- replay
# ArrayStream: column (counter + k) mod d of the array, next2d two columns


@pytest.mark.parametrize("d", [1, 2, 5, 8])
def test_array_stream_columns_and_wrap_match_jax(d):
    """A mixed run of next / next2d past the array's width reads the same
    columns, bit for bit, and advances the counter by 1 and 2."""
    vals = np.random.default_rng(d).random((7, d)).astype(np.float32)
    js = jrng.make_array_stream(jax.numpy.asarray(vals))
    ts = trng.make_array_stream(torch.as_tensor(vals))
    for op in ("1", "2", "2", "1", "2", "1", "1", "2", "2"):
        if op == "1":
            a, js = jrng.stream_next(js, (7,))
            b, ts = trng.stream_next(ts, (7,))
        else:
            a, js = jrng.stream_next2d(js, (7,))
            b, ts = trng.stream_next2d(ts, (7,))
        assert tuple(b.shape) == np.asarray(a).shape
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert ts.counter == int(js.counter)
    assert ts.counter == 14


def test_array_stream_offset_start():
    """The MCMC integrators start the path at column 2."""
    vals = np.arange(12, dtype=np.float32).reshape(2, 6)
    ts = trng.ArrayStream(values=torch.as_tensor(vals), counter=2)
    u, ts = trng.stream_next2d(ts)
    np.testing.assert_array_equal(u.numpy(), [[2, 3], [8, 9]])
    u, ts = trng.stream_next(ts)
    np.testing.assert_array_equal(u.numpy(), [4, 10])


# ------------------------------------------------------------ stratified


@pytest.mark.parametrize("spp, pass_idx", [(1, 0), (4, 3), (16, 5),
                                           (13, 12)])
def test_stratified_stream_matches_jax(spp, pass_idx):
    """StratifiedStream over a per-pass threefry stream: the first NB_DIM
    1D and 2D draws stratified, the later ones the inner stream's, in
    every interleaving; equal bit for bit, the dim counters too."""
    n, w = 96, 16
    base_j, base_t = jrng.make_stream(4), trng.make_stream(4, "cpu")
    pid = np.arange(n, dtype=np.int32) * 3 % (w * 8)
    js = jrng.StratifiedStream(inner=jrng.stream_fold(base_j, pass_idx),
                               pixel_ids=jax.numpy.asarray(pid),
                               pass_idx=pass_idx, spp=spp,
                               base_key=base_j.key)
    ts = trng.StratifiedStream(inner=trng.stream_fold(base_t, pass_idx),
                               pixel_ids=torch.as_tensor(pid),
                               pass_idx=pass_idx, spp=spp,
                               base_key=base_t.key)
    for op in "2112121212112":
        fj = jrng.stream_next if op == "1" else jrng.stream_next2d
        ft = trng.stream_next if op == "1" else trng.stream_next2d
        a, js = fj(js, (n,))
        b, ts = ft(ts, (n,))
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert (ts.d1, ts.d2) == (int(js.d1), int(js.d2))
        assert ts.inner.counter == int(js.inner.counter)
    assert (ts.d1, ts.d2) == (7, 6)


def test_stratified_2d_covers_every_stratum():
    """Over its n4 passes, each pixel's first 2D draw lands once in each
    cell of the sqrt(n4) grid."""
    spp, n = 16, 40
    base = trng.make_stream(9, "cpu")
    pid = torch.arange(n)
    cells = []
    for s in range(spp):
        st = trng.StratifiedStream(inner=trng.stream_fold(base, s),
                                   pixel_ids=pid, pass_idx=s, spp=spp,
                                   base_key=base.key)
        u, _ = trng.stream_next2d(st, (n,))
        cells.append((u * 4).floor().to(torch.int64) @ torch.tensor([1, 4]))
    cells = torch.stack(cells, 1).sort(1).values
    assert torch.equal(cells, torch.arange(16).expand(n, 16))

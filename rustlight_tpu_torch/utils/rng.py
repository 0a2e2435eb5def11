"""Counter-based RNG streams, bit-exact with the JAX package's streams.

Port of rustlight_tpu/utils/rng.py. A stream is a threefry2x32 key plus a
dimension counter; each `stream_next` derives `fold_in(key, counter)` and
draws one uniform per lane, exactly as `jax.random.uniform` does with jax's
default threefry in partitionable mode:

  - key from an integer seed: [0, seed mod 2^32] (`threefry_seed`);
  - fold_in(key, data) = threefry2x32(key, [0, data]);
  - random bits for a shape: threefry2x32(key, (hi, lo)) over the flat
    row-major iota split into its high and low 32 bits, bits = y0 ^ y1;
  - uniform: (bits >> 9) | 0x3f800000 reinterpreted as f32, minus 1.

Key derivation is scalar work and runs on the host in Python integers; the
per-lane hash runs on the stream's device in int64 masked to 32 bits
(torch's uint32 lacks most arithmetic).

Two other stream types go through the same `stream_next` / `stream_next2d`,
which dispatch on the stream's type:

  - `ArrayStream`: primary-sample-space replay, the dimensions read from an
    explicit [n, d] array (column (counter + k) mod d); `next2d` reads two
    columns. The gradient and MCMC integrators drive the path tracer with it.
  - `StratifiedStream`: wraps a threefry stream so that its first NB_DIM 1D
    and first NB_DIM 2D draws are stratified over the sample passes
    (samplers/stratified.py); `base_key` is the pass-independent key of the
    stratum permutations, `d1` / `d2` count the 1D / 2D draws made.

A threefry stream may carry a lane window (`with_window`): the rank of a
device mesh that holds lanes [lo, hi) of an [n, ...] wavefront draws the
counters lo * k ... hi * k - 1 of it (k the product of the trailing dims),
the slice of the global iota that the JAX package's partitioned draw gives
that device. Every draw of a windowed stream must then have hi - lo lanes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .tracing import span

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


class RngStream(NamedTuple):
    key: Tuple[int, int]   # raw threefry key, two uint32 as Python ints
    counter: int           # dimension counter
    device: torch.device   # where the uniforms are drawn
    window: Optional[Tuple[int, int]] = None   # lanes [lo, hi) of the draws


def _threefry2x32(k0, k1, x0, x1, mask):
    """Threefry-2x32 (20 rounds) over Python ints or int64 tensors.

    `mask(v)` reduces a value to 32 bits; additions wrap through it. The
    round structure follows jax._src.prng._threefry2x32_lowering."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = mask(x0 + ks[0])
    x1 = mask(x1 + ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = mask(x0 + x1)
            x1 = mask((x1 << r) | (x1 >> (32 - r)))
            x1 = x1 ^ x0
        x0 = mask(x0 + ks[(i + 1) % 3])
        x1 = mask(x1 + ks[(i + 2) % 3] + i + 1)
    return x0, x1


def _mask_int(v):
    return v & _M32


def _mask_tensor(v):
    return torch.bitwise_and(v, _M32)


def _fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    return _threefry2x32(key[0], key[1], 0, int(data) & _M32, _mask_int)


def make_stream(seed_or_key, device) -> RngStream:
    """Stream from an integer seed (jax.random.PRNGKey(seed)) or a raw
    two-word key; `device` is where its uniforms are drawn."""
    if isinstance(seed_or_key, int):
        key = (0, seed_or_key & _M32)
    else:
        key = (int(seed_or_key[0]) & _M32, int(seed_or_key[1]) & _M32)
    return RngStream(key=key, counter=0, device=torch.device(device))


def stream_fold(stream: RngStream, data: int) -> RngStream:
    """Derive an independent sub-stream (e.g. per sample-pass); it keeps
    the stream's lane window."""
    return RngStream(key=_fold_in(stream.key, data), counter=0,
                     device=stream.device, window=stream.window)


def with_window(stream: RngStream, lo: int, hi: int) -> RngStream:
    """The stream whose draws are lanes [lo, hi) of the global draws."""
    return stream._replace(window=(int(lo), int(hi)))


def random_bits(key: Tuple[int, int], n: int, device,
                start: int = 0) -> torch.Tensor:
    """jax.random.bits(key, (N,))[start:start + n] for 32-bit words
    (partitionable threefry): threefry2x32 over the flat iota, y0 ^ y1, as
    int64 in [0, 2^32). Under a profiler, one `rng.draw` span on the
    device (utils/tracing.py)."""
    # the flat iota's high words are zero below 2^32 lanes
    assert start + n < 2 ** 32, (start, n)
    with span("rng.draw", device):
        lo = torch.arange(start, start + n, dtype=torch.int64, device=device)
        y0, y1 = _threefry2x32(key[0], key[1], torch.zeros_like(lo), lo,
                               _mask_tensor)
        return torch.bitwise_xor(y0, y1)


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """jax.random.fold_in on a raw two-word key."""
    return _fold_in(key, data)


def _uniform(key: Tuple[int, int], shape, device,
             window=None) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    start = 0
    if window is not None:
        lo, hi = window
        if not shape or int(shape[0]) != hi - lo:
            raise ValueError(f"a draw of shape {tuple(shape)} from a stream "
                             f"windowed to lanes [{lo}, {hi})")
        start = lo * (n // max(hi - lo, 1))
    bits = random_bits(key, n, device, start)
    fbits = torch.bitwise_or(torch.bitwise_right_shift(bits, 9), 0x3F800000)
    u = fbits.to(torch.int32).view(torch.float32) - 1.0
    return u.reshape(tuple(shape))


def uniform(key: Tuple[int, int], shape, device) -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32."""
    return _uniform(key, tuple(shape), device)


def _threefry_next(stream: RngStream, shape=()):
    u = _uniform(_fold_in(stream.key, stream.counter), tuple(shape),
                 stream.device, stream.window)
    return u, stream._replace(counter=stream.counter + 1)


def _threefry_next2d(stream: RngStream, shape=()):
    u = _uniform(_fold_in(stream.key, stream.counter), tuple(shape) + (2,),
                 stream.device, stream.window)
    return u, stream._replace(counter=stream.counter + 1)


class ArrayStream(NamedTuple):
    """Primary-sample-space stream: dimension k of every lane is column
    (counter + k) mod d of `values` [n, d]. Every chain keeps a dense
    vector of primary samples; reading past d wraps."""
    values: torch.Tensor   # [n, d]
    counter: int


def make_array_stream(values) -> ArrayStream:
    return ArrayStream(values=values, counter=0)


def _array_col(stream: ArrayStream, offset: int) -> torch.Tensor:
    return stream.values[:, (stream.counter + offset) % stream.values.shape[1]]


def astream_next(stream: ArrayStream, shape=()):
    """One column: [n]; `shape` is ignored (the array's lanes are the
    wavefront)."""
    return _array_col(stream, 0), stream._replace(counter=stream.counter + 1)


def astream_next2d(stream: ArrayStream, shape=()):
    """Two consecutive columns: [n, 2]."""
    u = torch.stack([_array_col(stream, 0), _array_col(stream, 1)], dim=-1)
    return u, stream._replace(counter=stream.counter + 2)


class StratifiedStream(NamedTuple):
    """A threefry stream whose first NB_DIM 1D draws and first NB_DIM 2D
    draws are stratified over the sample-pass axis
    (samplers/stratified.py). `base_key` keys the stratum permutations and
    must not depend on the pass (the inner stream is folded per pass);
    draws past NB_DIM are the inner stream's plain uniforms."""
    inner: RngStream
    pixel_ids: torch.Tensor   # [n] int
    pass_idx: int
    spp: int
    base_key: Tuple[int, int]
    d1: int = 0               # 1D draws made
    d2: int = 0               # 2D draws made


def stream_next(stream, shape=()) -> Tuple[torch.Tensor, object]:
    """One uniform in [0,1) per lane; `shape` is the wavefront shape."""
    if isinstance(stream, ArrayStream):
        return astream_next(stream, shape)
    if isinstance(stream, StratifiedStream):
        from ..samplers.stratified import NB_DIM, stratified_1d
        u, inner = stream_next(stream.inner, shape)
        if stream.d1 < NB_DIM:
            u = stratified_1d(stream.base_key, stream.pixel_ids,
                              stream.pass_idx, stream.spp, stream.d1, u)
        return u, stream._replace(inner=inner, d1=stream.d1 + 1)
    return _threefry_next(stream, shape)


def stream_next2d(stream, shape=()) -> Tuple[torch.Tensor, object]:
    """Two uniforms per lane, shaped [*shape, 2]."""
    if isinstance(stream, ArrayStream):
        return astream_next2d(stream, shape)
    if isinstance(stream, StratifiedStream):
        from ..samplers.stratified import NB_DIM, stratified_2d
        u, inner = stream_next2d(stream.inner, shape)
        if stream.d2 < NB_DIM:
            u = stratified_2d(stream.base_key, stream.pixel_ids,
                              stream.pass_idx, stream.spp, stream.d2, u)
        return u, stream._replace(inner=inner, d2=stream.d2 + 1)
    return _threefry_next2d(stream, shape)

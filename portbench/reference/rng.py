"""Counter-based uniforms, a frozen copy of the rule the renderer states for
its random streams (jax's threefry2x32 in partitionable mode):

  - key from an integer seed: (0, seed mod 2^32);
  - fold_in(key, data) = threefry2x32(key, (0, data));
  - draw number c of a stream keyed k uses the key fold_in(k, c);
  - lane i of a one-dimensional draw is threefry2x32(key, (0, i)), the two
    words xor'ed; lane i of a two-dimensional draw takes counters 2i, 2i+1;
  - the float is ((bits >> 9) | 0x3f800000) as float32, minus 1.

Only the lanes asked for are hashed, so a replay of a few pixels of a full
film costs what those pixels cost.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1, mask):
    """Threefry-2x32, 20 rounds, over Python ints or int64 tensors."""
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


def seed_key(seed: int):
    return (0, int(seed) & M32)


def fold_in(key, data: int):
    return threefry2x32(key[0], key[1], 0, int(data) & M32, lambda v: v & M32)


def uniform_at(key, counters: torch.Tensor, dtype=torch.float32):
    """The uniforms of the flat counters `counters` (int64) under `key`."""
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(counters),
                          counters, lambda v: torch.bitwise_and(v, M32))
    bits = torch.bitwise_xor(y0, y1)
    f = torch.bitwise_or(torch.bitwise_right_shift(bits, 9), 0x3F800000)
    u = f.to(torch.int32).view(torch.float32) - 1.0
    return u.to(dtype)


class Stream:
    """A stream keyed `key` drawing for lanes `lanes` (int64 lane indices of
    the full wavefront)."""

    def __init__(self, key, lanes: torch.Tensor, dtype=torch.float32):
        self.key, self.lanes, self.dtype, self.counter = key, lanes, dtype, 0

    def next1(self):
        u = uniform_at(fold_in(self.key, self.counter), self.lanes, self.dtype)
        self.counter += 1
        return u

    def next2(self):
        k = fold_in(self.key, self.counter)
        u = torch.stack([uniform_at(k, 2 * self.lanes, self.dtype),
                         uniform_at(k, 2 * self.lanes + 1, self.dtype)], -1)
        self.counter += 1
        return u

"""The 1,500-triangle soup of tests/test_pallas_walk.py and its rays, shared
by the port's walk tests. Imports nothing of JAX, so the `cuda` tests that
use it run on a card without JAX."""
import numpy as np
import torch

N_RAYS = 1000            # not a multiple of the 64-ray tile


def _soup_mesh():
    """The soup of tests/test_pallas_walk.py: 1,500 small triangles."""
    rng = np.random.default_rng(7)
    nt = 1500
    c = rng.uniform(-1, 1, (nt, 3)).astype(np.float32)
    vs = [c + rng.normal(0, .06, (nt, 3)).astype(np.float32) for _ in range(3)]
    verts = np.concatenate(vs, 0).astype(np.float32)
    idx = np.arange(3 * nt).reshape(3, nt).T.astype(np.int32)
    return verts, idx, c


def _rays(centers, seed=0, n=N_RAYS):
    """Rays from outside aimed at triangles, and rays from inside in random
    directions; lanes k % 7 == 3 inert (tfar = 0), k % 11 == 5 empty
    (tnear >= tfar), k % 5 == 1 a bounded tfar, k % 13 == 6 NaN tnear and
    k % 17 == 8 NaN tfar (both sanitized by the walk)."""
    rng = np.random.default_rng(seed)
    o = np.empty((n, 3), np.float32)
    h = n // 2
    o[:h] = rng.uniform(-2.5, -1.8, (h, 3))
    o[h:] = rng.uniform(-1.0, 1.0, (n - h, 3))
    d = np.empty((n, 3), np.float32)
    d[:h] = centers[rng.integers(0, len(centers), h)] - o[:h]
    d[h:] = rng.normal(size=(n - h, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = np.arange(n)
    tnear = np.full(n, 1e-4, np.float32)
    tfar = np.full(n, np.inf, np.float32)
    tfar[k % 5 == 1] = rng.uniform(0.2, 3.0, (k % 5 == 1).sum())
    tfar[k % 7 == 3] = 0.0
    tnear[k % 11 == 5], tfar[k % 11 == 5] = 2.0, 1.0
    tnear[k % 13 == 6] = np.nan
    tfar[k % 17 == 8] = np.nan
    return o, d.astype(np.float32), tnear, tfar


def _t(x, device="cpu"):
    return torch.as_tensor(np.asarray(x), device=device)


def _sanitized(tnear, tfar):
    return (np.where(tnear >= 0, tnear, np.inf).astype(np.float32),
            np.where(tfar > 0, tfar, 0.0).astype(np.float32))

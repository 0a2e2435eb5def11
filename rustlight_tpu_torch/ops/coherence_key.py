"""The walk's incidence coherence key: its wrapper and its plain PyTorch
version, with the morton helpers of both coherence keys.

The key (accel/walk.py:_incidence_key) is the reference's XLA code
rustlight_tpu/accel/pallas_walk.py:_incidence_key: a slab pass gives each
ray its overlapped real clusters; major = direction octant << 18 | 6-bit/
axis morton of the centroid of their centres, minor = their count (capped
at 63), both int32.

The CUDA kernel (csrc/coherence_key.cu) computes both in one launch, one
thread a lane, the clusters staged in shared memory. It is built by
ops/native.py into the production library (K-independent: tables of any K
take it from there) and called through ctypes on PyTorch's current stream.

`incidence_key_ref` does the same arithmetic on [rays, C] tensors, chunked
over rays. The wrapper uses it only for tensors on the CPU; a CUDA tensor
launches the kernel or raises. The two have equal counts, and major keys
that differ only where the centroid's sum, in another order, crosses a
morton cell's edge.

The wrapper adds one to `LAUNCHES["incidence_key"]` where it launches the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .dense_trace import _launch
from .native import load_cuda
from .walk_trace import _slab_inv

LAUNCHES = {"incidence_key": 0}

_LIB = None
_F32 = torch.float32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _load():
    global _LIB
    if _LIB is None:
        lib = load_cuda()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rl_incidence_key.argtypes = [p, p, i, i, p, p, p, p, i, p, p, p]
        lib.rl_incidence_key.restype = i
        _LIB = lib
    return _LIB


def _check(wt, o, d, tnear, tfar) -> None:
    """Raise on inputs the kernel does not take."""
    n = o.shape[0]
    dev = wt.lo.device
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("tnear", tnear, (n,)), ("tfar", tfar, (n,)),
                           ("lo", wt.lo, tuple(wt.hi.shape))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    for name, x in (("lo", wt.lo), ("hi", wt.hi), ("o", o), ("d", d),
                    ("tnear", tnear), ("tfar", tfar)):
        if x.dtype != _F32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the tables on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if wt.lo.dim() != 2 or wt.lo.shape[0] != 3:
        raise ValueError(f"lo must be [3, Cp], got {tuple(wt.lo.shape)}")
    if not 0 < int(wt.n_real) <= wt.lo.shape[1]:
        raise ValueError(f"n_real {int(wt.n_real)} outside (0, "
                         f"{wt.lo.shape[1]}]")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


# ------------------------------------------------------------ plain version

def _octant(d):
    return ((d[:, 0] > 0).int() * 4 + (d[:, 1] > 0).int() * 2
            + (d[:, 2] > 0).int())


def _morton(q, bits: int):
    """Interleave the low `bits` bits of q [n, 3] int32, x lowest."""
    m = torch.zeros_like(q[:, 0])
    for b in range(bits):
        for ax in range(3):
            m = m | (((q[:, ax] >> b) & 1) << (3 * b + ax))
    return m


def _quantize(x, cells: int):
    """Truncate x [n, 3] to a cell index in [0, cells - 1]."""
    return torch.clamp(x, 0.0, cells - 1.0).int()


def incidence_key_ref(wt, o, d, tnear, tfar):
    """Plain version of the kernel: the (major, minor) int32 pair of rays
    (o, d) within (tnear, tfar) over the real clusters of walk tables `wt`.
    Rays are chunked so the [chunk, C] slab stays near 64 MB."""
    c = int(wt.n_real)
    lo, hi = wt.lo[:, :c], wt.hi[:, :c]
    ctr = 0.5 * (lo + hi)                                # [3, C]
    wlo = lo.amin(dim=1)
    span = torch.clamp(hi.amax(dim=1) - wlo, min=1e-9)
    n = o.shape[0]
    chunk = max(512, min(65536, (1 << 26) // max(4 * c, 1)))
    cms, cnts = [], []
    for s in range(0, n, chunk):
        o_c, tn_c, tf_c = o[s:s + chunk], tnear[s:s + chunk], tfar[s:s + chunk]
        inv = _slab_inv(d[s:s + chunk])
        tmin = tmax = None
        for ax in range(3):
            t0 = (lo[ax] - o_c[:, ax:ax + 1]) * inv[:, ax:ax + 1]
            t1 = (hi[ax] - o_c[:, ax:ax + 1]) * inv[:, ax:ax + 1]
            lo_t, hi_t = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tmin = lo_t if tmin is None else torch.maximum(tmin, lo_t)
            tmax = hi_t if tmax is None else torch.minimum(tmax, hi_t)
        ov = ((tmax >= torch.maximum(tmin, torch.clamp(tn_c, min=0.0)[:, None]))
              & (tmin <= tf_c[:, None]) & (tf_c > 0.0)[:, None])
        ovf = ov.float()
        cnt = ovf.sum(dim=1)
        cen = (ovf @ ctr.T) / torch.clamp(cnt, min=1.0)[:, None]
        cms.append(_morton(_quantize((cen - wlo) / span * 64.0, 64), 6))
        cnts.append(torch.clamp(cnt, max=63.0).int())
    return (_octant(d) << 18) | torch.cat(cms), torch.cat(cnts)


# ------------------------------------------------------------------ wrapper

def incidence_key(wt, o, d, tnear, tfar):
    """The incidence key (major, minor) [n] int32 of rays (o, d) [n, 3]
    within (tnear, tfar) [n] over walk tables `wt` (its lo/hi [3, Cp] and
    n_real): the kernel on a CUDA device, the plain version on the CPU."""
    _check(wt, o, d, tnear, tfar)
    dev = o.device
    if dev.type == "cpu":
        return incidence_key_ref(wt, o, d, tnear, tfar)
    n = o.shape[0]
    kmaj, kmin = torch.empty((2, n), dtype=torch.int32, device=dev).unbind(0)
    if n:
        _launch(_load().rl_incidence_key, dev, wt.lo.data_ptr(),
                wt.hi.data_ptr(), int(wt.n_real), wt.lo.shape[1],
                o.data_ptr(), d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(),
                n, kmaj.data_ptr(), kmin.data_ptr())
        LAUNCHES["incidence_key"] += 1
    return kmaj, kmin

"""Dense closest-hit and any-hit ray-triangle kernels: wrappers and plain
PyTorch versions.

The CUDA kernels (csrc/dense_trace.cu) replace the TPU kernels
rustlight_tpu/ops/pallas_trace.py:_trace_kernel and :_anyhit_kernel. They are
built by ops/native.py (nvcc for sm_90a, at first use) and called through
ctypes on PyTorch's current stream.

`dense_closest_ref`/`dense_anyhit_ref` do the same arithmetic on [rays, T]
tensors, chunked over rays. The wrappers use them only for tensors on the
CPU; a CUDA tensor launches the kernel or raises.

Each wrapper adds one to `LAUNCHES[name]` where it launches its kernel, and
adds the lanes it was handed with tfar > 0 to `counting_rays()`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .native import count_rays, counting_rays, load_cuda  # noqa: F401

LAUNCHES = {"dense_closest": 0, "dense_anyhit": 0}

_LIB = None
_REF_CHUNK = 8192   # rays per chunk of the plain versions' [rays, T] tensors


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _load():
    global _LIB
    if _LIB is None:
        lib = load_cuda()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rl_dense_closest.argtypes = [p, i, p, p, p, p, i, p, p, p, p, p]
        lib.rl_dense_closest.restype = i
        lib.rl_dense_anyhit.argtypes = [p, i, p, p, p, p, i, p, p]
        lib.rl_dense_anyhit.restype = i
        _LIB = lib
    return _LIB


def _check(rows, o, d, tnear, tfar) -> None:
    dev = rows.device
    if rows.dim() != 3 or rows.shape[1:] != (3, 4):
        raise ValueError(f"rows must be [T, 3, 4], got {tuple(rows.shape)}")
    n = o.shape[0]
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("tnear", tnear, (n,)), ("tfar", tfar, (n,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    for name, x in (("rows", rows), ("o", o), ("d", d), ("tnear", tnear),
                    ("tfar", tfar)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rows on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")


# ------------------------------------------------------------ plain versions

def _dot4(x4, r):
    """[m, 4] x [T, 4] -> [m, T] in the reference's _dot4 order."""
    return (x4[:, 0:1] * r[None, :, 0] + x4[:, 1:2] * r[None, :, 1]
            + x4[:, 2:3] * r[None, :, 2] + x4[:, 3:4] * r[None, :, 3])


def _chunk_test(rows, o, d, tnear, tfar):
    one = torch.ones_like(o[:, :1])
    o4 = torch.cat([o, one], dim=1)
    d4 = torch.cat([d, torch.zeros_like(one)], dim=1)
    no, nd = _dot4(o4, rows[:, 0]), _dot4(d4, rows[:, 0])
    live = torch.abs(nd) > 1e-20
    t = -no / torch.where(live, nd, 1.0)
    u = _dot4(o4, rows[:, 1]) + t * _dot4(d4, rows[:, 1])
    v = _dot4(o4, rows[:, 2]) + t * _dot4(d4, rows[:, 2])
    valid = (live & (t > tnear[:, None]) & (t < tfar[:, None])
             & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
    return t, u, v, valid


def dense_closest_ref(rows, o, d, tnear, tfar) -> Tuple[torch.Tensor, ...]:
    """Plain version of the closest-hit kernel: (t, idx, u, v), t = inf and
    idx = -1 (u = v = 0) on a miss; ties go to the lowest index."""
    n, n_tris = o.shape[0], rows.shape[0]
    ts, ids, us, vs = [], [], [], []
    iota = torch.arange(n_tris, dtype=torch.int32, device=o.device)
    for s in range(0, n, _REF_CHUNK):
        e = min(n, s + _REF_CHUNK)
        t, u, v, valid = _chunk_test(rows, o[s:e], d[s:e], tnear[s:e], tfar[s:e])
        t_masked = torch.where(valid, t, float("inf"))
        best_t = torch.amin(t_masked, dim=1)
        hit = torch.isfinite(best_t)
        idx = torch.amin(torch.where(t_masked == best_t[:, None], iota, n_tris),
                         dim=1).clamp(max=n_tris - 1)
        col = idx.long()[:, None]
        # + 0 maps a -0 barycentric to +0, as the reference's masked sum does
        ts.append(best_t)
        ids.append(torch.where(hit, idx, -1))
        us.append(torch.where(hit, u.gather(1, col)[:, 0] + 0.0, 0.0))
        vs.append(torch.where(hit, v.gather(1, col)[:, 0] + 0.0, 0.0))
    if n == 0:
        empty = torch.empty(0, dtype=torch.float32, device=o.device)
        return empty, torch.empty(0, dtype=torch.int32, device=o.device), empty, empty
    return torch.cat(ts), torch.cat(ids), torch.cat(us), torch.cat(vs)


def dense_anyhit_ref(rows, o, d, tnear, tfar) -> torch.Tensor:
    """Plain version of the any-hit kernel: True where any triangle is hit."""
    n = o.shape[0]
    out = [_chunk_test(rows, o[s:s + _REF_CHUNK], d[s:s + _REF_CHUNK],
                       tnear[s:s + _REF_CHUNK], tfar[s:s + _REF_CHUNK])[3].any(dim=1)
           for s in range(0, n, _REF_CHUNK)]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool,
                                                  device=o.device)


# ------------------------------------------------------------------ wrappers

def dense_closest(rows, o, d, tnear, tfar):
    """Closest hit of rays (o, d) [n, 3] within (tnear, tfar) [n] against
    Baldwin-Weber rows [T, 3, 4]: returns (t, idx, u, v), each [n]."""
    _check(rows, o, d, tnear, tfar)
    count_rays(tfar)
    if o.device.type == "cpu":
        return dense_closest_ref(rows, o, d, tnear, tfar)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    idx = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        with torch.cuda.device(o.device):
            err = _load().rl_dense_closest(
                rows.data_ptr(), rows.shape[0], o.data_ptr(), d.data_ptr(),
                tnear.data_ptr(), tfar.data_ptr(), n, t.data_ptr(),
                idx.data_ptr(), u.data_ptr(), v.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dense_closest launch failed: CUDA error {err}")
        LAUNCHES["dense_closest"] += 1
    return t, idx, u, v


def dense_anyhit(rows, o, d, tnear, tfar) -> torch.Tensor:
    """Any hit of rays (o, d) within (tnear, tfar): True = occluded."""
    _check(rows, o, d, tnear, tfar)
    count_rays(tfar)
    if o.device.type == "cpu":
        return dense_anyhit_ref(rows, o, d, tnear, tfar)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        with torch.cuda.device(o.device):
            err = _load().rl_dense_anyhit(
                rows.data_ptr(), rows.shape[0], o.data_ptr(), d.data_ptr(),
                tnear.data_ptr(), tfar.data_ptr(), n, occ.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dense_anyhit launch failed: CUDA error {err}")
        LAUNCHES["dense_anyhit"] += 1
    return occ

"""Dense closest-hit and any-hit ray-triangle kernels: wrappers and plain
PyTorch versions.

The CUDA kernels (csrc/dense_trace.cu) replace the TPU kernels
rustlight_tpu/ops/pallas_trace.py:_trace_kernel and :_anyhit_kernel. They are
built by ops/native.py (nvcc for sm_90a, at first use) and called through
ctypes on PyTorch's current stream.

`dense_closest_ref`/`dense_anyhit_ref` do the same arithmetic on [rays, T]
tensors, chunked over rays. The wrappers use them only for tensors on the
CPU; a CUDA tensor launches the kernel or raises.

`dense_model` follows the kernels' own order of work (the best hit as the
closest hit's cap, the any hit's exact rejects before the division, the
staged rows without the + 0 * w terms) on the CPU; the tests hold it to
the plain versions, and `planted_sets` are the boundary cases that the
tests and chip_smoke.py hold the kernels and the model to.

Each wrapper adds one to `LAUNCHES[name]` where it launches its kernel, and
adds the lanes it was handed with tfar > 0 to `counting_rays()`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .native import count_rays, counting_rays, load_cuda  # noqa: F401

LAUNCHES = {"dense_closest": 0, "dense_anyhit": 0}

# csrc/dense_trace.cu's reject margin and the least cap it applies to
MAG_MARGIN = 1.0 + 2.0 ** -22
MAG_MIN_CAP = 2.0 ** -58

_LIB = None
_REF_CHUNK = 8192   # rays per chunk of the plain versions' [rays, T] tensors
_F32 = torch.float32


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
    """Raise on inputs the kernels do not take. The common case is one
    combined test; the detailed checks below it name the fault."""
    n = o.shape[0]
    dev = rows.device
    if (rows.dim() == 3 and rows.shape[1:] == (3, 4)
            and o.shape == d.shape == (n, 3) and tnear.shape == tfar.shape == (n,)
            and rows.dtype == o.dtype == d.dtype == tnear.dtype == tfar.dtype == _F32
            and o.device == dev and d.device == dev and tnear.device == dev
            and tfar.device == dev and rows.is_contiguous() and o.is_contiguous()
            and d.is_contiguous() and tnear.is_contiguous()
            and tfar.is_contiguous()
            and (dev.type == "cpu"
                 or (dev.type == "cuda" and rows.data_ptr() % 16 == 0))):
        return
    if rows.dim() != 3 or rows.shape[1:] != (3, 4):
        raise ValueError(f"rows must be [T, 3, 4], got {tuple(rows.shape)}")
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("tnear", tnear, (n,)), ("tfar", tfar, (n,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    for name, x in (("rows", rows), ("o", o), ("d", d), ("tnear", tnear),
                    ("tfar", tfar)):
        if x.dtype != _F32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rows on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    raise ValueError("rows must be 16-byte aligned")


def _stream(index) -> int:
    """The current CUDA stream of device `index`, as an int. PyTorch's raw
    query where the build has it: a tenth of a microsecond against some
    six for torch.cuda.current_stream() (measured on an H100 host)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw else torch.cuda.current_stream(index).cuda_stream


def _launch(entry, dev, *args) -> None:
    """Call a kernel entry point on `dev`'s current stream (switching the
    current device only when it is another), and raise on a launch error."""
    if dev.index == torch.cuda.current_device():
        err = entry(*args, _stream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = entry(*args, _stream(dev.index))
    if err:
        raise RuntimeError(f"{entry.__name__} launch failed: CUDA error {err}")


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


# --------------------------------------------- the kernels' order of work

def _dot3(x, r):
    """((x0*r0 + x1*r1) + x2*r2) for x [n, 3] and a row r [4]."""
    return (x[:, 0] * r[0] + x[:, 1] * r[1]) + x[:, 2] * r[2]


def _mag_cap(cap, pos):
    """csrc/dense_trace.cu:mag_cap."""
    return torch.where(pos & (cap >= MAG_MIN_CAP), cap * MAG_MARGIN,
                       float("inf"))


def staged_rows(rows):
    """csrc/dense_trace.cu:stage: the rows with the N row of every
    triangle with a non-finite w made NaN, so that the kernels may leave
    the + 0 * w of the d sums out."""
    dead = ~torch.isfinite(rows[:, :, 3]).all(1)
    n = torch.where(dead[:, None], float("nan"), rows[:, 0])
    return torch.cat([n[:, None], rows[:, 1:]], 1)


def dense_model(rows, o, d, tnear, tfar, anyhit=False):
    """The kernels' order of work in torch (csrc/dense_trace.cu), for the
    tests: one ray a thread against the staged rows (staged_rows), each
    triangle in ascending order, the d sums without their + 0 * w; the
    closest hit tests t against the cap min(tfar, best t) and takes every
    valid hit as its new best; the any hit drops a test by keep() (the
    sign and magnitude rejects, for rays with tnear >= 0) before the
    division and stops a ray at its first hit.

    Returns (t, idx, u, v) or the occlusion mask, and the counts of tests
    by where they ended: {"tests", "nd" (|Nd| <= 1e-20), "rejected" (by
    keep(), any hit only), "divided" (the tests that paid the division),
    "bary" (the tests that passed the range and computed u, v)}."""
    rows = staged_rows(rows)
    n = o.shape[0]
    live = tnear < tfar
    pos = tnear >= 0.0
    lo = torch.where(pos, 0.0, float("-inf"))
    cap = tfar.clone()
    capm = _mag_cap(tfar, pos)
    best = torch.full((n,), -1, dtype=torch.int32)
    bu = torch.zeros(n)
    bv = torch.zeros(n)
    occ = torch.zeros(n, dtype=torch.bool)
    counts = dict.fromkeys(("tests", "nd", "rejected", "divided", "bary"), 0)
    for j in range(rows.shape[0]):
        todo = live & ~occ
        if not bool(todo.any()):
            break
        rn, ru, rv = rows[j]
        nd = _dot3(d, rn)
        no = _dot3(o, rn) + rn[3]
        ok = todo & (nd.abs() > 1e-20)
        div = ok
        if anyhit:
            s = torch.where(torch.signbit(nd), no, -no)
            div = ok & (s > lo) & (s < nd.abs() * capm)
        t = -no / torch.where(div, nd, 1.0)
        rng = div & (t > tnear) & (t < cap)
        u = (_dot3(o, ru) + ru[3]) + t * _dot3(d, ru)
        v = (_dot3(o, rv) + rv[3]) + t * _dot3(d, rv)
        valid = rng & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        for k, m in (("tests", todo), ("nd", todo & ~ok),
                     ("rejected", ok & ~div), ("divided", div),
                     ("bary", rng)):
            counts[k] += int(m.sum())
        if anyhit:
            occ |= valid
        else:
            cap = torch.where(valid, t, cap)
            best = torch.where(valid, j, best)
            bu = torch.where(valid, u, bu)
            bv = torch.where(valid, v, bv)
    if anyhit:
        return occ, counts
    hit = best >= 0
    # + 0 maps a -0 barycentric to +0, as the kernel does
    return (torch.where(hit, cap, float("inf")), best, bu + 0.0,
            bv + 0.0), counts


# ------------------------------------------------------- planted boundary sets

def _next(x, toward):
    return np.nextafter(np.float32(x), np.float32(toward), dtype=np.float32)


def _bw_rows(p0, p1, p2):
    from ..scene.geometry import _baldwin_weber_rows
    e1, e2 = p1 - p0, p2 - p0
    n = np.cross(e1, e2)
    ng = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    return _baldwin_weber_rows(p0, e1, e2, ng)


def _axis_rows(nz=1.0, w=0.0, uw=0.0, vw=0.0):
    """Rows of the triangle (0,0), (1,0), (0,1) of a plane normal to z:
    N = (0, 0, nz, w), U = (1, 0, 0, uw), V = (0, 1, 0, vw)."""
    return np.array([[0, 0, nz, w], [1, 0, 0, uw], [0, 1, 0, vw]], np.float32)


def _tnears(n):
    """tnear -1, 0 and 1e-4 in turn."""
    return np.array([-1.0, 0.0, 1e-4], np.float32)[np.arange(n) % 3]


def planted_sets(seed=0):
    """Boundary cases for the kernels, as {name: (rows [T, 3, 4], o [n, 3],
    d [n, 3], tnear [n], tfar [n])} of float32 numpy arrays: a hit's t
    exactly at tfar, one ulp either side, and exactly at tnear; -No = +0
    and -0; |Nd| at 1e-20 and one ulp either side; equal t at two indices
    in both orders; tfar = inf and subnormal; tnear < 0; inert and empty
    lanes; rows with inf or NaN; products that overflow. No set's count
    of rays is a multiple of the kernels' 256-ray block."""
    rng = np.random.default_rng(seed)
    sets = {}
    f32 = np.float32

    # random triangles; rays aimed at their centroids, with tnear / tfar
    # placed on the nearest valid t as the plain arithmetic computes it
    m = 24
    c = rng.uniform(-1, 1, (m, 3)).astype(f32)
    p = [c + rng.normal(0, 0.3, c.shape).astype(f32) for _ in range(3)]
    rows = _bw_rows(*p)
    rows[7] = rows[3]          # one triangle at two indices
    cent = ((p[0] + p[1] + p[2]) / 3).astype(f32)
    o = rng.uniform(-3, 3, (m, 3)).astype(f32)
    d = cent - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tt = torch.as_tensor
    t, _, _, valid = _chunk_test(tt(rows), tt(o), tt(d),
                                 tt(np.full(m, 1e-4, f32)),
                                 tt(np.full(m, np.inf, f32)))
    best = torch.where(valid, t, float("inf")).amin(1).numpy()
    hit = np.isfinite(best)
    o, d, best = o[hit], d[hit], best[hit]
    k = len(best)
    inf = np.full(k, np.inf, f32)
    eps = np.full(k, 1e-4, f32)
    cases = [(eps, best), (eps, _next(best, np.inf)), (eps, _next(best, 0)),
             (eps, inf), (best, inf), (_next(best, 0), inf),
             (_next(best, np.inf), inf), (np.full(k, -5, f32), inf),
             (np.full(k, -5, f32), best), (eps, np.zeros(k, f32)),
             (best, best), (eps, np.full(k, 1e-3, f32))]
    sets["caps"] = (rows, np.tile(o, (len(cases), 1)),
                    np.tile(d, (len(cases), 1)),
                    np.concatenate([a for a, _ in cases]).astype(f32),
                    np.concatenate([b for _, b in cases]).astype(f32))
    # the same rays reversed: every triangle behind them (tnear < 0 sees it)
    sets["behind"] = (rows, np.tile(o, (3, 1)), -np.tile(d, (3, 1)),
                      np.repeat(np.array([1e-4, -1e30, 0.0], f32), k),
                      np.full(3 * k, np.inf, f32))

    # planes normal to z, rays along +-z from points (x, y, z0)
    planes = {
        # -No = +0 and -0: origin on the plane
        "zero_num": (_axis_rows(1.0, 0.0), 0.0, 1.0),
        "neg_zero_num": (_axis_rows(1.0, -0.0), -0.0, -1.0),
        # equal t at two indices, both orders (u differs between them)
        "tie_ab": (np.stack([_axis_rows(1.0, -2.0),
                             _axis_rows(1.0, -2.0, uw=0.1)]), 0.0, 1.0),
        "tie_ba": (np.stack([_axis_rows(1.0, -2.0, uw=0.1),
                             _axis_rows(1.0, -2.0)]), 0.0, 1.0),
        # a nearer hit after a farther one, and one ulp nearer
        "nearer_later": (np.stack([_axis_rows(1.0, -2.0),
                                   _axis_rows(1.0, float(_next(-2.0, 0))),
                                   _axis_rows(1.0, -1.0)]), 0.0, 1.0),
    }
    for name, (r, z0, dz) in planes.items():
        r = r.reshape(-1, 3, 4)
        n = 37
        # x, y of both signs: No = +0 or -0 on the plane
        o = np.full((n, 3), z0, f32)
        o[:, :2] = rng.uniform(-0.2, 0.45, (n, 2)).astype(f32)
        d = np.tile(np.array([0, 0, dz], f32), (n, 1))
        sets[name] = (r, o, d, _tnears(n), np.full(n, np.inf, f32))

    # |Nd| at 1e-20 and one ulp either side: N = (nx, 0, 0, w), d = +x
    lim = f32(1e-20)
    nds = [lim, _next(lim, 1), _next(lim, 0), -lim, -_next(lim, 1)]
    r = np.stack([np.array([[x, 0, 0, -5 * x], [0, 1, 0, 0], [0, 0, 1, 0]],
                           f32) for x in nds])
    n = len(nds) * 9
    o = np.tile(np.array([0, 0.25, 0.25], f32), (n, 1))
    d = np.tile(np.array([1, 0, 0], f32), (n, 1))
    sets["nd_limit"] = (r, o, d, _tnears(n), np.full(n, np.inf, f32))

    # subnormal t and tfar, tnear = 0: N = (1, 0, 0, -1e-40), d = +x
    sub = f32(1e-40)
    r = np.array([[[1, 0, 0, -sub], [0, 1, 0, 0], [0, 0, 1, 0]]], f32)
    tf = np.array([2 * sub, sub, _next(sub, 1), _next(sub, 0), 1e-45, np.inf,
                   3e-38, 1.1754942e-38] * 5, f32)
    n = len(tf)
    sets["subnormal"] = (r, np.tile(np.array([0, .25, .25], f32), (n, 1)),
                         np.tile(np.array([1, 0, 0], f32), (n, 1)),
                         np.zeros(n, f32), tf)

    # rows with inf or NaN in each place, beside a plain triangle behind them
    bad = []
    for row in range(3):
        for col in range(4):
            for val in (np.inf, -np.inf, np.nan):
                x = _axis_rows(1.0, -1.0)
                x[row, col] = val
                bad.append(x)
    bad.append(_axis_rows(1.0, -3.0))
    n = 41
    o = np.zeros((n, 3), f32)
    o[:, :2] = rng.uniform(0.05, 0.45, (n, 2)).astype(f32)
    d = np.tile(np.array([0, 0, 1], f32), (n, 1))
    tnear = np.where(np.arange(n) % 2 == 0, f32(1e-4), f32(-1)).astype(f32)
    sets["nonfinite"] = (np.stack(bad), o, d, tnear, np.full(n, np.inf, f32))

    # products that overflow: huge rows and caps
    big = f32(3e38)
    r = np.stack([_axis_rows(1e30, -2e30), _axis_rows(1.0, -big),
                  _axis_rows(big, -big), _axis_rows(1.0, -1e-30)])
    n = 45
    o = np.tile(np.array([0.25, 0.25, 0.0], f32), (n, 1))
    d = np.tile(np.array([0, 0, 1], f32), (n, 1))
    d[n // 3:2 * n // 3, 2] = 1e-10
    tf = np.tile(np.array([np.inf, big, 1e30, 3.0, f32(3.4028235e38)], f32),
                 n // 5)
    sets["overflow"] = (r, o, d, np.full(n, 0.0, f32), tf)

    # random rays against all planted rows, with inert and empty lanes
    allr = np.concatenate([s[0] for s in sets.values()])
    n = 1000
    o = rng.uniform(-2, 2, (n, 3)).astype(f32)
    d = rng.normal(size=(n, 3)).astype(f32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tnear = np.full(n, 1e-4, f32)
    tfar = np.full(n, np.inf, f32)
    k = np.arange(n)
    tfar[k % 7 == 3] = 0.0
    tnear[k % 11 == 5], tfar[k % 11 == 5] = 2.0, 1.0
    tnear[k % 13 == 4] = -1.0
    tfar[k % 5 == 1] = rng.uniform(0.1, 3.0, (k % 5 == 1).sum())
    sets["mixed"] = (allr, o, d, tnear, tfar)
    return sets


# ------------------------------------------------------------------ wrappers

def dense_closest(rows, o, d, tnear, tfar):
    """Closest hit of rays (o, d) [n, 3] within (tnear, tfar) [n] against
    Baldwin-Weber rows [T, 3, 4]: returns (t, idx, u, v), each [n]."""
    _check(rows, o, d, tnear, tfar)
    count_rays(tfar, "closest")
    dev = o.device
    if dev.type == "cpu":
        return dense_closest_ref(rows, o, d, tnear, tfar)
    n = o.shape[0]
    t, idx, u, v = torch.empty((4, n), dtype=_F32, device=dev).unbind(0)
    idx = idx.view(torch.int32)
    if n:
        _launch(_load().rl_dense_closest, dev, rows.data_ptr(), rows.shape[0],
                o.data_ptr(), d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(),
                n, t.data_ptr(), idx.data_ptr(), u.data_ptr(), v.data_ptr())
        LAUNCHES["dense_closest"] += 1
    return t, idx, u, v


def dense_anyhit(rows, o, d, tnear, tfar) -> torch.Tensor:
    """Any hit of rays (o, d) within (tnear, tfar): True = occluded."""
    _check(rows, o, d, tnear, tfar)
    count_rays(tfar, "anyhit")
    dev = o.device
    if dev.type == "cpu":
        return dense_anyhit_ref(rows, o, d, tnear, tfar)
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _launch(_load().rl_dense_anyhit, dev, rows.data_ptr(), rows.shape[0],
                o.data_ptr(), d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(),
                n, occ.data_ptr())
        LAUNCHES["dense_anyhit"] += 1
    return occ

"""The walk tier's laboratory kernels (K9): wrappers and plain PyTorch
versions.

The CUDA kernels (csrc/walk_lab.cu) replace the TPU kernels of
rustlight_tpu's tools/perf/roofline.py: _closest_kernel_counted (:58, also
called from tools/perf/tree_lab.py:80), _floor_kernel (:119) and _fma_kernel
(:163). They are the instruments of rustlight_tpu_torch/tools/perf/: built by
ops/native.py and called through ctypes on PyTorch's current stream.

  - `walk_closest_counted`: the production closest-hit walk of
    ops/walk_trace.py with one more output, the tile's visit count (2 per
    loop iteration) written to every lane. Its plain version is that
    module's plain walk, which already counts visit pairs per tile.
  - `walk_floor`: `nv_total` visits a tile with csel = i % Cp and nothing
    else of the schedule: no entry pass, no pops, no threshold. The same
    visit (stage, scan, best update) as the production walk's.
  - `fma_peak`: two chained fused multiply-adds per element of a [64, 3K]
    f32 block, `iters` steps, on `blocks` blocks that all compute the same
    block: the card's f32 FMA rate on the visit's tile shape is
    blocks * iters * 64 * 3K * 4 / time. Its plain version emulates the
    fused step in float64, rounded to f32 each step.
  - `mma_products`: the two matrix products of the tensor-core form of the
    triangle test (csrc/tri_test_mma.cuh) for one tile and one cluster, as
    the kernels' visit computes them: the probe of their accuracy. Its
    plain versions are the _dot4-ordered products and the f32 matmul.
  - `mma_form_lanes`, `mma_form_visits`: the candidate forms of those
    products (MMA_FORMS; PRODUCTION_FORM is the production body): [o, 1] . N
    and [d, 0] . N of each lane against its own triangle, whose t = -no / nd
    is held to the _dot4 form's; and `nvis` visits a tile of products in
    the form, summed per 32 rays, for its time. Their plain versions are
    the _dot4 products and the f32 sum of the matmul products.

counted and floor run in the production form of the closest-hit walk
(ops/walk_trace.py:PRODUCTION_FORMS: P threads a ray), so that production /
floor compares like with like, or with the private `_form=ONE_THREAD_FORM`
one thread a ray. They keep the _dot4 triangle test and are bit-identical to
their plain versions; with `mxu=True` they take the tensor-core form (see
ops/walk_trace.py) one thread a ray, both, so that they still compare like
with like (the split tensor-core visit is K3/K4's alone). The wrappers use
the plain versions only for tensors on the CPU; a CUDA tensor launches the
kernel or raises. Each wrapper adds one to `LAUNCHES[name]` where it
launches its kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .native import count_k, load_cuda
from .walk_trace import (K, ONE_THREAD_FORM, RAY_TILE, _check,
                         _matmul_products, _resolve_form, _tiled,
                         _visit_closest, _walk_ref, form_args,
                         launch_geometry, load_for, table_k)

# the fused step's constants, as f32 (roofline.py:169-170)
_FMA_A = (float(np.float32(1.000001)), 0.5)
_FMA_B = (float(np.float32(0.999999)), 0.25)
FMA_SHAPE = (RAY_TILE, 3 * K)

LAUNCHES = {"walk_closest_counted": 0, "walk_floor": 0, "fma_peak": 0,
            "mma_products": 0, "walk_closest_counted_mma": 0,
            "walk_floor_mma": 0, "mma_form_lanes": 0, "mma_form_visits": 0}
# the candidate forms of the tensor-core products (csrc/walk_lab.cu:
# form_f32), by index; PRODUCTION_FORM is tri_test_mma.cuh:mma_products
MMA_FORMS = ("TF32 3 passes (lo.hi + hi.lo + hi.hi)",
             "TF32 4 passes (+ lo.lo)", "TF32 3 passes, hi.hi apart",
             "TF32 6 passes, 3-way split",
             "TF32 6 passes, 3-way split, hi.hi apart",
             "TF32 9 passes, 3-way split, hi.hi a pass per column",
             "FP64 1 pass")
PRODUCTION_FORM = 4

_LIBS = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _load(k: int = K):
    if k not in _LIBS:
        lib = load_cuda(k)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rl_walk_closest_counted.argtypes = [p, p, i, i, p, p, p, p, p, p,
                                                i, i, i, i, i, p, p, p, p, p,
                                                p]
        lib.rl_walk_floor.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, i,
                                      p, p, p, p, p]
        lib.rl_fma_peak.argtypes = [p, i, i, p, p]
        lib.rl_mma_products.argtypes = [p, p, p, p, p, p]
        lib.rl_mma_form_lanes.argtypes = [i, p, p, p, i, p, p, p]
        lib.rl_mma_form_visits.argtypes = [i, p, i, i, p, p, i, p, p]
        for fn in (lib.rl_walk_closest_counted, lib.rl_walk_floor,
                   lib.rl_fma_peak, lib.rl_mma_products,
                   lib.rl_mma_form_lanes, lib.rl_mma_form_visits):
            fn.restype = i
        _LIBS[k] = lib
    return _LIBS[k]


# ------------------------------------------------------------ plain versions

def walk_closest_counted_ref(wt, o, d, tnear, tfar, mxu: bool = False):
    """Plain version of the counted walk: (t, tri, u, v, nv), nv [n] int32
    the tile's visits on every lane."""
    (t, tri, u, v), visits = _walk_ref(wt, o, d, tnear, tfar, False, mxu=mxu)
    return t, tri, u, v, visits.int().repeat_interleave(RAY_TILE)


def _floor_chunk(rows, ids, nv_total, mxu, o, d, tnear, tfar):
    g = o.shape[0]
    cp = rows.shape[0]
    best = (tfar.clone(),
            torch.full(tfar.shape, -1, dtype=torch.int32, device=o.device),
            torch.zeros_like(tfar), torch.zeros_like(tfar))
    for i in range(nv_total):
        csel = torch.full((g,), i % cp, dtype=torch.int64, device=o.device)
        best = _visit_closest(rows, ids, csel, o, d, tnear, best, mxu=mxu)
    best_t, best_i, best_u, best_v = best
    return ((torch.where(best_i >= 0, best_t, float("inf")), best_i, best_u,
             best_v),)


def walk_floor_ref(wt, o, d, tnear, tfar, nv_total: int, mxu: bool = False):
    """Plain version of the floor walk: (t, tri, u, v)."""
    cp, k = int(wt.n_clusters), table_k(wt)
    rows = wt.rows.view(cp, k, 3, 4)
    ids = wt.ids.view(cp, k)
    return _tiled(lambda *r: _floor_chunk(rows, ids, nv_total, mxu, *r),
                  k, o, d, tnear, tfar)[0]


def fma_peak_ref(x, iters: int):
    """Plain version of the FMA chains: each fused step emulated as a
    float64 multiply-add (the product of two f32 is exact there) rounded to
    f32. Agrees with the kernel's fmaf to a last-place rounding now and
    then: rtol 1e-4 at 4,000 steps."""
    a = x.double()
    b = (x + 1.0).double()
    for _ in range(iters):
        a = (a * _FMA_A[0] + _FMA_A[1]).float().double()
        b = (b * _FMA_B[0] + _FMA_B[1]).float().double()
    return (a.float() + b.float())


def _o4_d4(o, d):
    one = torch.ones_like(o[:, :1])
    return (torch.cat([o, one], dim=1),
            torch.cat([d, torch.zeros_like(one)], dim=1))


def mma_products_ref(rows, o, d):
    """Plain version of the two products, by one f32 matmul each: rows
    [K, 3, 4] of one cluster, rays o, d [64, 3] -> ao, ad [64, 3K] with the
    columns in blocks N | U | V."""
    o4, d4 = _o4_d4(o, d)
    ao, ad = _matmul_products(rows[None], o4[None], d4[None])
    return ao[0], ad[0]


def dot4_products(rows, o, d):
    """The same two products in the default form's _dot4 order, exactly as
    the bit-identical kernels sum them."""
    o4, d4 = _o4_d4(o, d)
    p = rows.permute(1, 0, 2).reshape(3 * rows.shape[0], 4)       # [3K, 4]

    def dot(x4):
        return (x4[:, 0:1] * p[None, :, 0] + x4[:, 1:2] * p[None, :, 1]
                + x4[:, 2:3] * p[None, :, 2] + x4[:, 3:4] * p[None, :, 3])

    return dot(o4), dot(d4)


def mma_form_lanes_ref(tri_rows, o, d):
    """Plain version of mma_form_lanes, in _dot4 order: tri_rows [n, 3, 4],
    o, d [n, 3] -> (no, nd) [n]."""
    o4, d4 = _o4_d4(o, d)
    n = tri_rows[:, 0]
    return tuple(((x[:, 0] * n[:, 0] + x[:, 1] * n[:, 1]) + x[:, 2] * n[:, 2])
                 + x[:, 3] * n[:, 3] for x in (o4, d4))


def mma_form_visits_ref(wt, o, d, nvis: int):
    """Plain version of mma_form_visits: per 32 rays, the f32 sum of their
    products over visits k = 0 .. nvis - 1 of cluster (tile + k) % Cp (not
    in the kernel's order of summation)."""
    cp, k = int(wt.n_clusters), table_k(wt)
    rows = wt.rows.view(cp, k, 3, 4).permute(0, 3, 2, 1).reshape(cp, 4, 3 * k)
    o4, d4 = _o4_d4(o, d)
    tile = torch.arange(o.shape[0], device=o.device) // RAY_TILE
    out = torch.zeros(o.shape[0], device=o.device)
    for k in range(nvis):
        p = rows[(tile + k) % cp]                             # [n, 4, 3K]
        out += (torch.bmm(o4[:, None], p) + torch.bmm(d4[:, None], p)).sum(
            dim=(1, 2))
    return out.view(-1, 32).sum(dim=1)


# ------------------------------------------------------------------ wrappers

def walk_closest_counted(wt, o, d, tnear, tfar, mxu: bool = False, *,
                         _form=None) -> Tuple[torch.Tensor, ...]:
    """The production closest-hit walk of whole 64-ray tiles over walk
    tables `wt` (at most 2^14 clusters), with the tile's visit count:
    (t, tri, u, v, nv), nv [n] int32."""
    _check(wt, o, d, tnear, tfar)
    form = _resolve_form("walk_closest", _form)
    if mxu:
        form = ONE_THREAD_FORM
    smem = launch_geometry("walk_closest", form, wt.n_clusters,
                           k=table_k(wt))[1]
    if o.device.type == "cpu":
        return walk_closest_counted_ref(wt, o, d, tnear, tfar, mxu)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    nv = torch.empty_like(tri)
    if n:
        with torch.cuda.device(o.device):
            err = load_for(wt, "walk_closest_counted",
                           _load).rl_walk_closest_counted(
                wt.lo.data_ptr(), wt.hi.data_ptr(), int(wt.n_clusters),
                int(wt.n_real), wt.rows.data_ptr(), wt.ids.data_ptr(),
                o.data_ptr(), d.data_ptr(), tnear.data_ptr(), tfar.data_ptr(),
                n, int(mxu), *form_args(form, smem), t.data_ptr(),
                tri.data_ptr(),
                u.data_ptr(), v.data_ptr(), nv.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"walk_closest_counted launch failed: CUDA error {err}")
        name = "walk_closest_counted" + ("_mma" if mxu else "")
        LAUNCHES[name] += 1
        count_k(name, table_k(wt))
    return t, tri, u, v, nv


def walk_floor(wt, o, d, tnear, tfar, nv_total: int, mxu: bool = False, *,
               _form=None) -> Tuple[torch.Tensor, ...]:
    """`nv_total` round-robin visits a tile (cluster i % Cp at visit i) of
    whole 64-ray tiles over walk tables `wt`: (t, tri, u, v)."""
    _check(wt, o, d, tnear, tfar)
    if nv_total < 0:
        raise ValueError(f"nv_total must not be negative, got {nv_total}")
    form = _resolve_form("walk_closest", _form)
    if mxu:
        form = ONE_THREAD_FORM
    smem = launch_geometry("walk_floor", form, 0, k=table_k(wt))[1]
    if o.device.type == "cpu":
        return walk_floor_ref(wt, o, d, tnear, tfar, nv_total, mxu)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        with torch.cuda.device(o.device):
            err = load_for(wt, "walk_floor", _load).rl_walk_floor(
                int(wt.n_clusters), int(nv_total), wt.rows.data_ptr(),
                wt.ids.data_ptr(), o.data_ptr(), d.data_ptr(),
                tnear.data_ptr(), tfar.data_ptr(), n, int(mxu),
                *form_args(form, smem), t.data_ptr(), tri.data_ptr(),
                u.data_ptr(), v.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"walk_floor launch failed: CUDA error {err}")
        name = "walk_floor" + ("_mma" if mxu else "")
        LAUNCHES[name] += 1
        count_k(name, table_k(wt))
    return t, tri, u, v


def _check_f32(name, x, shape) -> None:
    if tuple(x.shape) != shape or x.dtype != torch.float32:
        raise ValueError(f"{name} must be f32 {shape}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def fma_peak(x, iters: int, blocks: int = 1) -> torch.Tensor:
    """y = a + b after `iters` steps of a = a * 1.000001 + 0.5 (from x) and
    b = b * 0.999999 + 0.25 (from x + 1), elementwise on x [64, 3K] f32.
    On a card `blocks` blocks each compute the whole block and one writes
    it: 4 * blocks * iters * 64 * 3K flop in all."""
    _check_f32("x", x, FMA_SHAPE)
    if iters < 0 or blocks < 1:
        raise ValueError(f"iters >= 0 and blocks >= 1, got {iters}, {blocks}")
    if x.device.type == "cpu":
        return fma_peak_ref(x, iters)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _load().rl_fma_peak(x.data_ptr(), int(iters), int(blocks),
                                  y.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fma_peak launch failed: CUDA error {err}")
    LAUNCHES["fma_peak"] += 1
    return y


def mma_products(rows, o, d) -> Tuple[torch.Tensor, torch.Tensor]:
    """ao = [o, 1] . rows and ad = [d, 0] . rows as the tensor-core visit
    forms them: rows [K, 3, 4] f32 of one cluster, rays o, d [64, 3] f32 ->
    ao, ad [64, 3K] with the columns in blocks N | U | V."""
    _check_f32("rows", rows, (K, 3, 4))
    _check_f32("o", o, (RAY_TILE, 3))
    _check_f32("d", d, (RAY_TILE, 3))
    if not rows.device == o.device == d.device:
        raise ValueError("rows, o and d must share a device")
    if rows.device.type == "cpu":
        return mma_products_ref(rows, o, d)
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    ao = torch.empty(FMA_SHAPE, dtype=torch.float32, device=rows.device)
    ad = torch.empty_like(ao)
    with torch.cuda.device(rows.device):
        err = _load().rl_mma_products(rows.data_ptr(), o.data_ptr(),
                                      d.data_ptr(), ao.data_ptr(),
                                      ad.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mma_products launch failed: CUDA error {err}")
    LAUNCHES["mma_products"] += 1
    return ao, ad


def _check_form(form: int) -> None:
    if form not in range(len(MMA_FORMS)):
        raise ValueError(f"form must lie in [0, {len(MMA_FORMS)}), got {form}")


def mma_form_lanes(form: int, tri_rows, o, d) -> Tuple[torch.Tensor, ...]:
    """[o, 1] . N and [d, 0] . N of each lane against its own triangle in
    candidate form `form`: tri_rows [n, 3, 4] (N, U, V rows), o, d [n, 3]
    f32, n a multiple of 64 -> (no, nd) [n]."""
    _check_form(form)
    n = o.shape[0]
    if n % RAY_TILE:
        raise ValueError(f"{n} lanes: the probe takes whole {RAY_TILE}-lane "
                         "tiles")
    _check_f32("tri_rows", tri_rows, (n, 3, 4))
    _check_f32("o", o, (n, 3))
    _check_f32("d", d, (n, 3))
    if o.device.type == "cpu":
        return mma_form_lanes_ref(tri_rows, o, d)
    no = torch.empty(n, dtype=torch.float32, device=o.device)
    nd = torch.empty_like(no)
    if n:
        with torch.cuda.device(o.device):
            err = _load().rl_mma_form_lanes(
                int(form), tri_rows.data_ptr(), o.data_ptr(), d.data_ptr(), n,
                no.data_ptr(), nd.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"mma_form_lanes launch failed: CUDA error {err}")
        LAUNCHES["mma_form_lanes"] += 1
    return no, nd


def mma_form_visits(form: int, wt, o, d, nvis: int) -> torch.Tensor:
    """`nvis` visits a 64-ray tile of cluster (tile + k) % Cp of walk tables
    `wt`, each forming all its products in candidate form `form`: the sum
    of the products of each 32 rays, [n / 32] (a timing probe)."""
    _check_form(form)
    n = o.shape[0]
    if n % RAY_TILE or nvis < 0:
        raise ValueError(f"whole {RAY_TILE}-ray tiles and nvis >= 0, got "
                         f"{n} rays, nvis {nvis}")
    _check_f32("o", o, (n, 3))
    _check_f32("d", d, (n, 3))
    if o.device.type == "cpu":
        return mma_form_visits_ref(wt, o, d, nvis)
    out = torch.empty(n // 32, dtype=torch.float32, device=o.device)
    if n:
        with torch.cuda.device(o.device):
            err = load_for(wt, "mma_form_visits",
                           _load).rl_mma_form_visits(
                int(form), wt.rows.data_ptr(), int(wt.n_clusters), int(nvis),
                o.data_ptr(), d.data_ptr(), n, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"mma_form_visits launch failed: CUDA error {err}")
        LAUNCHES["mma_form_visits"] += 1
        count_k("mma_form_visits", table_k(wt))
    return out

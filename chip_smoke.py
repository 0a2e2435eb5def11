"""GPU smoke run of the PyTorch/CUDA port (rustlight_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda), g++ and this
checkout; imports nothing of JAX. Phases, one line each or more:

  0. device: require CUDA; print the card's name and power limit; turn
     TF32 off for matmuls and cuDNN;
  1. build: compile the port's CUDA kernels from csrc/ (sm_90a, one nvcc
     per source, all at once);
  2. kernels: the dense kernels (K1, K2) against their plain versions at
     262,144 rays against the Cornell box's rows and against a random
     1,000-triangle soup, with inert (tfar = 0) and empty (tnear >= tfar)
     lanes; times are medians of 10 synchronised runs;
  3. main path, cbox: render(cornell_box(512, 512), path tracer depth 6,
     128 spp) twice (warm-up, then timed), with launch counts reset just
     before the timed render; the image must be finite and within 4x the
     measured floor of regress/bench_ref.npz on 8x8 block means, and both
     dense kernels must have launched;
  4. profile, cbox: torch.profiler over one warm 8 spp render;
  5. walk kernels (K3/K4): on sphere_grid(122_000) (C = 512 clusters, the
     K3 row) and sphere_grid(516_000) (C = 2,048, the K4 row), two
     65,536-ray wavefronts (the scene's camera rays, a point origin; rays
     from the camera rays' hits in random directions with inert, bounded
     and empty lanes) go through the walk's sort, then the kernels and
     their plain versions see the same tiles: ids equal except near-ties,
     t/u/v within 1e-6, occlusion equal, no inert lane hits; times are
     medians of 10 (kernel, and the walk with its sort) and of 3 (plain);
  6. main path, grids: render(sphere_grid(n, 256, 256), path tracer depth
     5, 8 spp) for n = 122,000 and 516,000 (bench.py:132-139), warm-up
     then timed with launch counts reset just before; the image must be
     finite, the walk kernels must have launched and the dense ones not;
  7. oracle: sphere_grid(122_000, 64, 64) at 2 spp, seed 0, nee_rr = 0.25,
     once through the walk and once through the dense kernels over all
     131k triangles: 99.9% of pixels within 1e-3 (relative), means within
     1e-4 (relative);
  8. profile, grid122k: torch.profiler over one warm 2 spp render.

Before the last line: the card line from nvidia-smi and a JSON line with
each kernel's launches, error, times and bound. The last line is the JSON
status {"ok": true, "device": {...}}; a failed phase raises and prints no
status.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
N_RAYS = 262_144
CBOX_RES, CBOX_SPP, CBOX_DEPTH = 512, 128, 6
TIMING_RUNS = 10
PLAIN_RUNS = 3
# ids may differ only where the two nearest valid t are this close (relative)
TIE_RTOL = 1e-6
# t, u, v tolerance kernel vs plain version: both run the same IEEE f32
# operations in the same order (no FMA contraction), so they are expected
# bit-identical; this bound only absorbs a last-ulp difference
T_RTOL, UV_ATOL = 1e-6, 1e-6
GATE_MARGIN = 4.0   # bench.py's correctness gate: l1 <= 4x the seed floor
# the walk rows of bench.py:132-139 and their render settings
GRID_ROWS = (("grid122k", 122_000), ("grid516k", 516_000))
GRID_RES, GRID_SPP, GRID_DEPTH = 256, 8, 5   # 65,536 lanes a wavefront
ORACLE_RES, ORACLE_SPP, ORACLE_NEE_RR = 64, 2, 0.25
ORACLE_PIX_FRAC, ORACLE_PIX_RTOL, ORACLE_MEAN_RTOL = 0.999, 1e-3, 1e-4
# the bound: H100 SXM peak f32 rate outside the tensor cores and HBM rate
# (NVIDIA's data sheet), and the f32 operations of one ray-triangle test
PEAK_F32_OPS, PEAK_BYTES_S = 67e12, 3.35e12
OPS_PER_TEST = 25
RAY_IN_BYTES = 32          # o, d, tnear, tfar
KERNEL_SOURCES = {"dense": "rustlight_tpu_torch/csrc/dense_trace.cu",
                  "walk": "rustlight_tpu_torch/csrc/walk_trace.cu"}
WALK_REPLACES = ("rustlight_tpu/accel/pallas_walk.py:{} (K3), "
                 "rustlight_tpu/accel/pallas_walk.py:{} (K4)")


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def _median_ms(fn, runs=TIMING_RUNS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound_ms(n_tests, n_bytes):
    """The least time for the work: (ms, what bounds it)."""
    ops_ms = n_tests * OPS_PER_TEST / PEAK_F32_OPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _lanes(rng, tnear, tfar, span):
    """Lanes k % 7 == 3 inert (tfar = 0), k % 11 == 5 with tnear >= tfar,
    k % 5 == 1 a finite tfar (in place)."""
    k = np.arange(tfar.shape[0])
    tfar[k % 5 == 1] = rng.uniform(0.05, 1.0, (k % 5 == 1).sum()) * span
    tfar[k % 7 == 3] = 0.0
    tnear[k % 11 == 5] = 0.5 * span
    tfar[k % 11 == 5] = 0.25 * span


def _rays(rng, lo, hi, n, device):
    """Rays from points in the box [lo, hi] in random directions, with
    inert, empty and bounded lanes (_lanes)."""
    import torch
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tnear = np.full(n, 1e-4, np.float32)
    tfar = np.full(n, np.inf, np.float32)
    _lanes(rng, tnear, tfar, float(np.linalg.norm(np.subtract(hi, lo))))
    return [torch.as_tensor(x, device=device) for x in (o, d, tnear, tfar)]


def _near_tie(rows, o, d, tnear, tfar, lanes) -> bool:
    """Whether every lane in `lanes` has its two nearest valid t within
    TIE_RTOL of each other (the plain version's arithmetic)."""
    import torch
    from rustlight_tpu_torch.ops.dense_trace import _chunk_test
    for s in range(0, lanes.numel(), 64):   # [64, T] tensors at a time
        k = lanes[s:s + 64]
        t, _, _, valid = _chunk_test(rows, o[k], d[k], tnear[k], tfar[k])
        t2 = torch.topk(torch.where(valid, t, float("inf")), 2, dim=1,
                        largest=False).values
        if not bool(torch.all(t2[:, 1] - t2[:, 0] <= TIE_RTOL * t2[:, 0].abs())):
            return False
    return True


def _compare(label, rows, rays, closest_k, closest_p, occ_k, occ_p):
    """Kernel against plain outputs on one ray set; returns the max abs
    error of the closest-hit and any-hit outputs and the tie-id count.
    `rows` are the scene's dense rows, for the near-tie test."""
    import torch
    o, d, tnear, tfar = rays
    t_k, i_k, u_k, v_k = closest_k
    t_p, i_p, u_p, v_p = closest_p
    hit_k, hit_p = torch.isfinite(t_k), torch.isfinite(t_p)
    if not torch.equal(hit_k, hit_p):
        raise AssertionError(f"{label}: hit masks differ on "
                             f"{int((hit_k != hit_p).sum())} rays")
    diff_ids = torch.nonzero(i_k != i_p)[:, 0]
    if not _near_tie(rows, o, d, tnear, tfar, diff_ids):
        raise AssertionError(f"{label}: {diff_ids.numel()} triangle ids "
                             "differ outside near-ties")
    same = hit_p & (i_k == i_p)
    err_t = (t_k[same] - t_p[same]).abs()
    if bool(torch.any(err_t > T_RTOL * t_p[same].abs())):
        raise AssertionError(f"{label}: t differs beyond rtol {T_RTOL}")
    err_uv = torch.cat([(u_k[same] - u_p[same]).abs(),
                        (v_k[same] - v_p[same]).abs()])
    if bool(torch.any(err_uv > UV_ATOL)):
        raise AssertionError(f"{label}: u/v differ beyond atol {UV_ATOL}")
    if not torch.equal(occ_k, occ_p):
        raise AssertionError(f"{label}: occlusion differs on "
                             f"{int((occ_k != occ_p).sum())} rays")
    inert = ~(tnear < tfar)
    if bool(torch.any(hit_k[inert])) or bool(torch.any(occ_k[inert])):
        raise AssertionError(f"{label}: an inert lane reported a hit")
    err_closest = max(float(err_t.max()) if err_t.numel() else 0.0,
                      float(err_uv.max()) if err_uv.numel() else 0.0)
    err_anyhit = float((occ_k.int() - occ_p.int()).abs().max())
    return err_closest, err_anyhit, diff_ids.numel()


def check_kernels(rows, rays, label):
    """Dense kernels against plain versions on one (rows, rays) set; returns
    the max abs error of each kernel, the four median times and the two
    bounds."""
    from rustlight_tpu_torch.ops import dense_trace as dt
    o, d, tnear, tfar = rays
    closest_k = dt.dense_closest(rows, o, d, tnear, tfar)
    closest_p = dt.dense_closest_ref(rows, o, d, tnear, tfar)
    occ_k = dt.dense_anyhit(rows, o, d, tnear, tfar)
    occ_p = dt.dense_anyhit_ref(rows, o, d, tnear, tfar)
    import torch
    torch.cuda.synchronize()
    err_c, err_a, ties = _compare(label, rows, rays, closest_k, closest_p,
                                  occ_k, occ_p)
    fns = {"closest": dt.dense_closest, "closest_plain": dt.dense_closest_ref,
           "anyhit": dt.dense_anyhit, "anyhit_plain": dt.dense_anyhit_ref}
    times = {f"{k}_ms": _median_ms(lambda fn=fn: fn(rows, o, d, tnear, tfar))
             for k, fn in fns.items()}
    # every ray read once against every triangle; outputs t, idx, u, v
    # (16 B) or occ (1 B)
    n, n_tris = o.shape[0], rows.shape[0]
    table = rows.numel() * 4
    bounds = {"closest": _bound_ms(n * n_tris, n * (RAY_IN_BYTES + 16) + table),
              "anyhit": _bound_ms(n * n_tris, n * (RAY_IN_BYTES + 1) + table)}
    phase("kernels", f"{label}: {int(torch.isfinite(closest_k[0]).sum())} "
          f"hits, {int(occ_k.sum())} occluded, {ties} tie ids, max abs err "
          f"{err_c:.3g} / {err_a:.3g}; " + ", ".join(
              f"{k} {v:.4f}" for k, v in times.items())
          + f", bound {bounds['closest'][0]:.4f} / "
          f"{bounds['anyhit'][0]:.4f} ms ({bounds['closest'][1]})")
    return err_c, err_a, times, bounds


def block_mean_l1(img: np.ndarray) -> tuple:
    """bench.py's correctness gate in numpy: l1 of 8x8 block means against
    the committed reference; returns (l1, floor)."""
    ref = np.load(os.path.join(ROOT, "regress", "bench_ref.npz"))
    b = int(ref["block"])
    h, w, c = img.shape
    bm = img.astype(np.float64).reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))
    return float(np.abs(bm - ref["blockmean"]).mean()), float(ref["floor_l1"])


def profile_render(label, sd, integ, spp, names, top=12):
    """torch.profiler over one warm render at `spp`; prints the device time
    by kernel (the top ones and those whose name holds one of `names`), the
    number of launches and the device's busy share of the wall time (one
    stream, so kernel times do not overlap). Returns (busy share, share of
    the device time spent in kernels matching `names`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from rustlight_tpu_torch.integrators import render
    render(sd, integ, spp=spp, seed=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        render(sd, integ, spp=spp, seed=1)
        torch.cuda.synchronize()
        wall = time.time() - t0
    from torch.autograd import DeviceType
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count > 0]
    kern.sort(key=lambda e: e.self_device_time_total, reverse=True)
    if not kern:
        phase("profile", f"{label}: torch.profiler recorded no device kernels")
        return None, None
    busy_us = sum(e.self_device_time_total for e in kern)
    ours = [e for e in kern if any(nm in e.key for nm in names)]
    ours_us = sum(e.self_device_time_total for e in ours)
    launches = sum(e.count for e in kern)
    phase("profile", f"{label} {spp} spp render: wall {wall:.3f}s, device "
          f"busy {busy_us / 1e6:.3f}s ({100 * busy_us / 1e6 / wall:.1f}%), "
          f"{launches} device launches, {'/'.join(names)} kernels "
          f"{ours_us / 1e6:.3f}s ({100 * ours_us / max(busy_us, 1e-9):.1f}% "
          "of device time)")
    for e in kern[:top] + [e for e in ours if e not in kern[:top]]:
        phase("profile", f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:7d}x {e.self_device_time_total / e.count:8.2f} us  "
              f"{e.key[:90]}")
    return busy_us / 1e6 / wall, ours_us / max(busy_us, 1e-9)


def _reset_launches():
    from rustlight_tpu_torch.ops import dense_trace as dt
    from rustlight_tpu_torch.ops import walk_trace as wk
    dt.reset_launches()
    wk.reset_launches()


def _launches():
    from rustlight_tpu_torch.ops import dense_trace as dt
    from rustlight_tpu_torch.ops import walk_trace as wk
    return {**dt.LAUNCHES, **wk.LAUNCHES}


def timed_render(label, sd, integ, spp):
    """Warm-up render, then a timed one with launch counts reset just
    before and read just after. Returns (image, wall s, warm-up s, rays,
    launches)."""
    import torch
    from rustlight_tpu_torch.integrators import render
    from rustlight_tpu_torch.ops.native import counting_rays
    t0 = time.time()
    render(sd, integ, spp=spp, seed=0)
    warm = time.time() - t0
    _reset_launches()
    with counting_rays(sd.device) as rays:
        t0 = time.time()
        film = render(sd, integ, spp=spp, seed=0)
        torch.cuda.synchronize()
        wall = time.time() - t0
        n_rays = int(rays)
    launches = _launches()
    img = film["primal"]
    w, h = sd.camera.width, sd.camera.height
    if img.shape != (h, w, 3) or not np.all(np.isfinite(img)):
        raise AssertionError(f"{label}: bad image {img.shape}")
    return img, wall, warm, n_rays, launches


def _wavefronts(sd, rng):
    """The two walk wavefronts on a grid scene: its camera rays (one
    origin) and rays from their hits in random directions, with inert,
    empty and bounded lanes (_lanes)."""
    import torch
    from rustlight_tpu_torch.accel import intersect_rays
    from rustlight_tpu_torch.scene import generate_rays
    dev = sd.device
    w, h = sd.camera.width, sd.camera.height
    ys, xs = np.mgrid[0:h, 0:w]
    px = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    px += rng.uniform(0, 1, px.shape).astype(np.float32)
    o, d = generate_rays(sd.camera, torch.as_tensor(px, device=dev))
    o = o.contiguous()
    n = o.shape[0]
    tnear = torch.full((n,), 1e-4, device=dev)
    tfar = torch.full((n,), float("inf"), device=dev)
    rh = intersect_rays(sd.geom, o, d, tnear, tfar)
    p = torch.where(rh.hit[:, None], o + d * (rh.t - 1e-3)[:, None], o)
    d2 = rng.normal(size=(n, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    tn2 = np.full(n, 1e-4, np.float32)
    tf2 = np.full(n, np.inf, np.float32)
    walk = sd.geom.walk
    span = float(torch.linalg.norm(walk.world_hi - walk.world_lo))
    _lanes(rng, tn2, tf2, span)
    spread = [p.contiguous(), *(torch.as_tensor(x, device=dev)
                                for x in (d2, tn2, tf2))]
    return {"camera": [o, d.contiguous(), tnear, tfar], "spread": spread}


def check_walk(label, sd, rng):
    """Walk kernels against their plain versions on the scene's two
    wavefronts, sorted by the walk; returns one record per wavefront."""
    import torch
    from rustlight_tpu_torch.accel import walk
    from rustlight_tpu_torch.ops import walk_trace as wk
    wt = sd.geom.walk
    table = (wt.rows.numel() + wt.ids.numel() + wt.lo.numel()
             + wt.hi.numel()) * 4
    out = []
    for name, rays in _wavefronts(sd, rng).items():
        srt = walk._prepare(wt, *rays)[:4]
        closest_k = wk.walk_closest(wt, *srt)
        closest_p, tile_c = wk._walk_ref(wt, *srt, False)
        occ_k = wk.walk_anyhit(wt, *srt)
        (occ_p,), tile_a = wk._walk_ref(wt, *srt, True)
        torch.cuda.synchronize()
        tag = f"{label}/{name}"
        err_c, err_a, ties = _compare(tag, sd.geom.inter_rows, srt, closest_k,
                                      closest_p, occ_k, occ_p)
        n = srt[0].shape[0]
        tiles = n // wk.RAY_TILE
        rec = {"table": label, "wavefront": name, "cp": wt.n_clusters,
               "n_real": wt.n_real, "rays": n, "tie_ids": ties,
               "hits": int(torch.isfinite(closest_k[0]).sum()),
               "occluded": int(occ_k.sum())}
        for kind, visits, err, kfn, pfn, any_hit, out_b in (
                ("closest", tile_c, err_c, wk.walk_closest,
                 wk.walk_closest_ref, False, 16),
                ("anyhit", tile_a, err_a, wk.walk_anyhit,
                 wk.walk_anyhit_ref, True, 1)):
            bound, by = _bound_ms(int(visits.sum()) * wk.RAY_TILE * wk.K,
                                  n * (RAY_IN_BYTES + out_b) + table)
            rec[kind] = {
                "visits_per_tile": int(visits.sum()) / tiles,
                "max_visits": int(visits.max()),
                "p99_visits": float(torch.quantile(visits.double(), 0.99)),
                "max_abs_err": err,
                "ms": _median_ms(lambda f=kfn: f(wt, *srt)),
                "walk_ms": _median_ms(lambda a=any_hit: walk._walk_impl(
                    wt, *rays, a)),
                "plain_ms": _median_ms(lambda f=pfn: f(wt, *srt),
                                       runs=PLAIN_RUNS),
                "bound_ms": bound, "bound_by": by}
        phase("walk", f"{tag}: Cp {wt.n_clusters} ({wt.n_real} real), "
              f"{n} rays, {rec['hits']} hits, {rec['occluded']} occluded, "
              f"{ties} tie ids; " + "; ".join(
                  f"{k}: {rec[k]['visits_per_tile']:.2f} visits/tile (p99 "
                  f"{rec[k]['p99_visits']:.0f}, max {rec[k]['max_visits']}), kernel "
                  f"{rec[k]['ms']:.4f} ms, walk+sort {rec[k]['walk_ms']:.4f} "
                  f"ms, plain {rec[k]['plain_ms']:.2f} ms, bound "
                  f"{rec[k]['bound_ms']:.4f} ms ({rec[k]['bound_by']}), err "
                  f"{rec[k]['max_abs_err']:.3g}" for k in ("closest", "anyhit")))
        out.append(rec)
    return out


def oracle_check(dev):
    """The walk render against the dense kernels over every triangle."""
    from rustlight_tpu_torch.integrators import IntegratorPathTracing, render
    from rustlight_tpu_torch.models import sphere_grid
    sd = sphere_grid(GRID_ROWS[0][1], ORACLE_RES, ORACLE_RES).compile(
        device=dev)
    brute = sd._replace(geom=sd.geom._replace(walk=None))
    integ = IntegratorPathTracing(max_depth=GRID_DEPTH, nee_rr=ORACLE_NEE_RR)
    imgs = {}
    for name, scene in (("walk", sd), ("dense", brute)):
        _reset_launches()
        t0 = time.time()
        imgs[name] = render(scene, integ, spp=ORACLE_SPP, seed=0)["primal"]
        secs = time.time() - t0
        launched = {k: v for k, v in _launches().items() if v}
        if not all(k.startswith(name) for k in launched) or not launched:
            raise AssertionError(f"oracle: the {name} render launched "
                                 f"{launched}")
        phase("oracle", f"{name}: {secs:.3f}s, launches {launched}")
    a, b = imgs["walk"], imgs["dense"]
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-4)
    frac = float((rel.max(-1) <= ORACLE_PIX_RTOL).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
    phase("oracle", f"sphere_grid({GRID_ROWS[0][1]}) {ORACLE_RES}^2 "
          f"{ORACLE_SPP} spp: walk mean {a.mean():.7f}, dense mean "
          f"{b.mean():.7f}, {100 * frac:.3f}% of pixels within "
          f"{ORACLE_PIX_RTOL}, means differ by {mean_rel:.3g} (relative)")
    if not (np.all(np.isfinite(a)) and b.mean() > 0):
        raise AssertionError("oracle: bad images")
    if frac < ORACLE_PIX_FRAC or mean_rel > ORACLE_MEAN_RTOL:
        raise AssertionError("oracle: walk and dense renders disagree")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    t_start = time.time()
    dev = torch.device(DEVICE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", f"{torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")

    from rustlight_tpu_torch.ops import native
    t0 = time.time()
    lib = native.build(verbose=True)
    phase("build", f"{lib.name} in {time.time() - t0:.2f}s")

    from rustlight_tpu_torch.integrators import IntegratorPathTracing
    from rustlight_tpu_torch.models import cornell_box, sphere_grid
    from rustlight_tpu_torch.scene.geometry import (TriMesh,
                                                    build_geometry_tables)
    rng = np.random.default_rng(0)
    sd = cornell_box(CBOX_RES, CBOX_RES).compile(device=dev)
    cbox_rays = _rays(rng, (-20.0, -20.0, -800.0), (576.0, 568.8, 559.2),
                      N_RAYS, dev)
    err_cc, err_ca, times_c, bounds_c = check_kernels(sd.geom.inter_rows,
                                                      cbox_rays, "cbox")
    verts = rng.uniform(0.0, 1.0, (3000, 3)).astype(np.float32)
    soup = TriMesh(verts, np.arange(3000, dtype=np.int32).reshape(1000, 3))
    soup_rows = torch.as_tensor(
        build_geometry_tables([soup], [-1]).inter_rows, device=dev)
    soup_rays = _rays(rng, (-0.2,) * 3, (1.2,) * 3, N_RAYS, dev)
    err_sc, err_sa, _, _ = check_kernels(soup_rows, soup_rays, "soup1000")

    integ = IntegratorPathTracing(max_depth=CBOX_DEPTH)
    img, wall, warm, n_rays, launches = timed_render("cbox", sd, integ,
                                                     CBOX_SPP)
    l1, floor = block_mean_l1(img)
    if not l1 <= GATE_MARGIN * floor:
        raise AssertionError(f"render: block-mean l1 {l1:.6f} > "
                             f"{GATE_MARGIN} x floor {floor:.6f}")
    for name in ("dense_closest", "dense_anyhit"):
        if launches[name] <= 0:
            raise AssertionError(f"render: kernel {name} never launched")
    cbox_launches = launches
    phase("main", f"cbox {CBOX_RES}x{CBOX_RES} {CBOX_SPP} spp depth "
          f"{CBOX_DEPTH}: warm-up {warm:.3f}s, timed {wall:.3f}s, {n_rays} "
          f"rays, {n_rays / wall / 1e6:.3f} Mrays/s, mean {img.mean():.6f}, "
          f"block-mean l1 {l1:.6f} (limit {GATE_MARGIN * floor:.6f}), "
          f"launches {launches}")
    profile_render("cbox", sd, integ, 8, ("dense_",))
    del sd

    walk_recs, grids = [], {}
    for label, n_tris in GRID_ROWS:
        t0 = time.time()
        gsd = sphere_grid(n_tris, GRID_RES, GRID_RES).compile(device=dev)
        torch.cuda.synchronize()
        grids[label] = (gsd, n_tris, time.time() - t0)
        walk_recs += check_walk(label, gsd, rng)
    walk_launches = {"walk_closest": 0, "walk_anyhit": 0}
    integ = IntegratorPathTracing(max_depth=GRID_DEPTH)
    for label, (gsd, n_tris, build_s) in grids.items():
        img, wall, warm, n_rays, launches = timed_render(label, gsd, integ,
                                                         GRID_SPP)
        if min(launches["walk_closest"], launches["walk_anyhit"]) <= 0:
            raise AssertionError(f"{label}: the walk kernels never launched")
        if launches["dense_closest"] or launches["dense_anyhit"]:
            raise AssertionError(f"{label}: a dense kernel launched")
        for k in walk_launches:
            walk_launches[k] += launches[k]
        w = gsd.geom.walk
        phase("main", f"{label} sphere_grid({n_tris}) "
              f"{gsd.geom.n_tris} triangles, Cp {w.n_clusters} ({w.n_real} "
              f"real), scene build {build_s:.3f}s; {GRID_RES}x{GRID_RES} "
              f"{GRID_SPP} spp depth {GRID_DEPTH}: warm-up {warm:.3f}s, "
              f"timed {wall:.3f}s, {n_rays} rays, {n_rays / wall / 1e6:.3f} "
              f"Mrays/s, mean {img.mean():.6f}, launches {launches}")
    oracle_check(dev)
    gsd = grids[GRID_ROWS[0][0]][0]
    profile_render(GRID_ROWS[0][0], gsd, integ, 2, ("walk_",))

    def pick(kind):
        """The K3-size spread wavefront stands for a walk kernel; every
        table and wavefront is in `cases`."""
        rec = next(r for r in walk_recs
                   if r["table"] == GRID_ROWS[0][0] and r["wavefront"] == "spread")
        return rec[kind], [{"table": r["table"], "wavefront": r["wavefront"],
                            "cp": r["cp"], **r[kind]} for r in walk_recs]

    kernels = []
    for name, replaces, err, kind in (
            ("dense_closest", "rustlight_tpu/ops/pallas_trace.py:35",
             max(err_cc, err_sc), "closest"),
            ("dense_anyhit", "rustlight_tpu/ops/pallas_trace.py:66",
             max(err_ca, err_sa), "anyhit")):
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES["dense"],
            "replaces": replaces, "launches": cbox_launches[name],
            "max_abs_err": err, "ms": times_c[f"{kind}_ms"],
            "plain_ms": times_c[f"{kind}_plain_ms"],
            "bound_ms": bounds_c[kind][0], "bound_by": bounds_c[kind][1],
            "library_ms": None})
    for name, lines, kind in (("walk_closest", (636, 1139), "closest"),
                              ("walk_anyhit", (703, 1219), "anyhit")):
        rec, cases = pick(kind)
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES["walk"],
            "replaces": WALK_REPLACES.format(*lines),
            "launches": walk_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "cases": cases})
    phase("done", f"all phases passed in {time.time() - t_start:.1f}s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
  8. profile, grid122k and grid516k: torch.profiler over one warm 2 spp
     render each;
  9-12, for each AO row: grid4p9M, the scene of bench.py:187-223
     (sphere_grid_mesh(4_200_000, n_theta=18): 8,000 spheres, 4,896,000
     triangles, 16,000 walk clusters, so the one-level walk, as in the
     reference), and grid5p7M, the next grid of that family (9,261
     spheres, 5,667,732 triangles, 18,700 clusters in 147 supers: past
     2^14, so the two-level walk, K5):
  9. walk-hier kernels (K5, on both rows: grid4p9M's tables are handed to
     the two-level kernels directly): the two wavefronts the AO integrator
     hands the walk in one 256^2 sample (its camera rays, its occlusion
     rays with tfar = 2 and dead lanes as it leaves them) go through the
     walk's sort, then the two-level kernels and their plain versions see
     the same tiles, all of them: ids equal except near-ties,
     t/u/v within 1e-6, occlusion equal, no inert lane hits; kernel times
     and those of the walk with its sort, forced onto the two-level route,
     are medians of 10 on the whole wavefront, plain times one run on the
     whole wavefront (the comparison's) and medians of 3 on every 8th tile;
 10. main path, AO: render(scene, IntegratorAO(max_distance=2), 4 spp),
     warm-up seed 0, timed seed 1 (bench.py:209-214); the image must be
     finite, the ray count 2 x 256^2 x 4 = 524,288, and the row's walk
     kernels the only trace kernels launched;
 11. oracle, AO: the same scene at 64^2, 2 spp, seed 0, once through the
     walk and once through the dense kernels over every triangle: 99.9% of
     pixels equal, means within 1e-3 (relative);
 12. profile, AO: torch.profiler over one warm 1 spp render.

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
# the AO rows: bench.py's 4.9M-triangle row (bench.py:140, :187-223), and
# the next sphere grid of its family, the first past 2^14 clusters
AO_ROWS = (("grid4p9M", 4_200_000), ("grid5p7M", 5_000_000))
AO_THETA = 18
AO_RES, AO_SPP, AO_DIST = 256, 4, 2.0      # 2 x 65,536 rays a sample
AO_ORACLE_RES, AO_ORACLE_SPP = 64, 2
AO_ORACLE_PIX_FRAC, AO_ORACLE_MEAN_RTOL = 0.999, 1e-3
HIER_SAMPLE = 8            # plain versions timed on every 8th tile
# a visit reads its cluster's rows (384 x 48 B) and ids (384 x 4 B)
HIER_VISIT_BYTES = 384 * 48 + 384 * 4
KERNEL_SOURCES = {"dense": "rustlight_tpu_torch/csrc/dense_trace.cu",
                  "walk": "rustlight_tpu_torch/csrc/walk_trace.cu",
                  "walk_hier": "rustlight_tpu_torch/csrc/walk_hier.cu"}
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
    step = max(1, min(64, (1 << 26) // rows.shape[0]))  # [step, T] at a time
    for s in range(0, lanes.numel(), step):
        k = lanes[s:s + step]
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


def _launch_modules():
    from rustlight_tpu_torch.ops import dense_trace as dt
    from rustlight_tpu_torch.ops import walk_hier as wh
    from rustlight_tpu_torch.ops import walk_trace as wk
    return dt, wk, wh


def _reset_launches():
    for m in _launch_modules():
        m.reset_launches()


def _launches():
    return {k: v for m in _launch_modules() for k, v in m.LAUNCHES.items()}


def timed_render(label, sd, integ, spp, seed=0):
    """Warm-up render (seed 0), then a timed one (`seed`) with launch counts
    reset just before and read just after. Returns (image, wall s, warm-up
    s, rays, launches)."""
    import torch
    from rustlight_tpu_torch.integrators import render
    from rustlight_tpu_torch.ops.native import counting_rays
    t0 = time.time()
    render(sd, integ, spp=spp, seed=0)
    warm = time.time() - t0
    _reset_launches()
    with counting_rays(sd.device) as rays:
        t0 = time.time()
        film = render(sd, integ, spp=spp, seed=seed)
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


def oracle_check(label, sd, integ, spp, walk_kernels, pix_frac, pix_rtol,
                 mean_rtol):
    """The walk render against the dense kernels over every triangle: at
    least pix_frac of the pixels within pix_rtol (0: equal), the means
    within mean_rtol (both relative). Each render must launch exactly its
    kernels: walk_kernels, or the dense pair."""
    from rustlight_tpu_torch.integrators import render
    brute = sd._replace(geom=sd.geom._replace(walk=None))
    imgs = {}
    for name, scene, kernels in (("walk", sd, walk_kernels),
                                 ("dense", brute, ("dense_closest",
                                                   "dense_anyhit"))):
        _reset_launches()
        t0 = time.time()
        imgs[name] = render(scene, integ, spp=spp, seed=0)["primal"]
        secs = time.time() - t0
        launched = {k: v for k, v in _launches().items() if v}
        if set(launched) != set(kernels):
            raise AssertionError(f"oracle: the {name} render launched "
                                 f"{launched}")
        phase("oracle", f"{label} {name}: {secs:.3f}s, launches {launched}")
    a, b = imgs["walk"], imgs["dense"]
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-4)
    frac = float((rel.max(-1) <= pix_rtol).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
    w, h = sd.camera.width, sd.camera.height
    phase("oracle", f"{label} {w}x{h} {spp} spp: walk mean {a.mean():.7f}, "
          f"dense mean {b.mean():.7f}, {100 * frac:.3f}% of pixels within "
          f"{pix_rtol}, means differ by {mean_rel:.3g} (relative)")
    if not (np.all(np.isfinite(a)) and b.mean() > 0):
        raise AssertionError(f"oracle {label}: bad images")
    if frac < pix_frac or mean_rel > mean_rtol:
        raise AssertionError(f"oracle {label}: walk and dense renders "
                             "disagree")


def ao_scene(dev, n_tris):
    """An AO row's scene as bench.py:198-207 builds grid4p9M: a grid of UV
    spheres of 612 triangles (sphere_grid_mesh(n_tris, n_theta=18), diffuse
    0.65, 0.6, 0.55), no emitter, the camera at (ext/2, ext/2, -0.35 ext)
    looking at the centre, fov 55, AO_RES^2. Returns (scene, build s,
    camera(res) -> the same camera at res^2)."""
    import torch
    from rustlight_tpu_torch.bsdfs import diffuse
    from rustlight_tpu_torch.models.presets import sphere_grid_mesh
    from rustlight_tpu_torch.scene import Scene, look_at, make_camera
    from rustlight_tpu_torch.scene.camera import camera_to
    t0 = time.time()
    sc = Scene()
    m = sc.add_material(diffuse((0.65, 0.6, 0.55)))
    mesh, gs = sphere_grid_mesh(n_tris, n_theta=AO_THETA, material=m)
    sc.add_mesh(mesh)
    ext = gs * 3.0
    to_world = look_at((ext / 2, ext / 2, -0.35 * ext),
                       (ext / 2, ext / 2, ext / 2), (0, 1, 0))

    def camera(res):
        return camera_to(make_camera(res, res, fov=55.0, to_world=to_world),
                         dev)

    sc.camera = make_camera(AO_RES, AO_RES, fov=55.0, to_world=to_world)
    sd = sc.compile(device=dev)
    torch.cuda.synchronize()
    return sd, time.time() - t0, camera


def ao_wavefronts(sd):
    """The two wavefronts the AO integrator hands the walk in one sample
    (seed 0, sample 0): its camera rays and its occlusion rays, taken from
    its calls to the walk."""
    import torch
    from rustlight_tpu_torch.accel import walk
    from rustlight_tpu_torch.integrators import IntegratorAO
    from rustlight_tpu_torch.integrators.common import _pixel_grid
    from rustlight_tpu_torch.utils.rng import make_stream, stream_fold
    seen = {}
    impl = walk._walk_impl

    def spy(wt, o, d, tnear, tfar, any_hit, *args, **kw):
        seen["ao" if any_hit else "camera"] = [
            x.contiguous().clone() for x in (o, d, tnear, tfar)]
        return impl(wt, o, d, tnear, tfar, any_hit, *args, **kw)

    walk._walk_impl = spy
    try:
        w, h = sd.camera.width, sd.camera.height
        pix = torch.as_tensor(_pixel_grid(w, h), device=sd.device)
        IntegratorAO(max_distance=AO_DIST).compute_pixel(
            sd, pix, stream_fold(make_stream(0, sd.device), 0))
    finally:
        walk._walk_impl = impl
    return seen


def _spread(x):
    """(mean, 99th percentile, max) of a per-tile count."""
    import torch
    x = x.double()
    return float(x.mean()), float(torch.quantile(x, 0.99)), int(x.max())


def check_hier(label, sd):
    """Two-level walk kernels against their plain versions on the AO
    integrator's two wavefronts, sorted by the walk: every tile is compared
    (the plain versions also count the supers opened and clusters visited
    per tile, for the bound), and the plain versions are timed on every
    HIER_SAMPLE-th tile. Returns one record per wavefront."""
    import torch
    from rustlight_tpu_torch.accel import walk
    from rustlight_tpu_torch.ops import walk_hier as wh
    from rustlight_tpu_torch.ops.walk_trace import RAY_TILE
    wt = sd.geom.walk
    out = []
    for name, rays in ao_wavefronts(sd).items():
        srt = walk._prepare(wt, *rays)[:4]
        n = srt[0].shape[0]
        tiles = n // RAY_TILE
        closest_k = wh.walk_hier_closest(wt, *srt)
        occ_k = wh.walk_hier_anyhit(wt, *srt)
        torch.cuda.synchronize()
        t0 = time.time()
        closest_p, opened_c, visits_c = wh._walk_hier_ref(wt, *srt, False)
        torch.cuda.synchronize()
        t1 = time.time()
        (occ_p,), opened_a, visits_a = wh._walk_hier_ref(wt, *srt, True)
        torch.cuda.synchronize()
        plain_ms = {"closest": (t1 - t0) * 1e3,
                    "anyhit": (time.time() - t1) * 1e3}
        tag = f"{label}/{name}"
        err_c, err_a, ties = _compare(tag, sd.geom.inter_rows, srt, closest_k,
                                      closest_p, occ_k, occ_p)
        lanes = (torch.arange(0, tiles, HIER_SAMPLE, device=srt[0].device)
                 [:, None] * RAY_TILE
                 + torch.arange(RAY_TILE, device=srt[0].device)).reshape(-1)
        sub = [x[lanes].contiguous() for x in srt]
        rec = {"table": label, "wavefront": name, "cp": wt.n_clusters,
               "n_real": wt.n_real, "n_sup": wt.n_sup, "rays": n,
               "tie_ids": ties,
               "hits": int(torch.isfinite(closest_k[0]).sum()),
               "occluded": int(occ_k.sum())}
        for kind, opened, visits, err, kfn, pfn, any_hit, out_b in (
                ("closest", opened_c, visits_c, err_c, wh.walk_hier_closest,
                 wh.walk_hier_closest_ref, False, 16),
                ("anyhit", opened_a, visits_a, err_a, wh.walk_hier_anyhit,
                 wh.walk_hier_anyhit_ref, True, 1)):
            nv = int(visits.sum())
            bound, by = _bound_ms(nv * RAY_TILE * wh.K,
                                  nv * HIER_VISIT_BYTES
                                  + n * (RAY_IN_BYTES + out_b))
            rec[kind] = {
                "supers_per_tile": _spread(opened),
                "visits_per_tile": _spread(visits),
                "max_abs_err": err,
                "ms": _median_ms(lambda f=kfn: f(wt, *srt)),
                "walk_ms": _median_ms(lambda a=any_hit: walk._walk_impl(
                    wt, *rays, a, hier=True)),
                "plain_ms": plain_ms[kind],
                "plain_sample_ms": _median_ms(lambda f=pfn: f(wt, *sub),
                                              runs=PLAIN_RUNS),
                "plain_tiles": lanes.numel() // RAY_TILE,
                "bound_ms": bound, "bound_by": by}
        phase("walk-hier", f"{tag}: Cp {wt.n_clusters} ({wt.n_real} real, "
              f"{wt.n_sup} supers of {wt.n_sup_pad}), {n} rays, "
              f"{rec['hits']} hits, {rec['occluded']} occluded, {ties} tie "
              "ids; " + "; ".join(
                  f"{k}: supers/tile {'%.2f, p99 %.0f, max %d' % rec[k]['supers_per_tile']}, "
                  f"visits/tile {'%.2f, p99 %.0f, max %d' % rec[k]['visits_per_tile']}, "
                  f"kernel {rec[k]['ms']:.4f} ms, walk+sort "
                  f"{rec[k]['walk_ms']:.4f} ms, plain {rec[k]['plain_ms']:.2f}"
                  f" ms (every tile), {rec[k]['plain_sample_ms']:.2f} ms "
                  f"({rec[k]['plain_tiles']} tiles), bound "
                  f"{rec[k]['bound_ms']:.4f} ms ({rec[k]['bound_by']}), err "
                  f"{rec[k]['max_abs_err']:.3g}" for k in ("closest", "anyhit")))
        out.append(rec)
    return out


def ao_row(dev, label, n_tris):
    """Phases 9-12 on one AO row. The two-level kernels are checked on
    every row; the render takes the reference's route: the two-level walk
    past FLAT_MAX_CLUSTERS clusters. Returns (walk-hier records, the AO
    render's launches)."""
    from rustlight_tpu_torch.accel.walk import FLAT_MAX_CLUSTERS
    from rustlight_tpu_torch.integrators import IntegratorAO
    sd, build_s, camera = ao_scene(dev, n_tris)
    w = sd.geom.walk
    hier = w.n_clusters > FLAT_MAX_CLUSTERS
    kernels = (("walk_hier_closest", "walk_hier_anyhit") if hier
               else ("walk_closest", "walk_anyhit"))
    phase("main", f"{label} sphere_grid_mesh({n_tris}, n_theta={AO_THETA}): "
          f"{sd.geom.n_tris} triangles, Cp {w.n_clusters} ({w.n_real} real),"
          f" n_sup {w.n_sup} (padded {w.n_sup_pad}), scene build "
          f"{build_s:.3f}s; route {'/'.join(kernels)}")
    recs = check_hier(label, sd)
    integ = IntegratorAO(max_distance=AO_DIST)
    img, wall, warm, n_rays, launches = timed_render(label, sd, integ,
                                                     AO_SPP, seed=1)
    expect = 2 * AO_RES * AO_RES * AO_SPP
    if n_rays != expect:
        raise AssertionError(f"{label}: {n_rays} rays traced, {expect} "
                             "expected")
    if min(launches[k] for k in kernels) <= 0 or any(
            v for k, v in launches.items() if k not in kernels):
        raise AssertionError(f"{label}: launches {launches}")
    phase("main", f"{label} AO {AO_RES}x{AO_RES} {AO_SPP} spp, max distance "
          f"{AO_DIST}: warm-up {warm:.3f}s, timed (seed 1) {wall:.3f}s, "
          f"{n_rays} rays, {n_rays / wall / 1e6:.3f} Mrays/s, mean_ao "
          f"{img.mean():.5f}, launches {launches}")
    small = sd._replace(camera=camera(AO_ORACLE_RES))
    oracle_check(label, small, integ, AO_ORACLE_SPP, kernels,
                 AO_ORACLE_PIX_FRAC, 0.0, AO_ORACLE_MEAN_RTOL)
    profile_render(label, sd, integ, 1, ("walk_hier",) if hier else ("walk_",))
    return recs, launches


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
    osd = sphere_grid(GRID_ROWS[0][1], ORACLE_RES, ORACLE_RES).compile(
        device=dev)
    oracle_check(f"sphere_grid({GRID_ROWS[0][1]})", osd,
                 IntegratorPathTracing(max_depth=GRID_DEPTH,
                                       nee_rr=ORACLE_NEE_RR),
                 ORACLE_SPP, ("walk_closest", "walk_anyhit"),
                 ORACLE_PIX_FRAC, ORACLE_PIX_RTOL, ORACLE_MEAN_RTOL)
    del osd
    for label, (gsd, _, _) in grids.items():
        profile_render(label, gsd, integ, 2, ("walk_",))
    del grids, gsd
    hier_recs, ao_launches = [], {}
    for label, n_tris in AO_ROWS:
        recs, launches = ao_row(dev, label, n_tris)
        hier_recs += recs
        for k, v in launches.items():
            ao_launches[k] = ao_launches.get(k, 0) + v
    for k in walk_launches:
        walk_launches[k] += ao_launches[k]

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
    from rustlight_tpu_torch.accel.walk import FLAT_MAX_CLUSTERS
    for name, line, kind, wave in (
            ("walk_hier_closest", 1311, "closest", "camera"),
            ("walk_hier_anyhit", 1411, "anyhit", "ao")):
        # the wavefront of the row whose render takes the two-level walk
        rec = next(r for r in hier_recs if r["wavefront"] == wave
                   and r["cp"] > FLAT_MAX_CLUSTERS)[kind]
        kernels.append({
            "name": name, "route": "cuda",
            "source": KERNEL_SOURCES["walk_hier"],
            "replaces": f"rustlight_tpu/accel/pallas_walk.py:{line} (K5)",
            "launches": ao_launches[name],
            "max_abs_err": max(r[kind]["max_abs_err"] for r in hier_recs),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None,
            "cases": [{"table": r["table"], "wavefront": r["wavefront"],
                       "cp": r["cp"], **r[kind]} for r in hier_recs]})
    phase("done", f"all phases passed in {time.time() - t_start:.1f}s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

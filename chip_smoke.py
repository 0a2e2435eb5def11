"""GPU smoke run of the PyTorch/CUDA port (rustlight_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda), g++ and this
checkout; imports nothing of JAX. Phases, one line each or more:

  0. device: require CUDA; print the card's name and power limit; turn
     TF32 off for matmuls and cuDNN;
  1. build: compile the port's CUDA kernels from csrc/ (sm_90a, one nvcc
     per source, all at once), and beside them, in a thread, the
     RL_LAB_FORMS library of K7's and K3w's candidate and laboratory forms
     (tools/perf/split_forms.py); ptxas's registers, shared memory and
     spills of every kernel (`ptxas` lines), and launch_geometry's static
     shared memory held to ptxas's for every walk kernel in both its forms
     (K7 and K3w included), K3/K4's and K3w's split tensor-core forms and
     K6's forms at every sub with both tests;
  2. kernels: the dense kernels (K1, K2) against their plain versions, bit
     for bit (0 lanes differ, no near-tie excuse), at 262,144 rays against
     the Cornell box's rows and against a random 1,000-triangle soup, with
     inert (tfar = 0) and empty (tnear >= tfar) lanes; on the wavefronts
     the cbox render hands them in its first two iterations (camera and
     first bounce rays, K1; the first NEE shadow rays, K2); and on the
     planted boundary sets of ops/dense_trace.py:planted_sets. Times on
     all but the planted sets: the wrapper's ms (medians of 10
     synchronised runs), the plain version's, the kernel's device us a
     launch (torch.profiler over 20), the wrapper's host us a call (1,000
     calls, one sync); beside the bound, the issue floor: tests x the
     FP32-pipe instructions a test in the kernel's SASS (cuobjdump, every
     path) / (132 SMs x 128 lanes x clocks.max.sm);
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
     and empty lanes) go through the walk's sort, then the kernels (the
     production form: P threads a ray, and for the any hit the ring of
     cluster rows; and the one-thread form, P1) and their plain versions
     see the same tiles: ids equal except near-ties, t/u/v within 1e-6,
     occlusion equal, no inert lane hits; the lanes on which the two forms
     differ are counted (0 expected; any must be a near tie); times are
     medians of 10 (kernel: P1, production, production, P1 in turns; and
     the walk with its sort), plain one run; ptxas's registers and shared
     memory of both forms are printed (`forms` lines; every kernel's after
     the build, `ptxas` lines, where launch_geometry's static shared
     memory must equal ptxas's for every walk kernel in both forms);
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
     t/u/v within 1e-6, occlusion equal, no inert lane hits, for the
     production form and for P1, and the two forms against each other and
     timed as in phase 5; kernel times
     and those of the walk with its sort, forced onto the two-level route,
     are medians of 10 on the whole wavefront, plain times one run on the
     whole wavefront (the comparison's) and one more on every 8th tile.
     On grid4p9M (the one-level route) the one-level kernels K4 too: both
     forms against the plain one-level walk on every tile (its visits give
     the bound), against each other and timed as in phase 5 (`walk-flat`);
 10. main path, AO: render(scene, IntegratorAO(max_distance=2), 4 spp),
     warm-up seed 0, timed seed 1 (bench.py:209-214); the image must be
     finite, the ray count 2 x 256^2 x 4 = 524,288, and the row's walk
     kernels the only trace kernels launched;
 11. oracle, AO: the same scene at 64^2, 2 spp, seed 0, once through the
     walk and once through the dense kernels over every triangle: 99.9% of
     pixels equal, means within 1e-3 (relative);
 12. profile, AO: torch.profiler over one warm 1 spp render;
 13. schedule kernels: on grid122k's tables and the two wavefronts of phase
     5, after the walk's sort: the sub-tiled walk (K6) at sub = 2, 4, 8, the
     sparse-visit walk (K7), the wide pop of K3/K4 with its heaps in shared
     and in device memory, and the pair walk (K8) at km = 8 and 2 (2 makes
     most rays re-trace), each against its plain version under phase 5's
     rules and against K3's result on the same rays (K7 with the share of
     visits that took the sparse branch and the rays flagged a visit);
     kernel and whole-call times are medians of 10 beside K3's, plain times
     one run. K6's production form (P threads a ray, ops/walk_sub.py:
     PRODUCTION_FORMS) at each sub is held to its one-thread form and to the
     plain version bit for bit (0 lanes may differ, no near-tie excuse) and
     the two forms are timed in turns (P1, new, new, P1; `forms` lines);
     so are K7's and the wide pop's production forms (P threads a ray,
     ops/walk_sparse.py and ops/walk_trace.py:PRODUCTION_FORMS), each held
     bit for bit to its one-thread form and its plain version, with the
     bound with the entry pass's slab tests (64 a real cluster and tile)
     beside the bound in `kernel_cases`, and K7's
     candidate forms (P = 4, the other feed; tools/perf/split_forms.py)
     timed the same way; before that, on the planted tiles whose groups
     stop far apart (ops/walk_sub.py:planted_tiles), both forms of both tests
     of K6 at every sub against the plain version (the tensor-core forms
     against each other), and on the planted tiles that flag 16 and 17 rays
     (ops/walk_sparse.py:planted_tiles) both forms of K7.
     Then the tensor-core forms of K3 (split over warps by columns, with
     its one-thread form), K6 (sub = 2, 4, 8; split, ops/walk_sub.py:
     MMA_FORMS) and K8 (km = 8, 2) on the same rays and pairs, each against its plain
     mxu version and against the _dot4 kernels under _compare_mxu's rules,
     with the count of lanes outside MXU_T_RTOL beside the plain form's
     (the cap of _check_mma) and against the exact t (_exact_cap), each
     split form against its one-thread tensor-core form bit for bit and
     timed in turns with it, and K8's whole pair walk timed. The wide pop
     the same way on grid5p7M's tables and the two AO wavefronts of phase 9
     (every tile), beside K5's times, its production form with each heap
     against its one-thread form and the plain version bit for bit and timed
     in turns, its split tensor-core forms against the one-thread ones with
     each heap, all of these again with 257 blocks for the 1,024 tiles (a
     block walking 3 or 4 tiles), and its candidate and laboratory forms
     (the entry pass
     alone, the pops alone, the other feed, P = 4;
     tools/perf/split_forms.py), which split its time into entry pass, pops
     and visits. (Run while each scene is alive: the grid122k part after
     phase 8, the grid5p7M part after phase 12.)
 14. main path, schedules: the grid122k render of phase 6 once more for each
     of WalkOptions(sub=2), (sparse=True), (pair=True), the scene uploaded
     with that option from the host tables built once: finite image; that
     schedule's kernels launched and no other trace kernel (pair: also the
     tile walk of its fallback); against phase 6's image of the same seed
     99.9% of pixels within 1e-3 (relative), means within 1e-4; a profile
     of a warm 2 spp render each, and the default schedule timed once more;
 15. main path, wide: the grid5p7M AO render of phase 10 with
     WalkOptions(hier=False): 524,288 rays, the wide kernels the only trace
     kernels, 99.9% of pixels equal to phase 10's image, means within 1e-3;
 16. sort key: the grid4p9M AO render with WalkOptions(inc_sort=False)
     beside phase 10's, images held equal as in 15.
 17. lab kernels (K9 and the tensor-core form of the triangle test): on the
     roofline tools' scene (sphere_grid_mesh(110_000, n_theta=18): 132,192
     triangles, 432 clusters padded to 512) and their coherent and divergent
     ray sets at 65,536 rays, sorted by the walk: the counted walk against
     its plain version (bit-equal, visits equal per tile) and against K3
     (bit-equal), both in the production form, and the floor walk at the
     same threads a ray and ring; the floor against its plain version
     (bit-equal; the
     plain one timed on every 8th tile); fma_peak against its plain version
     at 4,000 steps and one block (rtol 1e-4), then timed at the tools' size
     and at half the steps (the time must follow); the tensor-core visit of
     K3, the wide pop and K5: its two products against the _dot4 form's and
     against torch.matmul's (the error printed), then each kernel pair
     against its plain mxu version and against the _dot4 kernels under
     _compare_mxu's rules, the excused lanes printed. The candidate forms of
     the products (ops/walk_lab.py:MMA_FORMS; the kernels' one, bit for bit
     against mma_products): on every set where a tensor-core kernel is
     checked (the lab's two, grid122k's two, grid5p7M's camera and AO), each
     form's lanes outside MXU_T_RTOL of the _dot4 kernel's t and of the
     exact t, beside the plain matmul form's, and each form's time on
     A1_VISITS visits a tile;
     the table follows phase 18 (`a1` lines). The same check runs
     where the main path launches these kernels, and the kernels line takes
     their time, bound and error from there: K3's on grid122k's two
     wavefronts (with phase 13), the wide pop's and K5's on grid5p7M's
     camera and AO wavefronts (Cp 18,816, heaps in device memory; with
     phase 13's wide-pop check), the plain mxu version run on every tile.
 18. lab path: roofline.main and trace_122k.main at 262,144 rays, without
     and with --mxu, and tree_lab.main with its five variants, each printing
     its own JSON; launch counts reset before and read after; roofline
     twice more under torch.profiler for the lab kernels' device time; then
     intersect_bvh (the skip-link traversal, plain torch) on the coherent
     set's first 65,536 rays against K3: hit masks equal, ids equal save
     near ties, t within 1e-6 relative; steps and ms printed.
 19. main path, mxu: the grid122k render of phase 6 with
     WalkOptions(mxu_tritest=True), with (sub=2, mxu_tritest=True) and with
     (pair=True, mxu_tritest=True), each held to phase 6's image as in 14,
     only that schedule's tensor-core kernels launching (the pair walk's
     also K3's, for its fallback), a warm 2 spp render of each profiled;
     and, on grid5p7M, the AO render of
     phase 10 with mxu_tritest on the two-level walk and on the wide pop,
     held to phase 10's image as in 15. (Run with phases 14 and 15.)

Before the last line: a JSON line with each kernel's tables and wavefronts
(kernel_cases), the candidate forms' table (a1_forms) and the split forms'
records of K7 and K3w (split_forms), the card line
from nvidia-smi and a JSON line with each kernel's launches, error, times
and bound. The last line is the JSON status {"ok": true, "device": {...}};
a failed phase raises and prints no status. The run prints its seconds.
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
PLAIN_RUNS = 1
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
# the f32 operations of one slab test of the entry pass: three axes of two
# subtractions, two products, a min and a max and the two running limits
SLAB_OPS = 24
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
                  "walk_hier": "rustlight_tpu_torch/csrc/walk_hier.cu",
                  "walk_sub": "rustlight_tpu_torch/csrc/walk_sub.cu",
                  "walk_sparse": "rustlight_tpu_torch/csrc/walk_sparse.cu",
                  "pair": "rustlight_tpu_torch/csrc/pair_trace.cu",
                  "lab": "rustlight_tpu_torch/csrc/walk_lab.cu",
                  "mma": "rustlight_tpu_torch/csrc/tri_test_mma.cuh"}
# phase 17: the lab scene, and the tensor-core form's tolerance. It is not
# bit-identical to the _dot4 form: both round products of magnitudes that
# cancel (coordinates near 20 down to a t or u near 0), in another order.
# Against its plain mxu version and against the _dot4 kernels: hit masks,
# occlusion and ids equal except on lanes that are a near tie (TIE_RTOL) or
# whose u, v or u + v lies within MXU_EDGE of a triangle's edge, or on which
# an operand error of MXU_OPERAND_EPS of the summed magnitudes moves some
# triangle's t, u or v across a limit of the test (_graze_mask: rays that
# leave a surface at 1e-3 graze it) (excused, counted, at most
# MXU_EXCUSED_FRAC of the lanes together); on the other lanes t within
# MXU_T_RTOL / MXU_T_ATOL, or within what an operand error of MXU_OPERAND_EPS
# of the summed magnitudes makes of it (rays that start on a surface have
# t near 0 from terms near 400: such lanes are counted too); u, v likewise.
LAB_TRIS, LAB_THETA, LAB_RAYS = 110_000, 18, 65_536
MXU_T_RTOL, MXU_T_ATOL, MXU_EDGE = 1e-5, 1e-6, 1e-5
MXU_OPERAND_EPS, MXU_EXCUSED_FRAC = 1e-6, 1e-3
# the lanes held to the operand-error bound are capped too. Their share
# is the data's (under 1% of the lab's sets, a fifth of a wavefront that
# leaves a surface at 1e-3, where t near 1e-3 comes from terms near 10), so
# the cap is tied to it: at most MXU_LOOSE_RATIO x the lanes on which the
# plain mxu version (torch.matmul, full f32) misses the plain tolerance
# against the same _dot4 kernels, plus MXU_LOOSE_SLACK. The route is for
# ill-conditioned lanes, which any summation order shows: measured on an
# H100, even the exact products (float64) rounded to f32 miss it against
# the _dot4 t on 2.22x as many lanes as torch.matmul, whose rounding
# tracks the _dot4 form's; the six-pass products miss it on 2.23x
# (7,815 to 3,499 on grid122k's spread wavefront, 153 to 137 on the lab's
# divergent set) while they miss the exact t on 0.05x as many lanes as
# torch.matmul (phase 17's a1 lines). Their operand error is 2.1e-7 to
# torch.matmul's 1.6e-7. The ratio is 1.5 x the largest measured, and the
# slack covers sets where the plain version misses on few. What "f32
# accuracy" means is held against the exact t (the products in float64):
# on the lanes where a tensor-core kernel and its plain mxu version hit the
# same triangle, the kernel may miss MXU_T_RTOL / MXU_T_ATOL of the exact t
# on at most as many lanes as torch.matmul (_exact_cap).
MXU_LOOSE_RATIO, MXU_LOOSE_SLACK = 3.3, 32
TC_TF32_OPS = 495e12        # H100 SXM dense TF32 tensor-core rate
MMA_PASSES = 6              # TF32 passes a product (tri_test_mma.cuh:mma_f32)
A1_RATIO = 1.5              # a form's lanes outside rtol / the plain form's
A1_VISITS = 25              # visits a tile of phase 17's timing of the forms
FMA_RTOL = 1e-4
PW = "rustlight_tpu/accel/pallas_walk.py"
ROOFLINE = "tools/perf/roofline.py"
# the schedule renders of phase 14 and the shortlist lengths of phase 13
SCHED_PIX_FRAC, SCHED_PIX_RTOL, SCHED_MEAN_RTOL = 0.999, 1e-3, 1e-4
PAIR_KMS = (8, 2)
PAIR_IN_BYTES = RAY_IN_BYTES + 4   # a pair: its ray and its cluster id
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


def _form_name(form) -> str:
    """A kernel form (threads a ray, ring) as text."""
    p, ring = form
    return f"P{p}" + ("+ring" if ring else "")


_PTXAS = {}


def _ptxas(pattern) -> str:
    """ptxas's registers and static shared memory (and spills) of the one
    kernel whose mangled name holds `pattern`."""
    from rustlight_tpu_torch.ops import native
    if not _PTXAS:
        _PTXAS.update(native.ptxas_usage())
    hits = [v for k, v in _PTXAS.items() if pattern in k]
    if len(hits) != 1:
        raise AssertionError(f"ptxas: {len(hits)} kernels match {pattern}")
    regs, smem, spill = hits[0]
    return f"{regs} regs, {smem} B smem" + (f", {spill} B spilled"
                                           if spill else "")


def _symbol(kernel, form, count=False, mma=False) -> str:
    """The mangled-name fragment of `kernel` (a PRODUCTION_FORMS name, or
    walk_floor) in `form` (its one-thread or its split form); `count`: the
    counted walk's; `mma`: with the tensor-core test."""
    from rustlight_tpu_torch.ops import walk_trace as wk
    p, ring = (int(x) for x in form)
    if (p, ring) == (1, 0):
        return {"walk_closest": f"walk_closest_kernelILb{int(mma)}ELb"
                                f"{int(count)}EE",
                "walk_anyhit": f"walk_anyhit_kernelILb{int(mma)}EE",
                "walk_hier_closest": "walk_hier_closest_kernelILb0EE",
                "walk_hier_anyhit": "walk_hier_anyhit_kernelILb0EE",
                "walk_floor": "walk_floor_kernelILb0EE",
                "walk_closest_wide": f"walk_closest_wide_kernelILb{int(mma)}EE",
                "walk_anyhit_wide": f"walk_anyhit_wide_kernelILb{int(mma)}EE",
                "walk_sparse_closest": "walk_sparse_closest_kernelE",
                "walk_sparse_anyhit": "walk_sparse_anyhit_kernelE"}[kernel]
    if kernel in wk._WIDE:
        return f"{kernel}_split_kernelILi{p}ELb{ring}ELb{int(mma)}EE"
    if kernel.startswith("walk_sparse"):
        return f"{kernel}_split_kernelILi{p}ELb{ring}EE"
    if kernel == "walk_closest":
        return (f"walk_closest_split_kernelILb{int(count)}ELi{p}ELb{ring}"
                f"ELb{int(mma)}EE")
    if kernel == "walk_anyhit":
        return f"walk_anyhit_split_kernelILi{p}ELb{ring}ELb{int(mma)}EE"
    if kernel == "walk_floor":
        return f"walk_floor_split_kernelILi{p}ELb{ring}EE"
    return f"{kernel}_split_kernelILi{p}EE"


def _sub_symbol(name, sub, form, mma) -> str:
    """The mangled-name fragment of K6's kernel `name` (walk_sub_closest or
    walk_sub_anyhit) at `sub` in `form` (threads a ray, staged)."""
    p, stage = (int(x) for x in form)
    return f"{name}_kernelILi{sub}ELi{p}ELb{stage}ELb{int(mma)}EE"


def _static_of(sym) -> int:
    hits = [v for k, v in _PTXAS.items() if sym in k]
    if len(hits) != 1:
        raise AssertionError(f"ptxas: {len(hits)} kernels match {sym}")
    return hits[0][1]


def check_static_smem():
    """launch_geometry's static shared memory of every walk kernel in both
    its forms (ops/walk_trace.py:static_smem), K3/K4's and K3w's split form
    with the tensor-core test too, of K6 in every form built
    (ops/walk_sub.py:static_smem) and of K7 in both (ops/walk_sparse.py:
    static_smem), against ptxas's report."""
    from rustlight_tpu_torch.ops import walk_sparse as ws
    from rustlight_tpu_torch.ops import walk_sub as wsub
    from rustlight_tpu_torch.ops import walk_trace as wk
    checked = 0
    for name, split in ws.PRODUCTION_FORMS.items():
        for form in (wk.ONE_THREAD_FORM, split):
            sym = _symbol(name, form)
            if _static_of(sym) != ws.static_smem(form):
                raise AssertionError(
                    f"{sym}: ptxas {_static_of(sym)} B of static shared "
                    f"memory, launch_geometry {ws.static_smem(form)} B")
            checked += 1
    for kernel in (*wk.PRODUCTION_FORMS, "walk_floor"):
        split = wk.PRODUCTION_FORMS.get(kernel,
                                        wk.PRODUCTION_FORMS["walk_closest"])
        for form in (wk.ONE_THREAD_FORM, split):
            for count in ((False, True) if kernel == "walk_closest"
                          else (False,)):
                for mma in ((False, True) if kernel in wk._MMA_SPLIT
                            and not count else (False,)):
                    sym = _symbol(kernel, form, count, mma)
                    if _static_of(sym) != wk.static_smem(kernel, form):
                        raise AssertionError(
                            f"{sym}: ptxas {_static_of(sym)} B of static "
                            f"shared memory, launch_geometry "
                            f"{wk.static_smem(kernel, form)} B")
                    checked += 1
    for name in wsub.PRODUCTION_FORMS:
        for sub in wsub.SUBS:
            for mma, table in ((False, wsub.PRODUCTION_FORMS),
                               (True, wsub.MMA_FORMS)):
                for form in {wk.ONE_THREAD_FORM, table[name][sub]}:
                    sym = _sub_symbol(name, sub, form, mma)
                    if _static_of(sym) != wsub.static_smem(sub, form):
                        raise AssertionError(
                            f"{sym}: ptxas {_static_of(sym)} B of static "
                            f"shared memory, launch_geometry "
                            f"{wsub.static_smem(sub, form)} B")
                    checked += 1
    phase("ptxas", "launch_geometry's static shared memory = ptxas's on "
          f"{checked} walk kernels: both forms of every walk kernel, K3/K4's "
          "and K3w's split tensor-core forms, K6's forms at every sub with "
          "both tests, K7's forms")


def ptxas_table():
    """Every kernel of the library with ptxas's registers, static shared
    memory and spills, one line each."""
    import re
    from rustlight_tpu_torch.ops import native
    _PTXAS.update(native.ptxas_usage())
    for name, (regs, smem, spill) in sorted(_PTXAS.items()):
        m = re.search(r"([a-z][a-z_]*_kernel)(I(?:L[bi]\d+E)+E)?", name)
        short = name if m is None else m.group(1) + (
            "<" + ",".join(re.findall(r"L[bi](\d+)E", m.group(2))) + ">"
            if m.group(2) else "")
        phase("ptxas", f"{short}: {regs} registers, {smem} B static shared"
              f" memory, {spill} B spilled")


def _lanes_differ(a, b) -> "torch.Tensor":
    """Lanes on which two kernels' outputs (tuples of [n] tensors, or one)
    differ in any bit."""
    import torch
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    bad = torch.zeros(a[0].shape[0], dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        bad |= x != y
    return torch.nonzero(bad)[:, 0]


def _forms_vs_one(tag, kernels, wt, srt, rows):
    """The one-thread form and the production form of each of `kernels`
    ((LAUNCHES name, wrapper) pairs) on the same tiles: the lanes that
    differ between them (0 expected; any must be a near tie), their times
    in turns (one-thread, production, production, one-thread; medians of
    TIMING_RUNS each) and ptxas's lines. Returns {name: record}."""
    import torch
    from rustlight_tpu_torch.ops import walk_trace as wk
    one = wk.ONE_THREAD_FORM
    out = {}
    for name, fn in kernels:
        prod = wk.PRODUCTION_FORMS[name]
        new, old = fn(wt, *srt), fn(wt, *srt, _form=one)
        torch.cuda.synchronize()
        diff = _lanes_differ(new, old)
        if diff.numel() and not _near_tie(rows, *srt, diff):
            raise AssertionError(f"{tag} {name}: {_form_name(prod)} and P1 "
                                 f"differ on {diff.numel()} lanes")
        turns = [_median_ms(lambda f=f: fn(wt, *srt, _form=f))
                 for f in (one, None, None, one)]
        out[name] = {"form": _form_name(prod), "lanes_differ": diff.numel(),
                     "turns_ms": turns, "ms": (turns[1] + turns[2]) / 2,
                     "p1_ms": (turns[0] + turns[3]) / 2}
        phase("forms", f"{tag} {name}: {_form_name(prod)} vs P1 "
              f"{diff.numel()} lanes differ; P1, new, new, P1 "
              + ", ".join(f"{t:.4f}" for t in turns) + " ms; P1 "
              f"{_ptxas(_symbol(name, one))}, {_form_name(prod)} "
              f"{_ptxas(_symbol(name, prod))}")
    return out


def _rays(rng, lo, hi, n, device):
    """Rays from points in the box [lo, hi] in random directions, with
    inert, empty and bounded lanes (tools/perf/common.py:inert_lanes)."""
    import torch
    from rustlight_tpu_torch.tools.perf import common
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tnear = np.full(n, 1e-4, np.float32)
    tfar = np.full(n, np.inf, np.float32)
    common.inert_lanes(rng, tnear, tfar,
                       float(np.linalg.norm(np.subtract(hi, lo))))
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


def render_wavefronts(sd, integ):
    """The wavefronts the dense kernels see in the first two iterations of
    one compute_block of the scene's render at 1 spp: the camera rays and
    the first bounce's rays (closest hit), the first NEE shadow rays
    (integrators/path.py, `visible`: any hit). Returns {name: (kind,
    [o, d, tnear, tfar])}."""
    import torch
    from rustlight_tpu_torch.accel import dense as ad
    from rustlight_tpu_torch.integrators import render
    seen = {"closest": [], "anyhit": []}
    wrapped = {k: getattr(ad, "dense_" + k) for k in seen}

    def spy(kind):
        def call(rows, *rays):
            seen[kind].append([x.clone() for x in rays])
            return wrapped[kind](rows, *rays)
        return call
    try:
        for k in seen:
            setattr(ad, "dense_" + k, spy(k))
        render(sd, integ, spp=1, seed=0)
        torch.cuda.synchronize()
    finally:
        for k, fn in wrapped.items():
            setattr(ad, "dense_" + k, fn)
    return {"camera": ("closest", seen["closest"][0]),
            "bounce": ("closest", seen["closest"][1]),
            "shadow": ("anyhit", seen["anyhit"][0])}


def _device_us(fn, name, launches=20, tries=5):
    """The kernel `name`'s device time a launch, by torch.profiler over
    `launches` calls of `fn`. A profile that recorded no kernel of that name
    is taken again, up to `tries` profiles in all: on an H100 the profiler
    has come back empty now and then, twice in a row once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count
              and name in e.key]
        if ev:
            break
        phase("profile", f"{name}: no device events in profile "
              f"{attempt + 1} of {tries}")
    if len(ev) != 1:
        raise AssertionError(f"profiler: {len(ev)} device kernels match {name}")
    return ev[0].self_device_time_total / ev[0].count


def _host_us(fn, calls=1000):
    """The host's time a call of `fn`: perf_counter around `calls` calls
    without a sync, then one."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def sass_fp32_per_test(kernel):
    """FP32-pipe instructions (FADD, FMUL, FFMA) a ray-triangle test in the
    triangle loop of `kernel` (a name its mangled name holds), counted in
    `cuobjdump -sass` of the built library: the instructions of the
    innermost loop that holds the most |Nd| > 1e-20 compares, over their
    number (the tests the loop body holds). Every path of the test is
    counted once: what a warp issues when its lanes take them all."""
    import re
    from rustlight_tpu_torch.ops import native
    cuobjdump = os.path.join(os.path.dirname(native._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(native.build())],
                          capture_output=True, text=True, check=True).stdout
    body, on = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            on = kernel in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if on and m:
            body.append((int(m.group(1), 16), m.group(2)))
    if not body:
        raise AssertionError(f"sass: no function matches {kernel}")
    loops = []   # (target, branch address) of every backward branch
    for addr, ins in body:
        m = re.search(r"\bBRA\s+0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    best = None
    for lo, hi in loops:
        if any(lo <= a < b <= hi and (a, b) != (lo, hi) for a, b in loops):
            continue   # not innermost
        loop = [i for a, i in body if lo <= a <= hi]
        tests = sum("9.999999682655225389e-21" in i for i in loop)
        fp32 = sum(bool(re.match(r"(@!?U?P\w+\s+)?(FADD|FMUL|FFMA)(32I)?\b",
                                 i)) for i in loop)
        if tests and (best is None or tests > best[0]):
            best = (tests, fp32)
    if best is None:
        raise AssertionError(f"sass: no triangle loop in {kernel}")
    return best[1] / best[0]


def check_dense(sets, clock_hz):
    """Phase 2: each dense kernel against its plain version on every set,
    bit for bit (t, idx, u, v and occlusion torch.equal, 0 lanes differ);
    no inert lane hits. On the sets with `timed`, the wrapper's and the
    plain version's ms (medians of TIMING_RUNS, events), the kernel's
    device us a launch (torch.profiler), the bound and the issue floor
    (tests x sass_fp32_per_test / (132 x 128 x clock_hz)). Returns one
    record per set and kernel."""
    import torch
    from rustlight_tpu_torch.ops import dense_trace as dt
    per_test = {k: sass_fp32_per_test(f"dense_{k}_kernel")
                for k in ("closest", "anyhit")}
    phase("kernels", "FP32-pipe instructions a test (SASS, every path): "
          f"closest {per_test['closest']:.2f}, any hit "
          f"{per_test['anyhit']:.2f}")
    recs = []
    for label, (rows, rays, kinds, timed) in sets.items():
        o, d, tnear, tfar = rays
        for kind in kinds:
            fn = getattr(dt, f"dense_{kind}")
            plain = getattr(dt, f"dense_{kind}_ref")
            got, ref = fn(rows, *rays), plain(rows, *rays)
            torch.cuda.synchronize()
            diff = _lanes_differ(got, ref).numel()
            if diff:
                raise AssertionError(f"{label} {kind}: {diff} lanes differ "
                                     "from the plain version")
            hit = torch.isfinite(got[0]) if kind == "closest" else got
            if bool(torch.any(hit[~(tnear < tfar)])):
                raise AssertionError(f"{label} {kind}: an inert lane hit")
            if not timed:
                continue
            n, n_tris = o.shape[0], rows.shape[0]
            out_bytes = 16 if kind == "closest" else 1
            bound, bound_by = _bound_ms(
                n * n_tris, n * (RAY_IN_BYTES + out_bytes) + rows.numel() * 4)
            rec = {"set": label, "kind": kind, "rays": n, "tris": n_tris,
                   "hits": int(hit.sum()), "lanes_differ": diff,
                   "max_abs_err": 0.0,
                   "ms": _median_ms(lambda: fn(rows, *rays)),
                   "plain_ms": _median_ms(lambda: plain(rows, *rays)),
                   "device_us": _device_us(lambda: fn(rows, *rays),
                                           f"dense_{kind}_kernel"),
                   "host_us": _host_us(lambda: fn(rows, *rays)),
                   "bound_ms": bound, "bound_by": bound_by,
                   "issue_floor_ms": n * n_tris * per_test[kind]
                   / (132 * 128 * clock_hz) * 1e3}
            recs.append(rec)
            phase("kernels", f"{label} {kind}: {n} rays x {n_tris} "
                  f"triangles, {rec['hits']} hit, 0 lanes differ; wrapper "
                  f"{rec['ms']:.4f} ms (host {rec['host_us']:.2f} us a "
                  f"call), device {rec['device_us']:.2f} us, plain "
                  f"{rec['plain_ms']:.4f} ms, bound {bound:.4f} ms "
                  f"({bound_by}), issue floor {rec['issue_floor_ms']:.4f} ms")
    phase("kernels", f"dense kernels = plain versions, bit for bit, on "
          f"{len(sets)} sets ({', '.join(sets)})")
    return recs


def block_mean_l1(img: np.ndarray) -> tuple:
    """bench.py's correctness gate in numpy: l1 of 8x8 block means against
    the committed reference; returns (l1, floor)."""
    ref = np.load(os.path.join(ROOT, "regress", "bench_ref.npz"))
    b = int(ref["block"])
    h, w, c = img.shape
    bm = img.astype(np.float64).reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))
    return float(np.abs(bm - ref["blockmean"]).mean()), float(ref["floor_l1"])


def _profile(fn):
    """torch.profiler over one call of `fn`: (wall s, the device kernels'
    key averages, longest total first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    from torch.autograd import DeviceType
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count > 0]
    kern.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return wall, kern


def _kernel_line(e) -> str:
    return (f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d}x "
            f"{e.self_device_time_total / e.count:8.2f} us  {e.key[:90]}")


def profile_render(label, sd, integ, spp, names, top=12):
    """torch.profiler over one warm render at `spp`; prints the device time
    by kernel (the top ones and those whose name holds one of `names`), the
    number of launches and the device's busy share of the wall time (one
    stream, so kernel times do not overlap). Returns (busy share, share of
    the device time spent in kernels matching `names`)."""
    import torch
    from rustlight_tpu_torch.integrators import render
    render(sd, integ, spp=spp, seed=1)
    torch.cuda.synchronize()
    wall, kern = _profile(lambda: render(sd, integ, spp=spp, seed=1))
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
        phase("profile", _kernel_line(e))
    return busy_us / 1e6 / wall, ours_us / max(busy_us, 1e-9)


def _launch_modules():
    from rustlight_tpu_torch.ops import dense_trace as dt
    from rustlight_tpu_torch.ops import pair_trace as pt
    from rustlight_tpu_torch.ops import walk_hier as wh
    from rustlight_tpu_torch.ops import walk_lab as wl
    from rustlight_tpu_torch.ops import walk_sparse as ws
    from rustlight_tpu_torch.ops import walk_sub as wsub
    from rustlight_tpu_torch.ops import walk_trace as wk
    return dt, wk, wh, wsub, ws, pt, wl


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


def check_walk(label, sd, rng):
    """Walk kernels against their plain versions on the scene's two
    wavefronts, sorted by the walk; returns one record per wavefront, and
    the wavefronts."""
    import torch
    from rustlight_tpu_torch.accel import walk
    from rustlight_tpu_torch.ops import walk_trace as wk
    from rustlight_tpu_torch.tools.perf import common
    wt = sd.geom.walk
    table = (wt.rows.numel() + wt.ids.numel() + wt.lo.numel()
             + wt.hi.numel()) * 4
    out = []
    waves = common.walk_wavefronts(sd, rng)
    one = wk.ONE_THREAD_FORM
    for name, rays in waves.items():
        srt = walk._prepare(wt, *rays)[:4]
        closest_k = wk.walk_closest(wt, *srt)
        closest_p, tile_c = wk._walk_ref(wt, *srt, False)
        occ_k = wk.walk_anyhit(wt, *srt)
        (occ_p,), tile_a = wk._walk_ref(wt, *srt, True)
        closest_1 = wk.walk_closest(wt, *srt, _form=one)
        occ_1 = wk.walk_anyhit(wt, *srt, _form=one)
        torch.cuda.synchronize()
        tag = f"{label}/{name}"
        err_c, err_a, ties = _compare(tag, sd.geom.inter_rows, srt, closest_k,
                                      closest_p, occ_k, occ_p)
        _compare(f"{tag} P1", sd.geom.inter_rows, srt, closest_1, closest_p,
                 occ_1, occ_p)
        forms = _forms_vs_one(tag, (("walk_closest", wk.walk_closest),
                                    ("walk_anyhit", wk.walk_anyhit)),
                              wt, srt, sd.geom.inter_rows)
        n = srt[0].shape[0]
        tiles = n // wk.RAY_TILE
        rec = {"table": label, "wavefront": name, "cp": wt.n_clusters,
               "n_real": wt.n_real, "rays": n, "tie_ids": ties,
               "hits": int(torch.isfinite(closest_k[0]).sum()),
               "occluded": int(occ_k.sum())}
        for kind, visits, err, pfn, any_hit, out_b in (
                ("closest", tile_c, err_c, wk.walk_closest_ref, False, 16),
                ("anyhit", tile_a, err_a, wk.walk_anyhit_ref, True, 1)):
            bound, by = _bound_ms(int(visits.sum()) * wk.RAY_TILE * wk.K,
                                  n * (RAY_IN_BYTES + out_b) + table)
            rec[kind] = {
                "visits_per_tile": int(visits.sum()) / tiles,
                "max_visits": int(visits.max()),
                "p99_visits": float(torch.quantile(visits.double(), 0.99)),
                "max_abs_err": err, **forms[f"walk_{kind}"],
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
                  f"{rec[k]['ms']:.4f} ms ({rec[k]['form']}; P1 "
                  f"{rec[k]['p1_ms']:.4f}), walk+sort {rec[k]['walk_ms']:.4f} "
                  f"ms, plain {rec[k]['plain_ms']:.2f} ms, bound "
                  f"{rec[k]['bound_ms']:.4f} ms ({rec[k]['bound_by']}), err "
                  f"{rec[k]['max_abs_err']:.3g}" for k in ("closest", "anyhit")))
        out.append(rec)
    return out, waves


def _timed(fn):
    """One synchronised run: (result, ms)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.time() - t0) * 1e3


def _sched_line(tag, name, rec):
    phase("sched", f"{tag} {name}: " + "; ".join(
        f"{k}: {rec[k]['note']}, kernel {rec[k]['ms']:.4f} ms"
        + (f" ({rec[k]['form']}; P1 {rec[k]['p1_ms']:.4f})" if "form" in rec[k]
           else "")
        + f" (K3/K5 {rec[k]['base_ms']:.4f}), whole call "
        f"{rec[k]['walk_ms']:.4f} ms, plain {rec[k]['plain_ms']:.1f} ms, "
        f"bound {rec[k]['bound_ms']:.4f} ms ({rec[k]['bound_by']}), err "
        f"{rec[k]['max_abs_err']:.3g}" for k in ("closest", "anyhit")))


def _sub_form_name(form) -> str:
    """A K6 form (threads a ray, staged) as text."""
    p, stage = form
    return f"P{p}" + (" staged" if stage else "")


def _in_turns(fn, one, form) -> dict:
    """fn(_form=...) timed one-thread, production, production, one-thread
    (medians of TIMING_RUNS each)."""
    turns = [_median_ms(lambda f=f: fn(_form=f))
             for f in (one, form, form, one)]
    return {"turns_ms": turns, "ms": (turns[1] + turns[2]) / 2,
            "p1_ms": (turns[0] + turns[3]) / 2}


def _sub_forms_vs_one(tag, wt, srt, sub, got, plain):
    """K6's production form at `sub` (its outputs `got`: closest, any hit)
    against its one-thread form and against the plain version (`plain`:
    closest, occlusion), bit for bit: 0 lanes may differ. The two forms
    timed in turns, with ptxas's lines. Returns {kind: record}."""
    import torch
    from rustlight_tpu_torch.ops import walk_sub as wsub
    from rustlight_tpu_torch.ops.walk_trace import ONE_THREAD_FORM as one
    out = {}
    for kind, fn, new, ref in (
            ("closest", wsub.walk_sub_closest, got[0], plain[0]),
            ("anyhit", wsub.walk_sub_anyhit, got[1], plain[1])):
        name = f"walk_sub_{kind}"
        form = wsub.PRODUCTION_FORMS[name][sub]
        old = fn(wt, *srt, sub, _form=one)
        torch.cuda.synchronize()
        diff = _lanes_differ(new, old).numel()
        diff_p = _lanes_differ(new, ref).numel()
        if diff or diff_p:
            raise AssertionError(f"{tag} {kind}: {_sub_form_name(form)} "
                                 f"differs from P1 on {diff} lanes and from "
                                 f"the plain version on {diff_p}")
        out[kind] = {"form": _sub_form_name(form), "lanes_differ": diff,
                     **_in_turns(lambda **k: fn(wt, *srt, sub, **k), one,
                                 None)}
        phase("forms", f"{tag} {name}: {_sub_form_name(form)} vs P1 and vs "
              "the plain version: 0 lanes differ; P1, new, new, P1 "
              + ", ".join(f"{t:.4f}" for t in out[kind]["turns_ms"])
              + f" ms; P1 {_ptxas(_sub_symbol(name, sub, one, False))}, "
              f"{_sub_form_name(form)} "
              f"{_ptxas(_sub_symbol(name, sub, form, False))}")
    return out


def _split_vs_one(tag, name, fn, got, plain):
    """Kernel `name` (a PRODUCTION_FORMS name of ops/walk_trace.py or
    ops/walk_sparse.py) in its production form, whose outputs `got` came
    from fn(), against fn(_form=ONE_THREAD_FORM) and against the plain
    version's outputs `plain`, bit for bit: 0 lanes may differ. The two
    forms timed in turns, with ptxas's lines. Returns the record."""
    import torch
    from rustlight_tpu_torch.ops import walk_sparse as ws
    from rustlight_tpu_torch.ops import walk_trace as wk
    one = wk.ONE_THREAD_FORM
    form = {**wk.PRODUCTION_FORMS, **ws.PRODUCTION_FORMS}[name]
    old = fn(_form=one)
    torch.cuda.synchronize()
    diff = _lanes_differ(got, old).numel()
    diff_p = _lanes_differ(got, plain).numel()
    if diff or diff_p:
        raise AssertionError(f"{tag} {name}: {_form_name(form)} differs from "
                             f"P1 on {diff} lanes and from the plain version "
                             f"on {diff_p}")
    rec = {"form": _form_name(form), "lanes_differ": 0,
           **_in_turns(fn, one, None)}
    phase("forms", f"{tag} {name}: {_form_name(form)} vs P1 and vs the plain "
          "version: 0 lanes differ; P1, new, new, P1 "
          + ", ".join(f"{t:.4f}" for t in rec["turns_ms"])
          + f" ms (ratio {rec['ms'] / rec['p1_ms']:.3f}); P1 "
          f"{_ptxas(_symbol(name, one))}, {_form_name(form)} "
          f"{_ptxas(_symbol(name, form))}")
    return rec


def _bound_entry_ms(tests, slab_tests, n_bytes):
    """The bound with the entry pass's slab tests counted too (64 a real
    cluster and tile: the entry pass skips the padding): (tests x
    OPS_PER_TEST + slab tests x SLAB_OPS) / PEAK_F32_OPS, or the bytes'
    time if larger."""
    ops_ms = ((tests * OPS_PER_TEST + slab_tests * SLAB_OPS) / PEAK_F32_OPS
              * 1e3)
    return max(ops_ms, n_bytes / PEAK_BYTES_S * 1e3)


_LAB = {"records": []}


def start_lab_build():
    """Phase 1: nvcc builds the RL_LAB_FORMS library of K7's and K3w's
    candidate and laboratory forms (tools/perf/split_forms.py) in a thread
    beside the production library; phase 1 waits for the build, and
    lab_library() loads it where phase 13 first needs it. A CUDA library
    loaded while phase 2 profiled cost the profiles their events, so none is
    loaded before them."""
    import threading
    from rustlight_tpu_torch.tools.perf import split_forms
    t0 = time.time()

    def build():
        try:
            _LAB["path"] = split_forms.build_lab()
            _LAB["seconds"] = time.time() - t0
        except Exception as e:  # raised again where it is needed
            _LAB["error"] = e

    _LAB["thread"] = threading.Thread(target=build)
    _LAB["thread"].start()


def wait_lab_build():
    """Waits for start_lab_build's nvcc, raising its error."""
    _LAB["thread"].join()
    if "error" in _LAB:
        raise _LAB["error"]


def lab_library():
    """(library, ptxas usage) of start_lab_build, loaded at the first
    call."""
    from rustlight_tpu_torch.tools.perf import split_forms
    wait_lab_build()
    if "lib" not in _LAB:
        _LAB["lib"] = split_forms.lab_library(_LAB["path"])
    return _LAB["lib"]


def check_sparse_planted(dev):
    """Phase 13: K7 on the planted tiles whose visits flag exactly 16 rays
    (a sparse visit) and 17 (a dense one) (ops/walk_sparse.py:
    planted_tiles, 1,024 tiles): both forms of both tests against the
    plain version, bit for bit."""
    import torch
    from rustlight_tpu_torch.ops import walk_sparse as ws
    from rustlight_tpu_torch.ops import walk_trace as wk
    wt, rays = ws.planted_tiles(dev, tiles=1024)
    tiles = [x.view(-1, wk.RAY_TILE, *x.shape[1:]) for x in rays]
    _, flags = wk._tile_entries(wt.lo, wt.hi, wt.n_real, *tiles,
                                with_rays=True)
    counts = flags.sum(dim=1)
    if not bool((counts[:, 0] == 16).all() and (counts[:, 1] == 17).all()):
        raise AssertionError("planted tiles: the visits do not flag 16 and "
                             "17 rays")
    closest = ws.walk_sparse_closest_ref(wt, *rays)
    occ = ws.walk_sparse_anyhit_ref(wt, *rays)[0]
    for form in (wk.ONE_THREAD_FORM, None):
        got = (ws.walk_sparse_closest(wt, *rays, _form=form),
               ws.walk_sparse_anyhit(wt, *rays, _form=form))
        torch.cuda.synchronize()
        diff = (_lanes_differ(got[0], closest[:4]).numel(),
                _lanes_differ(got[1], occ).numel())
        if any(diff):
            raise AssertionError(f"planted tiles, K7 form {form}: {diff} "
                                 "lanes differ")
    phase("sched", f"planted tiles for K7 ({rays[0].shape[0]} rays; every "
          "tile flags 16 rays for one cluster and 17 for another): "
          f"{closest[4]} visits, {closest[5]} sparse, "
          f"{int((closest[1] >= 0).sum())} hits; both forms of both tests = "
          "the plain version bit for bit")


def check_sub_planted(dev):
    """Phase 13: K6's per-group barriers on the planted tiles whose groups
    stop far apart (ops/walk_sub.py:planted_tiles, 1,024 tiles): at each
    sub, the groups of each tile's first 32 rays stop after one pair of
    visits and the others visit every cluster (the plain walk's counts),
    and both forms of both tests give the plain version's results (the
    tensor-core forms each other's), bit for bit."""
    import torch
    from rustlight_tpu_torch.ops import walk_sub as wsub
    from rustlight_tpu_torch.ops import walk_trace as wk
    one = wk.ONE_THREAD_FORM
    wt, rays = wsub.planted_tiles(dev, tiles=1024)
    for sub in wsub.SUBS:
        closest, visits = wk._walk_ref(wt, *rays, False,
                                       tile=wk.RAY_TILE // sub)
        per = visits.view(-1, sub)
        if not (bool((per[:, :sub // 2] == 2).all()) and bool(
                (per[:, sub // 2:] >= wsub.PLANTED_CLUSTERS).all())):
            raise AssertionError(f"planted tiles, sub {sub}: the groups do "
                                 "not stop as planted")
        occ = wsub.walk_sub_anyhit_ref(wt, *rays, sub)[0]
        mma = []
        for form in (one, None):
            got = (wsub.walk_sub_closest(wt, *rays, sub, _form=form),
                   wsub.walk_sub_anyhit(wt, *rays, sub, _form=form))
            mma.append((wsub.walk_sub_closest(wt, *rays, sub, True,
                                              _form=form),
                        wsub.walk_sub_anyhit(wt, *rays, sub, True,
                                             _form=form)))
            torch.cuda.synchronize()
            diff = (_lanes_differ(got[0], closest).numel(),
                    _lanes_differ(got[1], occ).numel())
            if any(diff):
                raise AssertionError(f"planted tiles, sub {sub}, form "
                                     f"{form}: {diff} lanes differ")
        diff = (_lanes_differ(mma[0][0], mma[1][0]).numel(),
                _lanes_differ(mma[0][1], mma[1][1]).numel())
        if any(diff):
            raise AssertionError(f"planted tiles, sub {sub}: the tensor-core "
                                 f"forms differ on {diff} lanes")
    phase("sched", f"planted tiles ({rays[0].shape[0]} rays; half of each "
          "tile's groups stop after one pair of visits, the others visit "
          f"all {wsub.PLANTED_CLUSTERS} clusters): K6 at sub "
          f"{'/'.join(map(str, wsub.SUBS))}, both forms = the plain version "
          "bit for bit; the tensor-core forms equal")


def check_schedules(label, sd, waves):
    """Phase 13 on a resident table: K6 (sub 2, 4, 8), K7, the wide pop (both
    heaps) and K8 (km 8, 2) against their plain versions and against K3's
    result on the scene's two wavefronts. Returns {schedule: [a record per
    wavefront]}."""
    import torch
    from rustlight_tpu_torch.accel import pair_walk as pw
    from rustlight_tpu_torch.accel import walk
    from rustlight_tpu_torch.ops import pair_trace as pt
    from rustlight_tpu_torch.ops import walk_sparse as ws
    from rustlight_tpu_torch.ops import walk_sub as wsub
    from rustlight_tpu_torch.ops import walk_trace as wk
    wt = sd.geom.walk
    rows = sd.geom.inter_rows
    table = (wt.rows.numel() + wt.ids.numel() + wt.lo.numel()
             + wt.hi.numel()) * 4
    R, K = wk.RAY_TILE, wk.K
    # schedule -> (closest kernel, any-hit kernel, plain(any_hit) -> (outs,
    # tests, note), _walk_impl options)
    def tile_sched(closest, anyhit, ref, tests_note, **opt):
        return closest, anyhit, ref, tests_note, opt

    def plain_counts(any_hit, srt, **kw):
        outs, *counts = wk._walk_ref(wt, *srt, any_hit, **kw)
        return outs, [int(c.sum()) for c in counts]

    scheds = {}
    for sub in wsub.SUBS:
        scheds[f"sub{sub}"] = tile_sched(
            lambda *a, s=sub: wsub.walk_sub_closest(*a, s),
            lambda *a, s=sub: wsub.walk_sub_anyhit(*a, s),
            lambda any_hit, srt, s=sub: plain_counts(any_hit, srt,
                                                     tile=R // s),
            lambda c, tiles, s=sub: (
                c[0] * (R // s) * K,
                f"{c[0] / tiles:.2f} group visits/tile of {R // s} rays"),
            sub=sub)
    scheds["sparse"] = tile_sched(
        ws.walk_sparse_closest, ws.walk_sparse_anyhit,
        lambda any_hit, srt: plain_counts(any_hit, srt,
                                          sparse_cap=ws.SPARSE_CAP),
        lambda c, tiles: (
            c[2] * K,
            f"{c[0] / tiles:.2f} visits/tile, {100 * c[1] / max(c[0], 1):.1f}%"
            f" sparse, {c[3] / max(c[0], 1):.2f} rays flagged and "
            f"{c[2] / max(c[0], 1):.2f} tested a visit"),
        sparse=True)
    for heap in ("shared", "global"):
        scheds[f"wide/{heap}"] = tile_sched(
            lambda *a, h=heap, **k: wk.walk_closest(*a, wide=True, heap=h,
                                                    **k),
            lambda *a, h=heap, **k: wk.walk_anyhit(*a, wide=True, heap=h,
                                                   **k),
            lambda any_hit, srt: plain_counts(any_hit, srt, wide=True),
            lambda c, tiles: (c[0] * R * K, f"{c[0] / tiles:.2f} visits/tile"),
            wide=True)
    out = {name: [] for name in scheds}
    for km in PAIR_KMS:
        out[f"pair{km}"] = []
    for wname, rays in waves.items():
        tag = f"{label}/{wname}"
        srt = walk._prepare(wt, *rays)[:4]
        n = srt[0].shape[0]
        tiles = n // R
        k3 = (wk.walk_closest(wt, *srt), wk.walk_anyhit(wt, *srt))
        base_ms = {"closest": _median_ms(lambda: wk.walk_closest(wt, *srt)),
                   "anyhit": _median_ms(lambda: wk.walk_anyhit(wt, *srt))}
        base_walk = {a: _median_ms(lambda a=a: walk._walk_impl(wt, *rays, a))
                     for a in (False, True)}
        phase("sched", f"{tag}: K3 kernel {base_ms['closest']:.4f} / "
              f"{base_ms['anyhit']:.4f} ms, _walk_impl {base_walk[False]:.4f}"
              f" / {base_walk[True]:.4f} ms")
        for name, (closest, anyhit, ref, tests_note, opt) in scheds.items():
            got = (closest(wt, *srt), anyhit(wt, *srt))
            (pc, cc), pms_c = _timed(lambda: ref(False, srt))
            (pa, ca), pms_a = _timed(lambda: ref(True, srt))
            err_c, err_a, ties = _compare(f"{tag} {name}", rows, srt, got[0],
                                          pc, got[1], pa[0])
            _compare(f"{tag} {name} vs K3", rows, srt, got[0], k3[0], got[1],
                     k3[1])
            rec = {"table": label, "wavefront": wname, "schedule": name,
                   "cp": wt.n_clusters, "rays": n, "tie_ids": ties}
            if "sub" in opt:
                forms = _sub_forms_vs_one(f"{tag} {name}", wt, srt,
                                          opt["sub"], got, (pc, pa[0]))
            elif name == "sparse" or name.startswith("wide"):
                forms = {kind: _split_vs_one(
                    f"{tag} {name}",
                    ("walk_sparse_" if name == "sparse" else "walk_")
                    + kind + ("_wide" if name != "sparse" else ""),
                    lambda f=f, **k: f(wt, *srt, **k), g, ref_)
                    for kind, f, g, ref_ in (("closest", closest, got[0], pc),
                                             ("anyhit", anyhit, got[1],
                                              pa[0]))}
            for kind, counts, err, fn, any_hit, out_b, pms in (
                    ("closest", cc, err_c, closest, False, 16, pms_c),
                    ("anyhit", ca, err_a, anyhit, True, 1, pms_a)):
                tests, note = tests_note(counts, tiles)
                in_bytes = n * (RAY_IN_BYTES + out_b) + table
                bound, by = _bound_ms(tests, in_bytes)
                rec[kind] = {
                    "note": note, "tests": tests, "max_abs_err": err,
                    "base_ms": base_ms[kind],
                    "walk_ms": _median_ms(lambda a=any_hit: walk._walk_impl(
                        wt, *rays, a, **opt)),
                    "base_walk_ms": base_walk[any_hit],
                    "plain_ms": pms, "bound_ms": bound, "bound_by": by,
                    "bound_entry_ms": _bound_entry_ms(
                        tests, tiles * wt.n_real * R, in_bytes)}
                if "sub" in opt or name == "sparse" or name.startswith("wide"):
                    rec[kind].update(forms[kind])
                else:
                    rec[kind]["ms"] = _median_ms(lambda f=fn: f(wt, *srt))
            _sched_line(tag, name, rec)
            out[name].append(rec)
            if name == "sparse":
                # K7's candidate forms (tools/perf/split_forms.py)
                from rustlight_tpu_torch.tools.perf import split_forms
                _LAB["records"] += split_forms.sparse_forms(
                    *lab_library(), wt, srt, TIMING_RUNS, tag)
        # K8: the pairs of the morton-sorted wavefront, then the whole walk
        msrt = walk._prepare(wt, *rays, inc_sort=False)[:4]
        lane_k3 = (walk._walk_impl(wt, *rays, False)[:4],
                   walk._walk_impl(wt, *rays, True))
        for km in PAIR_KMS:
            pairs, cutoff = pw._make_pairs(wt, *msrt, km)
            m = pairs[0].shape[0]
            got = (pt.pair_closest(wt, *pairs), pt.pair_anyhit(wt, *pairs))
            (pc, pms_c) = _timed(lambda: pt.pair_closest_ref(wt, *pairs))
            (pa, pms_a) = _timed(lambda: pt.pair_anyhit_ref(wt, *pairs))
            err_c, err_a, ties = _compare(f"{tag} pair{km}", rows, pairs[:4],
                                          got[0], pc[:4], got[1], pa[0])
            whole = (pw._pairs_impl(wt, *rays, False, km)[:4],
                     pw._pairs_impl(wt, *rays, True, km))
            _compare(f"{tag} pair{km} vs K3", rows, rays, whole[0],
                     lane_k3[0], whole[1], lane_k3[1])
            live = pc[4]
            over = float(torch.isfinite(cutoff).float().mean())
            rec = {"table": label, "wavefront": wname,
                   "schedule": f"pair{km}", "cp": wt.n_clusters, "rays": n,
                   "tie_ids": ties}
            for kind, err, fn, any_hit, out_b, pms in (
                    ("closest", err_c, pt.pair_closest, False, 16, pms_c),
                    ("anyhit", err_a, pt.pair_anyhit, True, 1, pms_a)):
                bound, by = _bound_ms(live * K,
                                      m * (PAIR_IN_BYTES + out_b) + table)
                rec[kind] = {
                    "note": f"{live} live of {m} pairs, {100 * over:.1f}% of "
                            "rays overflow",
                    "tests": live * K, "max_abs_err": err,
                    "ms": _median_ms(lambda f=fn: f(wt, *pairs)),
                    "base_ms": base_ms[kind],
                    "walk_ms": _median_ms(lambda a=any_hit: pw._pairs_impl(
                        wt, *rays, a, km)),
                    "base_walk_ms": base_walk[any_hit],
                    "plain_ms": pms, "bound_ms": bound, "bound_by": by}
            _sched_line(tag, f"pair km={km}", rec)
            out[f"pair{km}"].append(rec)
    return out


# the blocks a wide launch starts in _wide_many_tiles: fewer than the tiles
# of a wavefront, and no divisor of 1,024, so that blocks walk 3 or 4 tiles
WIDE_FEW_BLOCKS = 257


def _wide_many_tiles(tag, wt, srt, plain_c, plain_a):
    """K3w with fewer blocks than tiles (ops/walk_trace.py:_WIDE_BLOCKS set
    to WIDE_FEW_BLOCKS for these launches), so that each block walks several
    tiles and carries its feed's copies and mbarrier phases from one tile to
    the next: with each heap and both tests, the production form against the
    one-thread form bit for bit, with the _dot4 test also against the plain
    version, with the tensor-core test against the one-thread tensor-core
    kernel."""
    import torch
    from rustlight_tpu_torch.ops import walk_trace as wk
    tiles = srt[0].shape[0] // wk.RAY_TILE
    if tiles <= WIDE_FEW_BLOCKS:
        raise AssertionError(f"{tag}: {tiles} tiles, no more than "
                             f"{WIDE_FEW_BLOCKS} blocks")
    keep, wk._WIDE_BLOCKS = wk._WIDE_BLOCKS, WIDE_FEW_BLOCKS
    try:
        for heap in ("shared", "global"):
            for mxu in (False, True):
                got = {f: (wk.walk_closest(wt, *srt, wide=True, heap=heap,
                                           mxu=mxu, _form=f),
                           wk.walk_anyhit(wt, *srt, wide=True, heap=heap,
                                          mxu=mxu, _form=f))
                       for f in (wk.ONE_THREAD_FORM, None)}
                torch.cuda.synchronize()
                refs = [got[wk.ONE_THREAD_FORM]] + (
                    [] if mxu else [(plain_c, plain_a)])
                diff = [_lanes_differ(got[None][k], ref[k]).numel()
                        for ref in refs for k in (0, 1)]
                if any(diff):
                    raise AssertionError(
                        f"{tag} wide/{heap}{' mma' if mxu else ''} with "
                        f"{WIDE_FEW_BLOCKS} blocks: lanes differ (closest, "
                        f"any) from P1{'' if mxu else ' and plain'}: {diff}")
    finally:
        wk._WIDE_BLOCKS = keep
    phase("forms", f"{tag} wide, {WIDE_FEW_BLOCKS} blocks for {tiles} tiles:"
          " production vs P1 (and _dot4 vs the plain version), each heap, "
          "both tests, _dot4 and tensor-core: 0 lanes differ")


def check_wide(label, sd, waves):
    """Phase 13 on a table past 2^14 clusters: the wide pop with both heaps
    against its plain version on every tile of the AO integrator's two
    wavefronts, and against K5's result; beside K5's times. The production
    form with each heap against its one-thread form and the plain version,
    bit for bit, and timed in turns with it; the split tensor-core forms
    against the one-thread ones with each heap, bit for bit; the same with
    fewer blocks than tiles (_wide_many_tiles); then the candidate and
    laboratory forms (tools/perf/split_forms.py). Returns a
    record per heap and wavefront, and the laboratory's records."""
    import torch
    from rustlight_tpu_torch.accel import walk
    from rustlight_tpu_torch.ops import walk_hier as wh
    from rustlight_tpu_torch.ops import walk_trace as wk
    from rustlight_tpu_torch.tools.perf import split_forms
    wt = sd.geom.walk
    rows = sd.geom.inter_rows
    R, K = wk.RAY_TILE, wk.K
    one = wk.ONE_THREAD_FORM
    out, lab = [], []
    for wname, rays in waves.items():
        tag = f"{label}/{wname}"
        srt = walk._prepare(wt, *rays)[:4]
        n = srt[0].shape[0]
        tiles = n // R
        k5 = (wh.walk_hier_closest(wt, *srt), wh.walk_hier_anyhit(wt, *srt))
        base_ms = {"closest": _median_ms(lambda: wh.walk_hier_closest(wt, *srt)),
                   "anyhit": _median_ms(lambda: wh.walk_hier_anyhit(wt, *srt))}
        ((pc, vc), pms_c) = _timed(lambda: wk._walk_ref(wt, *srt, False, True))
        (((pa,), va), pms_a) = _timed(lambda: wk._walk_ref(wt, *srt, True, True))
        for heap in ("shared", "global"):
            closest = lambda *a, h=heap, **k: wk.walk_closest(
                *a, wide=True, heap=h, **k)
            anyhit = lambda *a, h=heap, **k: wk.walk_anyhit(
                *a, wide=True, heap=h, **k)
            got = (closest(wt, *srt), anyhit(wt, *srt))
            err_c, err_a, ties = _compare(f"{tag} wide/{heap}", rows, srt,
                                          got[0], pc, got[1], pa)
            _compare(f"{tag} wide/{heap} vs K5", rows, srt, got[0], k5[0],
                     got[1], k5[1])
            forms = {kind: _split_vs_one(f"{tag} wide/{heap}",
                                         f"walk_{kind}_wide",
                                         lambda f=f, **k: f(wt, *srt, **k),
                                         g, ref)
                     for kind, f, g, ref in (("closest", closest, got[0], pc),
                                             ("anyhit", anyhit, got[1], pa))}
            mma = [(closest(wt, *srt, mxu=True, _form=f),
                    anyhit(wt, *srt, mxu=True, _form=f)) for f in (one, None)]
            torch.cuda.synchronize()
            diff = (_lanes_differ(mma[0][0], mma[1][0]).numel(),
                    _lanes_differ(mma[0][1], mma[1][1]).numel())
            if any(diff):
                raise AssertionError(f"{tag} wide/{heap}: the split "
                                     f"tensor-core forms differ from P1 on "
                                     f"{diff} lanes")
            phase("forms", f"{tag} wide/{heap} mma: split vs P1: 0 lanes "
                  "differ")
            rec = {"table": label, "wavefront": wname,
                   "schedule": f"wide/{heap}", "cp": wt.n_clusters, "rays": n,
                   "tie_ids": ties}
            for kind, visits, err, fn, any_hit, out_b, pms in (
                    ("closest", vc, err_c, closest, False, 16, pms_c),
                    ("anyhit", va, err_a, anyhit, True, 1, pms_a)):
                nv = int(visits.sum())
                in_bytes = nv * HIER_VISIT_BYTES + n * (RAY_IN_BYTES + out_b)
                bound, by = _bound_ms(nv * R * K, in_bytes)
                rec[kind] = {
                    "note": "visits/tile %.2f, p99 %.0f, max %d"
                            % _spread(visits),
                    "tests": nv * R * K, "max_abs_err": err,
                    "base_ms": base_ms[kind],
                    "walk_ms": _median_ms(lambda a=any_hit: walk._walk_impl(
                        wt, *rays, a, hier=False)),
                    "plain_ms": pms, "bound_ms": bound, "bound_by": by,
                    "bound_entry_ms": _bound_entry_ms(
                        nv * R * K, tiles * wt.n_real * R, in_bytes),
                    **forms[kind]}
            _sched_line(tag, f"wide/{heap}", rec)
            out.append(rec)
        _wide_many_tiles(tag, wt, srt, pc, pa)
        lab += split_forms.wide_forms(*lab_library(), wt, srt, TIMING_RUNS,
                                      tag, visits={False: vc, True: va})
    return out, lab


def _case(rec, kind):
    """A schedule record's entry in a kernel's `cases` (kept short: the
    whole record is in the phase's own line)."""
    return {"table": rec["table"], "wavefront": rec["wavefront"],
            "schedule": rec["schedule"],
            **{k: rec[kind][k] for k in ("form", "ms", "p1_ms", "bound_ms",
                                         "bound_entry_ms", "max_abs_err")
               if k in rec[kind]}}


def _images_agree(label, img, ref, pix_frac, pix_rtol, mean_rtol):
    """At least pix_frac of the pixels within pix_rtol (0: equal) of ref, the
    means within mean_rtol (both relative)."""
    rel = np.abs(img - ref) / np.maximum(np.abs(ref), 1e-4)
    frac = float((rel.max(-1) <= pix_rtol).mean())
    mean_rel = abs(float(img.mean()) - float(ref.mean())) / float(ref.mean())
    phase("main", f"{label}: {100 * frac:.3f}% of pixels within {pix_rtol} of"
          f" the default schedule's, means differ by {mean_rel:.3g}")
    if frac < pix_frac or mean_rel > mean_rtol:
        raise AssertionError(f"{label}: image differs from the default's")


def _only(label, launches, kernels):
    """Fails unless exactly `kernels` launched."""
    if min(launches[k] for k in kernels) <= 0 or any(
            v for k, v in launches.items() if k not in kernels):
        raise AssertionError(f"{label}: launches {launches}")


def schedule_renders(label, gsd, integ, ref_img, ref_rays, ref_wall):
    """Phases 14 and 19: the grid render once per schedule and tensor-core
    schedule, against the default schedule's image of the same seed
    (ref_rays rays in ref_wall s; a pair render counts its re-traced rays
    twice, so every rate here is over ref_rays). Returns the launches
    summed."""
    from rustlight_tpu_torch.accel.walk import WalkOptions
    from rustlight_tpu_torch.scene.scene import from_numpy_scene
    total = {}
    for name, options, kernels in (
            ("sub=2", WalkOptions(sub=2),
             ("walk_sub_closest", "walk_sub_anyhit")),
            ("sparse", WalkOptions(sparse=True),
             ("walk_sparse_closest", "walk_sparse_anyhit")),
            ("pair", WalkOptions(pair=True),
             ("pair_closest", "pair_anyhit", "walk_closest", "walk_anyhit")),
            ("mxu_tritest", WalkOptions(mxu_tritest=True),
             ("walk_closest_mma", "walk_anyhit_mma")),
            ("sub=2 mxu_tritest", WalkOptions(sub=2, mxu_tritest=True),
             ("walk_sub_closest_mma", "walk_sub_anyhit_mma")),
            ("pair mxu_tritest", WalkOptions(pair=True, mxu_tritest=True),
             ("pair_closest_mma", "pair_anyhit_mma", "walk_closest_mma",
              "walk_anyhit_mma"))):
        sd = from_numpy_scene(gsd.host, gsd.device, walk_options=options)
        tag = f"{label} {name}"
        img, wall, warm, n_rays, launches = timed_render(tag, sd, integ,
                                                         GRID_SPP)
        _only(tag, launches, kernels)
        phase("main", f"{tag}: warm-up {warm:.3f}s, timed {wall:.3f}s "
              f"(default schedule {ref_wall:.3f}s), {n_rays} rays counted, "
              f"{ref_rays / wall / 1e6:.3f} Mrays/s (default "
              f"{ref_rays / ref_wall / 1e6:.3f}), mean {img.mean():.6f}, "
              f"launches { {k: v for k, v in launches.items() if v} }")
        _images_agree(tag, img, ref_img, SCHED_PIX_FRAC, SCHED_PIX_RTOL,
                      SCHED_MEAN_RTOL)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        profile_render(tag, sd, integ, 2, ("walk_", "pair_"))
    # the default schedule once more: host time drifts within a run
    _, wall, _, _, _ = timed_render(label, gsd, integ, GRID_SPP)
    phase("main", f"{label} default schedule again: timed {wall:.3f}s, "
          f"{ref_rays / wall / 1e6:.3f} Mrays/s (phase 6: {ref_wall:.3f}s)")
    return total


def ao_option_render(label, sd, options, kernels, ref_img, ref_wall,
                     profile=True):
    """Phases 15, 16 and 19: the AO render of phase 10 with other walk
    options, its image held to phase 10's. Returns the launches."""
    from rustlight_tpu_torch.integrators import IntegratorAO
    from rustlight_tpu_torch.scene.scene import from_numpy_scene
    osd = from_numpy_scene(sd.host, sd.device, walk_options=options)
    img, wall, warm, n_rays, launches = timed_render(
        label, osd, IntegratorAO(max_distance=AO_DIST), AO_SPP, seed=1)
    expect = 2 * AO_RES * AO_RES * AO_SPP
    if n_rays != expect:
        raise AssertionError(f"{label}: {n_rays} rays traced, {expect} "
                             "expected")
    _only(label, launches, kernels)
    phase("main", f"{label}: warm-up {warm:.3f}s, timed (seed 1) {wall:.3f}s "
          f"(default {ref_wall:.3f}s), {n_rays} rays, "
          f"{n_rays / wall / 1e6:.3f} Mrays/s (default "
          f"{n_rays / ref_wall / 1e6:.3f}), mean_ao {img.mean():.5f}, "
          f"launches { {k: v for k, v in launches.items() if v} }")
    _images_agree(label, img, ref_img, AO_ORACLE_PIX_FRAC, 0.0,
                  AO_ORACLE_MEAN_RTOL)
    if profile:
        profile_render(label, osd, IntegratorAO(max_distance=AO_DIST), 1,
                       ("walk_",))
    return launches


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
    HIER_SAMPLE-th tile; the production and one-thread forms are held to
    each other and timed in turns (_forms_vs_one); on a row at most
    FLAT_MAX_CLUSTERS clusters the one-level walk too (check_flat_ao).
    Returns (one record per wavefront, the one-level walk's records)."""
    import torch
    from rustlight_tpu_torch.accel import walk
    from rustlight_tpu_torch.ops import walk_hier as wh
    from rustlight_tpu_torch.ops.walk_trace import ONE_THREAD_FORM, RAY_TILE
    wt = sd.geom.walk
    out, flat = [], []
    for name, rays in ao_wavefronts(sd).items():
        srt = walk._prepare(wt, *rays)[:4]
        n = srt[0].shape[0]
        tiles = n // RAY_TILE
        closest_k = wh.walk_hier_closest(wt, *srt)
        occ_k = wh.walk_hier_anyhit(wt, *srt)
        closest_1 = wh.walk_hier_closest(wt, *srt, _form=ONE_THREAD_FORM)
        occ_1 = wh.walk_hier_anyhit(wt, *srt, _form=ONE_THREAD_FORM)
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
        _compare(f"{tag} P1", sd.geom.inter_rows, srt, closest_1, closest_p,
                 occ_1, occ_p)
        forms = _forms_vs_one(tag, (("walk_hier_closest",
                                     wh.walk_hier_closest),
                                    ("walk_hier_anyhit", wh.walk_hier_anyhit)),
                              wt, srt, sd.geom.inter_rows)
        lanes = (torch.arange(0, tiles, HIER_SAMPLE, device=srt[0].device)
                 [:, None] * RAY_TILE
                 + torch.arange(RAY_TILE, device=srt[0].device)).reshape(-1)
        sub = [x[lanes].contiguous() for x in srt]
        if wt.n_clusters <= walk.FLAT_MAX_CLUSTERS:
            flat.append(check_flat_ao(label, name, sd, srt))
        rec = {"table": label, "wavefront": name, "cp": wt.n_clusters,
               "n_real": wt.n_real, "n_sup": wt.n_sup, "rays": n,
               "tie_ids": ties,
               "hits": int(torch.isfinite(closest_k[0]).sum()),
               "occluded": int(occ_k.sum())}
        for kind, opened, visits, err, pfn, any_hit, out_b in (
                ("closest", opened_c, visits_c, err_c,
                 wh.walk_hier_closest_ref, False, 16),
                ("anyhit", opened_a, visits_a, err_a,
                 wh.walk_hier_anyhit_ref, True, 1)):
            nv = int(visits.sum())
            bound, by = _bound_ms(nv * RAY_TILE * wh.K,
                                  nv * HIER_VISIT_BYTES
                                  + n * (RAY_IN_BYTES + out_b))
            rec[kind] = {
                "supers_per_tile": _spread(opened),
                "visits_per_tile": _spread(visits),
                "max_abs_err": err, **forms[f"walk_hier_{kind}"],
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
                  f"kernel {rec[k]['ms']:.4f} ms ({rec[k]['form']}; P1 "
                  f"{rec[k]['p1_ms']:.4f}), walk+sort "
                  f"{rec[k]['walk_ms']:.4f} ms, plain {rec[k]['plain_ms']:.2f}"
                  f" ms (every tile), {rec[k]['plain_sample_ms']:.2f} ms "
                  f"({rec[k]['plain_tiles']} tiles), bound "
                  f"{rec[k]['bound_ms']:.4f} ms ({rec[k]['bound_by']}), err "
                  f"{rec[k]['max_abs_err']:.3g}" for k in ("closest", "anyhit")))
        out.append(rec)
    return out, flat


def check_flat_ao(label, name, sd, srt):
    """Phase 9 on a row at most FLAT_MAX_CLUSTERS clusters: the one-level
    walk (K4, the row's render route) on the sorted AO wavefront `srt`:
    both forms against the plain walk on every tile, and against each other
    and timed as _forms_vs_one does; the bound from the plain walk's visit
    count. Returns a record as check_walk's."""
    import torch
    from rustlight_tpu_torch.ops import walk_trace as wk
    wt = sd.geom.walk
    rows = sd.geom.inter_rows
    tag = f"{label}/{name} K4"
    one = wk.ONE_THREAD_FORM
    closest_k, occ_k = wk.walk_closest(wt, *srt), wk.walk_anyhit(wt, *srt)
    closest_1 = wk.walk_closest(wt, *srt, _form=one)
    occ_1 = wk.walk_anyhit(wt, *srt, _form=one)
    torch.cuda.synchronize()
    plain_ms = {}
    t0 = time.time()
    closest_p, tile_c = wk._walk_ref(wt, *srt, False)
    torch.cuda.synchronize()
    plain_ms["closest"] = (time.time() - t0) * 1e3
    t0 = time.time()
    (occ_p,), tile_a = wk._walk_ref(wt, *srt, True)
    torch.cuda.synchronize()
    plain_ms["anyhit"] = (time.time() - t0) * 1e3
    err_c, err_a, ties = _compare(tag, rows, srt, closest_k, closest_p,
                                  occ_k, occ_p)
    _compare(f"{tag} P1", rows, srt, closest_1, closest_p, occ_1, occ_p)
    forms = _forms_vs_one(tag, (("walk_closest", wk.walk_closest),
                                ("walk_anyhit", wk.walk_anyhit)),
                          wt, srt, rows)
    n = srt[0].shape[0]
    table = (wt.rows.numel() + wt.ids.numel() + wt.lo.numel()
             + wt.hi.numel()) * 4
    rec = {"table": label, "wavefront": name, "cp": wt.n_clusters,
           "n_real": wt.n_real, "rays": n, "tie_ids": ties}
    for kind, visits, err, out_b in (("closest", tile_c, err_c, 16),
                                     ("anyhit", tile_a, err_a, 1)):
        bound, by = _bound_ms(int(visits.sum()) * wk.RAY_TILE * wk.K,
                              n * (RAY_IN_BYTES + out_b) + table)
        rec[kind] = {"visits_per_tile": _spread(visits), "max_abs_err": err,
                     **forms[f"walk_{kind}"], "plain_ms": plain_ms[kind],
                     "bound_ms": bound, "bound_by": by}
    phase("walk-flat", f"{tag}: Cp {wt.n_clusters}, {n} rays; plain walk on "
          f"every tile = both forms ({ties} tie ids); " + "; ".join(
              f"{k}: visits/tile {'%.2f, p99 %.0f, max %d' % rec[k]['visits_per_tile']}"
              f", kernel {rec[k]['ms']:.4f} ms ({rec[k]['form']}; "
              f"P1 {rec[k]['p1_ms']:.4f}), plain {rec[k]['plain_ms']:.2f} ms"
              f", bound {rec[k]['bound_ms']:.4f} ms ({rec[k]['bound_by']})"
              for k in ("closest", "anyhit")))
    return rec


# ------------------------------------------------------- phases 17 and 18

def _tie_mask(rows, o, d, tnear, tfar, lanes):
    """Per lane of `lanes`: whether its two nearest valid t lie within
    TIE_RTOL of each other (the plain version's arithmetic)."""
    import torch
    from rustlight_tpu_torch.ops.dense_trace import _chunk_test
    step = max(1, min(64, (1 << 26) // rows.shape[0]))
    out = []
    for s in range(0, lanes.numel(), step):
        k = lanes[s:s + step]
        t, _, _, valid = _chunk_test(rows, o[k], d[k], tnear[k], tfar[k])
        t2 = torch.topk(torch.where(valid, t, float("inf")), 2, dim=1,
                        largest=False).values
        out.append(t2[:, 1] - t2[:, 0] <= TIE_RTOL * t2[:, 0].abs())
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool,
                                                  device=lanes.device)


def _graze_mask(rows, o, d, tnear, tfar, lanes):
    """Per lane of `lanes`: whether an operand error of MXU_OPERAND_EPS of
    the summed magnitudes can change what the lane hits. Over every triangle
    (the plain version's arithmetic), with bt, bu, bv the error that operand
    error makes of t, u, v: some triangle passes the test widened by those
    errors while one of its conditions (u, v, u + v, tnear, tfar) lies
    within its error of its limit, or the two nearest such t lie within
    their errors of each other."""
    import torch
    from rustlight_tpu_torch.ops.dense_trace import _chunk_test
    step = max(1, min(64, (1 << 24) // rows.shape[0]))
    eps, inf = MXU_OPERAND_EPS, float("inf")
    rt = rows.permute(1, 2, 0).contiguous()                      # [3, 4, T]
    out = []
    for s in range(0, lanes.numel(), step):
        k = lanes[s:s + step]
        t, u, v, _ = _chunk_test(rows, o[k], d[k], tnear[k], tfar[k])
        one = torch.ones_like(o[k][:, :1])
        o4 = torch.cat([o[k], one], 1)
        d4 = torch.cat([d[k], 0 * one], 1)
        err = []
        for c in range(3):
            mag = o4.abs() @ rt[c].abs() + t.abs() * (d4.abs() @ rt[c].abs())
            err.append((eps * mag, d4 @ rt[c]))
        live = err[0][1].abs() > 1e-20
        bt = err[0][0] / err[0][1].abs().clamp(min=1e-30)
        bu = err[1][0] + bt * err[1][1].abs()
        bv = err[2][0] + bt * err[2][1].abs()
        tn, tf = tnear[k][:, None], tfar[k][:, None]
        wide = (live & (t > tn - bt) & (t < tf + bt) & (u >= -bu)
                & (v >= -bv) & (u + v <= 1.0 + bu + bv))
        near = ((u < bu) | (v < bv) | (1.0 - (u + v) < bu + bv)
                | ((t - tn).abs() < bt) | ((t - tf).abs() < bt))
        t2, i2 = torch.topk(torch.where(wide, t, inf), 2, dim=1, largest=False)
        b2 = torch.gather(bt, 1, i2)
        tie = torch.isfinite(t2[:, 1]) & (t2[:, 1] - t2[:, 0]
                                         <= b2[:, 0] + b2[:, 1])
        out.append((wide & near).any(1) | tie)
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool,
                                                  device=lanes.device)


def _on_edge(hit):
    """Whether a hit's u, v or u + v lies within MXU_EDGE of an edge."""
    import torch
    _, tri, u, v = hit
    edge = torch.minimum(torch.minimum(u, v), 1.0 - (u + v)) < MXU_EDGE
    return (tri >= 0) & edge


def _compare_mxu(label, rows, rays, got, ref, occ_got, occ_ref):
    """The tensor-core form `got` against `ref` (its plain version or the
    _dot4 kernels) on one sorted ray set, under the tolerance stated beside
    MXU_T_RTOL. Returns (max abs error of t/u/v on the lanes held to the
    plain bound, excused lanes, [n] mask of the lanes held to the
    operand-error bound: the caller caps their count)."""
    import torch
    o, d, tnear, tfar = rays
    n = o.shape[0]
    t_g, i_g, u_g, v_g = got
    t_r, i_r, u_r, v_r = ref
    differ = (i_g != i_r) | (occ_got != occ_ref)
    lanes = torch.nonzero(differ)[:, 0]
    excused = _on_edge(got)[lanes] | _on_edge(ref)[lanes]
    rest = lanes[~excused]
    rest = rest[~_tie_mask(rows, o, d, tnear, tfar, rest)]
    rest = rest[~_graze_mask(rows, o, d, tnear, tfar, rest)]
    if rest.numel():
        k = rest[:4]
        raise AssertionError(
            f"{label}: {rest.numel()} lanes differ in id, hit or occlusion "
            "outside near ties, edge grazes and what the operand error "
            f"explains; the first: lanes {k.tolist()}, got t {t_g[k].tolist()}"
            f" id {i_g[k].tolist()} u {u_g[k].tolist()} v {v_g[k].tolist()} "
            f"occ {occ_got[k].tolist()}, ref t {t_r[k].tolist()} id "
            f"{i_r[k].tolist()} u {u_r[k].tolist()} v {v_r[k].tolist()} occ "
            f"{occ_ref[k].tolist()}, tnear {tnear[k].tolist()} tfar "
            f"{tfar[k].tolist()}")
    if lanes.numel() > MXU_EXCUSED_FRAC * n:
        raise AssertionError(f"{label}: {lanes.numel()} of {n} lanes excused")
    same = (i_g == i_r) & (i_r >= 0)
    k = i_r[same].long()
    o4 = torch.cat([o[same], torch.ones_like(o[same][:, :1])], 1)
    d4 = torch.cat([d[same], torch.zeros_like(o[same][:, :1])], 1)
    mag_o = (o4[:, None, :] * rows[k]).abs().sum(-1)            # [m, 3]
    mag_d = (d4[:, None, :] * rows[k]).abs().sum(-1)
    dot_d = (d4[:, None, :] * rows[k]).sum(-1)
    t = t_r[same]
    eps = MXU_OPERAND_EPS
    bound_t = eps * (mag_o[:, 0] + t.abs() * mag_d[:, 0]) / dot_d[:, 0].abs()
    err_t = (t_g[same] - t).abs()
    plain_t = MXU_T_RTOL * t.abs() + MXU_T_ATOL
    if bool(torch.any(err_t > torch.maximum(plain_t, bound_t))):
        raise AssertionError(f"{label}: t differs beyond rtol {MXU_T_RTOL} "
                             "and beyond the operand-error bound")
    loose = err_t > plain_t
    err = float(err_t[~loose].max()) if bool((~loose).any()) else 0.0
    for a, b, c in ((u_g, u_r, 1), (v_g, v_r, 2)):
        bound = (MXU_T_ATOL + eps * (mag_o[:, c] + t.abs() * mag_d[:, c])
                 + torch.maximum(plain_t, bound_t) * dot_d[:, c].abs())
        e = (a[same] - b[same]).abs()
        if bool(torch.any(e > bound)):
            raise AssertionError(f"{label}: u/v differ beyond the bound")
        err = max(err, float(e[~loose].max()) if bool((~loose).any()) else 0.0)
    loose_lanes = torch.zeros(n, dtype=torch.bool, device=o.device)
    loose_lanes[same] = loose
    return err, lanes.numel(), loose_lanes


def _lab_sets(dev, n):
    """The tools' scene, tables, dense rows and their two ray sets (the
    draw order of tree_lab: coherent, then divergent)."""
    import torch
    from rustlight_tpu_torch.accel.walk import walk_tables_to
    from rustlight_tpu_torch.tools.perf import common
    geom, ext = common.lab_scene(LAB_TRIS, LAB_THETA)
    rng = np.random.default_rng(3)
    sets = {"coherent": common.to_device(dev, *common.coherent_rays(rng, n, ext)),
            "divergent": common.to_device(dev, *common.divergent_rays(rng, n, ext))}
    rows = torch.as_tensor(np.ascontiguousarray(geom.inter_rows[:geom.n_tris]),
                           device=dev)
    return geom, walk_tables_to(geom.walk, dev), rows, sets


def _mma_bound_ms(tests, n_bytes):
    """The bound of a walk with the tensor-core visit: (ms, what bounds it,
    the two routes' operation times) for `tests` ray-triangle tests. A test
    may take either route, so the operations' time is the smaller of the
    two: MMA_PASSES TF32 passes of its products (2 products x 3 row kinds x
    2 x 4 flop a pass at the TF32 rate) with the rest of the test (9 of the
    25 f32 operations), or all 25 operations at the f32 rate, as the _dot4
    kernels' bound counts."""
    routes = {"tc_route_ms": tests * (MMA_PASSES * 48 / TC_TF32_OPS
                                      + 9 / PEAK_F32_OPS) * 1e3,
              "f32_route_ms": tests * OPS_PER_TEST / PEAK_F32_OPS * 1e3}
    ops_ms = min(routes.values())
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    return ((ops_ms, "operations", routes) if ops_ms >= bytes_ms
            else (bytes_ms, "bytes", routes))


def _walk_variants(wt, srt, which):
    """The tensor-core kernel pairs named in `which` on the sorted rays
    `srt`: {name: (closest kernel name, any-hit kernel name, closest(**kw),
    anyhit(**kw), plain mxu closest, plain mxu any hit, rays a counted unit
    tests, the split forms' names, or None where the tensor-core visit is
    one thread a ray)}; a plain version returns its outputs, then the count
    (visits, or live pairs)."""
    from rustlight_tpu_torch.ops import walk_hier as wh
    from rustlight_tpu_torch.ops import walk_sub as wsub
    from rustlight_tpu_torch.ops import walk_trace as wk
    R = wk.RAY_TILE
    out = {
        "walk": ("walk_closest_mma", "walk_anyhit_mma",
                 lambda **k: wk.walk_closest(wt, *srt, **k),
                 lambda **k: wk.walk_anyhit(wt, *srt, **k),
                 lambda: wk.walk_closest_ref(wt, *srt, mxu=True),
                 lambda: wk.walk_anyhit_ref(wt, *srt, mxu=True), R,
                 _form_name(wk.PRODUCTION_FORMS["walk_closest"]) + "/"
                 + _form_name(wk.PRODUCTION_FORMS["walk_anyhit"])),
        "walk_wide": ("walk_closest_wide_mma", "walk_anyhit_wide_mma",
                      lambda **k: wk.walk_closest(wt, *srt, wide=True, **k),
                      lambda **k: wk.walk_anyhit(wt, *srt, wide=True, **k),
                      lambda: wk.walk_closest_ref(wt, *srt, True, True),
                      lambda: wk.walk_anyhit_ref(wt, *srt, True, True), R,
                      _form_name(wk.PRODUCTION_FORMS["walk_closest_wide"])
                      + "/" + _form_name(
                          wk.PRODUCTION_FORMS["walk_anyhit_wide"])),
        "walk_hier": ("walk_hier_closest_mma", "walk_hier_anyhit_mma",
                      lambda **k: wh.walk_hier_closest(wt, *srt, **k),
                      lambda **k: wh.walk_hier_anyhit(wt, *srt, **k),
                      lambda: wh.walk_hier_closest_ref(wt, *srt, True),
                      lambda: wh.walk_hier_anyhit_ref(wt, *srt, True), R,
                      None)}
    for sub in wsub.SUBS:
        out[f"sub{sub}"] = (
            "walk_sub_closest_mma", "walk_sub_anyhit_mma",
            lambda s=sub, **k: wsub.walk_sub_closest(wt, *srt, s, **k),
            lambda s=sub, **k: wsub.walk_sub_anyhit(wt, *srt, s, **k),
            lambda s=sub: wsub.walk_sub_closest_ref(wt, *srt, s, mxu=True),
            lambda s=sub: wsub.walk_sub_anyhit_ref(wt, *srt, s, mxu=True),
            R // sub, "/".join(
                _sub_form_name(wsub.MMA_FORMS[f"walk_sub_{k}"][sub])
                for k in ("closest", "anyhit")))
    return {k: out[k] for k in which}


def _pair_variants(wt, pairs, km):
    """The tensor-core pair kernels on one set of pairs, as _walk_variants."""
    from rustlight_tpu_torch.ops import pair_trace as pt
    return {f"pair{km}": (
        "pair_closest_mma", "pair_anyhit_mma",
        lambda **k: pt.pair_closest(wt, *pairs, **k),
        lambda **k: pt.pair_anyhit(wt, *pairs, **k),
        lambda: pt.pair_closest_ref(wt, *pairs, mxu=True),
        lambda: pt.pair_anyhit_ref(wt, *pairs, mxu=True), 1, None)}


def _form_counts(tag, rows, rays, dot, plain, add):
    """A1's candidate forms of the products (ops/walk_lab.py:MMA_FORMS) on
    the lanes the _dot4 kernel `dot` (t, tri, u, v) hits: each lane against
    its hit triangle, t = -no / nd. Counted per form: the lanes whose t lies
    outside MXU_T_RTOL / MXU_T_ATOL of the _dot4 t, and of the exact t (the
    products and the quotient in float64 from the same f32 operands); the
    _dot4 t and the plain mxu version's t (`plain`, on the lanes where its
    id is the _dot4 one) are counted against the exact t too. The record
    goes to add("mma_forms", ...) and the counts are returned."""
    import torch
    from rustlight_tpu_torch.ops import walk_lab as wl
    o, d = rays[0], rays[1]
    t_d, i_d = dot[0], dot[1]
    lanes = torch.nonzero(i_d >= 0)[:, 0]
    n = lanes.numel()
    pad = -n % 64
    sel = lambda x: torch.cat([x[lanes], torch.zeros((pad, *x.shape[1:]),
                                                     device=x.device,
                                                     dtype=x.dtype)])
    tri = sel(rows[i_d.clamp(min=0).long()]).contiguous()
    oo, dd = sel(o).contiguous(), sel(d).contiguous()
    nr = tri[:n, 0].double()
    one = torch.ones_like(oo[:n, :1]).double()
    t_x = (-(torch.cat([oo[:n].double(), one], 1) * nr).sum(1)
           / (torch.cat([dd[:n].double(), 0 * one], 1) * nr).sum(1))
    t = t_d[lanes]

    def outside(a, b):
        return int((~((a - b).abs() <= MXU_T_RTOL * b.abs()
                      + MXU_T_ATOL)).sum())

    counts, exact = [], []
    for form in range(len(wl.MMA_FORMS)):
        no, nd = wl.mma_form_lanes(form, tri, oo, dd)
        t_f = (-no / nd)[:n]
        counts.append(outside(t_f, t))
        exact.append(outside(t_f.double(), t_x))
    same = plain[1][lanes] == i_d[lanes]
    add("mma_forms", set=tag, lanes=n, counts=counts, exact=exact,
        dot4_exact=outside(t.double(), t_x),
        plain_exact=outside(plain[0][lanes][same].double(), t_x[same]),
        plain_lanes=int(same.sum()))
    return counts, exact


def _check_mma(tag, rows, wt, rays, variants, resident, add, in_bytes=None,
               forms=True, **where):
    """The tensor-core kernel pairs of `variants` (_walk_variants,
    _pair_variants) on one sorted wavefront or set of pairs `rays`: each
    against its plain mxu version on every tile and against its _dot4
    kernel, under the tolerance stated beside MXU_T_RTOL. The plain mxu
    version is held to the same _dot4 kernel, and the kernel may miss the
    plain tolerance on at most MXU_LOOSE_RATIO x as many lanes (plus
    MXU_LOOSE_SLACK). `resident`: the table is read once, else a cluster's
    rows per visit. With `forms`, A1's candidate forms are counted on the
    first variant's _dot4 hits (_form_counts). Records go to add(kernel
    name, **record)."""
    import torch
    from rustlight_tpu_torch.ops import walk_lab as wl
    from rustlight_tpu_torch.ops import walk_trace as wk
    one = wk.ONE_THREAD_FORM
    n = rays[0].shape[0]
    in_bytes = RAY_IN_BYTES if in_bytes is None else in_bytes
    table = (wt.rows.numel() + wt.ids.numel() + wt.lo.numel()
             + wt.hi.numel()) * 4
    first = forms
    for name, (cname, aname, closest, anyhit, pc, pa, per,
               split) in variants.items():
        dot_c, dot_a = closest(), anyhit()
        got_c, got_a = closest(mxu=True), anyhit(mxu=True)
        (out_c, pms_c), (out_a, pms_a) = _timed(pc), _timed(pa)
        ref_c, ref_a = out_c[:4], out_a[0]
        at = f"{tag} {name} mma"
        turns = {}
        if split:
            # the split tensor-core forms against the one-thread ones
            one_c, one_a = closest(mxu=True, _form=one), anyhit(mxu=True,
                                                                 _form=one)
            torch.cuda.synchronize()
            diff = (_lanes_differ(got_c, one_c).numel(),
                    _lanes_differ(got_a, one_a).numel())
            if any(diff):
                raise AssertionError(f"{at}: the split forms ({split}) differ "
                                     f"from P1 on {diff} lanes")
            for kname, fn in ((cname, closest), (aname, anyhit)):
                turns[kname] = _in_turns(
                    lambda fn=fn, **k: fn(mxu=True, **k), one, None)
            phase("forms", f"{at}: {split} vs P1: 0 lanes differ; P1, new, "
                  "new, P1 " + "; ".join(
                      ", ".join(f"{t:.4f}" for t in turns[k]["turns_ms"])
                      for k in (cname, aname)) + " ms")
        cap = _exact_cap(at, rows, rays, got_c, ref_c)
        err_p, exc_p, loose_p = _compare_mxu(
            f"{at} vs plain mxu", rows, rays, got_c, ref_c, got_a, ref_a)
        err_k, exc_k, loose_k = _compare_mxu(
            f"{at} vs _dot4 kernels", rows, rays, got_c, dot_c, got_a, dot_a)
        _, exc_r, loose_r = _compare_mxu(
            f"{tag} {name} plain mxu vs _dot4 kernels", rows, rays, ref_c,
            dot_c, ref_a, dot_a)
        n_p, n_k, n_r = (int(x.sum()) for x in (loose_p, loose_k, loose_r))
        shared = int((loose_k & loose_r).sum())
        if max(n_k, n_p) > MXU_LOOSE_RATIO * n_r + MXU_LOOSE_SLACK:
            raise AssertionError(
                f"{at}: {n_k} lanes miss rtol {MXU_T_RTOL} against the _dot4 "
                f"kernels and {n_p} against the plain mxu version, which "
                f"itself misses it against the _dot4 kernels on only {n_r}")
        form_note = ""
        if first:
            first = False
            counts, exact = _form_counts(tag, rows, rays, dot_c, ref_c, add)
            rec = add.last("mma_forms")
            rec.update(plain=n_r, kernel=n_k)
            form_note = (f"; A1's forms on the _dot4 hits: {counts} outside "
                         f"rtol of the _dot4 t, {exact} of the exact t "
                         f"(_dot4 {rec['dot4_exact']}, plain mxu "
                         f"{rec['plain_exact']}; form {wl.PRODUCTION_FORM} "
                         "is the kernels')")
        base = (_median_ms(closest), _median_ms(anyhit))
        for kname, fn, out, pms, b_ms, out_b in (
                (cname, closest, out_c, pms_c, base[0], 16),
                (aname, anyhit, out_a, pms_a, base[1], 1)):
            count = out[-1]             # this run's visits or live pairs
            tests = count * per * wk.K
            bound, by, routes = _mma_bound_ms(
                tests, n * (in_bytes + out_b)
                + (table if resident else count * HIER_VISIT_BYTES))
            timing = turns.get(kname) or {
                "ms": _median_ms(lambda: fn(mxu=True))}
            add(kname, max_abs_err=max(err_p, err_k), dot4_ms=b_ms,
                plain_ms=pms, bound_ms=bound, bound_by=by, **routes,
                tests=tests, excused=max(exc_p, exc_k),
                loose=max(n_p, n_k), plain_loose=n_r, schedule=name,
                form=split or "P1", exact_outside=cap[0],
                plain_exact_outside=cap[1], **timing, **where)
            rc = add.last(kname)
            phase("mma", f"{at} {kname}: {tests} tests, {rc['ms']:.4f} ms "
                  f"(_dot4 {b_ms:.4f}), plain {pms:.1f} ms, bound "
                  f"{bound:.4f} ms ({by}; tensor-core route "
                  f"{routes['tc_route_ms']:.4f}, f32 route "
                  f"{routes['f32_route_ms']:.4f})")
        phase("mma", f"{at} (of {n} lanes): vs plain mxu {exc_p} excused, "
              f"{n_p} on the operand-error bound; vs _dot4 kernels {exc_k}, "
              f"{n_k}; plain mxu vs _dot4 kernels {exc_r}, {n_r} ({shared} of "
              f"them the kernel's too; ratio "
              f"{n_k / max(n_r, 1):.2f}); outside rtol {MXU_T_RTOL} of the "
              f"exact t: the kernel {cap[0]}, torch.matmul {cap[1]} (of "
              f"{cap[2]} lanes); err {max(err_p, err_k):.3g}" + form_note)


def _exact_cap(label, rows, rays, got, ref):
    """The yardstick of f32 accuracy: on the lanes where a tensor-core
    kernel (`got`, closest hit) and its plain mxu version (`ref`:
    torch.matmul in full f32) hit the same triangle, the lanes whose t lies
    outside MXU_T_RTOL / MXU_T_ATOL of the exact t (the products and the
    quotient in float64 from the same f32 operands). The kernel's may be at
    most the plain version's. Returns (the kernel's, the plain version's,
    the lanes)."""
    import torch
    o, d = rays[0], rays[1]
    same = (got[1] == ref[1]) & (got[1] >= 0)
    nr = rows[got[1][same].long(), 0].double()
    one = torch.ones_like(nr[:, :1])
    t_x = (-(torch.cat([o[same].double(), one], 1) * nr).sum(1)
           / (torch.cat([d[same].double(), 0 * one], 1) * nr).sum(1))

    def outside(t):
        return int((~((t.double() - t_x).abs()
                      <= MXU_T_RTOL * t_x.abs() + MXU_T_ATOL)).sum())

    n_k, n_p = outside(got[0][same]), outside(ref[0][same])
    if n_k > n_p:
        raise AssertionError(f"{label}: {n_k} lanes outside rtol "
                             f"{MXU_T_RTOL} of the exact t, torch.matmul "
                             f"{n_p} on the same {int(same.sum())} lanes")
    return n_k, n_p, int(same.sum())


class _Records(dict):
    """{kernel name: [a record per case]}; callable to append one."""

    def __call__(self, name, **rec):
        self.setdefault(name, []).append(rec)

    def last(self, name):
        return self[name][-1]


def check_mma(label, sd, waves, which, pairs=False):
    """The tensor-core kernels named in `which` at the shapes their main
    path gives them: on the scene's own table and wavefronts, sorted by the
    walk (_check_mma); with `pairs` also K8's at each of PAIR_KMS on the
    pairs of the morton-sorted wavefront, as phase 13 makes them, with the
    whole pair walk's time. Returns {kernel name: [a record per case]}."""
    from rustlight_tpu_torch.accel import pair_walk as pw
    from rustlight_tpu_torch.accel import walk
    from rustlight_tpu_torch.accel.walk import FLAT_MAX_CLUSTERS
    wt = sd.geom.walk
    rows = sd.geom.inter_rows
    resident = wt.n_clusters <= FLAT_MAX_CLUSTERS
    recs = _Records()
    for wname, rays in waves.items():
        srt = walk._prepare(wt, *rays)[:4]
        tag = f"{label}/{wname}"
        _check_mma(tag, rows, wt, srt, _walk_variants(wt, srt, which),
                   resident, recs, table=label, wavefront=wname)
        if not pairs:
            continue
        msrt = walk._prepare(wt, *rays, inc_sort=False)[:4]
        wt_mxu = wt._replace(options=wt.options._replace(mxu_tritest=True))
        for km in PAIR_KMS:
            prs, _ = pw._make_pairs(wt, *msrt, km)
            _check_mma(tag, rows, wt, prs[:4], _pair_variants(wt, prs, km),
                       resident, recs, in_bytes=PAIR_IN_BYTES, forms=False,
                       table=label, wavefront=wname)
            for kname, any_hit in (("pair_closest_mma", False),
                                   ("pair_anyhit_mma", True)):
                rec = recs.last(kname)
                rec["walk_ms"] = _median_ms(lambda a=any_hit: pw._pairs_impl(
                    wt_mxu, *rays, a, km))
                phase("mma", f"{tag} pair{km} {kname}: the kernel with its "
                      f"cluster runs' sort {rec['ms']:.4f} ms, the whole pair "
                      f"walk {rec['walk_ms']:.4f} ms")
    return recs


def check_lab(dev):
    """Phase 17. Returns the records of the lab kernels and of the
    tensor-core kernels, keyed by kernel name."""
    import torch
    from rustlight_tpu_torch.ops import walk_lab as wl
    from rustlight_tpu_torch.ops import walk_trace as wk
    from rustlight_tpu_torch.tools.perf import common, roofline
    geom, wt, rows, sets = _lab_sets(dev, LAB_RAYS)
    R, K = wk.RAY_TILE, wk.K
    table = (wt.rows.numel() + wt.ids.numel() + wt.lo.numel()
             + wt.hi.numel()) * 4
    recs = _Records()

    def add(name, wname, **rec):
        recs(name, wavefront=wname, **rec)

    # the two products of the tensor-core form, one tile and one cluster
    crow = wt.rows.view(-1, K, 3, 4)[0].contiguous()
    o64 = sets["divergent"][0][:R].contiguous()
    d64 = sets["divergent"][1][:R].contiguous()
    got = wl.mma_products(crow, o64, d64)
    ref = wl.dot4_products(crow, o64, d64)
    lib = wl.mma_products_ref(crow, o64, d64)
    torch.cuda.synchronize()
    rel = lambda x, y: float(((x - y).abs() / y.abs().amax(1, keepdim=True)
                              .clamp(min=1e-30)).max())
    op_err = max(rel(a, b) for a, b in zip(got, ref))
    lib_err = max(rel(a, b) for a, b in zip(lib, ref))
    if op_err > 1e-5:
        raise AssertionError(f"mma_products: error {op_err:.3g} of a ray's "
                             "largest product: the fragment layout is off")
    prod_bytes = crow.numel() * 4 + 2 * o64.numel() * 4 + 2 * got[0].numel() * 4
    bound, by, _ = _mma_bound_ms(R * K, prod_bytes)
    add("mma_products", "divergent",
        max_abs_err=max(float((a - b).abs().max()) for a, b in zip(got, ref)),
        ms=_median_ms(lambda: wl.mma_products(crow, o64, d64)),
        plain_ms=_median_ms(lambda: wl.dot4_products(crow, o64, d64)),
        library_ms=_median_ms(lambda: wl.mma_products_ref(crow, o64, d64)),
        bound_ms=bound, bound_by=by)
    phase("lab", f"mma_products vs the _dot4 products, relative to each "
          f"ray's largest: {op_err:.3g} (torch.matmul, full f32: "
          f"{lib_err:.3g}; limit stated in PERF.md: {MXU_OPERAND_EPS:g}); "
          f"kernel {recs['mma_products'][0]['ms']:.4f} ms, torch.matmul x 2 "
          f"{recs['mma_products'][0]['library_ms']:.4f} ms")
    # A1: the lab's production form is the kernels' body, bit for bit
    lanes = torch.arange(R, device=dev)
    no, nd = wl.mma_form_lanes(wl.PRODUCTION_FORM,
                               crow[lanes % K].contiguous(), o64, d64)
    if not (torch.equal(no, got[0][lanes, lanes % K])
            and torch.equal(nd, got[1][lanes, lanes % K])):
        raise AssertionError(f"mma_form_lanes: form {wl.PRODUCTION_FORM} "
                             "is not the kernels' products")
    # and each form's time: A1_VISITS visits a tile of the divergent set
    o_dv, d_dv = sets["divergent"]
    for form, desc in enumerate(wl.MMA_FORMS):
        recs("mma_form_visits", form=form, desc=desc, visits=A1_VISITS,
             ms=_median_ms(lambda f=form: wl.mma_form_visits(
                 f, wt, o_dv, d_dv, A1_VISITS)))

    # fma_peak
    x = torch.rand(wl.FMA_SHAPE, device=dev) + 0.5
    y, yp = wl.fma_peak(x, roofline.FMA_ITERS, 1), wl.fma_peak_ref(
        x, roofline.FMA_ITERS)
    torch.cuda.synchronize()
    fma_err = float(((y - yp).abs() / yp.abs()).max())
    if not fma_err <= FMA_RTOL:
        raise AssertionError(f"fma_peak: rel err {fma_err:.3g} > {FMA_RTOL}")
    blocks, iters = roofline.FMA_BLOCKS, roofline.FMA_ITERS
    ms = _median_ms(lambda: wl.fma_peak(x, iters, blocks), runs=5)
    half = _median_ms(lambda: wl.fma_peak(x, iters // 2, blocks), runs=5)
    if not 1.8 <= ms / half <= 2.2:
        raise AssertionError(f"fma_peak: {ms:.3f} ms at {iters} steps, "
                             f"{half:.3f} at {iters // 2}: the chain is not "
                             "what is timed")
    flop = blocks * iters * R * 3 * K * 4
    add("fma_peak", "-", max_abs_err=float((y - yp).abs().max()), ms=ms,
        plain_ms=_median_ms(lambda: wl.fma_peak_ref(x, iters), runs=1),
        bound_ms=flop / PEAK_F32_OPS * 1e3, bound_by="operations",
        tflops=flop / ms / 1e9)
    phase("lab", f"fma_peak: rel err {fma_err:.3g} at {iters} steps; "
          f"{blocks} blocks: {ms:.3f} ms ({flop / ms / 1e9:.2f} TFLOP/s, "
          f"{100 * flop / ms / 1e9 / (PEAK_F32_OPS / 1e12):.1f}% of the f32 "
          f"peak), {half:.3f} ms at {iters // 2} steps")

    # batched torch.matmul of one visit's two products, every tile at once
    tiles = LAB_RAYS // R
    o4 = torch.rand((tiles, R, 4), device=dev)
    pm = torch.rand((tiles, 4, 3 * K), device=dev)
    mm_visit = _median_ms(lambda: (torch.matmul(o4, pm), torch.matmul(o4, pm)))
    phase("lab", f"torch.matmul [{tiles}, 64, 4] x [{tiles}, 4, 1152] twice "
          f"(one visit's products of every tile): {mm_visit:.4f} ms")

    for wname, (o, d) in sets.items():
        srt = common.sorted_tiles(wt, o, d)
        n = srt[0].shape[0]
        k3 = wk.walk_closest(wt, *srt)
        cnt = wl.walk_closest_counted(wt, *srt)
        cnt_p, pms = _timed(lambda: wl.walk_closest_counted_ref(wt, *srt))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(cnt, cnt_p)):
            raise AssertionError(f"lab/{wname}: counted differs from plain")
        if not all(torch.equal(a, b) for a, b in zip(cnt[:4], k3)):
            raise AssertionError(f"lab/{wname}: counted differs from K3")
        nv = cnt[4].view(-1, R)[:, 0].long()
        visits = int(nv.sum())
        bound, by = _bound_ms(visits * R * K, n * (RAY_IN_BYTES + 20) + table)
        k3_ms = _median_ms(lambda: wk.walk_closest(wt, *srt))
        add("walk_closest_counted", wname, max_abs_err=0.0,
            ms=_median_ms(lambda: wl.walk_closest_counted(wt, *srt)),
            plain_ms=pms, bound_ms=bound, bound_by=by, k3_ms=k3_ms,
            visits="%.2f, p99 %.0f, max %d" % _spread(nv))
        nvi = int(round(visits / tiles))
        fl = wl.walk_floor(wt, *srt, nvi)
        fl_p = wl.walk_floor_ref(wt, *srt, nvi)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(fl, fl_p)):
            raise AssertionError(f"lab/{wname}: floor differs from plain")
        lanes = (torch.arange(0, tiles, HIER_SAMPLE, device=dev)[:, None] * R
                 + torch.arange(R, device=dev)).reshape(-1)
        sub = [x[lanes].contiguous() for x in srt]
        bound, by = _bound_ms(tiles * nvi * R * K,
                              n * (RAY_IN_BYTES + 16) + table)
        add("walk_floor", wname, max_abs_err=0.0, visits=nvi,
            ms=_median_ms(lambda: wl.walk_floor(wt, *srt, nvi)),
            plain_sample_ms=_median_ms(
                lambda: wl.walk_floor_ref(wt, *sub, nvi), runs=PLAIN_RUNS),
            plain_tiles=lanes.numel() // R, bound_ms=bound, bound_by=by)
        c, f = recs["walk_closest_counted"][-1], recs["walk_floor"][-1]
        f["plain_ms"] = f["plain_sample_ms"] * HIER_SAMPLE
        phase("lab", f"{wname} ({_form_name(wk.PRODUCTION_FORMS['walk_closest'])}"
              f" threads a ray): counted = plain = K3 bit for bit, visits/"
              f"tile {c['visits']}; K3 {k3_ms:.4f} ms, counted "
              f"{c['ms']:.4f} ms (plain {pms:.1f} ms), floor at {nvi} visits "
              f"{f['ms']:.4f} ms = plain bit for bit (plain "
              f"{f['plain_sample_ms']:.1f} ms on {f['plain_tiles']} tiles): "
              f"production/floor {k3_ms / f['ms']:.2f}x; bound "
              f"{c['bound_ms']:.4f} ms ({by})")

        # the tensor-core visit: K3, the wide pop, K5 (forced onto these
        # tables), each against its plain mxu version and the _dot4 kernels
        _check_mma(f"lab/{wname}", rows, wt, srt,
                   _walk_variants(wt, srt, ("walk", "walk_wide", "walk_hier")),
                   True, recs, table="lab", wavefront=wname)
    return recs


def a1_summary(form_recs, visit_recs):
    """Phase 17's table of the candidate forms of the tensor-core products:
    per set, each form's lanes outside MXU_T_RTOL / MXU_T_ATOL of the _dot4
    kernel's t beside the plain matmul form's (and the production kernel's
    own), and of the exact t beside the plain form's and the _dot4 form's;
    per form, its largest ratio to the plain form on either yardstick,
    whether it stays within A1_RATIO x of it on every set, and its time.
    Returns the rows."""
    from rustlight_tpu_torch.ops import walk_lab as wl
    for r in form_recs:
        phase("a1", f"{r['set']}: {r['lanes']} lanes hit; outside rtol "
              f"{MXU_T_RTOL} of the _dot4 t: plain matmul form {r['plain']}, "
              f"the kernel {r['kernel']}, forms {r['counts']}; of the exact "
              f"t: plain matmul form {r['plain_exact']} (of "
              f"{r['plain_lanes']}), _dot4 {r['dot4_exact']}, forms "
              f"{r['exact']}")
    out = []
    for f, desc in enumerate(wl.MMA_FORMS):
        row = {"form": f, "desc": desc,
               "counts": [r["counts"][f] for r in form_recs],
               "exact": [r["exact"][f] for r in form_recs]}
        for key, plain in (("counts", "plain"), ("exact", "plain_exact")):
            row[f"{key}_max_ratio"] = max(r[key][f] / max(r[plain], 1)
                                          for r in form_recs)
            row[f"{key}_within"] = all(r[key][f] <= A1_RATIO * r[plain]
                                       for r in form_recs)
        row["ms"] = next(v["ms"] for v in visit_recs if v["form"] == f)
        out.append(row)
        phase("a1", f"form {f} ({desc})"
              f"{' [the kernels]' if f == wl.PRODUCTION_FORM else ''}: "
              f"against the _dot4 t largest ratio to the plain form "
              f"{row['counts_max_ratio']:.2f}, within {A1_RATIO}x on every "
              f"set {row['counts_within']}; against the exact t "
              f"{row['exact_max_ratio']:.2f}, {row['exact_within']}; "
              f"{A1_VISITS} visits a tile of the lab's divergent set "
              f"{row['ms']:.4f} ms")
    return out


def lab_path(dev):
    """Phase 18. Returns the launches of the tools' runs."""
    import torch
    from rustlight_tpu_torch.accel import bvh as tb
    from rustlight_tpu_torch.ops import walk_trace as wk
    from rustlight_tpu_torch.tools.perf import roofline, trace_122k, tree_lab
    out = os.path.join(ROOT, "build", "lab")
    _reset_launches()
    for tool, name, extra in ((roofline, "roofline", ()),
                              (roofline, "roofline_mxu", ("--mxu",)),
                              (trace_122k, "trace_122k", ()),
                              (trace_122k, "trace_122k_mxu", ("--mxu",)),
                              (tree_lab, "tree_lab", ())):
        t0 = time.time()
        tool.main(["--device", DEVICE, "--rays", str(N_RAYS), "--out",
                   os.path.join(out, f"{name}_h100.json"), *extra])
        phase("lab path", f"{name} in {time.time() - t0:.1f}s")
    launches = _launches()
    # the lab kernels' device time per launch at the tools' size
    for extra in ((), ("--mxu",)):
        _, kern = _profile(lambda: roofline.main(
            ["--device", DEVICE, "--rays", str(N_RAYS), "--runs", "1",
             "--out", os.path.join(out, "roofline_profiled.json"), *extra]))
        for e in kern:
            if any(nm in e.key for nm in ("walk_", "fma_peak", "mma_products")):
                phase("profile", _kernel_line(e))
    geom, wt, rows, sets = _lab_sets(dev, LAB_RAYS)
    o, d = sets["coherent"]
    bvh = tb.bvh_tables_to(tb.build_bvh(geom), dev)
    stats = {}
    tnear = torch.full((LAB_RAYS,), 1e-4, device=dev)
    tfar = torch.full((LAB_RAYS,), float("inf"), device=dev)
    rh, ms = _timed(lambda: tb.intersect_bvh(bvh, o, d, tnear, tfar,
                                             stats=stats))
    k3 = wk.walk_closest(wt, o, d, tnear, tfar)
    _compare("intersect_bvh vs K3", rows, (o, d, tnear, tfar), rh[:4], k3,
             rh.hit, k3[1] >= 0)
    phase("lab path", f"intersect_bvh: {LAB_RAYS} coherent rays, "
          f"{bvh.n_nodes} nodes, {stats['steps']} steps, {ms:.1f} ms, "
          f"{int(rh.hit.sum())} hits: masks and ids equal to K3's, t within "
          f"{T_RTOL}")
    return launches


def ao_row(dev, label, n_tris):
    """Phases 9-12 on one AO row, then phases 13 (the wide pop) and 15 on
    the row past FLAT_MAX_CLUSTERS clusters and phase 16 on the other. The
    two-level kernels are checked on every row; the render takes the
    reference's route: the two-level walk past FLAT_MAX_CLUSTERS clusters.
    Returns (walk-hier records, the one-level walk's records on a row at
    most FLAT_MAX_CLUSTERS clusters, wide records, the tensor-core kernels'
    records on this row's wavefronts, the launches of the row's main-path
    renders summed)."""
    from rustlight_tpu_torch.accel.walk import FLAT_MAX_CLUSTERS, WalkOptions
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
    recs, flat_recs = check_hier(label, sd)
    integ = IntegratorAO(max_distance=AO_DIST)
    img, wall, warm, n_rays, launches = timed_render(label, sd, integ,
                                                     AO_SPP, seed=1)
    expect = 2 * AO_RES * AO_RES * AO_SPP
    if n_rays != expect:
        raise AssertionError(f"{label}: {n_rays} rays traced, {expect} "
                             "expected")
    _only(label, launches, kernels)
    phase("main", f"{label} AO {AO_RES}x{AO_RES} {AO_SPP} spp, max distance "
          f"{AO_DIST}: warm-up {warm:.3f}s, timed (seed 1) {wall:.3f}s, "
          f"{n_rays} rays, {n_rays / wall / 1e6:.3f} Mrays/s, mean_ao "
          f"{img.mean():.5f}, launches { {k: v for k, v in launches.items() if v} }")
    small = sd._replace(camera=camera(AO_ORACLE_RES))
    oracle_check(label, small, integ, AO_ORACLE_SPP, kernels,
                 AO_ORACLE_PIX_FRAC, 0.0, AO_ORACLE_MEAN_RTOL)
    profile_render(label, sd, integ, 1, ("walk_hier",) if hier else ("walk_",))
    wide_recs, mma_recs = [], {}
    if hier:
        waves = ao_wavefronts(sd)
        wide_recs, lab = check_wide(label, sd, waves)
        _LAB["records"] += lab
        # the tensor-core visit where the renders below launch it
        mma_recs = check_mma(label, sd, waves, ("walk_wide", "walk_hier"))
        extra = ao_option_render(
            f"{label} AO hier=False (wide pop)", sd, WalkOptions(hier=False),
            ("walk_closest_wide", "walk_anyhit_wide"), img, wall)
        for name, options, mma_kernels in (
                ("mxu_tritest", WalkOptions(mxu_tritest=True),
                 ("walk_hier_closest_mma", "walk_hier_anyhit_mma")),
                ("hier=False mxu_tritest",
                 WalkOptions(hier=False, mxu_tritest=True),
                 ("walk_closest_wide_mma", "walk_anyhit_wide_mma"))):
            more = ao_option_render(f"{label} AO {name}", sd, options,
                                    mma_kernels, img, wall, profile=False)
            extra = {k: extra[k] + more[k] for k in extra}
    else:
        extra = ao_option_render(
            f"{label} AO inc_sort=False", sd, WalkOptions(inc_sort=False),
            kernels, img, wall)
    return recs, flat_recs, wide_recs, mma_recs, {
        k: launches[k] + extra[k] for k in launches}


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
    start_lab_build()
    lib = native.build(verbose=True)
    phase("build", f"{lib.name} in {time.time() - t0:.2f}s")
    ptxas_table()
    check_static_smem()
    wait_lab_build()
    phase("build", f"RL_LAB_FORMS library of K7's and K3w's forms in "
          f"{_LAB['seconds']:.2f}s (from the start of the build)")

    from rustlight_tpu_torch.integrators import IntegratorPathTracing
    from rustlight_tpu_torch.models import cornell_box, sphere_grid
    from rustlight_tpu_torch.scene.geometry import (TriMesh,
                                                    build_geometry_tables)
    from rustlight_tpu_torch.ops import dense_trace as dt
    rng = np.random.default_rng(0)
    sd = cornell_box(CBOX_RES, CBOX_RES).compile(device=dev)
    both = ("closest", "anyhit")
    sets = {"cbox": (sd.geom.inter_rows, _rays(
        rng, (-20.0, -20.0, -800.0), (576.0, 568.8, 559.2), N_RAYS, dev),
        both, True)}
    verts = rng.uniform(0.0, 1.0, (3000, 3)).astype(np.float32)
    soup = TriMesh(verts, np.arange(3000, dtype=np.int32).reshape(1000, 3))
    soup_rows = torch.as_tensor(
        build_geometry_tables([soup], [-1]).inter_rows, device=dev)
    sets["soup1000"] = (soup_rows, _rays(rng, (-0.2,) * 3, (1.2,) * 3, N_RAYS,
                                         dev), both, True)
    integ = IntegratorPathTracing(max_depth=CBOX_DEPTH)
    for label, (kind, rays) in render_wavefronts(sd, integ).items():
        sets[label] = (sd.geom.inter_rows, rays, (kind,), True)
    for label, (rows, *rays) in dt.planted_sets().items():
        sets["planted/" + label] = (
            torch.as_tensor(rows, device=dev),
            [torch.as_tensor(x, device=dev) for x in rays], both, False)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()
    dense_recs = check_dense(sets, float(clock[0]) * 1e6)
    del sets
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
          f"launches { {k: v for k, v in launches.items() if v} }")
    profile_render("cbox", sd, integ, 8, ("dense_",))
    del sd

    walk_recs, grids = [], {}
    for label, n_tris in GRID_ROWS:
        t0 = time.time()
        gsd = sphere_grid(n_tris, GRID_RES, GRID_RES).compile(device=dev)
        torch.cuda.synchronize()
        grids[label] = (gsd, n_tris, time.time() - t0)
        recs, waves = check_walk(label, gsd, rng)
        grids[label] += (waves,)
        walk_recs += recs
    walk_launches = {"walk_closest": 0, "walk_anyhit": 0}
    grid_renders = {}
    integ = IntegratorPathTracing(max_depth=GRID_DEPTH)
    for label, (gsd, n_tris, build_s, _) in grids.items():
        img, wall, warm, n_rays, launches = timed_render(label, gsd, integ,
                                                         GRID_SPP)
        grid_renders[label] = (img, n_rays, wall)
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
              f"Mrays/s, mean {img.mean():.6f}, launches { {k: v for k, v in launches.items() if v} }")
    osd = sphere_grid(GRID_ROWS[0][1], ORACLE_RES, ORACLE_RES).compile(
        device=dev)
    oracle_check(f"sphere_grid({GRID_ROWS[0][1]})", osd,
                 IntegratorPathTracing(max_depth=GRID_DEPTH,
                                       nee_rr=ORACLE_NEE_RR),
                 ORACLE_SPP, ("walk_closest", "walk_anyhit"),
                 ORACLE_PIX_FRAC, ORACLE_PIX_RTOL, ORACLE_MEAN_RTOL)
    del osd
    for label, (gsd, _, _, _) in grids.items():
        profile_render(label, gsd, integ, 2, ("walk_",))
    label = GRID_ROWS[0][0]
    gsd, _, _, waves = grids[label]
    check_sub_planted(dev)
    check_sparse_planted(dev)
    sched_recs = check_schedules(label, gsd, waves)
    # the tensor-core visit of K3, K6 and K8 where phase 19's renders launch
    # them
    mma_recs = check_mma(label, gsd, waves, ("walk", "sub2", "sub4", "sub8"),
                         pairs=True)
    sched_launches = schedule_renders(label, gsd, integ, *grid_renders[label])
    del grids, gsd, waves, grid_renders
    hier_recs, wide_recs, ao_launches = [], [], {}
    for label, n_tris in AO_ROWS:
        recs, frecs, wrecs, mrecs, launches = ao_row(dev, label, n_tris)
        hier_recs += recs
        walk_recs += frecs
        wide_recs += wrecs
        for k, v in mrecs.items():
            mma_recs.setdefault(k, []).extend(v)
        for k, v in launches.items():
            ao_launches[k] = ao_launches.get(k, 0) + v
    for k in walk_launches:
        # the pair renders' fallback launches the tile walk too
        walk_launches[k] += ao_launches[k] + sched_launches[k]
    lab_recs = check_lab(dev)
    a1 = a1_summary(mma_recs["mma_forms"] + lab_recs["mma_forms"],
                    lab_recs["mma_form_visits"])
    lab_launches = lab_path(dev)

    def pick(kind):
        """The K3-size spread wavefront stands for a walk kernel; every
        table and wavefront is in `cases`."""
        rec = next(r for r in walk_recs
                   if r["table"] == GRID_ROWS[0][0] and r["wavefront"] == "spread")
        return rec[kind], [{"table": r["table"], "wavefront": r["wavefront"],
                            "cp": r["cp"], **r[kind]} for r in walk_recs]

    kernels = []
    for name, replaces, kind in (
            ("dense_closest", "rustlight_tpu/ops/pallas_trace.py:35",
             "closest"),
            ("dense_anyhit", "rustlight_tpu/ops/pallas_trace.py:66",
             "anyhit")):
        # the cbox random set stands for the kernel; every timed set is in
        # `cases`
        cases = [r for r in dense_recs if r["kind"] == kind]
        rec = next(r for r in cases if r["set"] == "cbox")
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES["dense"],
            "replaces": replaces, "launches": cbox_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "issue_floor_ms": rec["issue_floor_ms"], "library_ms": None,
            "cases": [{k: r[k] for k in (
                "set", "rays", "tris", "ms", "plain_ms", "device_us",
                "host_us", "bound_ms", "issue_floor_ms", "max_abs_err")}
                for r in cases]})
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
    pw_file = "rustlight_tpu/accel/pallas_walk.py"
    for name, lines, kind, sched, source, launches in (
            ("walk_sub_closest", "765 (K6)", "closest", "sub2", "walk_sub",
             sched_launches),
            ("walk_sub_anyhit", "832 (K6)", "anyhit", "sub2", "walk_sub",
             sched_launches),
            ("walk_sparse_closest", "946 (K7)", "closest", "sparse",
             "walk_sparse", sched_launches),
            ("walk_sparse_anyhit", "1072 (K7)", "anyhit", "sparse",
             "walk_sparse", sched_launches)):
        # the spread wavefront of the schedule the main path runs; every
        # schedule of the source and wavefront is in `cases`
        cases = [_case(r, kind) for key, rs in sched_recs.items()
                 if key.startswith(sched[:3]) for r in rs]
        rec = next(r for r in sched_recs[sched]
                   if r["wavefront"] == "spread")[kind]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[source],
            "replaces": f"{pw_file}:{lines}", "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None,
            **({"form": rec["form"], "p1_ms": rec["p1_ms"]}
               if "form" in rec else {}), "cases": cases})
    for name, line, kind in (("pair_closest", 108, "closest"),
                             ("pair_anyhit", 155, "anyhit")):
        cases = [_case(r, kind) for km in PAIR_KMS for r in sched_recs[f"pair{km}"]]
        rec = next(r for r in sched_recs[f"pair{PAIR_KMS[0]}"]
                   if r["wavefront"] == "spread")[kind]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES["pair"],
            "replaces": f"rustlight_tpu/accel/pair_walk.py:{line} (K8)",
            "launches": sched_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "cases": cases})
    from rustlight_tpu_torch.ops import walk_trace as wk
    for name, lines, kind, wave in (
            ("walk_closest_wide", (636, 1139), "closest", "camera"),
            ("walk_anyhit_wide", (703, 1219), "anyhit", "ao")):
        # the wavefront of the row whose render takes the wide pop, heaps
        # where that render keeps them
        all_recs = wide_recs + sched_recs["wide/shared"] + sched_recs[
            "wide/global"]
        cases = [_case(r, kind) for r in all_recs]
        rec = next(r for r in wide_recs if r["wavefront"] == wave
                   and r["schedule"] == "wide/" + (
                       "shared" if r["cp"] <= wk._WIDE_SHARED_MAX
                       else "global"))[kind]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES["walk"],
            "replaces": WALK_REPLACES.format(*lines) + ", wide=True",
            "launches": ao_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None, "form": rec["form"], "p1_ms": rec["p1_ms"],
            "cases": cases})
    def lab_entry(name, source, replaces, launches, library_ms=None,
                  cases=None, wave="divergent", sched=None):
        """A kernel of phases 13 and 17-19: its numbers from the case `wave`
        (and schedule `sched`) of `cases` (by default phase 17's)."""
        cases = lab_recs[name] if cases is None else cases
        rec = next(c for c in cases if c["wavefront"] in (wave, "-")
                   and sched in (None, c.get("schedule")))
        return {"name": name, "route": "cuda",
                "source": KERNEL_SOURCES[source], "replaces": replaces,
                "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": library_ms,
                **({"form": rec["form"], "p1_ms": rec.get("p1_ms")}
                   if "form" in rec else {}),
                "cases": [{k: c[k] for k in (
                    "table", "wavefront", "schedule", "form", "ms", "p1_ms",
                    "dot4_ms", "walk_ms", "bound_ms",
                    "tc_route_ms", "f32_route_ms", "max_abs_err", "excused",
                    "loose", "exact_outside", "plain_exact_outside")
                    if k in c} for c in cases]}

    kernels += [
        lab_entry("walk_closest_counted", "lab", f"{ROOFLINE}:58",
                  lab_launches["walk_closest_counted"]
                  + lab_launches["walk_closest_counted_mma"]),
        lab_entry("walk_floor", "lab", f"{ROOFLINE}:119",
                  lab_launches["walk_floor"] + lab_launches["walk_floor_mma"]),
        lab_entry("fma_peak", "lab", f"{ROOFLINE}:163",
                  lab_launches["fma_peak"]),
        lab_entry("mma_products", "lab", f"{PW}:591 (MXU_TRITEST products)",
                  lab_launches["mma_products"],
                  lab_recs["mma_products"][0]["library_ms"])]
    # the tensor-core kernels: launches, time, bound and error from the table
    # and wavefront of their main-path render (the spread wavefront of
    # grid122k, the camera and AO wavefronts of the row past
    # FLAT_MAX_CLUSTERS); phase 17's cases on the lab scene follow in `cases`
    for name, what, launches, wave in (
            ("walk_closest_mma", "K3", sched_launches, "spread"),
            ("walk_anyhit_mma", "K3", sched_launches, "spread"),
            ("walk_closest_wide_mma", "K3, wide=True", ao_launches, "camera"),
            ("walk_anyhit_wide_mma", "K3, wide=True", ao_launches, "ao"),
            ("walk_hier_closest_mma", "K5", ao_launches, "camera"),
            ("walk_hier_anyhit_mma", "K5", ao_launches, "ao")):
        kernels.append(lab_entry(
            name, "mma", f"{PW}:591 (MXU_TRITEST in {what})", launches[name],
            cases=mma_recs[name] + lab_recs[name], wave=wave))
    # K6's and K8's: from grid122k's spread wavefront at the schedule its
    # main-path render takes (sub 2; km 8), the others in `cases`
    for name, what, sched, source in (
            ("walk_sub_closest_mma", f"K6, {PW}:765", "sub2", "walk_sub"),
            ("walk_sub_anyhit_mma", f"K6, {PW}:832", "sub2", "walk_sub"),
            ("pair_closest_mma", "K8, rustlight_tpu/accel/pair_walk.py:108",
             f"pair{PAIR_KMS[0]}", "pair"),
            ("pair_anyhit_mma", "K8, rustlight_tpu/accel/pair_walk.py:155",
             f"pair{PAIR_KMS[0]}", "pair")):
        kernels.append(lab_entry(
            name, source, f"{PW}:591 (MXU_TRITEST in {what})",
            sched_launches[name], cases=mma_recs[name], wave="spread",
            sched=sched))
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} never launched on a "
                                 "main path")
    phase("done", f"all phases passed in {time.time() - t_start:.1f}s")
    # every table and wavefront of each kernel on a line of its own, so the
    # kernels line stays short
    print(json.dumps({"kernel_cases": {k["name"]: k.pop("cases")
                                       for k in kernels if "cases" in k},
                      "a1_forms": a1, "split_forms": _LAB["records"]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

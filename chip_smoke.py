"""GPU smoke run of the PyTorch/CUDA port (rustlight_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda), g++ and this
checkout; imports nothing of JAX. Phases, one line each or more:

  0. device: require CUDA; print the card's name and power limit; turn
     TF32 off for matmuls and cuDNN;
  1. build: compile the port's CUDA kernels from csrc/ (sm_90a, one nvcc
     per source, all at once), and beside them, in threads, the
     RL_LAB_FORMS library of K7's, K3w's and K8's candidate and laboratory
     forms (tools/perf/split_forms.py) and the libraries of the walk
     sources at K = 128 and 768 (-DRL_KC=<k>, phase 29; their ptxas
     report held to the tables at their K as the production one); ptxas's registers, shared memory and
     spills of every kernel (`ptxas` lines), and launch_geometry's static
     shared memory held to ptxas's for every walk kernel in both its forms
     (K7 and K3w included), K3/K4's, K3w's and K5's split tensor-core
     forms, K6's forms at every sub with both tests and K8's split form
     with both tests;
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
     128 spp) after a warm-up (8 spp), with launch counts reset just
     before the timed render; the image must be finite and within 4x the
     measured floor of regress/bench_ref.npz on 8x8 block means, and both
     dense kernels must have launched;
  4. profile, cbox: torch.profiler over one warm 2 spp render;
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
     finite, the walk kernels and the incidence key must have launched
     and the dense ones not;
  7. oracle: sphere_grid(122_000, 64, 64) at 2 spp, seed 0, nee_rr = 0.25,
     once through the walk and once through the dense kernels over all
     131k triangles: 99.9% of pixels within 1e-3 (relative), means within
     1e-4 (relative);
  8. profile, grid122k and grid516k: torch.profiler over one warm 1 spp
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
     so is K8's split form (P threads a pair over runs of one cluster,
     ops/pair_trace.py:PRODUCTION_FORM) against the parent's warp-a-pair
     kernels (P1 in its lines), with each kernel's device us a launch and
     the whole pair walk timed in turns with each, and its candidate forms
     (P = 4, 4 runs a block, 4 runs with a ring) timed the same way; and
     K7's and the wide pop's production forms (P threads a ray,
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
     MMA_FORMS) and K8 (km = 8, 2; split as K3's over the same runs) on the
     same rays and pairs, each against its plain
     mxu version and against the _dot4 kernels under _compare_mxu's rules,
     with the count of lanes outside MXU_T_RTOL beside the plain form's
     (the cap of _check_mma) and against the exact t (_exact_cap), each
     split form against its one-thread tensor-core form bit for bit and
     timed in turns with it, and K8's whole pair walk timed in turns with
     the one-thread form. The wide pop and K5's split tensor-core form
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
     tile walk of its fallback), and no yardstick form (K5's and K8's
     wrappers count those apart, P1_LAUNCHES, `<name>_p1` in the
     launches); against phase 6's image of the same seed
     99.9% of pixels within 1e-3 (relative), means within 1e-4; a profile
     of a warm 1 spp render each, and the default schedule timed once more;
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
     also K3's, for its fallback; no yardstick form), a warm 1 spp render
     of each profiled; and, on grid5p7M, the AO render of
     phase 10 with mxu_tritest on the two-level walk (K5's split
     tensor-core form) and on the wide pop,
     held to phase 10's image as in 15. (Run with phases 14 and 15.)
 20. gate: the regression rows of tools/regression.py:59-75 at its
     settings, 32 spp, seed 0: cbox_direct (IntegratorDirect(1, 1) on
     cornell_box(128, 128), the per-pass route, as the stored row's) and
     veach_mis (the path tracer, max_depth = hard_cap = 8, on
     veach_mis(128, 96), through compute_block: statistical against the
     stored row, which the reference's per-pass route made); l1, l2, mape
     and dssim against regress/refs/<row>.exr (utils/metrics.py), each
     held to stored * 1.3 + 1.5 * floor (regress/results.json,
     regress/floors.json; tools/regression.py:13-16), only K1/K2 launched;
     the same two renders on the card against the port on the CPU at
     cornell_box(32, 32) and veach_mis(32, 24), 4 spp, and the material
     configurations of tests/test_oracle.py:85-180 (phong, glass, Beckmann
     and GGX metal, substrate, the 0.4 phong / 0.6 diffuse blend, checker
     walls with a bitmap right wall from a seeded 16x16 atlas) rendered by
     the path tracer at the oracle's depths on cornell_box(32, 32), 4 spp,
     card against CPU: 99.9% of pixels within 1e-3 (relative), means
     within 1e-4; then, timed as phase 3 (warm-up, then counts reset and
     rays counted over a timed render), direct on cornell_box(512, 512) at
     32 spp and the path tracer (depth 8) on veach_mis(256, 192) at 32
     spp, each with its K1/K2 launches and the device busy share of a warm
     2 spp render under torch.profiler.
 21. gate, AO, the light tracer and the medium: the rows cbox_ao/ao (the
     AO integrator's defaults), cbox_path/path,
     cbox_path/light, cbox_medium/path, cbox_medium/light and
     cbox_medium_single/path-single of tools/regression.py:46-83 at its
     settings (cornell_box(128, 128), for the two medium scenes in an
     infinite medium of sigma_s 0.0025; the path tracer and the light
     tracer at max_depth = hard_cap = 8, path-single at max_depth = hard_cap
     = 2, min_depth 1, single scattering; 32 spp, seed 0): the path rows
     through the per-pass route, as the stored rows were made, the light
     rows through render_splat; each metric held as in phase 20, only
     K1/K2 launched; cbox_medium/path once more through compute_block
     (statistical) under the same limits; the five rows on the card
     against the CPU at 32x32, 4 spp, under phase 20's bounds; then,
     timed as in phase 20 (but the warm-up at 2 spp), the light tracer on
     cornell_box(512, 512) and the path tracer through compute_block in the
     medium at 512x512, both at 16 spp and depth 8.
 22. the example scenes: (a) examples/cbox.pbrt, instances.pbrt,
     caustic.pbrt, envglass.xml and fog_box.xml through the port's
     load_scene, compiled on the card, their triangle counts and tiers
     checked (dense: K1/K2; walk: K3), and an OBJ written from fog_box's
     meshes loaded back through the native OBJ parser (built with g++;
     `obj.PARSES` must count it); (b) each example scene shrunk with
     resize_camera to 32 pixels wide, 4 spp, seed 0: the path tracer
     (depth 8, compute_block) on all five, direct on envglass and fog_box,
     the light tracer on fog_box and envglass, and the point + directional
     scene, the env-glass scene and the two uv-emission boxes (HSV,
     texture) of tests/test_oracle.py rebuilt with the port's classes, each
     on the card against the CPU: 99.9% of pixels within 1e-3 (relative),
     means within 1e-4, only K1/K2 on the dense scenes and only K3 on the
     walk scenes launched; (c) the white furnace, furnace_scene(256, 256,
     albedo 0.5) (8,064 triangles, K3), the path tracer at max_depth 6
     with no roulette, 32 spp: the center patch within 0.015 of 0.5, the
     corner within 1e-3 of 1 (tests/test_integrators.py:25-35 scaled to the
     film); (d) envglass 512x384, fog_box 384x288 and caustic 448x336, the
     path tracer (depth 8, compute_block) at 8 spp after a 1 spp warm-up,
     timed as phase 20 (Mrays/s, wall, K1/K2/K3 launches), and the device
     busy share of one 1 spp profile of envglass; (e) `python -m
     rustlight_tpu_torch.cli examples/envglass.xml -n 2 path -m 8` in a
     subprocess: exit 0 and a finite 512x384 image.
 23. VPL and the volumetric estimators: (a) the rows cbox_path/vpl,
     cbox_medium_single/{point-normal, plane-single, plane-single-unc} and
     cbox_medium_prims/{bre, beams, planes, vrl} of tools/regression.py:
     46-88 at its settings (cornell_box(128, 128), in the medium of sigma_s
     0.0025 but for VPL; 32 spp, the primitives 8; seed 0; the per-pass
     route, as the stored rows), each metric held as in phase 20, only K1/K2
     launched (K1 alone for BRE and beams, which trace no shadow ray);
     (b) each row on the card against the CPU at 32x32, 4 spp, under phase
     20's bounds, and so point-normal with the phase connection and with
     the best and pn_taylor_tr strategies; (c) timed as phase 20 (warm-up
     at 1 spp, the profile at 1 spp), at 512x512: VPL on cbox at 8 spp,
     point-normal (tr, equiangular) at 32 spp, beams and VRL at 4 spp on
     cbox_medium, with the peak of allocated device memory and K1/K2's
     share of the profiled device time.
 24. gradient domain and MCMC: (a) the rows cbox_path/gradient-path (the
     reconnection shift), gradient-path-explicit (the random-replay
     shift), pssmlt (65,536 chains, 16,384 normalization samples, the path
     tracer at depth 8) and erpt (nb_mc 2, 16 chain samples, depth 6) of
     tools/regression.py:46-124 at its settings (cornell_box(128, 128), 32
     spp, seed 0; the gradient tracers at max_depth 6), each through the
     integrator's own render, each metric held as in phase 20, only K1/K2
     launched; (b) each row's integrator on the card against the CPU at
     32x32, 4 spp: the gradient tracers' lanes (each lane's own values of
     a pass) agree on at least 99.9% of the (pass, lane) pairs, their raw
     films (primal_raw, gradient_x, gradient_y) within 1e-3 on every pixel
     no diverged lane reaches, the means under phase 20's bound (a
     gradient's against its mean absolute value); the MCMC tracers record
     their chains: at least 99.9% of the (chain, step) decisions equal,
     and every pixel that no chain splatted after its first step whose
     decision or proposal's tf (its seed's first) differs within 1e-3; (c)
     each of the four at 512x512 (GM_FULL's spp; ERPT with one round of 4
     chain steps), timed as phase 23 (warm-up at 1 spp; the profile at 1
     spp of gradient-path alone, GM_PROFILED), with its K1/K2 launches,
     peak device memory and busy share.
 25. SMCMC and ATS light sampling: (a) the row cbox_path/smcmc of
     tools/regression.py:111-113 at its settings (cornell_box(128, 128), 32
     spp, seed 0, IntegratorSMCMC(path tracer max_depth = hard_cap = 6,
     recons naive), its independent init), held as phase 20's rows, only
     K1/K2 launched; (b) SMCMC at depth 6 on the card against the CPU at
     32x32, 4 spp, for (independent, naive) and (mcmc, irls), both recording
     their chains: at least MCMC_DECISIONS of the tile chains' (chain, step)
     decisions and of the roaming chains' equal; a tile chain diverges at its
     first init attempt, step decision or proposal's tf that differs (tf by
     more than SCHED_PIX_RTOL) and reaches the pixels within Manhattan
     distance 2 of its tile (its cross and its exchange partners'); the
     naive reconstruction of the flushed accumulators within SCHED_PIX_RTOL
     on every pixel no diverged chain reached, for both; for irls, whose
     solve couples every pixel, the card's IRLS of the CPU's accumulators
     against the CPU's within IRLS_RTOL on every pixel, and where no chain
     diverged the final images within SCHED_PIX_RTOL on every pixel;
     (c) ATS on the card against the CPU at 32x32, 4 spp, under phase 20's
     bounds: the path tracer (depth 6) on cbox and on cbox with an emissive
     UV sphere (a light tree of depth 9), and point-normal (tr, equiangular)
     with -k 0.5 on cbox_medium_single's scene; (d) timed as phase 23
     (warm-up at 1 spp, the profile at 1 spp): SMCMC with the CLI's defaults
     (irls, the mcmc init) at depth 6 on cbox 512x512, 4 spp (its profile:
     one step of the chains kept from one more render, then the IRLS), the
     ATS path tracer (depth 6) on cbox 512x512 at 8 spp (K1/K2) and on
     examples/caustic.pbrt (448x336, depth 8) at EX_FULL_SPP (K3 only),
     each with Mrays/s, its kernels' launches and peak device memory, and
     SMCMC's busy share (the ATS renders unprofiled since phase 27).
 26. path guiding, adaptive sampling, the feature AOVs and the meta
     integrators: (a) the guided path tracer (render_guided, g 16, depth 6)
     on cbox 512x512, 8 passes, timed as phase 23 (K1/K2 only; Mrays/s,
     peak device memory, busy share of a 1-pass profile), its mean within
     2% of phase 3's 128-spp mean; torch.profiler's cost over a 1-spp
     direct render, host and device activities against the device's alone
     (every profile records the device's alone); one guided pass run twice
     on a trained table, its lanes and table bit for bit, and the deposit's
     index_put_ against index_add_ twice each on 262,144 lanes (repeats,
     ms); door_box 40x30 at depth 6 (tests/test_guiding.py:70-87's
     settings), guided and unguided at 64 spp against a 1,024-spp reference
     (the unguided and reference estimates many samples a pixel side by
     side in one wavefront: _wide_render): guided l1 below unguided, the
     means' ratio in (0.5, 2); (b) the guided examples/caustic.pbrt at its
     full size, 4 passes (K3 only; no profile); (c) the card against the
     CPU at 32x32: 4 guided passes (at most 0.1% of the (pass, lane) pairs
     off by more than SCHED_PIX_RTOL, the pixels no diverged lane reached
     within SCHED_PIX_RTOL; each pass once more on the card from the CPU's
     table, the table after it within 1e-5 of the CPU's largest entry),
     render_adaptive at 16 spp (counts equal on 99.9% of the pixels, the
     image under phase 20's bounds), render_feature_aovs at 4 spp (each AOV
     within 1e-5 on 99.9% of the pixels, means within SCHED_MEAN_RTOL); (d)
     the CLI in this process on cbox 128x128: `-a 3 -n 2` twice (bit for
     bit?) and `-a 1` then `-a 3 --resume`, for `path`, `--guiding path`
     and `smcmc` (kept chains): the resumed film equal bit for bit where
     the reruns are, else within 1e-6 relative; `-e 2000` achieving a
     sample or more; (e) render_adaptive (path, depth 6) at 32 spp and
     render_feature_aovs at 8 spp on cbox 512x512, timed as (a) (the
     adaptive render unprofiled since phase 27).
 27. rendering over a device mesh (rustlight_tpu_torch/parallel/), one
     spawn of ranks (run_on_mesh) a part, the kernels built in this
     process first: (a) NCCL with one rank: render_sharded of the path
     tracer (depth 6) on cbox 512x512 at 8 spp and render_splat_sharded of
     the light tracer there at 1 spp, timed (Mrays/s, wall, the
     collectives' ms); at 32x32, 4 spp, the rank's film against a gloo
     rank's on the CPU under phase 20's bounds; (b) two gloo ranks sharing
     the card, staged through the host, at 32x32: every family of the
     mesh (P1 render_sharded, P2/P6 render_splat_sharded, render_adaptive,
     render_guided, PSSMLT and ERPT chain by chain) against two gloo ranks
     on the CPU under phase 20's bounds, both gradient shifts and SMCMC
     against the card's single-device render (lanes that differ counted,
     means within 1e-4), SMCMC's exchange sending boundary rows only;
     (c) the two ranks at full width: path cbox 512x512 and grid122k
     256x256, 8 spp (K3 in both ranks), against one rank (rank 0's rows
     equal, wall, collectives' and staging's ms: what the mesh layer
     costs, not a scaling figure, both ranks on one card); (d) the CLI's
     `-t 2` on the card: one device and the info log, the film bit for bit
     the run's without -t, and `-a 2 -t 2` the same.
 28. the user tools (rustlight_tpu_torch/tools/): (a) the viewer's server
     on 127.0.0.1, port 0, cbox 512x512, the CLI's `path -m 6`: once 8
     passes are in, paused, /img.png fetched over HTTP and decoded by the
     port's PNG reader must equal tonemap_gamma of the running average on
     every pixel, with `uploads` 1; an orbit posted while paused, then
     resumed: the first frame after it is a new accumulation (spp drops,
     then climbs to 8 again), `uploads` still 1, and its first pass equals
     one compute_pixel pass on the card with the orbit camera and pass
     index 0 within 1e-6 on every pixel; /api/scene.json equal to the
     CPU's scene_to_web_json; 16 passes timed with the counts reset and
     rays counted (ops/native.py:counting_rays) while paused: passes/s
     and Mrays/s of served frames, K1/K2 launches a pass, only K1/K2
     launched; then the server and the render thread stopped, both
     checked ended, and no error in the state; (b) `python -m
     rustlight_tpu_torch.tools.regression --check -s cbox_ao cbox_direct
     --out build/regress_phase28` in a subprocess: exit 0, every metric
     equal to phases 20-21's renders of the two rows, its wall; (c)
     smoke_scenes.smoke over examples/ at 128x128, 4 spp: every scene
     finite and not black, only K3 launched on the walk scenes (caustic,
     envglass, fog_box), only K1/K2 on the dense ones.
 29. the walk at other cluster sizes and the labs: (a) at K = 128 and 768,
     on grid122k's mesh (sphere_grid_mesh(122_000, n_theta=10), tables
     built at that K) and 32,768 of the lab's divergent rays with inert,
     empty and bounded lanes, sorted by the walk: K3/K4 closest and any,
     K3w, K5 and the counted walk (K9a), each in its production and its
     one-thread form, against its plain version at that K bit for bit (0
     lanes may differ); K6 at sub 2, K7 and K8 at km 8 the same on tables
     of at most 640 clusters (at K = 128 the same family's 38,880-triangle
     grid); the tensor-core forms of K3, K3w, K5, K6 at sub 2 and K8 under
     _check_mma's rules; the whole walk of the same rays against K = 384's:
     hit masks and occlusion equal, ids equal but on near ties, t bit for
     bit where the triangle is the same; (b) each of the eight labs of
     rustlight_tpu_torch/tools/perf/ (sortkey_lab, grouping_lab,
     greedy_onchip, k_sweep, k_sweep_bench, prim_gather_scale, e2e_131k,
     e2e_4p9M) once through its main at LAB_RUNS' sizes, with the launches
     at other K (ops/native.py:K_LAUNCHES) reset before and read after:
     the kernels line's `walk_closest@K128` and kin take them.
 30. the walk's incidence key (csrc/coherence_key.cu): on grid122k's
     bounce wavefront as the path cell hands it (sphere_grid(122_000) at
     KEY_RES, the path tracer at depth GRID_DEPTH: the first wavefront
     the walk keys by incidence, captured in a 1 spp render; its dead
     lanes replaced by live ones drawn from a seeded generator, so that
     all 2,073,600 lanes are live), the kernel against its plain version
     (counts equal on every lane, the major key on at least KEY_FRAC),
     two launches identical; the wrapper's ms (median of 10 between CUDA
     events), a launch's device us (torch.profiler), the plain version's
     ms on the card, and the bound: KEY_OPS FP32 instructions a lane and
     real cluster over 132 SMs x 128 lanes x clocks.max.sm. Its entry in
     the kernels line gives the measured share of equal major keys and
     the count of lanes whose counts differ (0), in place of an error,
     and the key's launches in the timed renders of phase 6's grids and
     of the AO rows (phases 10-16).

Every line ends with the seconds since the run started. Before the last
line: a JSON line with each kernel's tables and wavefronts
(kernel_cases), the candidate forms' table (a1_forms) and the split forms'
records of K7, K3w and K8 (split_forms), the card line
from nvidia-smi and a JSON line with each kernel's launches, error, times
and bound (the walk's incidence key, a kernel of its preparation, may
launch beside any walk kernel in a launch check). The last line is the JSON status {"ok": true, "device": {...}};
a failed phase raises and prints no status. The run prints its seconds.
The K1/K2 launches of phases 20, 21, 23, 24 and 25's full-width renders,
and the K1/K2/K3 launches of phases 22, 25, 26 and 27's (every rank's) and
of phase 28's timed viewer passes and smoke renders, are added to K1/K2's
and K3's in the kernels line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from typing import Any, NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
N_RAYS = 262_144
CBOX_RES, CBOX_SPP, CBOX_DEPTH = 512, 128, 6
# the whole run's 1,200 s: phase 3's warm-up and phase 4's profile at these
# spp (128 and 8 until phase 24 came, the profile at 2 until phase 26 came),
# phases 8, 14, 16 and 19's profiles at SCHED_PROFILE_SPP (2 until phase
# 24); torch.profiler's host-side processing grows with the launches it
# records (PERF.md, section 6)
CBOX_WARM_SPP, CBOX_PROFILE_SPP, SCHED_PROFILE_SPP = 8, 1, 1
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
                  "mma": "rustlight_tpu_torch/csrc/tri_test_mma.cuh",
                  "key": "rustlight_tpu_torch/csrc/coherence_key.cu"}
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
# phase 20: the regression rows of tools/regression.py:59-75 at its
# settings (32 spp, seed 0), their gate (regression.py:13-16: limit =
# stored * GATE_STORED + GATE_FLOOR * floor); the card against the CPU at
# GATE_CPU_SPP on small images under the grids' bounds (SCHED_*); the
# material configurations of tests/test_oracle.py:85-180 at their depths;
# the full-width renders
GATE_SPP, GATE_STORED, GATE_FLOOR = 32, 1.3, 1.5
GATE_METRICS = ("l1", "l2", "mape", "dssim")
# the profiles at 8 before phase 24, at 2 before phase 26
GATE_CPU_SPP, GATE_PROFILE_SPP = 4, 1
# (the full-width spp were 128 until phase 23 came: the whole run stays
# well inside its 1,200 s)
DIRECT_RES, DIRECT_SPP = 512, 32
VEACH_RES, VEACH_SPP, VEACH_DEPTH = (256, 192), 32, 8
# phase 21: the rows of tools/regression.py:46-83 on the scenes cbox and
# cbox_medium (:51-54), their integrators' depth (:91-94), and the
# full-width renders at the bench's cbox width, at 16 spp: at 128 spp the
# whole run took 933 s of its 1,200 s on an H100 (700 W) with a slow host,
# and phase 23 took the room of the next cut from 32
MEDIUM_SIGMA_S, SLICE_DEPTH = 0.0025, 8
SLICE_RES, SLICE_SPP = 512, 16
# phase 22: the example scenes, their triangle counts and walk tier; the
# card against the CPU at EX_WIDTH pixels wide (the file's aspect kept),
# EX_SPP, depth EX_DEPTH; the furnace; the full-width renders
EXAMPLES = (("cbox.pbrt", 40, False), ("instances.pbrt", 52, False),
            ("caustic.pbrt", 2216, True), ("envglass.xml", 5954, True),
            ("fog_box.xml", 2000, True))
EX_WIDTH, EX_SPP, EX_DEPTH = 32, 4, 8
FURNACE_RES, FURNACE_SPP, FURNACE_DEPTH = 256, 32, 6
EX_FULL = ("envglass.xml", "fog_box.xml", "caustic.pbrt")
# EX_FULL_SPP 16 before phase 23; EX_PROFILE_SPP 2 before phase 24
EX_FULL_SPP, EX_WARM_SPP, EX_PROFILE_SPP = 8, 1, 1
# phase 23: the VPL and volumetric rows of tools/regression.py:46-88 (their
# integrators :100, :124-139; the primitives' rows at 8 spp), two more
# point-normal forms card against CPU, and the full-width renders at the
# bench's cbox width: (label, scene, technique, spp)
VOL_RES, VOL_WARM_SPP, VOL_PROFILE_SPP = 512, 1, 1   # profiles 2 before 24
VOL_FULL = (("vpl", "cbox", "vpl", 8), ("point-normal", "cbox_medium",
                                       "point-normal", 32),
            ("beams", "cbox_medium", "beams", 4),
            ("vrl", "cbox_medium", "vrl", 4))
# phase 24: the gradient-domain and MCMC rows of tools/regression.py:46-83
# (their integrators :105-124); the card against the CPU at GATE_CPU_SPP on
# 32x32: the gradient tracers' (pass, lane) pairs agreeing on at least
# GRAD_LANES of them, the raw buffers within SCHED_PIX_RTOL on the pixels
# that no diverged lane reaches, the means as phase 20's (a gradient
# buffer's mean, near 0, against its mean absolute value); the MCMC
# tracers' (chain, step) decisions equal on at least MCMC_DECISIONS of them
# and the pixels that no diverged chain splatted within SCHED_PIX_RTOL
# (index_add_ sums a pixel's k splats in any order: a relative change of
# about k x 6e-8, k < 2,000 here); the full-width renders (technique,
# spp), timed as phase 23
GM_RES, GM_WARM_SPP, GM_PROFILE_SPP = 512, 1, 1
# the full-width renders of phase 24 profiled (all four until phase 27 came)
GM_PROFILED = ("gradient-path",)
GM_FULL = (("gradient-path", 4), ("gradient-path-explicit", 4),
           ("pssmlt", 8), ("erpt", 8))
# ERPT's work does not grow with spp (nb_mc rounds of chain_samples steps
# over every pixel): at full width one round of 4 steps, so that its
# profile (torch.profiler's host-side processing grows with the launches
# it records) stays near the others'
GM_FULL_ERPT = dict(nb_mc=1, chain_samples=4)
GRAD_BUFFERS = ("primal", "gradient_x", "gradient_y")
GRAD_LANES, MCMC_DECISIONS = 0.999, 0.999
# phase 25: SMCMC's row (tools/regression.py:111-113) and the card against
# the CPU at GATE_CPU_SPP on 32x32 (the card's IRLS of the CPU's
# accumulators within IRLS_RTOL: float64 sums in another order); the
# full-width renders: SMCMC (the CLI's defaults, depth SM_DEPTH) at SM_SPP,
# the ATS path tracer on cbox at ATS_SPP and on ATS_EX at EX_FULL_SPP
SM_DEPTH, SM_RES, SM_SPP = 6, 512, 4
IRLS_RTOL = 1e-5
ATS_SPP, ATS_EX = 8, "caustic.pbrt"
# phase 26: the guided path tracer on cbox (GUIDE_RES, GUIDE_PASSES passes,
# a GUIDE_G^3 grid, depth CBOX_DEPTH), its mean within GUIDE_MEAN_RTOL of
# phase 3's; door_box (DOOR_RES, depth DOOR_DEPTH) guided and unguided at
# DOOR_SPP against a DOOR_REF_SPP reference, tests/test_guiding.py:70-87's
# settings (at 160x120 guiding lost, 0.80x the unguided l1, on the card:
# the 1,024-spp reference's own noise dominates there); examples/caustic.pbrt guided at
# its full size (GUIDE_EX_PASSES); card vs CPU at 32x32 (the guided passes'
# tables within GUIDE_TABLE_RTOL, render_adaptive at ADAPT_CPU_SPP,
# render_feature_aovs at FEAT_CPU_SPP within FEAT_RTOL); -a / --resume
# through the CLI at META_RES (META_PASSES passes of META_SPP), -e META_E_MS;
# render_adaptive at ADAPT_SPP and render_feature_aovs at FEAT_SPP on cbox
# GUIDE_RES
GUIDE_RES, GUIDE_PASSES, GUIDE_G, GUIDE_MEAN_RTOL = 512, 8, 16, 0.02
DOOR_RES, DOOR_DEPTH, DOOR_SPP, DOOR_REF_SPP = (40, 30), 6, 64, 1024
GUIDE_EX_PASSES, GUIDE_CPU_PASSES, GUIDE_TABLE_RTOL = 4, 4, 1e-5
ADAPT_CPU_SPP, FEAT_CPU_SPP, FEAT_RTOL = 16, 4, 1e-5
META_RES, META_PASSES, META_SPP, META_E_MS = 128, 3, 2, 2000
ADAPT_SPP, FEAT_SPP = 32, 8
# the adaptive profile (the pilot of 8 and one pass of extra samples at
# 9 until phase 27 came; its busy share is PERF.md's, PR 18)
ADAPT_PROFILE_SPP = 0
RESUME_RTOL = 1e-6
# phase 27: the mesh. (a) one NCCL rank at MESH_RES (MESH_SPP for the path
# tracer, MESH_LIGHT_SPP for the light tracer), then MESH_SMALL at
# MESH_SMALL_SPP against a gloo rank on the CPU; (b) the families at
# MESH_SMALL on two gloo ranks sharing the card; (c) the two ranks at
# MESH_RES and grid122k at GRID_RES, MESH_SPP, against one rank
MESH_RES, MESH_SPP, MESH_LIGHT_SPP = 512, 8, 1
MESH_SMALL, MESH_SMALL_SPP = 32, 4
MESH_TIMEOUT = 600.0
MESH_GRAD_MEAN, MESH_MEAN_RTOL = 1e-4, 0.01
# phase 28: the user tools. (a) the viewer on cbox VIEWER_RES (the CLI's
# path -m VIEWER_DEPTH), frames checked once VIEWER_SPP passes are in, then
# VIEWER_TIMED passes timed; every wait ends by TOOLS_WAIT_S; (b) the
# regression harness's --check on TOOLS_ROWS; (c) smoke_scenes at
# SMOKE_SIZE, SMOKE_SPP
VIEWER_RES, VIEWER_DEPTH, VIEWER_SPP, VIEWER_TIMED = 512, 6, 8, 16
VIEWER_FIRST_ATOL = 1e-6
TOOLS_WAIT_S = 60.0
TOOLS_ROWS = ("cbox_ao", "cbox_direct")
SMOKE_SIZE, SMOKE_SPP = 128, 4
# phase 30: the incidence key on grid122k's bounce wavefront at the path
# cell's size; its FP32 instructions a lane-cluster pair (6 subtractions, 6
# products, 6 min/max, the comparisons and 3 adds), and the share of lanes
# whose major key must equal the plain version's (tests/test_torch_walk.py:
# INC_KEY_FRAC)
KEY_RES, KEY_OPS, KEY_FRAC, KEY_SEED = (1920, 1080), 22, 0.999, 30
# each phase-20/21 row's metrics, by row, for phase 28's harness run
_GATE_GOT = {}


_T0 = time.time()


def phase(name, msg):
    """A line of the run: [name] msg, then the seconds since the start."""
    print(f"[{name}] {msg} (+{time.time() - _T0:.1f}s)", flush=True)


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


def _pair_form_name(form) -> str:
    """A split form of K8 (threads a pair, runs a block, ring) as text."""
    p, runs, ring = form
    return f"P{p}" + (f" x{runs} runs" if runs > 1 else "") + (
        "+ring" if ring else "")


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
                "walk_hier_closest": f"walk_hier_closest_kernelILb"
                                     f"{int(mma)}EE",
                "walk_hier_anyhit": f"walk_hier_anyhit_kernelILb{int(mma)}EE",
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
    return f"{kernel}_split_kernelILi{p}ELb{int(mma)}EE"


def _pair_symbol(any_hit, mma, form) -> str:
    """The mangled-name fragment of K8's kernel for `any_hit` with the
    tensor-core test `mma` in `form`: a split form (threads a pair, runs a
    block, ring), or ONE_THREAD_FORM for the parent's kernels."""
    if len(form) == 2:
        return ("pair_mma_kernelILb1EE" if mma and any_hit else
                "pair_mma_kernelILb0EE" if mma else
                "pair_anyhit_kernel" if any_hit else "pair_closest_kernel")
    p, runs, ring = (int(x) for x in form)
    return (f"pair_split_kernelILb{int(any_hit)}ELb{int(mma)}ELi{p}ELi{runs}"
            f"ELb{ring}EE")


def _sub_symbol(name, sub, form, mma) -> str:
    """The mangled-name fragment of K6's kernel `name` (walk_sub_closest or
    walk_sub_anyhit) at `sub` in `form` (threads a ray, staged)."""
    p, stage = (int(x) for x in form)
    return f"{name}_kernelILi{sub}ELi{p}ELb{stage}ELb{int(mma)}EE"


def _static_of(sym, usage=None) -> int:
    hits = [v for k, v in (usage or _PTXAS).items() if sym in k]
    if len(hits) != 1:
        raise AssertionError(f"ptxas: {len(hits)} kernels match {sym}")
    return hits[0][1]


def check_static_smem(usage=None, k=384):
    """launch_geometry's static shared memory of every walk kernel in both
    its forms (ops/walk_trace.py:static_smem), K3/K4's, K3w's and K5's
    split form with the tensor-core test too, of K6 in every form built
    (ops/walk_sub.py:static_smem), of K7 in both (ops/walk_sparse.py:
    static_smem) and of K8's split form with both tests
    (ops/pair_trace.py:SPLIT_STATIC), at K = k, against ptxas's report
    `usage` (the production library's by default)."""
    from rustlight_tpu_torch.ops import native
    from rustlight_tpu_torch.ops import walk_sparse as ws
    from rustlight_tpu_torch.ops import walk_sub as wsub
    from rustlight_tpu_torch.ops import walk_trace as wk
    if usage is None:
        if not _PTXAS:
            _PTXAS.update(native.ptxas_usage())
        usage = _PTXAS
    checked = 0
    for name, split in ws.PRODUCTION_FORMS.items():
        for form in (wk.ONE_THREAD_FORM, split):
            sym = _symbol(name, form)
            if _static_of(sym, usage) != ws.static_smem(form, k):
                raise AssertionError(
                    f"{sym} at K = {k}: ptxas {_static_of(sym, usage)} B of "
                    f"static shared memory, launch_geometry "
                    f"{ws.static_smem(form, k)} B")
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
                    if _static_of(sym, usage) != wk.static_smem(kernel, form,
                                                               k):
                        raise AssertionError(
                            f"{sym} at K = {k}: ptxas "
                            f"{_static_of(sym, usage)} B of static shared "
                            f"memory, launch_geometry "
                            f"{wk.static_smem(kernel, form, k)} B")
                    checked += 1
    from rustlight_tpu_torch.ops import pair_trace as pt
    for any_hit in (False, True):
        for mma in (False, True):
            sym = _pair_symbol(any_hit, mma,
                               pt.MMA_FORM if mma else pt.PRODUCTION_FORM)
            if _static_of(sym, usage) != pt.SPLIT_STATIC:
                raise AssertionError(
                    f"{sym} at K = {k}: ptxas {_static_of(sym, usage)} B of "
                    f"static shared memory, ops/pair_trace.py "
                    f"{pt.SPLIT_STATIC} B")
            checked += 1
    for name in wsub.PRODUCTION_FORMS:
        for sub in wsub.SUBS:
            for mma, table in ((False, wsub.PRODUCTION_FORMS),
                               (True, wsub.MMA_FORMS)):
                for form in {wk.ONE_THREAD_FORM, table[name][sub]}:
                    sym = _sub_symbol(name, sub, form, mma)
                    if _static_of(sym, usage) != wsub.static_smem(sub, form):
                        raise AssertionError(
                            f"{sym} at K = {k}: ptxas "
                            f"{_static_of(sym, usage)} B of static shared "
                            f"memory, launch_geometry "
                            f"{wsub.static_smem(sub, form)} B")
                    checked += 1
    phase("ptxas", f"K = {k}: launch_geometry's static shared memory = "
          f"ptxas's on {checked} kernels: both forms of every walk kernel, K3/K4's, "
          "K3w's and K5's split tensor-core forms, K6's forms at every sub "
          "with both tests, K7's forms, K8's split form with both tests")


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


def _render(sd, integ, spp, seed=0, persistent=None):
    """One render of `integ` on `sd`, as the reference's meta.py:
    _render_once dispatches: a splatting integrator through render_splat,
    a self-driving one (gradient domain, MCMC) through its own render, any
    other through render (`persistent` as render takes it)."""
    from rustlight_tpu_torch.integrators import (SplattingIntegrator, render,
                                                 render_splat)
    if isinstance(integ, SplattingIntegrator):
        return render_splat(sd, integ, spp, seed=seed)
    if hasattr(integ, "render"):
        return integ.render(sd, spp, seed=seed)
    return render(sd, integ, spp=spp, seed=seed, persistent=persistent)


def _profile(fn, cpu=False):
    """torch.profiler over one call of `fn`: (wall s, the device kernels'
    key averages, longest total first). It records the device's activity
    alone unless `cpu`: recording the host's ops as well slows the host
    loop it times, and takes two to three times as long to process
    (phase 26 (a) prints both)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
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
    _render(sd, integ, spp, seed=1)
    torch.cuda.synchronize()
    wall, kern = _profile(lambda: _render(sd, integ, spp, seed=1))
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
    from rustlight_tpu_torch.ops import coherence_key as ck
    from rustlight_tpu_torch.ops import dense_trace as dt
    from rustlight_tpu_torch.ops import pair_trace as pt
    from rustlight_tpu_torch.ops import walk_hier as wh
    from rustlight_tpu_torch.ops import walk_lab as wl
    from rustlight_tpu_torch.ops import walk_sparse as ws
    from rustlight_tpu_torch.ops import walk_sub as wsub
    from rustlight_tpu_torch.ops import walk_trace as wk
    return dt, wk, wh, wsub, ws, pt, wl, ck


def _reset_launches():
    for m in _launch_modules():
        m.reset_launches()


def _launches():
    """Every module's launch counts by kernel name, and `<name>_p1` for the
    yardstick forms that K5's and K8's wrappers count apart (P1_LAUNCHES):
    a main path launches none of them, which `_only` checks."""
    out = {k: v for m in _launch_modules() for k, v in m.LAUNCHES.items()}
    for m in _launch_modules():
        out.update({f"{k}_p1": v
                    for k, v in getattr(m, "P1_LAUNCHES", {}).items()})
    return out


def timed_render(label, sd, integ, spp, seed=0, warm_spp=None):
    """Warm-up render (seed 0; `warm_spp` samples, by default `spp`), then a
    timed one (`seed`) with launch counts reset just before and read just
    after. Returns (image, wall s, warm-up s, rays, launches)."""
    import torch
    from rustlight_tpu_torch.ops.native import counting_rays
    t0 = time.time()
    _render(sd, integ, spp if warm_spp is None else warm_spp, seed=0)
    warm = time.time() - t0
    _reset_launches()
    with counting_rays(sd.device) as rays:
        t0 = time.time()
        film = _render(sd, integ, spp, seed=seed)
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


def _pair_forms_vs_parent(tag, wt, pairs, got, plain, rays, km):
    """K8's production split form (its outputs `got`: closest, any hit)
    against the parent's warp-a-pair kernels (`_form=ONE_THREAD_FORM`) and
    against the plain version (`plain`: closest, occlusion), bit for bit: 0
    lanes may differ. The two forms timed in turns (wrapper ms, the layout's
    sort included, and the whole pair walk of the wavefront `rays`), each
    kernel's device us a launch (torch.profiler), and ptxas's lines.
    Returns {kind: record}."""
    import torch
    from rustlight_tpu_torch.accel import pair_walk as pw
    from rustlight_tpu_torch.ops import pair_trace as pt
    from rustlight_tpu_torch.ops.walk_trace import ONE_THREAD_FORM as one
    form = pt.PRODUCTION_FORM
    out = {}
    for kind, fn, new, ref, any_hit in (
            ("closest", pt.pair_closest, got[0], plain[0], False),
            ("anyhit", pt.pair_anyhit, got[1], plain[1], True)):
        old = fn(wt, *pairs, _form=one)
        torch.cuda.synchronize()
        diff = _lanes_differ(new, old).numel()
        diff_p = _lanes_differ(new, ref).numel()
        if diff or diff_p:
            raise AssertionError(f"{tag} {kind}: {_pair_form_name(form)} "
                                 f"differs from the parent's kernel on {diff}"
                                 f" lanes and from the plain version on "
                                 f"{diff_p}")
        rec = {"form": _pair_form_name(form), "lanes_differ": 0,
               **_in_turns(lambda **k: fn(wt, *pairs, **k), one, None)}
        whole = _in_turns(lambda a=any_hit, **k: pw._pairs_impl(
            wt, *rays, a, km, **k), one, None)
        rec.update(walk_ms=whole["ms"], walk_p1_ms=whole["p1_ms"],
                   walk_turns_ms=whole["turns_ms"],
                   device_us=_device_us(lambda: fn(wt, *pairs),
                                        "pair_split_kernel"),
                   p1_device_us=_device_us(
                       lambda: fn(wt, *pairs, _form=one),
                       f"pair_{kind}_kernel"))
        out[kind] = rec
        phase("forms", f"{tag} pair_{kind}: {rec['form']} vs the parent's "
              "kernel (P1) and vs the plain version: 0 lanes differ; P1, "
              "new, new, P1 " + ", ".join(f"{t:.4f}" for t in
                                          rec["turns_ms"])
              + f" ms (ratio {rec['ms'] / rec['p1_ms']:.3f}); device "
              f"{rec['device_us']:.2f} us a launch, P1 "
              f"{rec['p1_device_us']:.2f} (ratio "
              f"{rec['device_us'] / rec['p1_device_us']:.3f}); whole pair "
              "walk P1, new, new, P1 " + ", ".join(
                  f"{t:.4f}" for t in whole["turns_ms"]) + " ms (ratio "
              f"{whole['ms'] / whole['p1_ms']:.3f}); P1 "
              f"{_ptxas(_pair_symbol(any_hit, False, one))}, "
              f"{rec['form']} {_ptxas(_pair_symbol(any_hit, False, form))}")
    return out


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
    """Phase 1: nvcc builds the RL_LAB_FORMS library of K7's, K3w's and
    K8's candidate and laboratory forms (tools/perf/split_forms.py) in a thread
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
            forms = _pair_forms_vs_parent(f"{tag} pair{km}", wt, pairs, got,
                                          (pc[:4], pa[0]), rays, km)
            for kind, err, any_hit, out_b, pms in (
                    ("closest", err_c, False, 16, pms_c),
                    ("anyhit", err_a, True, 1, pms_a)):
                bound, by = _bound_ms(live * K,
                                      m * (PAIR_IN_BYTES + out_b) + table)
                rec[kind] = {
                    "note": f"{live} live of {m} pairs, {100 * over:.1f}% of "
                            "rays overflow",
                    "tests": live * K, "max_abs_err": err,
                    "base_ms": base_ms[kind],
                    "base_walk_ms": base_walk[any_hit],
                    "plain_ms": pms, "bound_ms": bound, "bound_by": by,
                    **forms[kind]}
            _sched_line(tag, f"pair km={km}", rec)
            out[f"pair{km}"].append(rec)
            # K8's candidate forms (tools/perf/split_forms.py)
            from rustlight_tpu_torch.tools.perf import split_forms
            _LAB["records"] += split_forms.pair_forms(
                *lab_library(), wt, pairs, TIMING_RUNS, f"{tag} km={km}")
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
            **{k: rec[kind][k] for k in ("form", "ms", "p1_ms", "device_us",
                                         "p1_device_us", "walk_ms",
                                         "walk_p1_ms", "bound_ms",
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


def _beside(kernels):
    """`kernels` and the kernels that may launch beside them: the walk's
    incidence key (a kernel of the walk's preparation) beside any walk."""
    walks = any(k.startswith(("walk_", "pair_")) for k in kernels)
    return set(kernels) | ({"incidence_key"} if walks else set())


def _only(label, launches, kernels):
    """Fails unless `kernels` launched, and nothing else but what may launch
    beside them (`_beside`)."""
    allowed = _beside(kernels)
    if min(launches[k] for k in kernels) <= 0 or any(
            v for k, v in launches.items() if k not in allowed):
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
        profile_render(tag, sd, integ, SCHED_PROFILE_SPP, ("walk_", "pair_"))
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
        if not set(kernels) <= set(launched) <= _beside(kernels):
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
    tests, the split forms' names)}; a plain version returns its outputs,
    then the count (visits, or live pairs)."""
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
                      _form_name(wk.PRODUCTION_FORMS["walk_hier_closest"])
                      + "/" + _form_name(
                          wk.PRODUCTION_FORMS["walk_hier_anyhit"]))}
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
    """The tensor-core pair kernels on one set of pairs, as _walk_variants
    (the split form against the parent's one-thread tensor-core kernel)."""
    from rustlight_tpu_torch.ops import pair_trace as pt
    return {f"pair{km}": (
        "pair_closest_mma", "pair_anyhit_mma",
        lambda **k: pt.pair_closest(wt, *pairs, **k),
        lambda **k: pt.pair_anyhit(wt, *pairs, **k),
        lambda: pt.pair_closest_ref(wt, *pairs, mxu=True),
        lambda: pt.pair_anyhit_ref(wt, *pairs, mxu=True), 1,
        _pair_form_name(pt.MMA_FORM))}


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
            tests = count * per * wt.k
            bound, by, routes = _mma_bound_ms(
                tests, n * (in_bytes + out_b)
                + (table if resident else count * HIER_VISIT_BYTES
                   * wt.k // wk.K))
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
    whole pair walk timed in turns with the parent's tensor-core kernel.
    Returns {kernel name: [a record per case]}."""
    from rustlight_tpu_torch.accel import pair_walk as pw
    from rustlight_tpu_torch.accel import walk
    from rustlight_tpu_torch.accel.walk import FLAT_MAX_CLUSTERS
    from rustlight_tpu_torch.ops.walk_trace import ONE_THREAD_FORM as one
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
                whole = _in_turns(lambda a=any_hit, **k: pw._pairs_impl(
                    wt_mxu, *rays, a, km, **k), one, None)
                rec.update(walk_ms=whole["ms"], walk_p1_ms=whole["p1_ms"],
                           walk_turns_ms=whole["turns_ms"])
                phase("mma", f"{tag} pair{km} {kname}: the kernel with its "
                      f"cluster runs' sort {rec['ms']:.4f} ms (P1 "
                      f"{rec['p1_ms']:.4f}), the whole pair walk in turns "
                      "with P1: " + ", ".join(
                          f"{t:.4f}" for t in whole["turns_ms"]) + " ms")
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


class _Row(NamedTuple):
    """A regression row of tools/regression.py gated on the card: its
    scene (a maker of width and height), its size, the size of its card
    against CPU check (None: none), its integrator maker, the route
    (`persistent` as render takes it), what the route means for the
    stored row, its spp and the kernels its render launches."""
    name: str
    tech: str
    make: Any
    res: tuple
    small: Any
    integ: Any
    persistent: Any
    route: str
    spp: int = GATE_SPP
    kernels: tuple = ("dense_closest", "dense_anyhit")


def _cbox_medium(w, h):
    """tools/regression.py's cbox_medium scene: the Cornell box in an
    infinite medium of sigma_s 0.0025 (sigma_a 0, isotropic)."""
    from rustlight_tpu_torch.models import cornell_box
    from rustlight_tpu_torch.scene import make_volume
    sc = cornell_box(w, h)
    sc.volume = make_volume(sigma_s=(MEDIUM_SIGMA_S,) * 3)
    return sc


def _gate_rows():
    """The regression rows cbox_direct and veach_mis of tools/
    regression.py:59-75 with the gate of :13-16 (phase 20)."""
    from rustlight_tpu_torch.integrators import (IntegratorDirect,
                                                 IntegratorPathTracing)
    from rustlight_tpu_torch.models import cornell_box, veach_mis
    return [
        _Row("cbox_direct", "direct", cornell_box, (128, 128), (32, 32),
             lambda: IntegratorDirect(nb_bsdf_samples=1, nb_light_samples=1),
             None, "sample for sample: the per-pass route, as the stored "
             "row's"),
        _Row("veach_mis", "path", veach_mis, (128, 96), (32, 24),
             lambda: IntegratorPathTracing(max_depth=VEACH_DEPTH,
                                           hard_cap=VEACH_DEPTH),
             None, "statistical: compute_block, while the stored row came "
             "from the reference's per-pass route"),
    ]


def _slice_rows():
    """The rows cbox_ao/ao, cbox_path/path, cbox_path/light,
    cbox_medium/path, cbox_medium/light and cbox_medium_single/path-single
    of tools/regression.py:46-83 at its integrators (:91-94, :127-129), and
    cbox_medium/path once more through compute_block (phase 21)."""
    from rustlight_tpu_torch.integrators import (IntegratorAO,
                                                 IntegratorLightTracing,
                                                 IntegratorPathTracing)
    from rustlight_tpu_torch.models import cornell_box

    def path():
        return IntegratorPathTracing(max_depth=SLICE_DEPTH,
                                     hard_cap=SLICE_DEPTH)

    def light():
        return IntegratorLightTracing(max_depth=SLICE_DEPTH,
                                      hard_cap=SLICE_DEPTH)

    def single():
        return IntegratorPathTracing(max_depth=2, hard_cap=2, min_depth=1,
                                     single_scattering=True)
    res, small = (128, 128), (32, 32)
    pp = "sample for sample: the per-pass route, as the stored row's"
    splat = ("render_splat, the stored row's route; its scatter-add order "
             "differs")
    return [
        _Row("cbox_ao", "ao", cornell_box, res, small, IntegratorAO, None,
             pp),
        _Row("cbox_path", "path", cornell_box, res, small, path, False, pp),
        _Row("cbox_path", "light", cornell_box, res, small, light, None,
             splat),
        _Row("cbox_medium", "path", _cbox_medium, res, small, path, False,
             pp),
        _Row("cbox_medium", "light", _cbox_medium, res, small, light, None,
             splat),
        _Row("cbox_medium_single", "path-single", _cbox_medium, res, small,
             single, False, pp),
        _Row("cbox_medium", "path", _cbox_medium, res, None, path, True,
             "statistical: compute_block, while the stored row came from "
             "the reference's per-pass route"),
    ]


def _card_vs_cpu(label, make_scene, res, integ, spp, dev, persistent=None,
                 tag="gate", walk=None, use_ats=False):
    """The same render (seed 0) on the card and on the CPU: at least
    SCHED_PIX_FRAC of the pixels within SCHED_PIX_RTOL (relative), means
    within SCHED_MEAN_RTOL. With `tag` "examples" (phase 22) the card's
    render may launch only its tier's kernels: the walk's if `walk` (by
    default the compiled scene's tier), else the dense ones. `use_ats`
    compiles the scene with the ATS light tree."""
    imgs = {}
    for where in (dev, "cpu"):
        sd = make_scene(*res).compile(device=where, use_ats=use_ats)
        tier = sd.geom.walk is not None
        if tag == "examples" and walk is not None and tier != walk:
            raise AssertionError(f"{tag} {label}: tier")
        _reset_launches()
        imgs[str(where)] = _render(sd, integ, spp, seed=0,
                                   persistent=persistent)["primal"]
        if tag == "examples" and where == dev:
            _only(f"{tag} {label}", _launches(),
                  ("walk_closest", "walk_anyhit") if tier
                  else ("dense_closest", "dense_anyhit"))
    a, b = imgs[str(dev)], imgs["cpu"]
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-4)
    frac = float((rel.max(-1) <= SCHED_PIX_RTOL).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
    phase(tag, f"{label} {res[0]}x{res[1]} {spp} spp, card vs CPU: card "
          f"mean {a.mean():.7f}, CPU mean {b.mean():.7f}, {100 * frac:.3f}% "
          f"of pixels within {SCHED_PIX_RTOL}, means differ by "
          f"{mean_rel:.3g} (limits {100 * SCHED_PIX_FRAC:.1f}%, "
          f"{SCHED_MEAN_RTOL})")
    if not (np.all(np.isfinite(a)) and b.mean() > 0):
        raise AssertionError(f"{tag} {label}: bad images")
    if frac < SCHED_PIX_FRAC or mean_rel > SCHED_MEAN_RTOL:
        raise AssertionError(f"{tag} {label}: card and CPU renders disagree")


def _oracle_configs():
    """tests/test_oracle.py:85-180's material configurations of the Cornell
    box: (name, mat_overrides, extra materials, texture atlas, max_depth)."""
    from rustlight_tpu_torch import bsdfs as b
    rng = np.random.default_rng(11)
    tex = (0.2 + 0.6 * rng.random((16, 16, 3))).astype(np.float32)
    return [
        ("phong", {"blocks": b.phong(kd=(0.2,) * 3, ks=(0.5,) * 3,
                                     exponent=50.0, weight_specular=0.5)},
         [], None, 4),
        ("glass", {"blocks": b.glass()}, [], None, 6),
        ("metal", {"blocks": b.metal(alpha=0.25, dist_ggx=False),
                   "right": b.metal(ks=(0.9, 0.4, 0.3), alpha=0.35,
                                    dist_ggx=True)}, [], None, 4),
        ("substrate", {"blocks": b.substrate(kd=(0.4, 0.5, 0.6),
                                             ks=(0.08, 0.08, 0.08),
                                             alpha=0.3)}, [], None, 4),
        ("blend", {"blocks": b.blend(4, 0, 0.4)},
         [b.phong(kd=(0.1,) * 3, ks=(0.6,) * 3, exponent=30.0,
                  weight_specular=0.5)], None, 4),
        ("textured", {"white": b.MaterialDesc(
            kind=b.KIND_DIFFUSE, kd=(0.7, 0.7, 0.7), tex_kind=b.TEX_CHECKER,
            tex_c1=(0.25, 0.25, 0.3), tex_scale=(2.0, 2.0)),
                      "right": b.MaterialDesc(kind=b.KIND_DIFFUSE,
                                              tex_kind=b.TEX_BITMAP,
                                              tex_img=0)}, [], tex[None], 3),
    ]


def _gate_row(row: _Row, dev):
    """Render a row on the card at its spp, seed 0, with only its kernels
    (K1/K2) launched; hold l1, l2, mape and dssim against
    regress/refs/<row>.exr to stored * GATE_STORED + GATE_FLOOR * floor
    (regress/results.json, regress/floors.json); then the card against the
    CPU at the row's small size."""
    import torch
    from rustlight_tpu_torch.utils.image import read_exr
    from rustlight_tpu_torch.utils.metrics import metric_scalar
    regress = os.path.join(ROOT, "regress")
    with open(os.path.join(regress, "results.json")) as f:
        row_rec = json.load(f)[f"{row.name}/{row.tech}"]
    with open(os.path.join(regress, "floors.json")) as f:
        floor = json.load(f)[row.name]
    sd = row.make(*row.res).compile(device=dev)
    _reset_launches()
    t0 = time.time()
    img = _render(sd, row.integ(), row.spp, seed=0,
                  persistent=row.persistent)["primal"]
    torch.cuda.synchronize()
    secs = time.time() - t0
    launched = {k: v for k, v in _launches().items() if v}
    label = f"{row.name}/{row.tech}"
    _only(f"gate {label}", _launches(), row.kernels)
    if img.shape != (row.res[1], row.res[0], 3) or not np.all(
            np.isfinite(img)):
        raise AssertionError(f"gate {label}: bad image {img.shape}")
    ref = read_exr(os.path.join(regress, "refs", f"{row.name}.exr"))
    got = {m: metric_scalar(ref, img, m) for m in GATE_METRICS}
    _GATE_GOT.setdefault(f"{row.name}/{row.tech}", got)
    limit = {m: row_rec[m] * GATE_STORED + GATE_FLOOR * floor[m]
             for m in GATE_METRICS}
    phase("gate", f"{label} {row.res[0]}x{row.res[1]} {row.spp} spp seed 0"
          f" against regress/refs/{row.name}.exr ({row.route}): " + ", ".join(
              f"{m} {got[m]:.6g} (limit {limit[m]:.6g}, stored "
              f"{row_rec[m]:.6g}, {abs(got[m] - row_rec[m]) / row_rec[m]:.2g}"
              " relative)" for m in GATE_METRICS)
          + f"; {secs:.3f}s, launches {launched}")
    bad = [m for m in GATE_METRICS if not got[m] <= limit[m]]
    if bad:
        raise AssertionError(f"gate {label}: {bad} over the limit")
    if row.small is not None:
        _card_vs_cpu(label, row.make, row.small, row.integ(), GATE_CPU_SPP,
                     dev, row.persistent)


def _full_width(label, sd, integ, spp, card, dense, warm_spp=None,
                kernels=None, profile_spp=GATE_PROFILE_SPP, tag="gate",
                before_profile=None, keep=None):
    """A render timed as phase 3 (warm-up, of `warm_spp` samples if given,
    then counts reset and rays counted over a timed render) with only
    `kernels` launched (by default K1/K2), the launches of `dense`'s
    kernels added to it, the peak of allocated device memory over the timed
    render, and the device busy share of a warm `profile_spp` render under
    torch.profiler (after `before_profile()`, if given; none with
    `profile_spp` 0). Returns (busy share, the share of device time of the
    kernels in `dense`); the timed render's image goes to keep["img"] when
    `keep` is given."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    img, wall, warm, n_rays, launches = timed_render(label, sd, integ, spp,
                                                     warm_spp=warm_spp)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if keep is not None:
        keep["img"] = img
    _only(f"{tag} {label}", launches, kernels or tuple(dense))
    for k in dense:
        dense[k] += launches[k]
    if before_profile is not None:
        before_profile()
    busy = ours = None
    if profile_spp:
        busy, ours = profile_render(
            label, sd, integ, profile_spp,
            tuple(sorted({k.split("_")[0] + "_" for k in dense})), top=6)
    busy_s = "not measured" if busy is None else f"{100 * busy:.1f}%"
    phase(tag, f"{label} {spp} spp: warm-up {warm:.3f}s"
          + ("" if warm_spp is None else f" ({warm_spp} spp)") + ", timed "
          f"{wall:.3f}s, {n_rays} rays, {n_rays / wall / 1e6:.3f} "
          f"Mrays/s, mean {img.mean():.6f}, peak device memory "
          f"{peak:.2f} GiB, device busy {busy_s}"
          + (f" (of a warm {profile_spp} spp render)" if profile_spp else "")
          + ", launches " + ", ".join(
              f"{k} {launches[k]}" for k in dense) + f" | {card}")
    return busy, ours


def gate_phase(dev, card):
    """Phase 20. Returns the dense kernels' launches of the two full-width
    renders (counts reset just before each timed render, read just
    after)."""
    from rustlight_tpu_torch.integrators import (IntegratorDirect,
                                                 IntegratorPathTracing)
    from rustlight_tpu_torch.models import cornell_box, veach_mis
    for row in _gate_rows():
        _gate_row(row, dev)
    for cname, ov, extra, tex, depth in _oracle_configs():
        def make(w, h, ov=ov, extra=extra, tex=tex):
            sc = cornell_box(w, h, mat_overrides=ov)
            for d in extra:
                sc.add_material(d)
            sc.textures = tex
            return sc
        _card_vs_cpu(f"cbox-{cname} path depth {depth}", make, (32, 32),
                     IntegratorPathTracing(max_depth=depth), GATE_CPU_SPP,
                     dev)
    dense = {"dense_closest": 0, "dense_anyhit": 0}
    _full_width(f"direct cbox {DIRECT_RES}x{DIRECT_RES}",
                cornell_box(DIRECT_RES, DIRECT_RES).compile(device=dev),
                IntegratorDirect(1, 1), DIRECT_SPP, card, dense)
    _full_width(f"path veach_mis {VEACH_RES[0]}x{VEACH_RES[1]} depth "
                f"{VEACH_DEPTH}", veach_mis(*VEACH_RES).compile(device=dev),
                IntegratorPathTracing(max_depth=VEACH_DEPTH), VEACH_SPP, card,
                dense)
    return dense


def slice_phase(dev, card):
    """Phase 21. Returns the dense kernels' launches of its two full-width
    renders. Their warm-ups take GATE_PROFILE_SPP samples: a pass of the
    light tracer and an iteration of compute_block are the same work at
    any spp, and the run stays well inside its time limit."""
    from rustlight_tpu_torch.integrators import (IntegratorLightTracing,
                                                 IntegratorPathTracing)
    from rustlight_tpu_torch.models import cornell_box
    for row in _slice_rows():
        _gate_row(row, dev)
    dense = {"dense_closest": 0, "dense_anyhit": 0}
    _full_width(f"light cbox {SLICE_RES}x{SLICE_RES} depth {SLICE_DEPTH}",
                cornell_box(SLICE_RES, SLICE_RES).compile(device=dev),
                IntegratorLightTracing(max_depth=SLICE_DEPTH,
                                       hard_cap=SLICE_DEPTH), SLICE_SPP, card,
                dense, warm_spp=GATE_PROFILE_SPP)
    _full_width(f"path cbox_medium {SLICE_RES}x{SLICE_RES} depth "
                f"{SLICE_DEPTH} (compute_block)",
                _cbox_medium(SLICE_RES, SLICE_RES).compile(device=dev),
                IntegratorPathTracing(max_depth=SLICE_DEPTH), SLICE_SPP, card,
                dense, warm_spp=GATE_PROFILE_SPP)
    return dense


def _volume_integrators():
    """tools/regression.py's integrators of phase 23's rows (:100,
    :124-139), by technique."""
    from rustlight_tpu_torch.integrators import (IntegratorPointNormal,
                                                 IntegratorSinglePlane,
                                                 IntegratorVolPrimitives,
                                                 IntegratorVPL)

    def prims(p):
        return lambda: IntegratorVolPrimitives(
            nb_primitive=1024, max_depth=6, hard_cap=6, primitives=p,
            radius=8.0)
    return {
        "vpl": lambda: IntegratorVPL(nb_vpl=256, max_depth=6, hard_cap=6),
        "point-normal": lambda: IntegratorPointNormal(
            strategies=("tr", "equiangular")),
        "plane-single": lambda: IntegratorSinglePlane(nb_primitive=256,
                                                      strategy="average"),
        "plane-single-unc": lambda: IntegratorSinglePlane(
            nb_primitive=256, strategy="average", uncorrelated=True),
        **{p: prims(p) for p in ("bre", "beams", "planes", "vrl")}}


def _volume_rows():
    """The rows cbox_path/vpl, cbox_medium_single/{point-normal,
    plane-single, plane-single-unc} and cbox_medium_prims/{bre, beams,
    planes, vrl} of tools/regression.py:46-88 (phase 23): the per-pass
    route, as the stored rows; the primitives at 8 spp; BRE and beams
    trace no shadow ray (K1 only)."""
    from rustlight_tpu_torch.models import cornell_box
    integ = _volume_integrators()
    res, small = (128, 128), (32, 32)
    pp = "sample for sample: the per-pass route, as the stored row's"
    rows = [_Row("cbox_path", "vpl", cornell_box, res, small, integ["vpl"],
                 None, pp)]
    rows += [_Row("cbox_medium_single", t, _cbox_medium, res, small, integ[t],
                  None, pp) for t in ("point-normal", "plane-single",
                                      "plane-single-unc")]
    rows += [_Row("cbox_medium_prims", p, _cbox_medium, res, small, integ[p],
                  None, pp, spp=8,
                  kernels=(("dense_closest",) if p in ("bre", "beams")
                           else ("dense_closest", "dense_anyhit")))
             for p in ("bre", "beams", "planes", "vrl")]
    return rows


def volume_phase(dev, card):
    """Phase 23. Returns the dense kernels' launches of its full-width
    renders (counts reset just before each timed render, read just
    after)."""
    from rustlight_tpu_torch.integrators import IntegratorPointNormal
    from rustlight_tpu_torch.models import cornell_box
    for row in _volume_rows():
        _gate_row(row, dev)
    # point-normal's phase connection and its product samplers, card
    # against CPU only (no stored row)
    for label, kw in (
            ("point-normal phase connection", dict(
                strategies=("tr", "equiangular"), connection="phase")),
            ("point-normal tr+equiangular+best+pn_taylor_tr", dict(
                strategies=("tr", "equiangular", "best", "pn_taylor_tr")))):
        _card_vs_cpu(f"cbox_medium_single/{label}", _cbox_medium, (32, 32),
                     IntegratorPointNormal(**kw), GATE_CPU_SPP, dev,
                     tag="volume")
    dense = {"dense_closest": 0, "dense_anyhit": 0}
    integ = _volume_integrators()
    shares = []
    for label, scene, tech, spp in VOL_FULL:
        make = cornell_box if scene == "cbox" else _cbox_medium
        busy, ours = _full_width(
            f"{label} {scene} {VOL_RES}x{VOL_RES}",
            make(VOL_RES, VOL_RES).compile(device=dev), integ[tech](), spp,
            card, dense, warm_spp=VOL_WARM_SPP,
            kernels=(("dense_closest",) if tech in ("bre", "beams")
                     else ("dense_closest", "dense_anyhit")),
            profile_spp=VOL_PROFILE_SPP, tag="volume")
        shares.append(f"{label} " + ("not measured" if ours is None else
                                     f"{100 * ours:.1f}%"))
    phase("volume", "K1/K2's share of device time in the full-width "
          "renders' profiles (the rest: the gathers' and the light paths' "
          "elementwise kernels, the RNG): " + ", ".join(shares))
    return dense


def _gm_integrators():
    """tools/regression.py's integrators of phase 24's rows (:105-124), by
    technique."""
    from rustlight_tpu_torch.integrators import IntegratorPathTracing
    from rustlight_tpu_torch.integrators.gradient import (
        IntegratorGradientPath, IntegratorGradientPathReconnect)
    from rustlight_tpu_torch.integrators.mcmc import (IntegratorERPT,
                                                      IntegratorPSSMLT)
    return {
        "gradient-path": lambda: IntegratorGradientPathReconnect(max_depth=6),
        "gradient-path-explicit": lambda: IntegratorGradientPath(max_depth=6),
        "pssmlt": lambda: IntegratorPSSMLT(
            IntegratorPathTracing(max_depth=8, hard_cap=8),
            nb_samples_norm=16384, nb_chains=65536),
        "erpt": lambda **kw: IntegratorERPT(
            IntegratorPathTracing(max_depth=6, hard_cap=6), **{
                **dict(nb_mc=2, chain_samples=16, nb_samples_norm=16384),
                **kw})}


def _agree_buffer(tag, label, name, a, b, signed):
    """Phase 20's pixel bounds on one buffer, card `a` against CPU `b`
    (at least SCHED_PIX_FRAC of the pixels within SCHED_PIX_RTOL, relative
    with a 1e-4 floor; the means within SCHED_MEAN_RTOL of the CPU's mean,
    or for a `signed` buffer of its mean absolute value). Returns the
    line's text."""
    if not (np.all(np.isfinite(a)) and np.abs(b).mean() > 0):
        raise AssertionError(f"{tag} {label} {name}: bad images")
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-4)
    frac = float((rel.max(-1) <= SCHED_PIX_RTOL).mean())
    scale = float(np.abs(b).mean()) if signed else float(b.mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / scale
    if frac < SCHED_PIX_FRAC or mean_rel > SCHED_MEAN_RTOL:
        raise AssertionError(f"{tag} {label} {name}: card and CPU disagree "
                             f"({100 * frac:.3f}%, {mean_rel:.3g})")
    return (f"{name} {100 * frac:.3f}% within {SCHED_PIX_RTOL}, means "
            f"{a.mean():.7f} / {b.mean():.7f} ({mean_rel:.3g} of "
            f"{'its mean |x|' if signed else 'the mean'})")


def _gradient_lanes(integ, sd, s):
    """Each lane's own values of pass s (stream_fold(make_stream(0), s))
    before the film's rolls, [n, k] on the host: the reconnection shift's
    l_main, l_off, l_grad and very_direct; the random-replay shift's base
    and four offset evaluations of the same primary samples."""
    import torch
    from rustlight_tpu_torch.integrators.common import _pixel_grid
    from rustlight_tpu_torch.integrators.gradient.path import _OFFSETS
    from rustlight_tpu_torch.utils.rng import (make_stream, stream_fold,
                                               stream_next)
    w, h = sd.camera.width, sd.camera.height
    pix = torch.as_tensor(_pixel_grid(w, h), device=sd.device)
    stream = stream_fold(make_stream(0, sd.device), s)
    if hasattr(integ, "compute_pixel_gradient"):
        l_main, l_off, l_grad, vd = integ.compute_pixel_gradient(
            sd, pix, stream, integ.has_delta(sd))
        vals = [l_main, *l_off, *l_grad, vd]
    else:
        u, _ = stream_next(stream, (w * h, integ.pss_dims))
        vals = [integ._eval(sd, pix, u)] + [integ._eval(sd, torch.stack([
            torch.clamp(pix[:, 0] + dx, 0, w - 1),
            torch.clamp(pix[:, 1] + dy, 0, h - 1)], -1), u)
            for dy, dx, _, _ in _OFFSETS]
    return torch.cat(vals, 1).cpu().numpy()


def _gradient_card_vs_cpu(label, make_integ, dev):
    """A gradient tracer at 32x32, GATE_CPU_SPP passes, seed 0 on the card
    and on the CPU. A lane of a pass diverged where any of its own values
    (_gradient_lanes) is off by more than SCHED_PIX_RTOL (relative, 1e-4
    floor): at least GRAD_LANES of the (pass, lane) pairs may not; the
    films' primal_raw, gradient_x and gradient_y within SCHED_PIX_RTOL on
    every pixel that no diverged lane reaches (the lane and its four
    offset pixels); the reconstructed primal's and the gradients' means as
    phase 20's (a gradient's against its mean absolute value). The
    reconnection shift's rays graze edges: a hit point's last bit can
    flip a lane, and the Poisson solve spreads it over its neighbours."""
    from rustlight_tpu_torch.models import cornell_box
    films, lanes = {}, {}
    for where in (dev, "cpu"):
        sd = cornell_box(32, 32).compile(device=where)
        integ = make_integ()
        films[str(where)] = integ.render(sd, GATE_CPU_SPP, seed=0)
        lanes[str(where)] = [_gradient_lanes(integ, sd, s)
                             for s in range(GATE_CPU_SPP)]
    keep = np.ones((32, 32), bool)
    n_div = 0
    for a, b in zip(lanes[str(dev)], lanes["cpu"]):
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-4)
        div = (rel.max(-1) > SCHED_PIX_RTOL).reshape(32, 32)
        n_div += int(div.sum())
        for y, x in zip(*np.nonzero(div)):
            for dy, dx in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)):
                if 0 <= y + dy < 32 and 0 <= x + dx < 32:
                    keep[y + dy, x + dx] = False
    total = GATE_CPU_SPP * 32 * 32
    fa, fb = films[str(dev)], films["cpu"]
    worst = {k: float((np.abs(fa[k] - fb[k]) / np.maximum(
        np.abs(fb[k]), 1e-4)).max(-1)[keep].max())
        for k in ("primal_raw", "gradient_x", "gradient_y")}
    means = {}
    for k in GRAD_BUFFERS:
        scale = float(np.abs(fb[k]).mean()) if k != "primal" else float(
            fb[k].mean())
        means[k] = abs(float(fa[k].mean()) - float(fb[k].mean())) / scale
    rel_p = np.abs(fa["primal"] - fb["primal"]) / np.maximum(
        np.abs(fb["primal"]), 1e-4)
    phase("gm", f"{label} 32x32 {GATE_CPU_SPP} spp, card vs CPU: "
          f"{n_div} of {total} (pass, lane) pairs diverged (limit "
          f"{100 * (1 - GRAD_LANES):.1f}%); on the {int(keep.sum())} pixels "
          "no diverged lane reaches, worst relative difference " + ", ".join(
              f"{k} {v:.3g}" for k, v in worst.items())
          + f" (limit {SCHED_PIX_RTOL}); means off by " + ", ".join(
              f"{k} {v:.3g}" for k, v in means.items())
          + f" (limit {SCHED_MEAN_RTOL}); the reconstructed primal "
          f"{100 * float((rel_p.max(-1) <= SCHED_PIX_RTOL).mean()):.3f}% of "
          f"pixels within {SCHED_PIX_RTOL}")
    if (n_div > (1 - GRAD_LANES) * total or max(worst.values()) >
            SCHED_PIX_RTOL or max(means.values()) > SCHED_MEAN_RTOL):
        raise AssertionError(f"gm {label}: card and CPU disagree")


def _diverged_pixels(a, b):
    """The pixels that a chain splatted, on either side, from its first
    step whose decision differs or whose tf differs by more than
    SCHED_PIX_RTOL (the initial state's tf first: a step's proposal's
    after). `a`, `b`: (accepts [runs, steps, lanes], visits [runs, steps +
    1, lanes] with the flush last, tfs [runs, steps + 1, lanes] with the
    initial state's first). Returns (pixels, diverged chains)."""
    (acc_a, vis_a, tf_a), (acc_b, vis_b, tf_b) = a, b
    off = np.abs(tf_a - tf_b) > SCHED_PIX_RTOL * np.maximum(np.abs(tf_b),
                                                            1e-4)
    # step t diverges where its decision or its proposal differs; a
    # chain whose initial state differs diverges at step 0
    diff = (acc_a != acc_b) | off[:, 1:]
    diff[:, 0] |= off[:, 0]
    out, chains = set(), 0
    for r, lane in zip(*np.nonzero(diff.any(1))):
        t = int(np.argmax(diff[r, :, lane]))
        out.update(vis_a[r, t:, lane].tolist())
        out.update(vis_b[r, t:, lane].tolist())
        chains += 1
    return out, chains


def _mcmc_card_vs_cpu(label, make_integ, dev):
    """An MCMC tracer at 32x32, GATE_CPU_SPP, seed 0 on the card and on the
    CPU, both recording their chains: at least MCMC_DECISIONS of the
    (chain, step) decisions equal, and the pixels that no diverged chain
    splatted (_diverged_pixels) within SCHED_PIX_RTOL (relative, 1e-4
    floor)."""
    from rustlight_tpu_torch.models import cornell_box
    run, rec = {}, {}
    for where in (dev, "cpu"):
        integ = make_integ()
        integ.record_accepts = True
        run[str(where)] = integ.render(
            cornell_box(32, 32).compile(device=where), GATE_CPU_SPP,
            seed=0)["primal"]
        rec[str(where)] = (integ.accepts, integ.visits, integ.tfs)
    _mcmc_agree("gm", label, run[str(dev)], rec[str(dev)], run["cpu"],
                rec["cpu"])


def _mcmc_agree(tag, label, a, rec_a, b, rec_b):
    """Two MCMC renders at 32x32, GATE_CPU_SPP, chain by chain: image `a`
    with its chains' records `rec_a` (accepts, visits, tfs) on the card,
    `b` with `rec_b` on the CPU. At least MCMC_DECISIONS of the decisions
    equal, the pixels that no diverged chain splatted within
    SCHED_PIX_RTOL."""
    if not (np.all(np.isfinite(a)) and b.mean() > 0):
        raise AssertionError(f"{tag} {label}: bad images")
    acc_a, acc_b = rec_a[0], rec_b[0]
    same = float((acc_a == acc_b).mean())
    touched, chains = _diverged_pixels(rec_a, rec_b)
    keep = np.ones(32 * 32, bool)
    keep[sorted(touched)] = False
    rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-4)).max(-1).reshape(-1)
    worst = float(rel[keep].max())
    phase(tag, f"{label} 32x32 {GATE_CPU_SPP} spp, card vs CPU: "
          f"{acc_a.size} decisions ({100 * acc_a.mean():.2f}% accepted), "
          f"{100 * same:.4f}% equal (limit {100 * MCMC_DECISIONS:.1f}%); "
          f"{chains} of {acc_a.shape[0] * acc_a.shape[2]} chains diverged, "
          f"{int(keep.sum())} of 1024 pixels none of them touched, worst "
          f"relative difference there {worst:.3g} (limit {SCHED_PIX_RTOL}); "
          f"means {a.mean():.7f} / {b.mean():.7f}")
    if same < MCMC_DECISIONS or worst > SCHED_PIX_RTOL:
        raise AssertionError(f"{tag} {label}: card and CPU disagree")


def gradient_mcmc_phase(dev, card):
    """Phase 24. Returns the dense kernels' launches of its full-width
    renders (counts reset just before each timed render, read just
    after)."""
    from rustlight_tpu_torch.models import cornell_box
    integ = _gm_integrators()
    route = ("the stored row's integrator and route; sample for sample on "
             "the gradient rows, the chains' decisions within an ulp's "
             "flips on the MCMC rows")
    for tech in integ:
        _gate_row(_Row("cbox_path", tech, cornell_box, (128, 128), None,
                       integ[tech], None, route), dev)
    for tech in ("gradient-path", "gradient-path-explicit"):
        _gradient_card_vs_cpu(f"cbox_path/{tech}", integ[tech], dev)
    for tech in ("pssmlt", "erpt"):
        _mcmc_card_vs_cpu(f"cbox_path/{tech}", integ[tech], dev)
    dense = {"dense_closest": 0, "dense_anyhit": 0}
    shares = []
    for tech, spp in GM_FULL:
        kw = GM_FULL_ERPT if tech == "erpt" else {}
        busy, ours = _full_width(
            f"{tech} cbox {GM_RES}x{GM_RES}" + "".join(
                f" {k} {v}" for k, v in kw.items()),
            cornell_box(GM_RES, GM_RES).compile(device=dev), integ[tech](**kw),
            spp, card, dense, warm_spp=GM_WARM_SPP,
            profile_spp=GM_PROFILE_SPP if tech in GM_PROFILED else 0,
            tag="gm")
        shares.append(f"{tech} " + ("not measured" if ours is None else
                                    f"{100 * ours:.1f}%"))
    phase("gm", "K1/K2's share of device time in the full-width renders' "
          "profiles: " + ", ".join(shares))
    return dense


def _sphere_lit(w, h):
    """The Cornell box with an emissive 8x8 UV sphere: a light tree of depth
    9 (tests/test_torch_ats.py's scene)."""
    from rustlight_tpu_torch.models import cornell_box
    from rustlight_tpu_torch.scene import make_sphere
    sc = cornell_box(w, h)
    sc.add_mesh(make_sphere((278.0, 330.0, 280.0), 60.0,
                            emission=(4.0, 3.0, 2.0), n_theta=8, n_phi=8))
    return sc


def _smcmc(**kw):
    """IntegratorSMCMC over the path tracer at max_depth = hard_cap =
    SM_DEPTH (tools/regression.py:111-113's inner integrator)."""
    from rustlight_tpu_torch.integrators import IntegratorPathTracing
    from rustlight_tpu_torch.integrators.mcmc import IntegratorSMCMC
    return IntegratorSMCMC(IntegratorPathTracing(max_depth=SM_DEPTH,
                                                 hard_cap=SM_DEPTH), **kw)


def _smcmc_reach(a, b, w, h):
    """The tile chains that diverged between records `a` and `b` (each
    (init_tfs [k, n], accepts [1, steps, n], tfs [1, steps + 1, n])) at
    their first init attempt, decision or proposal's tf that differs (tf by
    more than SCHED_PIX_RTOL, relative with a 1e-4 floor), and the pixels
    they reach: within Manhattan distance 2 of the tile, its cross and its
    exchange partners'. Returns (reached [n] bool, diverged chains)."""
    def off(x, y):
        return np.abs(x - y) > SCHED_PIX_RTOL * np.maximum(np.abs(y), 1e-4)
    (itf_a, acc_a, tf_a), (itf_b, acc_b, tf_b) = a, b
    div = (off(itf_a, itf_b).any(0) | off(tf_a[0], tf_b[0]).any(0)
           | (acc_a[0] != acc_b[0]).any(0) | off(tf_a[0, 1:],
                                                 tf_b[0, 1:]).any(0))
    ys, xs = np.divmod(np.nonzero(div)[0], w)
    yy, xx = np.mgrid[0:h, 0:w]
    reached = np.zeros((h, w), bool)
    for y, x in zip(ys, xs):
        reached |= (np.abs(yy - y) + np.abs(xx - x)) <= 2
    return reached.reshape(-1), int(div.sum())


def _smcmc_card_vs_cpu(label, make_integ, dev):
    """SMCMC at 32x32, GATE_CPU_SPP, seed 0 on the card and on the CPU, both
    recording their chains: at least MCMC_DECISIONS of the tile chains' and
    of the roaming chains' decisions equal; the naive reconstruction of the
    flushed accumulators within SCHED_PIX_RTOL on every pixel no diverged
    chain reached (_smcmc_reach). With IRLS, whose solve couples every
    pixel: the card's solve of the CPU's accumulators against the CPU's
    within IRLS_RTOL on every pixel, and the final images within
    SCHED_PIX_RTOL on every pixel where no chain diverged."""
    from rustlight_tpu_torch.integrators.mcmc import smcmc as sm
    from rustlight_tpu_torch.models import cornell_box
    run, rec, integ = {}, {}, {}
    for where in (dev, "cpu"):
        g = make_integ()
        g.record_accepts = True
        run[str(where)] = g.render(cornell_box(32, 32).compile(device=where),
                                   GATE_CPU_SPP, seed=0)["primal"]
        rec[str(where)] = (g.init_tfs, g.accepts, g.tfs)
        integ[str(where)] = g
    ga, gb = integ[str(dev)], integ["cpu"]
    a, b = run[str(dev)], run["cpu"]
    if not (np.all(np.isfinite(a)) and b.mean() > 0):
        raise AssertionError(f"smcmc {label}: bad images")
    same = float((ga.accepts == gb.accepts).mean())
    roam = ("no roaming chains" if gb.init_accepts is None else
            f"roaming chains' {ga.init_accepts.size} decisions "
            f"{100 * float((ga.init_accepts == gb.init_accepts).mean()):.4f}"
            "% equal")
    same_roam = (1.0 if gb.init_accepts is None else
                 float((ga.init_accepts == gb.init_accepts).mean()))
    reached, chains = _smcmc_reach(rec[str(dev)], rec["cpu"], 32, 32)
    lay = {w: sm.make_layout(32, 32, w) for w in (dev, "cpu")}
    naive = [sm.naive_reconstruction(g.flushed, lay[w].cross_valid,
                                     lay[w].cross_pid).cpu().numpy()
             for g, w in ((ga, dev), (gb, "cpu"))]
    rel = (np.abs(naive[0] - naive[1]) / np.maximum(np.abs(naive[1]), 1e-4)
           ).max(-1)
    worst = float(rel[~reached].max()) if (~reached).any() else 0.0
    ok = same >= MCMC_DECISIONS and same_roam >= MCMC_DECISIONS and (
        worst <= SCHED_PIX_RTOL)
    line = (f"{label} 32x32 {GATE_CPU_SPP} spp, card vs CPU: "
            f"{ga.accepts.size} tile decisions ({100 * ga.accepts.mean():.2f}%"
            f" accepted), {100 * same:.4f}% equal, {roam} (limit "
            f"{100 * MCMC_DECISIONS:.1f}%); {chains} of {32 * 32} tile chains"
            f" diverged, {int((~reached).sum())} of 1024 pixels none of them "
            f"reached, the accumulators' naive reconstruction there within "
            f"{worst:.3g} (limit {SCHED_PIX_RTOL})")
    if ga.recons == "irls":
        cpu = gb.flushed
        mine = sm.irls_reconstruction(
            *(x.to(dev) for x in (cpu.acc_v, cpu.acc_mc, cpu.nb_s, cpu.b_acc,
                                  cpu.nb_u)), lay[dev].cross_valid,
            lay[dev].cross_pid, 32, 32).cpu().numpy()
        theirs = sm.irls_reconstruction(
            cpu.acc_v, cpu.acc_mc, cpu.nb_s, cpu.b_acc, cpu.nb_u,
            lay["cpu"].cross_valid, lay["cpu"].cross_pid, 32, 32).numpy()
        solve = float((np.abs(mine - theirs)
                       / np.maximum(np.abs(theirs), 1e-6)).max())
        whole = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-4)).max())
        ok = ok and solve <= IRLS_RTOL and (chains > 0
                                            or whole <= SCHED_PIX_RTOL)
        line += (f"; the IRLS solve of the CPU's accumulators, card vs CPU, "
                 f"within {solve:.3g} (limit {IRLS_RTOL}); the final images "
                 f"within {whole:.3g} (limit {SCHED_PIX_RTOL} where no chain"
                 " diverged)")
    phase("smcmc", line + f"; means {a.mean():.7f} / {b.mean():.7f}")
    if not ok:
        raise AssertionError(f"smcmc {label}: card and CPU disagree")


def smcmc_ats_phase(dev, card):
    """Phase 25. Returns the K1/K2/K3 launches of its full-width renders
    (counts reset just before each timed render, read just after)."""
    from rustlight_tpu_torch import cli
    from rustlight_tpu_torch.integrators import (IntegratorPathTracing,
                                                 IntegratorPointNormal)
    from rustlight_tpu_torch.models import cornell_box
    _gate_row(_Row("cbox_path", "smcmc", cornell_box, (128, 128), None,
                   lambda: _smcmc(recons="naive"), None,
                   "the stored row's integrator and route; the chains' "
                   "decisions within an ulp's flips"), dev)
    for init, recons in (("independent", "naive"), ("mcmc", "irls")):
        _smcmc_card_vs_cpu(f"cbox_path/smcmc {init} {recons}",
                           lambda: _smcmc(init=init, recons=recons), dev)
    path = IntegratorPathTracing(max_depth=CBOX_DEPTH)
    for label, make, integ in (
            (f"cbox path depth {CBOX_DEPTH}", cornell_box, path),
            (f"cbox + emissive sphere path depth {CBOX_DEPTH}", _sphere_lit,
             path),
            ("cbox_medium_single point-normal -k 0.5", _cbox_medium,
             IntegratorPointNormal(strategies=("tr", "equiangular"),
                                   splitting=0.5))):
        _card_vs_cpu(f"{label}, ATS", make, (32, 32), integ, GATE_CPU_SPP,
                     dev, tag="ats", use_ats=True)
    dense = {"dense_closest": 0, "dense_anyhit": 0}
    walk = {"walk_closest": 0, "walk_anyhit": 0}
    integ = cli.build_integrator(cli.build_parser().parse_args(
        ["cbox", "smcmc", "-m", str(SM_DEPTH)]))
    sd = cornell_box(SM_RES, SM_RES).compile(device=dev)

    def keep():
        # the profile renders continue these chains one step each
        integ.keep_chains = True
        _render(sd, integ, 1)
    shares = []
    busy, ours = _full_width(
        f"smcmc (CLI defaults: {integ.recons}, {integ.init} init) cbox "
        f"{SM_RES}x{SM_RES} depth {SM_DEPTH}", sd, integ, SM_SPP, card,
        dense, warm_spp=1, profile_spp=1, tag="smcmc",
        before_profile=keep)
    shares.append(("smcmc", busy, ours))
    del sd
    busy, ours = _full_width(
        f"path cbox {SM_RES}x{SM_RES} depth {CBOX_DEPTH}, ATS",
        cornell_box(SM_RES, SM_RES).compile(device=dev, use_ats=True),
        path, ATS_SPP, card, dense, warm_spp=1, profile_spp=0, tag="ats")
    shares.append(("ats cbox", busy, ours))
    ex = _example(ATS_EX).compile(device=dev, use_ats=True)
    busy, ours = _full_width(
        f"path {ATS_EX} {ex.camera.width}x{ex.camera.height} depth "
        f"{EX_DEPTH}, ATS", ex, IntegratorPathTracing(max_depth=EX_DEPTH),
        EX_FULL_SPP, card, walk, warm_spp=EX_WARM_SPP, profile_spp=0,
        tag="ats")
    shares.append((f"ats {ATS_EX}", busy, ours))
    phase("smcmc", "the trace kernels' share of device time in the "
          "full-width renders' profiles: " + ", ".join(
              f"{name} " + ("not measured" if ours is None else
                            f"{100 * ours:.1f}%") for name, _, ours in shares))
    return {**dense, **walk}


class _Guided:
    """render_guided as a self-driving integrator: every render starts from
    a cold table (IntegratorGuidedPath would carry it over)."""

    def __init__(self, integ, g):
        self.integ, self.g = integ, g

    def render(self, sd, spp, seed=0):
        from rustlight_tpu_torch.integrators.guiding import render_guided
        return render_guided(sd, self.integ, spp, seed=seed, g=self.g)


class _Adaptive:
    """render_adaptive over `integ` as a self-driving integrator."""

    def __init__(self, integ):
        self.integ = integ

    def render(self, sd, spp, seed=0):
        from rustlight_tpu_torch.integrators.common import render_adaptive
        return render_adaptive(sd, self.integ, spp, seed=seed)


class _Features:
    """render_feature_aovs as a self-driving integrator: its film holds the
    three AOVs, the albedo as the primal."""

    def render(self, sd, spp, seed=0):
        from rustlight_tpu_torch.integrators.common import render_feature_aovs
        from rustlight_tpu_torch.utils.film import Film
        film = Film(sd.camera.width, sd.camera.height)
        film.buffers.update(render_feature_aovs(sd, spp=spp, seed=seed))
        film.buffers["primal"] = film.buffers["albedo"]
        return film


def _wide_render(sd, integ, spp, seed, tile):
    """The per-pass route's estimate, spp samples a pixel of
    integ.compute_pixel, `tile` samples of every pixel side by side in one
    wavefront (pass s draws from stream_fold(make_stream(seed), s)): far
    fewer iterations of the eager loop than spp passes. [h, w, 3] on the
    host."""
    import torch
    from rustlight_tpu_torch.integrators.common import _pixel_grid
    from rustlight_tpu_torch.utils.film import accumulate_safe
    from rustlight_tpu_torch.utils.rng import make_stream, stream_fold
    w, h = sd.camera.width, sd.camera.height
    pix = torch.as_tensor(_pixel_grid(w, h), device=sd.device).repeat(tile,
                                                                      1)
    base = make_stream(seed, sd.device)
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=sd.device)
    for s in range(spp // tile):
        li = accumulate_safe(integ.compute_pixel(sd, pix,
                                                 stream_fold(base, s)))
        acc = acc + li.reshape(tile, w * h, 3).sum(0)
    return (acc / spp).cpu().numpy().reshape(h, w, 3)


def _guided_card_vs_cpu(dev):
    """(c), guiding: GUIDE_CPU_PASSES guided passes of cbox 32x32 (depth
    CBOX_DEPTH, a GUIDE_G^3 grid, seed 0) on the card and on the CPU, each
    device from its own tables. A lane of a pass diverged where its
    radiance is off by more than SCHED_PIX_RTOL (relative, 1e-4 floor): at
    most 1 - SCHED_PIX_FRAC of the (pass, lane) pairs may; the image (the
    passes' mean) within SCHED_PIX_RTOL on every pixel no diverged lane
    reached. Every pass is run on the card once more from the CPU's table
    before it: the table after it within GUIDE_TABLE_RTOL of the CPU's
    largest entry. (Run from its own tables, the card's drifts further
    from pass to pass: the draw reuses the CDF's residual, so an ulp of a
    row's sum moves a draw in a bin of small weight; the drift is
    printed.)"""
    import torch
    from dataclasses import replace
    from rustlight_tpu_torch.integrators import IntegratorPathTracing
    from rustlight_tpu_torch.integrators.common import _pixel_grid
    from rustlight_tpu_torch.integrators.guiding import (guided_pass,
                                                         make_guide_grid)
    from rustlight_tpu_torch.models import cornell_box
    from rustlight_tpu_torch.utils.rng import make_stream, stream_fold
    run = {}
    for w in (str(dev), "cpu"):
        sd = cornell_box(32, 32).compile(device=w)
        integ = IntegratorPathTracing(max_depth=CBOX_DEPTH)
        integ.guide_alpha = 0.5
        run[w] = (sd, integ, torch.as_tensor(_pixel_grid(32, 32), device=w),
                  make_stream(0, w), make_guide_grid(sd, GUIDE_G))

    def one(w, grid, j):
        sd, integ, pix, base, _ = run[w]
        rad, grid = guided_pass(sd, integ, grid, pix, stream_fold(base, j),
                                0.8)
        return rad.cpu().numpy(), grid
    free = {w: run[w][4] for w in run}
    img = {w: 0.0 for w in run}
    keep = np.ones(32 * 32, bool)
    n_div, tables, drift = 0, [], []
    for j in range(GUIDE_CPU_PASSES):
        before = free["cpu"].table
        out = {}
        for w in run:
            rad, free[w] = one(w, free[w], j)
            img[w] = img[w] + rad
            out[w] = rad
        ra, rb = out[str(dev)], out["cpu"]
        div = (np.abs(ra - rb) / np.maximum(np.abs(rb), 1e-4)).max(-1) > (
            SCHED_PIX_RTOL)
        n_div += int(div.sum())
        keep &= ~div
        tb = free["cpu"].table.numpy()
        _, same_in = one(str(dev), replace(free[str(dev)], table=before.to(
            dev)), j)
        tables.append(float(np.abs(same_in.table.cpu().numpy() - tb).max()
                            / np.abs(tb).max()))
        drift.append(float(np.abs(free[str(dev)].table.cpu().numpy() - tb)
                           .max() / np.abs(tb).max()))
    img_a = img[str(dev)] / GUIDE_CPU_PASSES
    img_b = img["cpu"] / GUIDE_CPU_PASSES
    rel = (np.abs(img_a - img_b) / np.maximum(np.abs(img_b), 1e-4)).max(-1)
    worst = float(rel[keep].max())
    total = GUIDE_CPU_PASSES * 32 * 32
    phase("guide", f"(c) guided cbox 32x32, {GUIDE_CPU_PASSES} passes, g "
          f"{GUIDE_G}, card vs CPU: {n_div} of {total} (pass, lane) pairs "
          f"diverged (limit {100 * (1 - SCHED_PIX_FRAC):.1f}%); each pass "
          "from the CPU's table, the table after it within " + ", ".join(
              f"{t:.3g}" for t in tables) + " of the CPU's largest entry "
          f"(limit {GUIDE_TABLE_RTOL}); from the card's own tables " +
          ", ".join(f"{t:.3g}" for t in drift) + f"; on the "
          f"{int(keep.sum())} pixels no diverged lane reached, worst "
          f"relative difference {worst:.3g} (limit {SCHED_PIX_RTOL}); "
          f"means {img_a.mean():.7f} / {img_b.mean():.7f}")
    if not (img_b.mean() > 0 and np.all(np.isfinite(img_a))):
        raise AssertionError("guide (c): bad images")
    if (n_div > (1 - SCHED_PIX_FRAC) * total or max(tables) >
            GUIDE_TABLE_RTOL or worst > SCHED_PIX_RTOL):
        raise AssertionError("guide (c): guided card and CPU disagree")


def _adaptive_card_vs_cpu(dev):
    """(c), render_adaptive and render_feature_aovs on cbox 32x32 (depth
    CBOX_DEPTH) on the card and on the CPU: the adaptive counts equal on at
    least SCHED_PIX_FRAC of the pixels and the images under phase 20's
    bounds; each feature AOV within FEAT_RTOL (relative, 1e-4 floor) on at
    least SCHED_PIX_FRAC of the pixels, the means within SCHED_MEAN_RTOL."""
    from rustlight_tpu_torch.integrators import IntegratorPathTracing
    from rustlight_tpu_torch.integrators.common import (render_adaptive,
                                                        render_feature_aovs)
    from rustlight_tpu_torch.models import cornell_box
    ad, feat = {}, {}
    for w in (dev, "cpu"):
        sd = cornell_box(32, 32).compile(device=w)
        ad[str(w)] = render_adaptive(
            sd, IntegratorPathTracing(max_depth=CBOX_DEPTH), ADAPT_CPU_SPP)
        feat[str(w)] = render_feature_aovs(sd, spp=FEAT_CPU_SPP)
    fa, fb = ad[str(dev)], ad["cpu"]
    same = float((fa["spp"] == fb["spp"]).mean())
    line = _agree_buffer("guide", "(c) adaptive", "primal", fa["primal"],
                         fb["primal"], False)
    phase("guide", f"(c) render_adaptive cbox 32x32 {ADAPT_CPU_SPP} spp, card"
          f" vs CPU: counts equal on {100 * same:.3f}% of pixels (limit "
          f"{100 * SCHED_PIX_FRAC:.1f}%), budgets {int(fa['spp'].sum())} / "
          f"{int(fb['spp'].sum())}; {line}")
    if same < SCHED_PIX_FRAC or fa["spp"].sum() != fb["spp"].sum():
        raise AssertionError("guide (c): adaptive counts disagree")
    parts = []
    for name in ("albedo", "normal", "depth"):
        a, b = feat[str(dev)][name], feat["cpu"][name]
        rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-4)).max(-1)
        frac = float((rel <= FEAT_RTOL).mean())
        mean_rel = abs(float(a.mean()) - float(b.mean())) / max(
            float(np.abs(b).mean()), 1e-30)
        parts.append(f"{name} {100 * frac:.3f}% within {FEAT_RTOL} (worst "
                     f"{float(rel.max()):.3g}), means off by {mean_rel:.3g}")
        if (not np.all(np.isfinite(a)) or frac < SCHED_PIX_FRAC
                or mean_rel > SCHED_MEAN_RTOL):
            raise AssertionError(f"guide (c): feature AOV {name} disagrees")
    phase("guide", f"(c) render_feature_aovs cbox 32x32 {FEAT_CPU_SPP} spp, "
          "card vs CPU: " + "; ".join(parts))


def _cli_film(argv, out):
    """One in-process run of the port's CLI on the card; its film."""
    from rustlight_tpu_torch import cli
    from rustlight_tpu_torch.utils.image import read_pfm
    if cli.main(argv) != 0:
        raise AssertionError(f"guide (d): {' '.join(argv)} failed")
    return read_pfm(out)


def _cli_resume(tmp, dev, label, tail):
    """(d) for one integrator: two identical `-a META_PASSES` runs, then `-a
    1` and `-a META_PASSES --resume` from its dumps. Returns (bit-equal
    reruns, largest relative difference between the reruns, between the
    resumed and the uninterrupted films)."""
    def run(name, *flags):
        out = os.path.join(tmp, f"{label}_{name}.pfm")
        return _cli_film(["cbox", "-n", str(META_SPP), "-s",
                          str(META_RES / 512), "-o", out, "--device",
                          str(dev), *flags, *tail], out)
    a = run("a", "-a", str(META_PASSES))
    b = run("b", "-a", str(META_PASSES))
    run("r", "-a", "1")
    r = run("r", "-a", str(META_PASSES), "--resume")

    def rel(x, y):
        return float((np.abs(x - y) / np.maximum(np.abs(y), 1e-30)).max())
    if not (np.all(np.isfinite(a)) and a.mean() > 0):
        raise AssertionError(f"guide (d) {label}: bad film")
    return np.array_equal(a, b), rel(b, a), rel(r, a), np.array_equal(r, a)


def _deposit_determinism(dev):
    """The card's deposit (index_put_ with accumulate, guiding.deposit)
    against index_add_ on the same 262,144 lanes into a g = 16 table, each
    twice: whether each repeats bit for bit, and each one's median ms."""
    import torch
    from rustlight_tpu_torch.integrators import guiding as gd
    gen = torch.Generator(device=dev).manual_seed(0)
    n, cells = 262_144, 16 ** 3 * gd.N_BINS
    # lanes herded into few cells, as a wavefront's vertices are
    idx = (torch.rand(n, device=dev, generator=gen) ** 4 * cells).long()
    val = torch.rand(n, device=dev, generator=gen)
    zero = torch.zeros(cells, device=dev)

    def put():
        return zero.clone().index_put_((idx,), val, accumulate=True)

    def add():
        return zero.clone().index_add_(0, idx, val)
    out = []
    for name, fn in (("index_put_ (the port's deposit)", put),
                     ("index_add_", add)):
        x, y = fn(), fn()
        out.append(f"{name}: repeats bit for bit {bool(torch.equal(x, y))}, "
                   f"largest difference {float((x - y).abs().max()):.3g}, "
                   f"{_median_ms(fn):.4f} ms")
    return "; ".join(out)


def guiding_meta_phase(dev, card, cbox_mean):
    """Phase 26. Returns the K1/K2/K3 launches of its full-width renders
    (counts reset just before each timed render, read just after).
    `cbox_mean` is phase 3's 128-spp mean."""
    import tempfile
    import torch
    from rustlight_tpu_torch.integrators import (IntegratorDirect,
                                                 IntegratorPathTracing)
    from rustlight_tpu_torch.integrators.guiding import (guided_pass,
                                                         render_guided)
    from rustlight_tpu_torch.models import cornell_box, door_box
    dense = {"dense_closest": 0, "dense_anyhit": 0}
    walk = {"walk_closest": 0, "walk_anyhit": 0}
    path = IntegratorPathTracing(max_depth=CBOX_DEPTH)
    # (a) the guided path tracer at full width, its mean against phase 3's
    sd = cornell_box(GUIDE_RES, GUIDE_RES).compile(device=dev)
    keep = {}
    busy, _ = _full_width(
        f"(a) guided path cbox {GUIDE_RES}x{GUIDE_RES} depth {CBOX_DEPTH}, "
        f"g {GUIDE_G}", sd, _Guided(path, GUIDE_G), GUIDE_PASSES, card,
        dense, warm_spp=1, profile_spp=1, tag="guide", keep=keep)
    g_mean = float(keep["img"].mean())
    off = abs(g_mean - cbox_mean) / cbox_mean
    phase("guide", f"(a) guided mean {g_mean:.6f} against phase 3's "
          f"{CBOX_SPP}-spp mean {cbox_mean:.6f}: {off:.3g} relative (limit "
          f"{GUIDE_MEAN_RTOL})")
    if off > GUIDE_MEAN_RTOL:
        raise AssertionError("guide (a): the guided mean is off")
    # the profiler's own cost, host and device activities against the
    # device's alone, on one render
    costs = []
    direct = IntegratorDirect(1, 1)
    _render(sd, direct, 1)
    for cpu in (True, False):
        t0 = time.time()
        wall, kern = _profile(lambda: _render(sd, direct, 1, seed=1), cpu=cpu)
        busy = sum(e.self_device_time_total for e in kern) / 1e6
        costs.append(f"{'host + device' if cpu else 'device only'}: wall "
                     f"{wall:.3f}s, busy {100 * busy / wall:.1f}%, "
                     f"{sum(e.count for e in kern)} launches, "
                     f"{time.time() - t0:.1f}s with the processing")
    phase("guide", f"(a) torch.profiler over direct cbox {GUIDE_RES}x"
          f"{GUIDE_RES} 1 spp, recording " + "; ".join(costs))
    # the deposits of one pass, twice on a trained table: bit for bit?
    film, grid = render_guided(sd, path, 2, seed=3, g=GUIDE_G,
                               return_grid=True)
    from rustlight_tpu_torch.integrators.common import _pixel_grid
    from rustlight_tpu_torch.utils.rng import make_stream, stream_fold
    pix = torch.as_tensor(_pixel_grid(GUIDE_RES, GUIDE_RES), device=dev)
    st = stream_fold(make_stream(4, dev), 0)
    (ra, ga), (rb, gb) = (guided_pass(sd, path, grid, pix, st, 0.8)
                          for _ in range(2))
    same = torch.equal(ga.table, gb.table) and torch.equal(ra, rb)
    phase("guide", f"(a) one guided pass twice on a trained table: tables "
          f"and lanes bit for bit {same}; " + _deposit_determinism(dev))
    if not same:
        raise AssertionError("guide (a): the guided pass does not repeat")
    del sd, film, grid, ga, gb, ra, rb
    # door_box: guided against unguided at equal spp
    dsd = door_box(*DOOR_RES).compile(device=dev)
    dpath = IntegratorPathTracing(max_depth=DOOR_DEPTH, hard_cap=DOOR_DEPTH)
    t0 = time.time()
    ref = _wide_render(dsd, dpath, DOOR_REF_SPP, 99, DOOR_REF_SPP // 4)
    un = _wide_render(dsd, dpath, DOOR_SPP, 1, DOOR_SPP)
    t1 = time.time()
    gu = render_guided(dsd, dpath, DOOR_SPP, seed=1, g=GUIDE_G)["primal"]
    torch.cuda.synchronize()
    t2 = time.time()
    l1u, l1g = (float(np.abs(x - ref).mean()) for x in (un, gu))
    ratio = float(gu.mean() / ref.mean())
    phase("guide", f"(a) door_box {DOOR_RES[0]}x{DOOR_RES[1]} depth "
          f"{DOOR_DEPTH}, {DOOR_SPP} spp against {DOOR_REF_SPP} spp: l1 "
          f"unguided {l1u:.6f}, guided {l1g:.6f} ({l1u / l1g:.3f}x), guided "
          f"mean / reference mean {ratio:.4f} (limits: guided l1 below "
          f"unguided, ratio in (0.5, 2)); reference + unguided "
          f"{t1 - t0:.2f}s, guided {t2 - t1:.2f}s")
    if not (l1g < l1u and 0.5 < ratio < 2.0):
        raise AssertionError("guide (a): guiding does not help on door_box")
    del dsd
    # (b) the guided walk-tier scene at its full size: K3
    ex = _example(ATS_EX).compile(device=dev)
    _full_width(f"(b) guided path {ATS_EX} {ex.camera.width}x"
                f"{ex.camera.height} depth {EX_DEPTH}, g {GUIDE_G}", ex,
                _Guided(IntegratorPathTracing(max_depth=EX_DEPTH), GUIDE_G),
                GUIDE_EX_PASSES, card, walk, warm_spp=1, profile_spp=0,
                tag="guide")
    del ex
    # (c) card against the CPU at 32x32
    _guided_card_vs_cpu(dev)
    _adaptive_card_vs_cpu(dev)
    # (d) -a and --resume through the CLI on the card
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        lines = []
        for label, tail in (("path", ["path", "-m", str(CBOX_DEPTH)]),
                            ("guided", ["--guiding", "path", "-m",
                                        str(CBOX_DEPTH)]),
                            ("smcmc", ["smcmc", "-m", str(SM_DEPTH)])):
            rerun, rerun_rel, res_rel, res_eq = _cli_resume(tmp, dev, label,
                                                            tail)
            lines.append(f"{label}: reruns bit for bit {rerun} (largest "
                         f"relative difference {rerun_rel:.3g}), resumed = "
                         f"uninterrupted bit for bit {res_eq} "
                         f"({res_rel:.3g})")
            if (res_rel > RESUME_RTOL) or (rerun and not res_eq):
                raise AssertionError(f"guide (d) {label}: --resume differs")
        log = os.path.join(tmp, "e.log")
        out = os.path.join(tmp, "e.pfm")
        t0 = time.time()
        _cli_film(["cbox", "-n", "1", "-s", str(META_RES / 512), "-o", out,
                   "--device", str(dev), "-e", str(META_E_MS), "-l", log,
                   "path", "-m", str(CBOX_DEPTH)], out)
        secs = time.time() - t0
        with open(log) as f:
            got = [ln for ln in f if "Achieved spp" in ln]
        spp = int(got[-1].split(":")[-1]) if got else 0
    phase("guide", f"(d) the CLI on cbox {META_RES}x{META_RES}, -a "
          f"{META_PASSES} -n {META_SPP} against -a 1 then -a {META_PASSES} "
          f"--resume (limit {RESUME_RTOL} relative where reruns differ): "
          + "; ".join(lines) + f"; -e {META_E_MS}: achieved {spp} spp in "
          f"{secs:.2f}s with the set-up pass")
    if spp <= 0:
        raise AssertionError("guide (d): -e achieved no sample")
    # (e) adaptive sampling and the feature AOVs at full width
    sd = cornell_box(GUIDE_RES, GUIDE_RES).compile(device=dev)
    _full_width(f"(e) render_adaptive path cbox {GUIDE_RES}x{GUIDE_RES} "
                f"depth {CBOX_DEPTH}", sd, _Adaptive(path), ADAPT_SPP, card,
                dense, warm_spp=8, profile_spp=ADAPT_PROFILE_SPP, tag="guide")
    _full_width(f"(e) render_feature_aovs cbox {GUIDE_RES}x{GUIDE_RES}", sd,
                _Features(), FEAT_SPP, card, dense, kernels=("dense_closest",),
                warm_spp=1, profile_spp=1, tag="guide")
    return {**dense, **walk}


def _example(name, width=None):
    """The port's host scene of examples/<name>, its camera re-derived for
    `width` pixels wide (the file's aspect kept) when given."""
    from rustlight_tpu_torch.scene import resize_camera
    from rustlight_tpu_torch.scene.loaders import load_scene
    sc = load_scene(os.path.join(ROOT, "examples", name))
    if width is not None:
        cam = sc.camera
        sc.camera = resize_camera(cam, width,
                                  round(width * cam.height / cam.width))
    return sc


def _oracle_scenes():
    """tests/test_oracle.py's point + directional scene (:250-268), env-glass
    scene (:181-206) and uv-emission boxes (:305-321) with the port's
    classes: (name, scene maker of width and height, max_depth)."""
    from rustlight_tpu_torch import bsdfs as b
    from rustlight_tpu_torch.models import cornell_box
    from rustlight_tpu_torch.scene import (Scene, look_at, make_camera,
                                           make_quad, make_sphere)

    def point_dir(w, h):
        sc = Scene()
        m = sc.add_material(b.diffuse((0.6, 0.55, 0.5)))
        sc.add_mesh(make_quad((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5),
                              material=m))
        sc.add_mesh(make_quad((-5, 0, -5), (-5, 4, -5), (5, 4, -5),
                              (5, 0, -5), material=m))
        sc.point_lights.append(((0.0, 3.0, 1.0), (8.0, 7.0, 6.0)))
        sc.directional_lights.append(((0.3, -1.0, 0.2), (0.6, 0.7, 0.8)))
        sc.camera = make_camera(w, h, fov=60.0, to_world=look_at(
            (0, 2.5, 6), (0, 1, 0), (0, 1, 0)))
        return sc

    def env_glass(w, h):
        rng = np.random.default_rng(5)
        env = 0.3 + 0.4 * rng.random((12, 24, 3))
        env[3:5, 6:9] = (12.0, 10.0, 8.0)
        sc = Scene()
        mg = sc.add_material(b.glass())
        mm = sc.add_material(b.metal(alpha=0.0))
        md = sc.add_material(b.diffuse((0.5, 0.45, 0.4)))
        sc.add_mesh(make_sphere((-1.2, 1.0, 0), 1.0, material=mg))
        sc.add_mesh(make_sphere((1.2, 1.0, 0), 1.0, material=mm))
        sc.add_mesh(make_quad((-20, 0, -20), (20, 0, -20), (20, 0, 20),
                              (-20, 0, 20), material=md))
        sc.env_image = env.astype(np.float32)
        sc.camera = make_camera(w, h, fov=55.0, to_world=look_at(
            (0, 1.6, -6), (0, 1, 0), (0, 1, 0)))
        return sc

    def uv_box(kind):
        def make(w, h):
            sc = cornell_box(w, h)
            for m in sc.meshes:
                if m.is_light:
                    m.emission_kind = kind
                    m.emission_scale = 15.0
                    m.emission_tex = 0
            if kind == 2:
                yy, xx = np.mgrid[0:16, 0:16].astype(np.float32) / 15.0
                sc.textures = np.stack([xx, yy, 0.5 * (1 - xx)], -1)[None]
            return sc
        return make
    return [("point+dir", point_dir, 4), ("env-glass", env_glass, 6),
            ("uv-emission HSV", uv_box(1), 3),
            ("uv-emission texture", uv_box(2), 3)]


def _obj_round_trip(dev):
    """Phase 22 (a): fog_box's meshes written to an OBJ under build/ and
    loaded back through load_scene; the native parser must have read it."""
    from rustlight_tpu_torch.scene.loaders import load_scene
    from rustlight_tpu_torch.scene.loaders import obj
    out = os.path.join(ROOT, "build", "examples")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "fog_box.obj")
    lines, base = [], 1
    meshes = _example("fog_box.xml").meshes
    for m in meshes:
        lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in m.vertices]
        lines += [f"f {a + base} {b + base} {c + base}" for a, b, c in m.indices]
        base += len(m.vertices)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    before = obj.PARSES["native"]
    t0 = time.time()
    sd = load_scene(path).compile(device=dev)
    n = sum(m.n_triangles for m in meshes)
    if obj.PARSES["native"] != before + 1:
        raise AssertionError(f"examples: the native OBJ parser did not run "
                             f"({obj.PARSES})")
    if sd.geom.n_tris != n or sd.geom.walk is None:
        raise AssertionError("examples: the OBJ round trip lost triangles")
    phase("examples", f"(a) {path} ({n} triangles) through the native OBJ "
          f"parser and compiled in {time.time() - t0:.3f}s; parses "
          f"{obj.PARSES}")


def examples_check(dev):
    """Phase 22 (a)-(c): load and tier, the card against the CPU on every
    example and oracle scene, the furnace."""
    import torch
    from rustlight_tpu_torch.integrators import (IntegratorDirect,
                                                 IntegratorLightTracing,
                                                 IntegratorPathTracing)
    from rustlight_tpu_torch.models import furnace_scene
    walks = {}
    for name, n_tris, walk in EXAMPLES:
        t0 = time.time()
        sd = _example(name).compile(device=dev)
        torch.cuda.synchronize()
        wt = sd.geom.walk
        if sd.geom.n_tris != n_tris or (wt is not None) != walk:
            raise AssertionError(f"examples {name}: {sd.geom.n_tris} "
                                 f"triangles, walk {wt is not None}")
        walks[name] = walk
        phase("examples", f"(a) {name}: {n_tris} triangles, "
              + (f"walk (K3), Cp {wt.n_clusters} ({wt.n_real} real)"
                 if walk else "dense (K1/K2)")
              + f", atoms {sorted(sd.emitters.kinds)} "
              f"({sd.emitters.n_atoms}), film {sd.camera.width}x"
              f"{sd.camera.height}, load + compile {time.time() - t0:.3f}s")
    _obj_round_trip(dev)

    def path():
        return IntegratorPathTracing(max_depth=EX_DEPTH)
    cases = [(name, path) for name, _, _ in EXAMPLES]
    cases += [(name, lambda: IntegratorDirect(1, 1))
              for name in ("envglass.xml", "fog_box.xml")]
    cases += [(name, lambda: IntegratorLightTracing(max_depth=EX_DEPTH,
                                                    hard_cap=EX_DEPTH))
              for name in ("fog_box.xml", "envglass.xml")]
    for name, integ in cases:
        sc = _example(name, EX_WIDTH)
        res = (sc.camera.width, sc.camera.height)
        _card_vs_cpu(f"(b) {name} {type(integ()).__name__}",
                     lambda w, h, name=name: _example(name, w), res, integ(),
                     EX_SPP, dev, True, "examples", walks[name])
    for name, make, depth in _oracle_scenes():
        _card_vs_cpu(f"(b) {name} path depth {depth}", make,
                     (EX_WIDTH, EX_WIDTH), IntegratorPathTracing(
                         max_depth=depth), EX_SPP, dev, True, "examples")

    sd = furnace_scene(FURNACE_RES, FURNACE_RES, albedo=0.5).compile(
        device=dev)
    _reset_launches()
    t0 = time.time()
    img = _render(sd, IntegratorPathTracing(max_depth=FURNACE_DEPTH,
                                            rr_depth=None), FURNACE_SPP,
                  seed=1)["primal"]
    secs = time.time() - t0
    _only("examples furnace", _launches(), ("walk_closest", "walk_anyhit"))
    lo, hi = round(8 * FURNACE_RES / 24), round(16 * FURNACE_RES / 24)
    center, corner = float(img[lo:hi, lo:hi].mean()), float(img[0, 0].mean())
    phase("examples", f"(c) furnace {FURNACE_RES}x{FURNACE_RES} "
          f"({sd.geom.n_tris} triangles) {FURNACE_SPP} spp depth "
          f"{FURNACE_DEPTH}: center [{lo}:{hi}] {center:.6f} (0.5 +- 0.015), "
          f"corner {corner:.7f} (1 +- 1e-3), {secs:.3f}s")
    if not (abs(center - 0.5) < 0.015 and abs(corner - 1.0) < 1e-3):
        raise AssertionError("examples: the furnace is off its answer")


def examples_phase(dev, card):
    """Phase 22. Returns the K1/K2/K3 launches of its full-width renders
    (counts reset just before each timed render, read just after)."""
    from rustlight_tpu_torch.integrators import IntegratorPathTracing
    from rustlight_tpu_torch.utils.image import read_exr
    examples_check(dev)
    launched = {k: 0 for k in ("dense_closest", "dense_anyhit",
                               "walk_closest", "walk_anyhit")}
    integ = IntegratorPathTracing(max_depth=EX_DEPTH)
    for name in EX_FULL:
        sd = _example(name).compile(device=dev)
        img, wall, warm, n_rays, launches = timed_render(
            name, sd, integ, EX_FULL_SPP, warm_spp=EX_WARM_SPP)
        _only(f"examples {name}", launches, ("walk_closest", "walk_anyhit"))
        for k in launched:
            launched[k] += launches[k]
        busy_s = ""
        if name == EX_FULL[0]:
            busy, _ = profile_render(name, sd, integ, EX_PROFILE_SPP,
                                     ("walk_",), top=6)
            busy_s = (", device busy " + ("not measured" if busy is None
                                          else f"{100 * busy:.1f}%")
                      + f" (of a warm {EX_PROFILE_SPP} spp render)")
        phase("examples", f"(d) {name} {sd.camera.width}x{sd.camera.height} "
              f"path depth {EX_DEPTH} {EX_FULL_SPP} spp: warm-up {warm:.3f}s "
              f"({EX_WARM_SPP} spp), timed {wall:.3f}s, {n_rays} rays, "
              f"{n_rays / wall / 1e6:.3f} Mrays/s, mean {img.mean():.6f}"
              f"{busy_s}, K3 walk_closest {launches['walk_closest']} and "
              f"walk_anyhit {launches['walk_anyhit']}, K1/K2 "
              f"{launches['dense_closest']}/{launches['dense_anyhit']} "
              f"launches | {card}")
    out = os.path.join(ROOT, "build", "examples", "envglass.exr")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.time()
    run = subprocess.run(
        [sys.executable, "-m", "rustlight_tpu_torch.cli",
         os.path.join("examples", "envglass.xml"), "-n", "2", "-o", out,
         "path", "-m", "8"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"examples: the CLI exited {run.returncode}: "
                             f"{run.stderr[-2000:]}")
    img = read_exr(out)
    if img.shape != (384, 512, 3) or not np.all(np.isfinite(img)):
        raise AssertionError(f"examples: the CLI's image {img.shape}")
    phase("examples", f"(e) the CLI on examples/envglass.xml, 2 spp: exit 0 "
          f"in {time.time() - t0:.2f}s, {img.shape[1]}x{img.shape[0]}, mean "
          f"{img.mean():.6f}; {run.stdout.strip()}")
    return launched


# ---- phase 27: rendering over a device mesh


def _rank_launches(mesh, launches):
    """Every rank's launch counts, in rank order (on every rank)."""
    from rustlight_tpu_torch.parallel.mesh import gather_objects
    return gather_objects(mesh, {k: v for k, v in launches.items() if v})


def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _mesh_cfg():
    """Phase 27's sizes, handed to the ranks (which import this file
    afresh)."""
    return dict(res=MESH_RES, spp=MESH_SPP, light_spp=MESH_LIGHT_SPP,
                small=MESH_SMALL, small_spp=MESH_SMALL_SPP,
                depth=CBOX_DEPTH, grid=(GRID_ROWS[0][0], GRID_ROWS[0][1],
                                        GRID_RES, GRID_DEPTH),
                adapt_spp=ADAPT_CPU_SPP, gate_spp=GATE_CPU_SPP, g=GUIDE_G)


def _mesh_timed(mesh, sd, fn, spp, warm_spp=1):
    """A warm-up of `fn(spp)` at `warm_spp`, then a timed one with the
    launch counts reset just before and read just after and the rays
    counted; the mesh's collectives counted over it. Returns this rank's
    record (image, wall, rays, launches, collectives' and staging's
    ms, bytes staged)."""
    from rustlight_tpu_torch.ops.native import counting_rays
    fn(warm_spp)
    _sync(sd.device)
    mesh.reset_counts()
    _reset_launches()
    with counting_rays(sd.device) as rays:
        t0 = time.time()
        img = fn(spp)["primal"]
        _sync(sd.device)
        wall = time.time() - t0
        n_rays = int(rays)
    return {"img": img, "wall": wall, "rays": n_rays,
            "launches": _launches(), "coll_ms": 1e3 * mesh.coll_s,
            "stage_ms": 1e3 * mesh.stage_s, "staged": mesh.staged,
            "calls": mesh.calls}


def _p27_nccl(mesh, cfg):
    """(a): one NCCL rank. The path tracer's and the light tracer's
    full-width records, and the small film."""
    t_enter = time.time()
    from rustlight_tpu_torch.integrators import (IntegratorLightTracing,
                                                 IntegratorPathTracing)
    from rustlight_tpu_torch.models import cornell_box
    from rustlight_tpu_torch.parallel import (render_sharded,
                                              render_splat_sharded)
    dev = mesh.device
    sd = cornell_box(cfg["res"], cfg["res"]).compile(device=dev)
    path = IntegratorPathTracing(max_depth=cfg["depth"])
    light = IntegratorLightTracing(max_depth=8, hard_cap=8)
    n_pix = cfg["res"] ** 2
    out = {"t_enter": t_enter, "backend": mesh.backend, "device": str(dev)}
    out["path"] = _mesh_timed(mesh, sd, lambda spp: render_sharded(
        sd, path, spp, mesh=mesh), cfg["spp"])
    out["light"] = _mesh_timed(mesh, sd, lambda spp: render_splat_sharded(
        sd, light, n_paths=spp * n_pix, mesh=mesh), cfg["light_spp"])
    small = cornell_box(cfg["small"], cfg["small"]).compile(device=dev)
    _reset_launches()
    out["small"] = render_sharded(small, path, cfg["small_spp"],
                                  mesh=mesh)["primal"]
    out["small_launches"] = _launches()
    return out


def _p27_families(mesh, cfg, cpu):
    """(b) on this rank: every family of the mesh at MESH_SMALL, seed 0.
    On the card (`cpu` False) also the gradient shifts and SMCMC; on the
    CPU also (a)'s small film from a one-rank subgroup of rank 0."""
    import torch.distributed as dist
    from rustlight_tpu_torch.integrators import (IntegratorLightTracing,
                                                 IntegratorPathTracing)
    from rustlight_tpu_torch.integrators.common import render_adaptive
    from rustlight_tpu_torch.integrators.guiding import render_guided
    from rustlight_tpu_torch.models import cornell_box
    from rustlight_tpu_torch.parallel import (Mesh, render_sharded,
                                              render_splat_sharded)
    dev = mesh.device
    n, spp = cfg["small"], cfg["gate_spp"]
    sd = cornell_box(n, n).compile(device=dev)
    path = IntegratorPathTracing(max_depth=cfg["depth"])
    out = {}
    _reset_launches()
    out["P1"] = render_sharded(sd, path, cfg["small_spp"],
                               mesh=mesh)["primal"]
    out["P2/P6"] = render_splat_sharded(
        sd, IntegratorLightTracing(max_depth=8, hard_cap=8),
        n_paths=cfg["small_spp"] * n * n, mesh=mesh)["primal"]
    ad = render_adaptive(sd, path, cfg["adapt_spp"], mesh=mesh)
    out["adaptive"], out["adaptive spp"] = ad["primal"], ad["spp"]
    film, grid = render_guided(sd, path, 1, g=cfg["g"], return_grid=True,
                               mesh=mesh)
    out["guided"], out["guided table"] = film["primal"], grid.table.cpu(
        ).numpy()
    gm = _gm_integrators()
    for tech in ("pssmlt", "erpt"):
        integ = gm[tech]()
        integ.record_accepts = True
        out[tech] = (integ.render(sd, spp, seed=0, mesh=mesh)["primal"],
                     (integ.accepts, integ.visits, integ.tfs))
    if not cpu:
        for tech in ("gradient-path", "gradient-path-explicit"):
            out[tech] = dict(gm[tech]().render(sd, spp, seed=0,
                                               mesh=mesh).buffers)
        sm = _smcmc()
        out["smcmc"] = sm.render(sd, spp, seed=0, mesh=mesh)["primal"]
        out["smcmc moved"] = sm.exchange_moved
    out["launches"] = _rank_launches(mesh, _launches())
    if cpu:
        one = dist.new_group([0])
        if mesh.rank == 0:
            out["small"] = render_sharded(
                sd, path, cfg["small_spp"],
                mesh=Mesh(0, 1, dev, one, mesh.backend))["primal"]
    return out


def _p27_cpu(mesh, cfg):
    return _p27_families(mesh, cfg, True)


def _gloo_cuda(mesh):
    """Which of gloo's collectives take CUDA tensors in this torch (the
    mesh stages every one through the host regardless): {op: "yes" or the
    error's class}. Its send and recv are left out: their transport reads
    the tensor's memory from the host."""
    import torch
    import torch.distributed as dist
    x = torch.ones(4, device=mesh.device)
    ops = {
        "all_gather": lambda: dist.all_gather([torch.empty_like(x)
                                               for _ in range(2)], x),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0)}
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            out[name] = "yes"
        except Exception as e:   # noqa: BLE001 (the answer recorded)
            out[name] = type(e).__name__
        dist.barrier()
    return out


def _p27_card(mesh, cfg):
    """(b) and (c) on two gloo ranks sharing the card."""
    t_enter = time.time()
    from rustlight_tpu_torch.integrators import IntegratorPathTracing
    from rustlight_tpu_torch.models import cornell_box, sphere_grid
    from rustlight_tpu_torch.parallel import render_sharded
    from rustlight_tpu_torch.parallel.mesh import gather_objects
    out = _p27_families(mesh, cfg, False)
    out["t_enter"] = gather_objects(mesh, t_enter)
    g_label, g_tris, g_res, g_depth = cfg["grid"]
    for label, sd, depth in (
            ("path cbox", cornell_box(cfg["res"], cfg["res"]), cfg["depth"]),
            (g_label, sphere_grid(g_tris, g_res, g_res), g_depth)):
        sd = sd.compile(device=mesh.device)
        integ = IntegratorPathTracing(max_depth=depth)
        rec = _mesh_timed(mesh, sd, lambda spp: render_sharded(
            sd, integ, spp, mesh=mesh), cfg["spp"])
        img = rec.pop("img")
        out[label] = {"img": img, "ranks": gather_objects(mesh, rec)}
    out["gloo cuda"] = _gloo_cuda(mesh)
    return out


def _p27_one_rank(sd, integ, dev):
    """(c)'s one rank in this process: render_sharded over a mesh of one
    (the streams of a one-rank mesh), timed as _mesh_timed."""
    from rustlight_tpu_torch.parallel import Mesh, render_sharded
    one = Mesh(device=dev)
    return _mesh_timed(one, sd, lambda spp: render_sharded(
        sd, integ, spp, mesh=one), MESH_SPP)


def _p27_only_dense(label, launches):
    """Each rank's launches: K1 and K2, and nothing else."""
    for r, ln in enumerate(launches):
        _only(f"mesh {label} rank {r}", {**{k: 0 for k in _launches()},
                                         **ln},
              ("dense_closest", "dense_anyhit"))


def _p27_cli(dev):
    """(d): the CLI's -t 2 on the one card, in this process: one device and
    the info log, the film bit for bit the run's without -t; -a 2 -t 2 the
    same. Returns the line's text."""
    import logging
    import tempfile

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())
    keep = Keep()
    log = logging.getLogger("rustlight_tpu_torch")
    log.addHandler(keep)
    parts = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for tag, extra in (("", []), ("-a 2 ", ["-a", "2"])):
                films = []
                for t in ([], ["-t", "2"]):
                    out = os.path.join(tmp, f"d{len(films)}{len(tag)}.pfm")
                    films.append(_cli_film(
                        ["cbox", "-n", str(MESH_SMALL_SPP), "-s",
                         str(MESH_SMALL / 512), "-o", out, "--device",
                         str(dev), *extra, *t, "path", "-m", "6"], out))
                if not np.array_equal(films[0], films[1]):
                    raise AssertionError(f"mesh (d): {tag}-t 2 changed the "
                                         "film")
                parts.append(f"`{tag}-t 2` film bit for bit the run's "
                             "without -t")
    finally:
        log.removeHandler(keep)
    info = [x for x in keep.lines if x.startswith("-t 2:")]
    if len(info) != 2 or "one cuda device" not in info[0]:
        raise AssertionError(f"mesh (d): the -t info log {info}")
    return f"log {info[0]!r}; " + "; ".join(parts)


def mesh_phase(dev, card):
    """Phase 27. Returns the K1/K2/K3 launches of its renders, every rank's
    (counts reset just before each render, read just after)."""
    import threading
    import torch
    from rustlight_tpu_torch.integrators import IntegratorPathTracing
    from rustlight_tpu_torch.models import cornell_box, sphere_grid
    from rustlight_tpu_torch.parallel import run_on_mesh
    from rustlight_tpu_torch.ops import native
    counts = {"dense_closest": 0, "dense_anyhit": 0, "walk_closest": 0,
              "walk_anyhit": 0}
    cfg = _mesh_cfg()
    # the ranks load what this process built and never race to build it
    native.build()
    native.build_host(native.CSRC / "bvh_builder.cpp")

    def add(launches):
        for k in counts:
            counts[k] += launches.get(k, 0)
    # the CPU ranks' reference runs beside the card's
    cpu_box = {}

    def cpu_run():
        try:
            cpu_box["out"] = run_on_mesh(2, _p27_cpu, cfg, backend="gloo",
                                         device="cpu", timeout=MESH_TIMEOUT,
                                         threads=1)
        except BaseException as e:   # noqa: BLE001 (raised below)
            cpu_box["err"] = e
    cpu_thread = threading.Thread(target=cpu_run)
    cpu_thread.start()

    # (a) one NCCL rank
    t0 = time.time()
    a = run_on_mesh(1, _p27_nccl, cfg, backend="nccl", timeout=MESH_TIMEOUT)
    a_wall = time.time() - t0
    for label, spp in (("path", MESH_SPP), ("light", MESH_LIGHT_SPP)):
        rec = a[label]
        _only(f"mesh (a) {label}", rec["launches"],
              ("dense_closest", "dense_anyhit"))
        add(rec["launches"])
        img = rec["img"]
        if not (np.all(np.isfinite(img)) and img.mean() > 0):
            raise AssertionError(f"mesh (a) {label}: bad image")
        phase("mesh", f"(a) {a['backend']} one rank on {a['device']}: "
              f"render_{'splat_' if label == 'light' else ''}sharded "
              f"{label} cbox {MESH_RES}x{MESH_RES} {spp} spp: timed "
              f"{rec['wall']:.3f}s, {rec['rays']} rays, "
              f"{rec['rays'] / rec['wall'] / 1e6:.3f} Mrays/s, mean "
              f"{img.mean():.6f}, {rec['calls']} collectives "
              f"({rec['coll_ms']:.3f} ms; one rank sends nothing), launches "
              + ", ".join(f"{k} {v}" for k, v in rec["launches"].items()
                          if v) + f" | {card}")
    add(a["small_launches"])
    phase("mesh", f"(a) spawn to the rank's first line "
          f"{a['t_enter'] - t0:.2f}s, the whole call {a_wall:.2f}s")

    # single-device references on the card for (b)'s GSPMD families
    gm = _gm_integrators()
    small = cornell_box(MESH_SMALL, MESH_SMALL).compile(device=dev)
    ref = {tech: dict(gm[tech]().render(small, GATE_CPU_SPP,
                                        seed=0).buffers)
           for tech in ("gradient-path", "gradient-path-explicit")}
    ref["smcmc"] = _smcmc().render(small, GATE_CPU_SPP, seed=0)["primal"]

    # (b) and (c): two gloo ranks on the card
    t0 = time.time()
    b = run_on_mesh(2, _p27_card, cfg, backend="gloo", device=dev,
                    timeout=MESH_TIMEOUT)
    b_wall = time.time() - t0
    spawn = [t - t0 for t in b["t_enter"]]
    cpu_thread.join(MESH_TIMEOUT)
    if "err" in cpu_box or "out" not in cpu_box:
        raise AssertionError(f"mesh (b): the CPU ranks failed: "
                             f"{cpu_box.get('err')}")
    c = cpu_box["out"]
    phase("mesh", "(a) " + _agree_buffer(
        "mesh", "(a) path cbox 32x32", f"path cbox {MESH_SMALL}x"
        f"{MESH_SMALL} {MESH_SMALL_SPP} spp, one NCCL rank vs one gloo rank "
        "on the CPU:", a["small"], c["small"], False))
    _p27_only_dense("(b)", b["launches"])
    for ln in b["launches"]:
        add(ln)
    phase("mesh", "(b) the families' launches a rank: " + " / ".join(
        ", ".join(f"{k} {v}" for k, v in ln.items()) for ln in b["launches"]))
    for fam in ("P1", "P2/P6", "adaptive", "guided"):
        phase("mesh", "(b) " + _agree_buffer(
            "mesh", f"(b) {fam}", f"{fam} cbox {MESH_SMALL}x{MESH_SMALL}, "
            "two gloo ranks, card vs CPU:", b[fam], c[fam], False))
    same = float((b["adaptive spp"] == c["adaptive spp"]).mean())
    tab = float(np.abs(b["guided table"] - c["guided table"]).max()
                / max(float(np.abs(c["guided table"]).max()), 1e-30))
    phase("mesh", f"(b) adaptive counts equal on {100 * same:.3f}% of the "
          f"pixels (limit {100 * SCHED_PIX_FRAC:.1f}%); the guided table "
          f"after the pass within {tab:.3g} of the CPU's largest entry "
          f"(limit {GUIDE_TABLE_RTOL})")
    if same < SCHED_PIX_FRAC or tab > GUIDE_TABLE_RTOL:
        raise AssertionError("mesh (b): adaptive counts or guided table")
    for tech in ("pssmlt", "erpt"):
        _mcmc_agree("mesh", f"(b) {tech} two gloo ranks", b[tech][0],
                    b[tech][1], c[tech][0], c[tech][1])
    for tech in ("gradient-path", "gradient-path-explicit", "smcmc"):
        got, want = b[tech], ref[tech]
        if tech == "smcmc":
            got, want = {"primal": got}, {"primal": want}
        parts, worst = [], 0.0
        for k, x in want.items():
            y = got[k]
            lanes = int((y != x).any(-1).sum())
            scale = max(float(np.abs(x).mean()), 1e-30)
            off = abs(float(y.mean()) - float(x.mean())) / scale
            worst = max(worst, off)
            parts.append(f"{k} {lanes} lanes differ, means {off:.3g}")
            if not np.all(np.isfinite(y)):
                raise AssertionError(f"mesh (b) {tech}: non-finite {k}")
        phase("mesh", f"(b) {tech} cbox 32x32 {GATE_CPU_SPP} spp, two "
              "gloo ranks vs the card's single-device render: "
              + "; ".join(parts) + f" (means limit {MESH_GRAD_MEAN})")
        if worst > MESH_GRAD_MEAN:
            raise AssertionError(f"mesh (b) {tech}: ranks vs one device")
    d = _smcmc().pss_dims
    want = 2 * MESH_SMALL * (d + 3)   # one vertical step of GATE_CPU_SPP
    phase("mesh", f"(b) SMCMC's exchange sent {b['smcmc moved']} elements "
          f"a rank, boundary rows {want} (of {MESH_SMALL ** 2 * d} in the "
          "chains' states)")
    if b["smcmc moved"] != want:
        raise AssertionError("mesh (b): SMCMC's exchange sent more than "
                             "its boundary rows")

    # (c) against one rank in this process
    for label, make, depth, walk in (
            ("path cbox", lambda: cornell_box(MESH_RES, MESH_RES),
             CBOX_DEPTH, False),
            (GRID_ROWS[0][0], lambda: sphere_grid(
                GRID_ROWS[0][1], GRID_RES, GRID_RES), GRID_DEPTH, True)):
        sd = make().compile(device=dev)
        one = _p27_one_rank(sd, IntegratorPathTracing(max_depth=depth), dev)
        kern = (("walk_closest", "walk_anyhit") if walk
                else ("dense_closest", "dense_anyhit"))
        _only(f"mesh (c) {label} one rank", one["launches"], kern)
        add(one["launches"])
        two = b[label]
        for r, rec in enumerate(two["ranks"]):
            _only(f"mesh (c) {label} rank {r}", rec["launches"], kern)
            add(rec["launches"])
        half = sd.camera.height // 2
        x, y = two["img"], one["img"]
        rows0 = bool(np.array_equal(x[:half], y[:half]))
        rel = np.abs(x[:half] - y[:half]) / np.maximum(np.abs(y[:half]),
                                                        1e-4)
        frac0 = float((rel.max(-1) <= SCHED_PIX_RTOL).mean())
        off = abs(float(x.mean()) - float(y.mean())) / float(y.mean())
        wall = max(r["wall"] for r in two["ranks"])
        rays = sum(r["rays"] for r in two["ranks"])
        r0 = two["ranks"][0]
        phase("mesh", f"(c) {label} {sd.camera.width}x{sd.camera.height} "
              f"{MESH_SPP} spp, two gloo ranks on one card: wall "
              f"{wall:.3f}s ({rays / wall / 1e6:.3f} Mrays/s), collectives "
              f"{r0['calls']} ({r0['coll_ms']:.3f} ms on rank 0, staging "
              f"{r0['stage_ms']:.3f} ms of it, {r0['staged']} bytes, "
              f"{100 * r0['stage_ms'] / 1e3 / wall:.2f}% of the wall); one "
              f"rank: wall {one['wall']:.3f}s "
              f"({one['rays'] / one['wall'] / 1e6:.3f} Mrays/s); rank 0's rows equal one rank's bit for bit "
              f"{rows0} ({100 * frac0:.3f}% within {SCHED_PIX_RTOL}), means "
              f"differ by {off:.3g} (limit {MESH_MEAN_RTOL}); launches a rank "
              + " / ".join(", ".join(f"{k} {r['launches'][k]}" for k in kern)
                           for r in two["ranks"]) + f" | {card}")
        if (frac0 < SCHED_PIX_FRAC or off > MESH_MEAN_RTOL
                or not np.all(np.isfinite(x))):
            raise AssertionError(f"mesh (c) {label}: two ranks vs one")
    phase("mesh", "(b) gloo's collectives on CUDA tensors in torch "
          f"{torch.__version__}: " + ", ".join(
              f"{k} {v}" for k, v in b["gloo cuda"].items())
          + " (the mesh stages every one through the host)")
    phase("mesh", f"(b)-(c) spawn to each rank's first line "
          + ", ".join(f"{t:.2f}s" for t in spawn)
          + f", the whole call {b_wall:.2f}s")

    # (d) the CLI
    _reset_launches()
    phase("mesh", "(d) " + _p27_cli(dev))
    add(_launches())
    return counts



# ---- phase 28: the user tools


def _viewer_wait(viewer, pred, what):
    """Poll `pred` until it holds; fail on a render-loop error or after
    TOOLS_WAIT_S."""
    t0 = time.time()
    while time.time() - t0 < TOOLS_WAIT_S:
        if viewer._STATE["error"]:
            raise AssertionError(f"tools (a) viewer: the render loop "
                                 f"failed:\n{viewer._STATE['error']}")
        if pred():
            return time.time() - t0
        time.sleep(0.005)
    raise AssertionError(f"tools (a) viewer: {what} not within "
                         f"{TOOLS_WAIT_S}s (state "
                         f"{ {k: v for k, v in viewer._STATE.items() if k != 'png'} })")


def _http(port, path, body=None):
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="GET" if body is None
        else "POST", data=None if body is None else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def _viewer_pause(viewer, port):
    """Pause the viewer and wait until no pass is in flight."""
    _http(port, "/api/pause", {"paused": True})
    _viewer_wait(viewer, lambda: viewer._STATE["paused"]
                 and not viewer._STATE["busy"], "the pause")


def viewer_check(dev, card):
    """Phase 28 (a): the viewer's server at full width on the card. Returns
    the K1/K2 launches of its timed passes."""
    import torch
    from rustlight_tpu_torch import cli
    from rustlight_tpu_torch.ops.native import counting_rays
    from rustlight_tpu_torch.tools import viewer
    from rustlight_tpu_torch.utils.image import decode_png, tonemap_gamma
    rest = ["path", "-m", str(VIEWER_DEPTH)]
    t0 = time.time()
    srv = viewer.main(["cbox", "--port", "0", "--host", "127.0.0.1", "--res",
                       str(VIEWER_RES / 512), "--device", str(dev), "--"]
                      + rest, block=False)
    port = srv.server_address[1]
    t_up = time.time() - t0
    try:
        first = _viewer_wait(viewer, lambda: viewer._STATE["spp"] >= 1,
                             "a first frame")
        _viewer_wait(viewer, lambda: viewer._STATE["spp"] >= VIEWER_SPP,
                     f"{VIEWER_SPP} passes")
        _viewer_pause(viewer, port)
        png = _http(port, "/img.png")
        st = json.loads(_http(port, "/api/state"))
        px = decode_png(png)
        want = tonemap_gamma(viewer._FRAME["avg"])
        if px.shape != (VIEWER_RES, VIEWER_RES, 3) or not np.array_equal(
                px, want) or st["uploads"] != 1 or st["backend"] != "cuda":
            raise AssertionError(f"tools (a) viewer: frame {px.shape} equal "
                                 f"{np.array_equal(px, want)}, state {st}")
        phase("tools", f"(a) viewer cbox {VIEWER_RES}x{VIEWER_RES} path -m "
              f"{VIEWER_DEPTH} on 127.0.0.1:{port}: server up (scene uploaded) "
              f"{t_up:.2f}s after the call, the first frame {first:.2f}s "
              f"later, paused at spp {st['spp']} after "
              f"{time.time() - t0:.2f}s; /img.png ({len(png)} bytes) decodes to "
              f"tonemap_gamma of the running average, every pixel; uploads "
              f"{st['uploads']}, backend {st['backend']}")

        # the orbit: accumulation restarts, the scene is not uploaded again
        # the orbit is posted while paused (the loop takes it at once), so
        # the first frame after the resume is the first pass at the new pose
        old_cam, spp0, seq0 = (viewer._FRAME["first_cam"], st["spp"],
                               st["seq"])
        _http(port, "/api/orbit", {"dtheta": 0.6, "dphi": 0.2, "dzoom": 0.9})
        _viewer_wait(viewer, lambda: not viewer._ORBIT["dirty"],
                     "the orbit taken while paused")
        _http(port, "/api/pause", {"paused": False})
        _viewer_wait(viewer, lambda: viewer._STATE["seq"] > seq0,
                     "the orbit's first frame")
        with viewer._LOCK:
            low = viewer._STATE["spp"]
        if viewer._FRAME["first_cam"] is old_cam:
            raise AssertionError("tools (a) viewer: the orbit did not move "
                                 "the camera")
        _viewer_wait(viewer, lambda: viewer._STATE["spp"] >= VIEWER_SPP,
                     f"{VIEWER_SPP} passes after the orbit")
        _viewer_pause(viewer, port)
        st = json.loads(_http(port, "/api/state"))
        cam = viewer._FRAME["first_cam"]
        if not (viewer._FRAME["first_pass"] == 0 and low < spp0
                and st["uploads"] == 1):
            raise AssertionError(f"tools (a) viewer: orbit: spp {spp0} -> "
                                 f"{low} -> {st['spp']}, uploads "
                                 f"{st['uploads']}")
        # the first pass at the new pose against one compute_pixel pass on
        # the card, with the orbit camera and pass index 0
        args = cli.build_parser().parse_args(
            ["cbox", "-s", str(VIEWER_RES / 512), "--device", str(dev)] + rest)
        scene = cli.load_scene_arg(args)
        sd = scene.compile(device=dev)
        integ = cli.build_integrator(args)
        step, _ = viewer.make_interactive_step(sd, integ)
        ref_cam = viewer._orbit_camera(sd.camera)
        if not (torch.equal(ref_cam.to_world, cam.to_world)
                and torch.equal(ref_cam.to_local, cam.to_local)):
            raise AssertionError("tools (a) viewer: the orbit camera")
        ref = step(ref_cam, 0).cpu().numpy()
        err = float(np.abs(viewer._FRAME["first"] - ref).max())
        export = viewer.scene_to_web_json(scene, integ)
        served = json.loads(_http(port, "/api/scene.json"))
        same_export = served == json.loads(json.dumps(export))
        phase("tools", f"(a) orbit: spp {spp0} -> {low} -> {st['spp']}, "
              f"uploads {st['uploads']}; the first pass at the new pose "
              f"against compute_pixel on the card (pass 0, the orbit "
              f"camera): max abs error {err:.3g} over {ref.shape[0]} pixels "
              f"(limit {VIEWER_FIRST_ATOL}), mean {ref.mean():.6f}; "
              f"/api/scene.json equal to the CPU export: {same_export} "
              f"({len(served['v0'])} triangles)")
        if not err <= VIEWER_FIRST_ATOL or not np.isfinite(ref).all():
            raise AssertionError("tools (a) viewer: the first pass after the "
                                 "orbit differs from compute_pixel")
        if not same_export:
            raise AssertionError("tools (a) viewer: /api/scene.json differs "
                                 "from the CPU export")
        del sd, step

        # the timed passes: counts reset while paused, read once paused again
        spp0 = viewer._STATE["spp"]
        _reset_launches()
        with counting_rays(dev) as rays:
            t1 = time.time()
            _http(port, "/api/pause", {"paused": False})
            _viewer_wait(viewer, lambda: viewer._STATE["spp"]
                         >= spp0 + VIEWER_TIMED, f"{VIEWER_TIMED} passes")
            _viewer_pause(viewer, port)
            torch.cuda.synchronize()
            n_rays = int(rays)
        wall = viewer._STATE["frame_at"] - t1
        passes = viewer._STATE["spp"] - spp0
        launches = _launches()
        _only("tools (a) viewer", launches, ("dense_closest", "dense_anyhit"))
        st = json.loads(_http(port, "/api/state"))
        phase("tools", f"(a) {passes} timed passes (frames served): "
              f"{wall:.3f}s, {passes / wall:.3f} passes/s, {n_rays} rays, "
              f"{n_rays / wall / 1e6:.3f} Mrays/s (PNG encoding included; "
              f"the loop's own pass rate {st['pass_s']:.3f}/s); launches a "
              f"pass: dense_closest {launches['dense_closest'] / passes:.2f}, "
              f"dense_anyhit {launches['dense_anyhit'] / passes:.2f}; uploads "
              f"{st['uploads']} | {card}")
        if st["uploads"] != 1:
            raise AssertionError(f"tools (a) viewer: uploads {st['uploads']}")
    finally:
        ended = viewer.stop(srv)
    if not ended or viewer._STATE["error"]:
        raise AssertionError(f"tools (a) viewer: threads ended {ended}, "
                             f"error {viewer._STATE['error']}")
    phase("tools", "(a) server and render thread stopped: "
          f"render alive {srv.render_thread.is_alive()}, serve alive "
          f"{srv.serve_thread.is_alive()}")
    return {k: launches[k] for k in ("dense_closest", "dense_anyhit")}


def regression_check(card):
    """Phase 28 (b): the harness's --check on TOOLS_ROWS in a subprocess; its
    metrics against phases 20-21's renders of the same rows."""
    import ast
    import shutil
    out = os.path.join(ROOT, "build", "regress_phase28")
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "rustlight_tpu_torch.tools.regression",
           "--check", "-s", *TOOLS_ROWS, "--out", out]
    t0 = time.time()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    wall = time.time() - t0
    if res.returncode != 0 or "regression gate OK" not in res.stdout:
        raise AssertionError(f"tools (b) regression --check: exit "
                             f"{res.returncode}\n{res.stdout}\n{res.stderr}")
    rows = {}
    for line in res.stdout.splitlines():
        if line.startswith("[") and "] {" in line and "/" in line.split("]")[0]:
            key = line[1:line.index("]")]
            rows[key] = ast.literal_eval(line[line.index("{"):
                                              line.index("}") + 1])
    diffs = {}
    for key, got in _GATE_GOT.items():
        if key.split("/")[0] not in TOOLS_ROWS:
            continue
        if key not in rows:
            raise AssertionError(f"tools (b): no row {key} in\n{res.stdout}")
        diffs[key] = max(abs(rows[key][m] - got[m]) / abs(got[m])
                         for m in GATE_METRICS)
        if any(rows[key][m] != got[m] for m in GATE_METRICS):
            raise AssertionError(f"tools (b) {key}: harness {rows[key]} vs "
                                 f"phases 20-21 {got}")
    if len(diffs) != len(TOOLS_ROWS):
        raise AssertionError(f"tools (b): rows {sorted(diffs)}")
    phase("tools", f"(b) `{' '.join(cmd[2:-2])} --out build/"
          f"regress_phase28`: exit 0, {wall:.2f}s wall (the process's start "
          "included), rows " + "; ".join(
              f"{k} " + ", ".join(f"{m} {rows[k][m]:.6g}" for m in GATE_METRICS)
              + f" ({rows[k]['time_s']}s, backend {rows[k]['backend']}), equal "
              f"to phases 20-21's (largest relative difference {d:.3g})"
              for k, d in sorted(diffs.items())) + f" | {card}")


def smoke_check(dev, card):
    """Phase 28 (c): smoke_scenes over examples/ on the card. Returns the
    K1/K2/K3 launches of its renders."""
    from rustlight_tpu_torch.tools import smoke_scenes
    paths = sorted(p for p in smoke_scenes.EXAMPLES.iterdir()
                   if p.suffix in smoke_scenes.SUFFIXES)
    t0 = time.time()
    recs = smoke_scenes.smoke(paths, SMOKE_SIZE, SMOKE_SPP, dev,
                              log=lambda line: phase("tools", f"(c) {line}"))
    counts = {"dense_closest": 0, "dense_anyhit": 0, "walk_closest": 0,
              "walk_anyhit": 0}
    for r in recs:
        kern = (("walk_closest", "walk_anyhit") if r["tier"] == "walk"
                else ("dense_closest", "dense_anyhit"))
        if not r["ok"]:
            raise AssertionError(f"tools (c) {r['name']}: {r['status']}")
        _only(f"tools (c) {r['name']}", {**dict.fromkeys(counts, 0),
                                         **r["launches"]}, kern)
        for k, v in r["launches"].items():
            counts[k] += v
    walk = [r["name"] for r in recs if r["tier"] == "walk"]
    phase("tools", f"(c) smoke_scenes {SMOKE_SIZE}x{SMOKE_SIZE} {SMOKE_SPP} "
          f"spp: all {len(recs)} scenes finite and not black in "
          f"{time.time() - t0:.2f}s; K3 launched on every walk scene "
          f"({', '.join(walk)}), K1/K2 on the others; launches {counts}")
    if not walk:
        raise AssertionError("tools (c): no walk scene among the examples")
    return counts


def tools_phase(dev, card):
    """Phase 28: the viewer, the regression harness and smoke_scenes on the
    card. Returns the launches of (a)'s timed passes and (c)'s renders."""
    t0 = time.time()
    counts = {"dense_closest": 0, "dense_anyhit": 0, "walk_closest": 0,
              "walk_anyhit": 0}
    for k, v in viewer_check(dev, card).items():
        counts[k] += v
    regression_check(card)
    for k, v in smoke_check(dev, card).items():
        counts[k] += v
    phase("tools", f"phase 28 in {time.time() - t0:.1f}s")
    return counts


# ---- phase 29: the walk at other cluster sizes, and the laboratory's labs

# the K of the libraries phase 1 builds beside the production one
# (ops/native.py:build_k: the walk sources with -DRL_KC=<k>), and phase 29
# (a)'s wavefront: grid122k's mesh and the laboratory's divergent rays
K_OTHER = (128, 768)
K_RAYS = 32_768
K_SCENE = (122_000, 10)
# K6, K7 and K8 take tables of at most ops/walk_sub.py:MAX_VMEM_CLUSTERS
# (640, the reference's resident bound, the same at every K); where
# grid122k's tables at a K are larger, they walk the tables of this grid of
# the same family
K_RESIDENT_TRIS = 30_000
_KLIB = {}


def start_k_build():
    """Phase 1: nvcc builds the K_OTHER libraries (ops/native.py:build_k)
    in threads beside the production one; none is loaded before phase 29."""
    import threading
    from rustlight_tpu_torch.ops import native
    t0 = time.time()

    def build(k):
        try:
            _KLIB[k] = {"path": native.build_k(k),
                        "seconds": time.time() - t0}
        except Exception as e:  # raised again by wait_k_build
            _KLIB[k] = {"error": e}

    _KLIB["threads"] = [threading.Thread(target=build, args=(k,))
                        for k in K_OTHER]
    for t in _KLIB["threads"]:
        t.start()


def wait_k_build():
    """Waits for start_k_build's nvcc, raising its error; then holds each
    library's static shared memory to ops/walk_trace.py's tables at its K
    (check_static_smem)."""
    from rustlight_tpu_torch.ops import native
    for t in _KLIB.pop("threads"):
        t.join()
    for k in K_OTHER:
        if "error" in _KLIB[k]:
            raise _KLIB[k]["error"]
        phase("build", f"K = {k}: {_KLIB[k]['path'].name} ("
              f"{', '.join(native.WALK_SOURCES)}, -DRL_KC={k}) in "
              f"{_KLIB[k]['seconds']:.2f}s (from the start of the build)")
        check_static_smem(native.ptxas_usage(_KLIB[k]["path"]), k)


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _k_bitwise(tag, name, fn, plain, one=True):
    """Kernel form(s) of `fn` (its production form, and with `one` its
    one-thread form) against `plain` (the plain version's outputs, then
    any counts) bit for bit: 0 lanes may differ. Returns (the plain
    version's tuple, its ms)."""
    import torch
    from rustlight_tpu_torch.ops import walk_trace as wk
    ref, pms = _timed(plain)
    ref = _as_tuple(ref)
    forms = [("production", fn())]
    if one:
        forms.append(("P1", fn(_form=wk.ONE_THREAD_FORM)))
    torch.cuda.synchronize()
    for form, got in forms:
        got = _as_tuple(got)
        diff = _lanes_differ(got, ref[:len(got)])
        if diff.numel():
            raise AssertionError(f"{tag} {name} ({form}): {diff.numel()} "
                                 "lanes differ from the plain version")
    return ref, pms


def _flat(walk_ref):
    """wk._walk_ref's ((outputs), visits per tile) as (*outputs, visits)."""
    return (*walk_ref[0], walk_ref[1])


def _k_tables(geom, bvh, k, dev):
    from rustlight_tpu_torch.accel.walk import (build_walk_tables,
                                                walk_tables_to)
    return walk_tables_to(build_walk_tables(geom, bvh=bvh, k=k), dev)


def _k_scene(n_tris, theta):
    """The laboratory's scene at (n_tris, theta): (numpy geometry tables,
    their BVH, the grid's extent)."""
    from rustlight_tpu_torch.accel.bvh import build_bvh
    from rustlight_tpu_torch.tools.perf import common
    geom, ext = common.lab_scene(n_tris, theta)
    return geom, build_bvh(geom, max_leaf=8), ext


def _k_rays(dev, ext, n, seed):
    """The laboratory's divergent rays with inert, empty and bounded lanes
    (tools/perf/common.py:inert_lanes)."""
    import torch
    from rustlight_tpu_torch.tools.perf import common
    rng = np.random.default_rng(seed)
    o, d = common.divergent_rays(rng, n, ext)
    tnear = np.full(n, 1e-4, np.float32)
    tfar = np.full(n, np.inf, np.float32)
    common.inert_lanes(rng, tnear, tfar, ext * 3 ** 0.5)
    return [torch.as_tensor(x, device=dev) for x in (o, d, tnear, tfar)]


def check_k_forms(dev):
    """Phase 29 (a): at each K of K_OTHER, every walk kernel form that the
    production dispatch or the labs launch against its plain version at
    that K (bit for bit; the tensor-core forms under _check_mma's rules),
    and the whole walk against K = 384's on the same rays. Returns
    {"walk_closest@K<k>": record, ...} for the kernels line."""
    import torch
    from rustlight_tpu_torch.accel import pair_walk as pw
    from rustlight_tpu_torch.accel import walk
    from rustlight_tpu_torch.ops import pair_trace as pt
    from rustlight_tpu_torch.ops import walk_hier as wh
    from rustlight_tpu_torch.ops import walk_lab as wl
    from rustlight_tpu_torch.ops import walk_sparse as ws
    from rustlight_tpu_torch.ops import walk_sub as wsub
    from rustlight_tpu_torch.ops import walk_trace as wk
    t0 = time.time()
    geom, bvh, ext = _k_scene(*K_SCENE)
    rows = torch.as_tensor(np.ascontiguousarray(geom.inter_rows[:geom.n_tris]),
                           device=dev)
    rays = _k_rays(dev, ext, K_RAYS, 29)
    base = _k_tables(geom, bvh, wk.K, dev)
    ref = (walk._walk_impl(base, *rays, False), walk._walk_impl(base, *rays,
                                                                True))
    small = None
    out = {}
    for k in K_OTHER:
        wt = _k_tables(geom, bvh, k, dev)
        srt = walk._prepare(wt, *rays)[:4]
        tag = f"K{k} grid122k"
        n = srt[0].shape[0]
        table = (wt.rows.numel() + wt.ids.numel() + wt.lo.numel()
                 + wt.hi.numel()) * 4
        recs = {}
        for name, fn, plain in (
                ("walk_closest", lambda **kw: wk.walk_closest(wt, *srt, **kw),
                 lambda: _flat(wk._walk_ref(wt, *srt, False))),
                ("walk_anyhit", lambda **kw: wk.walk_anyhit(wt, *srt, **kw),
                 lambda: _flat(wk._walk_ref(wt, *srt, True))),
                ("walk_closest_wide",
                 lambda **kw: wk.walk_closest(wt, *srt, wide=True, **kw),
                 lambda: _flat(wk._walk_ref(wt, *srt, False, True))),
                ("walk_anyhit_wide",
                 lambda **kw: wk.walk_anyhit(wt, *srt, wide=True, **kw),
                 lambda: _flat(wk._walk_ref(wt, *srt, True, True)))):
            plain_out, pms = _k_bitwise(tag, name, fn, plain)
            visits = int(plain_out[-1].sum())
            any_hit = "anyhit" in name
            bound, by = _bound_ms(visits * wk.RAY_TILE * k,
                                  n * (RAY_IN_BYTES + (1 if any_hit else 16))
                                  + table)
            recs[name] = {"ms": _median_ms(fn), "plain_ms": pms,
                          "bound_ms": bound, "bound_by": by,
                          "max_abs_err": 0.0, "visits": visits}
        for name, fn, plain in (
                ("walk_hier_closest",
                 lambda **kw: wh.walk_hier_closest(wt, *srt, **kw),
                 lambda: wh.walk_hier_closest_ref(wt, *srt)[:4]),
                ("walk_hier_anyhit",
                 lambda **kw: wh.walk_hier_anyhit(wt, *srt, **kw),
                 lambda: wh.walk_hier_anyhit_ref(wt, *srt)[0])):
            _k_bitwise(tag, name, fn, plain)
        (counted, pms) = _k_bitwise(
            tag, "walk_closest_counted",
            lambda **kw: wl.walk_closest_counted(wt, *srt, **kw),
            lambda: wl.walk_closest_counted_ref(wt, *srt))
        nv = int(counted[4].view(-1, wk.RAY_TILE)[:, 0].long().sum())
        if nv != recs["walk_closest"]["visits"]:
            raise AssertionError(f"{tag}: the counted kernel's {nv} visits, "
                                 "the plain walk's "
                                 f"{recs['walk_closest']['visits']}")
        recs["walk_closest_counted"] = {
            **recs["walk_closest"], "plain_ms": pms,
            "ms": _median_ms(lambda: wl.walk_closest_counted(wt, *srt))}
        # K6, K7 and K8 on resident tables
        rwt, rsrt, rrows, rtag = wt, srt, rows, tag
        if int(wt.n_clusters) > wsub.MAX_VMEM_CLUSTERS:
            if small is None:
                sgeom, sbvh, sext = _k_scene(K_RESIDENT_TRIS, K_SCENE[1])
                small = (sgeom, sbvh, _k_rays(dev, sext, K_RAYS // 2, 30),
                         torch.as_tensor(np.ascontiguousarray(
                             sgeom.inter_rows[:sgeom.n_tris]), device=dev))
            rwt = _k_tables(small[0], small[1], k, dev)
            rsrt = walk._prepare(rwt, *small[2])[:4]
            rrows = small[3]
            rtag = f"K{k} sphere_grid_mesh({K_RESIDENT_TRIS})"
        for name, fn, plain in (
                ("walk_sub_closest",
                 lambda **kw: wsub.walk_sub_closest(rwt, *rsrt, 2, **kw),
                 lambda: wsub.walk_sub_closest_ref(rwt, *rsrt, 2)[:4]),
                ("walk_sub_anyhit",
                 lambda **kw: wsub.walk_sub_anyhit(rwt, *rsrt, 2, **kw),
                 lambda: wsub.walk_sub_anyhit_ref(rwt, *rsrt, 2)[0]),
                ("walk_sparse_closest",
                 lambda **kw: ws.walk_sparse_closest(rwt, *rsrt, **kw),
                 lambda: ws.walk_sparse_closest_ref(rwt, *rsrt)[:4]),
                ("walk_sparse_anyhit",
                 lambda **kw: ws.walk_sparse_anyhit(rwt, *rsrt, **kw),
                 lambda: ws.walk_sparse_anyhit_ref(rwt, *rsrt)[0])):
            _k_bitwise(rtag, name, fn, plain)
        msrt = walk._prepare(rwt, *(small[2] if rwt is not wt else rays),
                             inc_sort=False)[:4]
        pairs, _ = pw._make_pairs(rwt, *msrt, PAIR_KMS[0])
        for name, fn, plain in (
                ("pair_closest", lambda **kw: pt.pair_closest(rwt, *pairs,
                                                              **kw),
                 lambda: pt.pair_closest_ref(rwt, *pairs)[:4]),
                ("pair_anyhit", lambda **kw: pt.pair_anyhit(rwt, *pairs,
                                                            **kw),
                 lambda: pt.pair_anyhit_ref(rwt, *pairs)[0])):
            _k_bitwise(f"{rtag} km={PAIR_KMS[0]}", name, fn, plain)
        phase("k", f"{tag} (Cp {wt.n_clusters}, {wt.n_real} real, "
              f"{wt.n_sup} supers; {n} rays): K3/K4, K3w, K5 and K9a, both "
              f"forms, = their plain versions bit for bit; K6 at sub 2, K7 "
              f"and K8 at km {PAIR_KMS[0]} on {rtag} (Cp {rwt.n_clusters}) "
              "too; " + "; ".join(
                  f"{nm}: {r['ms']:.4f} ms, plain {r['plain_ms']:.1f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"{r['visits'] / (n // wk.RAY_TILE):.2f} visits/tile"
                  for nm, r in recs.items()))
        # the tensor-core forms under _check_mma's rules
        mrec = _Records()
        _check_mma(tag, rows, wt, srt,
                   _walk_variants(wt, srt, ("walk", "walk_wide",
                                            "walk_hier")),
                   True, mrec, forms=False)
        _check_mma(rtag, rrows, rwt, rsrt, _walk_variants(rwt, rsrt,
                                                          ("sub2",)),
                   True, mrec, forms=False)
        _check_mma(f"{rtag} km={PAIR_KMS[0]}", rrows, rwt, pairs[:4],
                   _pair_variants(rwt, pairs, PAIR_KMS[0]), True, mrec,
                   in_bytes=PAIR_IN_BYTES, forms=False)
        # the same rays against K = 384, the whole walk in lane order
        got = (walk._walk_impl(wt, *rays, False),
               walk._walk_impl(wt, *rays, True))
        torch.cuda.synchronize()
        if not torch.equal(got[0].hit, ref[0].hit):
            raise AssertionError(f"{tag}: hit masks differ from K = 384's on "
                                 f"{int((got[0].hit != ref[0].hit).sum())} "
                                 "lanes")
        diff = torch.nonzero(got[0].tri != ref[0].tri)[:, 0]
        if diff.numel() and not _near_tie(rows, *rays, diff):
            raise AssertionError(f"{tag}: {diff.numel()} triangle ids differ "
                                 "from K = 384's outside near ties")
        same = got[0].hit & (got[0].tri == ref[0].tri)
        if not torch.equal(got[0].t[same].view(torch.int32),
                           ref[0].t[same].view(torch.int32)):
            raise AssertionError(f"{tag}: t differs from K = 384's on the "
                                 "same triangle")
        if not torch.equal(got[1], ref[1]):
            raise AssertionError(f"{tag}: occlusion differs from K = 384's")
        phase("k", f"{tag} vs K = 384 on the same {K_RAYS} rays: hit masks "
              f"and occlusion equal, {diff.numel()} ids differ (near ties), t"
              " bit for bit on the others")
        for name in ("walk_closest", "walk_closest_counted"):
            out[f"{name}@K{k}"] = recs[name]
    phase("k", f"phase 29 (a) in {time.time() - t0:.1f}s")
    return out


# phase 29 (b): each lab's main at sizes that keep it short
LAB_RUNS = (
    ("sortkey_lab", ["--rays", "16384"]),
    ("grouping_lab", ["--rays", "4096"]),
    ("greedy_onchip", ["--rays", "8192", "--runs", "3"]),
    ("k_sweep", ["--ks", "384,128", "--rays", "16384", "--runs", "3"]),
    ("k_sweep_bench", ["--ks", "128,384,768", "--rays", "65536",
                       "--runs", "3"]),
    ("prim_gather_scale", ["--nb", "1024,16384", "--runs", "1"]),
    ("e2e_131k", ["--spp", "2"]),
    ("e2e_4p9M", ["--ao-spp", "1"]))


def labs_phase(dev):
    """Phase 29 (b): each lab of rustlight_tpu_torch/tools/perf/ once on the
    card at LAB_RUNS' sizes, its record under build/lab/phase29/, with the
    per-K launch counts (ops/native.py:K_LAUNCHES) reset just before and
    read just after. Returns them."""
    import importlib
    from rustlight_tpu_torch.ops import native
    t0 = time.time()
    native.K_LAUNCHES.clear()
    out_dir = os.path.join(ROOT, "build", "lab", "phase29")
    for name, argv in LAB_RUNS:
        t1 = time.time()
        mod = importlib.import_module(
            f"rustlight_tpu_torch.tools.perf.{name}")
        extra = (["--png", os.path.join(out_dir, "bigscene_4p9M.png")]
                 if name == "e2e_4p9M" else [])
        mod.main(["--device", str(dev), *argv, *extra,
                  "--out", os.path.join(out_dir, f"{name}.json")])
        phase("labs", f"{name} {' '.join(argv)} in {time.time() - t1:.1f}s")
    launches = dict(native.K_LAUNCHES)
    phase("labs", f"phase 29 (b) in {time.time() - t0:.1f}s; launches at "
          f"other K: {launches}")
    return launches


def bounce_wavefront(sd, integ):
    """The first wavefront that `integ`'s 1 spp render on `sd` keys by
    incidence (accel/walk.py:_incidence_key's arguments, cloned)."""
    from rustlight_tpu_torch.accel import walk as tw
    got, key = [], tw._incidence_key

    def capture(wt, *rays):
        if not got:
            got.append([x.clone() for x in rays])
        return key(wt, *rays)

    tw._incidence_key = capture
    try:
        _render(sd, integ, 1)
    finally:
        tw._incidence_key = key
    return got[0]


def coherence_key_phase(dev, clock_hz):
    """Phase 30: the incidence key's kernel against its plain version on
    grid122k's bounce wavefront at KEY_RES, every lane live; its times and
    bound. Returns the record."""
    import torch
    from rustlight_tpu_torch.integrators import IntegratorPathTracing
    from rustlight_tpu_torch.models import sphere_grid
    from rustlight_tpu_torch.ops import coherence_key as ck
    sd = sphere_grid(122_000, *KEY_RES).compile(device=dev)
    wt = sd.geom.walk
    o, d, tnear, tfar = bounce_wavefront(
        sd, IntegratorPathTracing(max_depth=GRID_DEPTH))
    live = torch.nonzero(tfar > 0.0)[:, 0]
    n_live = live.numel()
    gen = torch.Generator(device=dev).manual_seed(KEY_SEED)
    lane = torch.where(tfar > 0.0, torch.arange(tfar.numel(), device=dev),
                       live[torch.randint(n_live, tfar.shape, device=dev,
                                          generator=gen)])
    rays = [x[lane].contiguous() for x in (o, d, tnear, tfar)]
    n, c = rays[0].shape[0], int(wt.n_real)
    got = ck.incidence_key(wt, *rays)
    again = ck.incidence_key(wt, *rays)
    ref = ck.incidence_key_ref(wt, *rays)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("incidence key: two launches differ")
    diff = int((got[1] != ref[1]).sum())
    if diff:
        raise AssertionError(f"incidence key: {diff} counts differ from the "
                             "plain version")
    same = float((got[0] == ref[0]).float().mean())
    if same < KEY_FRAC:
        raise AssertionError(f"incidence key: major key equal on {same:.6f} "
                             f"of the lanes, under {KEY_FRAC}")
    bound = n * c * KEY_OPS / (132 * 128 * clock_hz) * 1e3
    rec = {"table": "grid122k", "wavefront": "bounce", "rays": n,
           "live_before": n_live, "clusters": c, "major_equal": same,
           "counts_differ": diff,
           "ms": _median_ms(lambda: ck.incidence_key(wt, *rays)),
           "device_us": _device_us(lambda: ck.incidence_key(wt, *rays),
                                   "incidence_key_kernel"),
           "plain_ms": _median_ms(lambda: ck.incidence_key_ref(wt, *rays),
                                  runs=3),
           "bound_ms": bound, "bound_by": "operations"}
    phase("key", f"grid122k bounce {n} lanes ({n_live} live as handed, the "
          f"rest drawn from them) x {c} clusters: counts equal, major key "
          f"equal on {100 * same:.4f}%, two launches identical; wrapper "
          f"{rec['ms']:.4f} ms, device {rec['device_us']:.2f} us, plain "
          f"{rec['plain_ms']:.3f} ms, bound {bound:.4f} ms ({KEY_OPS} FP32 "
          f"a pair at {clock_hz / 1e6:.0f} MHz)")
    return rec


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
    start_k_build()
    lib = native.build(verbose=True)
    phase("build", f"{lib.name} in {time.time() - t0:.2f}s")
    ptxas_table()
    check_static_smem()
    wait_lab_build()
    phase("build", f"RL_LAB_FORMS library of K7's, K3w's and K8's forms in "
          f"{_LAB['seconds']:.2f}s (from the start of the build)")
    wait_k_build()

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
    img, wall, warm, n_rays, launches = timed_render(
        "cbox", sd, integ, CBOX_SPP, warm_spp=CBOX_WARM_SPP)
    l1, floor = block_mean_l1(img)
    if not l1 <= GATE_MARGIN * floor:
        raise AssertionError(f"render: block-mean l1 {l1:.6f} > "
                             f"{GATE_MARGIN} x floor {floor:.6f}")
    for name in ("dense_closest", "dense_anyhit"):
        if launches[name] <= 0:
            raise AssertionError(f"render: kernel {name} never launched")
    cbox_launches = launches
    cbox_mean = float(img.mean())
    phase("main", f"cbox {CBOX_RES}x{CBOX_RES} {CBOX_SPP} spp depth "
          f"{CBOX_DEPTH}: warm-up {warm:.3f}s, timed {wall:.3f}s, {n_rays} "
          f"rays, {n_rays / wall / 1e6:.3f} Mrays/s, mean {img.mean():.6f}, "
          f"block-mean l1 {l1:.6f} (limit {GATE_MARGIN * floor:.6f}), "
          f"launches { {k: v for k, v in launches.items() if v} }")
    profile_render("cbox", sd, integ, CBOX_PROFILE_SPP, ("dense_",))
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
    # the incidence key's launches in the grid and AO rows' timed renders
    key_launches = 0
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
        if launches["incidence_key"] <= 0:
            raise AssertionError(f"{label}: the incidence key never launched")
        for k in walk_launches:
            walk_launches[k] += launches[k]
        key_launches += launches["incidence_key"]
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
        profile_render(label, gsd, integ, SCHED_PROFILE_SPP, ("walk_",))
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
    key_launches += ao_launches["incidence_key"]
    lab_recs = check_lab(dev)
    a1 = a1_summary(mma_recs["mma_forms"] + lab_recs["mma_forms"],
                    lab_recs["mma_form_visits"])
    lab_launches = lab_path(dev)
    gate_launches = gate_phase(dev, card)
    for k, v in slice_phase(dev, card).items():
        gate_launches[k] += v
    ex_launches = examples_phase(dev, card)
    for k in ("dense_closest", "dense_anyhit"):
        gate_launches[k] += ex_launches[k]
    for k, v in volume_phase(dev, card).items():
        gate_launches[k] += v
    for k, v in gradient_mcmc_phase(dev, card).items():
        gate_launches[k] += v
    for k, v in smcmc_ats_phase(dev, card).items():
        (gate_launches if k.startswith("dense") else walk_launches)[k] += v
    for k, v in guiding_meta_phase(dev, card, cbox_mean).items():
        (gate_launches if k.startswith("dense") else walk_launches)[k] += v
    for k, v in mesh_phase(dev, card).items():
        (gate_launches if k.startswith("dense") else walk_launches)[k] += v
    for k, v in tools_phase(dev, card).items():
        (gate_launches if k.startswith("dense") else walk_launches)[k] += v
    for k in ("walk_closest", "walk_anyhit"):
        walk_launches[k] += ex_launches[k]
    k_recs = check_k_forms(dev)
    k_launches = labs_phase(dev)
    key_rec = coherence_key_phase(dev, float(clock[0]) * 1e6)

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
            "replaces": replaces,
            "launches": cbox_launches[name] + gate_launches[name],
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
            "library_ms": None, "form": rec["form"], "p1_ms": rec["p1_ms"],
            "device_us": rec["device_us"],
            "p1_device_us": rec["p1_device_us"], "walk_ms": rec["walk_ms"],
            "walk_p1_ms": rec["walk_p1_ms"], "cases": cases})
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
                    "dot4_ms", "walk_ms", "walk_p1_ms", "bound_ms",
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
    # the walk at other K: K3 and the counted kernel (K9a), which phase
    # 29's labs launch at K_OTHER; their numbers from phase 29 (a)
    for key, rec in k_recs.items():
        name, k = key.split("@K")
        counted = name == "walk_closest_counted"
        kernels.append({
            "name": key, "route": "cuda",
            "source": KERNEL_SOURCES["lab" if counted else "walk"],
            "replaces": (f"{ROOFLINE}:58" if counted else
                         WALK_REPLACES.format(636, 1139)) + f", K = {k}",
            "launches": k_launches.get(key, 0),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    kernels.append({
        "name": "incidence_key", "route": "cuda",
        "source": KERNEL_SOURCES["key"],
        "replaces": "none: rustlight_tpu/accel/pallas_walk.py:379 "
                    "_incidence_key is XLA",
        "launches": key_launches,
        **{k: key_rec[k] for k in ("major_equal", "counts_differ", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "device_us")},
        "library_ms": None})
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

"""Command-line renderer: the ported subset of rustlight_tpu/cli.py.

Usage: python -m rustlight_tpu_torch.cli cbox -n 64 -o out.exr path -m 6
       python -m rustlight_tpu_torch.cli examples/envglass.xml -n 16 -o e.exr path -m 8
       python -m rustlight_tpu_torch.cli examples/caustic.pbrt -n 16 -o c.exr direct
       python -m rustlight_tpu_torch.cli mesh.obj -n 4 -o ao.pfm ao -d 2
       python -m rustlight_tpu_torch.cli cbox -n 8 -o l.exr light -m 8
       python -m rustlight_tpu_torch.cli cbox -m 0.0025 -n 8 -o m.exr path -m 8
       python -m rustlight_tpu_torch.cli cbox -n 8 -o v.exr vpl -m 6 -n2 256
       python -m rustlight_tpu_torch.cli cbox -m 0.0025 -n 8 -o p.exr point-normal
       python -m rustlight_tpu_torch.cli cbox -n 4 -o s.exr smcmc -m 6
       python -m rustlight_tpu_torch.cli cbox -x ats -n 8 -o a.exr path -m 6
       python -m rustlight_tpu_torch.cli cbox -n 2 -a 8 --guiding -o g.pfm path -m 6

Flags keep the reference CLI's names. Ported so far: scene files (.pbrt,
.xml and .obj, through scene/loaders) and the built-in `cbox`, `veach_mis`
and `door_box` scenes; the `path` integrator with -m/-n/-r/-x/-s
(strategies all, bsdf, emitter, naive; -x single scattering), the
`light-tracing` (`light`) integrator with -m/-n/-r and -s all | surface |
volume, the `ao` integrator with -d/--distance (`inf` for no limit) and
-c/--normal-correction, the `direct` integrator with -b/--nb-bsdf-samples
and -l/--nb-light-samples, `vpl` (-m/-n/-r, -b/--clamping, -n2/--nb-vpl),
`vol-primitives` (`vol-primitivies`; -m/-n/-r, -n2/--nb-primitive, -p bre
| beams | planes | vrl), `plane-single` and `uncorrelated-plane-single`
(-n2/--nb-primitive, -s uv | ut | vt | average | discrete_mis | ualpha |
cmis) and `point-normal` (-s and its strategy names, -w/--warps, -W L | B,
-z/--disable-aa, -k/--splitting, which takes the reference's ATS traversal
only with ATS tables, and -x/--use-mis, parsed and unused as in the
reference; these last four need -m); the gradient-domain path tracers
`gradient-path` (the reconnection shift; -m/-n/-r, -i/--iterations,
--strategy-recons uniform | weighted | bagging) and
`gradient-path-explicit` (the random-replay shift; the same and
--min-survival); `pssmlt` (-m/-n/-r, -s, -p/--large-prob,
-b/--nb-samples-norm), `erpt` (-m/-n/-r, -s, -k/--stratified, -e2/--nb-mc,
-c/--chain-samples) and `smcmc` (-m/-n/-r, -s, -p/--large-prob,
--recons-smcmc irls | naive, --init mcmc | independent; under -a its
chains persist across passes); and the global flags -n/--nbsamples,
-o/--output (.pfm, .exr, .png), -s/--scale-image (the camera re-derived
for the new size), -m/--medium sigma_s[:sigma_a[:g]] (an infinite
homogeneous medium), -r/--random-number-generator independent[:seed] |
stratified, --aovs (every buffer of the film as <output>_<name>.<ext>) and
-x/--xtra-options ats (the ATS light tree for NEE), no-shading, hvs-light
and texture-light (butterfly.jpg from the working directory, else a
procedural ramp), -a/--average N | Ns | inf (passes averaged, dumped as
<output>_<k>.pfm with the integrator's state beside them and
<output>_time.csv; --resume continues from the newest dump, --progress
draws a bar), -e/--equal-time (a render-time budget in milliseconds),
--guiding (the guided path tracer; its table persists across -a / -e
passes), --adaptive (variance-adaptive sampling of a per-pixel
integrator), --feature-aovs (first-hit albedo, normal and depth added to
the film), --profile OUT.json (per-phase timings and run metadata) and
-l/--log FILE and -t/--threads N. `--device` names the torch device to
render on.

-t N renders over a device mesh of n ranks (parallel/mesh.py), one process
each: on the card n = min(N, the cards torch sees) with NCCL, rank r on
cuda:r; on the CPU n = min(N, os.cpu_count()) gloo ranks (the counterpart
of XLA's virtual host devices, which the JAX package's -t shards over
there). Only n > 1 builds a mesh, as the reference; with n = 1 the run logs
so and renders on one device. Every rank renders its share; rank 0 writes
the output, the dumps and the log.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time

# integrator subcommands of the reference CLI that have no port yet
_NOT_PORTED = ()
# point-normal's -s names and the strategies they take
# (rustlight_tpu/cli.py:284-306); any other name takes tr and equiangular
_PN_STRATEGIES = {
    "tr_ex": ("tr", "equiangular"),
    "tr": ("tr",),
    "ex": ("equiangular",),
    "eq_ex": ("equiangular",),
    "ex_clamp": ("eq_clamp",),
    "eq_clamped_ex": ("eq_clamp",),
    "eq_warp_ex": ("warp",),
    "eq_tr_taylor_ex": ("taylor_tr",),
    "eq_phase_taylor_ex": ("taylor_phase",),
    "pn_ex": ("pn",),
    "eq_best_ex": ("best",),
    "pn_best_ex": ("pn_best",),
    "pn_warp_ex": ("pn", "warp"),
    "pn_tr_taylor_ex": ("pn_taylor_tr",),
    "pn_phase_taylor_ex": ("pn_taylor_phase",),
    "all": ("tr", "equiangular", "eq_clamp"),
    # the phase connection (a name ending in _phase)
    "eq_phase": ("equiangular",),
    "tr_phase": ("tr",),
    "eq_clamped_phase": ("eq_clamp",),
}
_PLANE_STRATEGIES = ["uv", "ut", "vt", "average", "discrete_mis", "ualpha",
                     "cmis"]
# -x values of the reference CLI that have no port yet
_NOT_PORTED_XTRA = ()
_BUILTIN = ("cbox", "veach_mis", "door_box")


def _inf_or(s, conv=int):
    """'inf' sentinel parsing, as the reference CLI does."""
    if s is None or s == "inf":
        return None
    return conv(s)


def _add_path_length(p):
    p.add_argument("-m", "--max-depth", default="inf")
    p.add_argument("-n", "--min-depth", default="0")
    p.add_argument("-r", "--rr-depth", default="0")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rustlight_tpu_torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("scene", help="scene file (.pbrt/.xml/.obj) or a "
                    "builtin: " + ", ".join(_BUILTIN))
    ap.add_argument("-n", "--nbsamples", type=int, default=1)
    ap.add_argument("-o", "--output", default="out.pfm")
    ap.add_argument("-s", "--scale-image", type=float, default=1.0)
    ap.add_argument("-r", "--random-number-generator", default="independent",
                    help="independent[:seed] | stratified")
    ap.add_argument("--aovs", action="store_true",
                    help="also write every buffer of the film as "
                    "<output>_<name>.<ext>")
    ap.add_argument("-m", "--medium", default="0.0",
                    help="sigma_s[:sigma_a[:g]] for an infinite homogeneous "
                    "medium")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda, cuda:1, cpu)")
    ap.add_argument("-a", "--average", default=None,
                    help="averaging passes or time budget ('inf' / '10s')")
    ap.add_argument("--progress", action="store_true",
                    help="in-place per-pass progress bar on stderr under "
                    "-a/-e")
    ap.add_argument("--resume", action="store_true",
                    help="continue -a averaging from the newest "
                    "<output>_<k>.pfm dump (bit-exact against an "
                    "uninterrupted run)")
    ap.add_argument("--adaptive", action="store_true",
                    help="variance-adaptive sampling: a pilot quarter of -n "
                    "measures per-pixel noise, the rest of the budget goes "
                    "to noisy pixels (per-pixel MC integrators)")
    ap.add_argument("--guiding", action="store_true",
                    help="path guiding: per-voxel directional radiance "
                    "histograms learned online, sampled as a defensive "
                    "BSDF/guide mixture (the path integrator)")
    ap.add_argument("--feature-aovs", action="store_true",
                    help="add denoiser guide channels (first-hit "
                    "albedo/normal/depth) to the film; write them with "
                    "--aovs")
    ap.add_argument("--profile", metavar="OUT.json", default=None,
                    help="write per-phase wall-clock timings and run "
                    "metadata as JSON")
    ap.add_argument("-e", "--equal-time", type=float, default=None,
                    help="render-time budget in milliseconds")
    ap.add_argument("-l", "--log", default=None,
                    help="write the log to this file instead of stderr")
    ap.add_argument("-t", "--threads", type=int, default=None,
                    help="render over a mesh of min(N, devices) ranks: "
                    "NCCL across cards, gloo processes on the CPU")
    ap.add_argument("-x", "--xtra-options", action="append", default=[],
                    choices=["ats", "no-shading", "hvs-light",
                             "texture-light"])
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("path")
    _add_path_length(p)
    p.add_argument("-x", "--single-scattering", action="store_true")
    p.add_argument("-s", "--strategy", default="all",
                   choices=["all", "bsdf", "emitter", "naive"])
    p = sub.add_parser("light-tracing", aliases=["light"])
    _add_path_length(p)
    p.add_argument("-s", "--strategy", default="all",
                   choices=["all", "surface", "volume"])
    p = sub.add_parser("ao")
    p.add_argument("-d", "--distance", default="1.0")
    p.add_argument("-c", "--normal-correction", action="store_true")
    p = sub.add_parser("direct")
    p.add_argument("-b", "--nb-bsdf-samples", type=int, default=1)
    p.add_argument("-l", "--nb-light-samples", type=int, default=1)
    p = sub.add_parser("vpl")
    _add_path_length(p)
    p.add_argument("-b", "--clamping", type=float, default=0.0)
    p.add_argument("-n2", "--nb-vpl", type=int, default=128)
    p = sub.add_parser("vol-primitivies", aliases=["vol-primitives"])
    _add_path_length(p)
    p.add_argument("-n2", "--nb-primitive", type=int, default=128)
    p.add_argument("-p", "--primitives", default="BRE",
                   choices=["BRE", "Beams", "Planes", "VRL",
                            "bre", "beams", "planes", "vrl"])
    for name in ("plane-single", "uncorrelated-plane-single"):
        p = sub.add_parser(name)
        p.add_argument("-n2", "--nb-primitive", type=int, default=128)
        p.add_argument("-s", "--strategy", default="average",
                       choices=_PLANE_STRATEGIES)
    p = sub.add_parser("point-normal")
    p.add_argument("-k", "--splitting", type=float, default=None)
    p.add_argument("-x", "--use-mis", action="store_true")
    p.add_argument("-z", "--disable-aa", action="store_true")
    p.add_argument("-s", "--strategy", default="tr_ex")
    p.add_argument("-w", "--warps", default="T",
                   help="warp chain chars from {T,P,N}")
    p.add_argument("-W", "--warps-strategy", default="L",
                   choices=["L", "B"], help="Linear | Bezier wrap")
    for name in ("gradient-path", "gradient-path-explicit"):
        p = sub.add_parser(name)
        _add_path_length(p)
        p.add_argument("-i", "--iterations", type=int, default=50)
        p.add_argument("--strategy-recons", default="uniform",
                       choices=["uniform", "weighted", "bagging"])
    p.add_argument("--min-survival", type=float, default=1.0)
    p = sub.add_parser("pssmlt")
    _add_path_length(p)
    p.add_argument("-s", "--strategy", default="all")
    p.add_argument("-p", "--large-prob", type=float, default=0.3)
    p.add_argument("-b", "--nb-samples-norm", type=int, default=100000)
    p = sub.add_parser("erpt")
    _add_path_length(p)
    p.add_argument("-k", "--stratified", action="store_true")
    p.add_argument("-s", "--strategy", default="all")
    p.add_argument("-e2", "--nb-mc", type=int, default=1)
    p.add_argument("-c", "--chain-samples", type=int, default=100)
    p = sub.add_parser("smcmc")
    _add_path_length(p)
    p.add_argument("-s", "--strategy", default="all")
    p.add_argument("-p", "--large-prob", type=float, default=0.3)
    p.add_argument("--recons-smcmc", default="irls")
    p.add_argument("--init", default="mcmc")
    for name in _NOT_PORTED:
        q = sub.add_parser(name)
        q.add_argument("rest", nargs=argparse.REMAINDER)
    return ap


def build_integrator(args):
    """The integrator of the subcommand, with the reference CLI's arguments
    (rustlight_tpu/cli.py:244-339)."""
    from .integrators import (IntegratorAO, IntegratorDirect,
                              IntegratorLightTracing, IntegratorPathTracing,
                              IntegratorPointNormal, IntegratorSinglePlane,
                              IntegratorVolPrimitives, IntegratorVPL)
    cmd = args.command
    if cmd in ("plane-single", "uncorrelated-plane-single"):
        return IntegratorSinglePlane(
            nb_primitive=args.nb_primitive,
            strategy={"discrete_mis": "dmis"}.get(args.strategy,
                                                  args.strategy),
            uncorrelated=cmd.startswith("uncorrelated"))
    if cmd == "point-normal":
        # -x (use-mis) is parsed and unused, as in the reference
        return IntegratorPointNormal(
            strategies=_PN_STRATEGIES.get(args.strategy,
                                          ("tr", "equiangular")),
            splitting=args.splitting, warps=args.warps,
            use_aa=not args.disable_aa,
            connection="phase" if args.strategy.endswith("_phase") else "ex",
            warps_strategy="bezier" if args.warps_strategy == "B"
            else "linear")
    if args.command == "ao":
        return IntegratorAO(max_distance=_inf_or(args.distance, float),
                            normal_correction=args.normal_correction)
    if args.command == "direct":
        return IntegratorDirect(args.nb_bsdf_samples, args.nb_light_samples)
    pl = dict(min_depth=_inf_or(args.min_depth),
              max_depth=_inf_or(args.max_depth),
              rr_depth=_inf_or(args.rr_depth))
    if cmd == "vpl":
        return IntegratorVPL(nb_vpl=args.nb_vpl, max_depth=pl["max_depth"],
                             rr_depth=pl["rr_depth"],
                             clamping_factor=args.clamping or None)
    if cmd in ("vol-primitivies", "vol-primitives"):
        return IntegratorVolPrimitives(
            nb_primitive=args.nb_primitive, max_depth=pl["max_depth"],
            rr_depth=pl["rr_depth"], primitives=args.primitives.lower())
    if cmd == "gradient-path":
        from .integrators.gradient import IntegratorGradientPathReconnect
        return IntegratorGradientPathReconnect(
            max_depth=pl["max_depth"], min_depth=pl["min_depth"],
            recons=args.strategy_recons, recons_iterations=args.iterations)
    if cmd == "gradient-path-explicit":
        from .integrators.gradient import IntegratorGradientPath
        return IntegratorGradientPath(
            max_depth=pl["max_depth"], recons=args.strategy_recons,
            recons_iterations=args.iterations,
            min_survival=args.min_survival)
    if cmd == "pssmlt":
        from .integrators.mcmc import IntegratorPSSMLT
        return IntegratorPSSMLT(
            IntegratorPathTracing(strategy=args.strategy, **pl),
            large_prob=args.large_prob,
            nb_samples_norm=args.nb_samples_norm)
    if cmd == "erpt":
        from .integrators.mcmc import IntegratorERPT
        return IntegratorERPT(
            IntegratorPathTracing(strategy=args.strategy, **pl),
            nb_mc=args.nb_mc, chain_samples=args.chain_samples,
            stratified=args.stratified)
    if cmd == "smcmc":
        from .integrators.mcmc import IntegratorSMCMC
        # the chains persist across -a passes, each returning the
        # cumulative reconstruction (-a then replaces the film each pass)
        return IntegratorSMCMC(
            IntegratorPathTracing(strategy=args.strategy, **pl),
            large_prob=args.large_prob, recons=args.recons_smcmc,
            init=args.init, keep_chains=args.average is not None)
    if args.command in ("light-tracing", "light"):
        return IntegratorLightTracing(
            render_surface=args.strategy in ("all", "surface"),
            render_volume=args.strategy in ("all", "volume"), **pl)
    return IntegratorPathTracing(strategy=args.strategy,
                                 single_scattering=args.single_scattering,
                                 **pl)


def _medium(spec):
    """-m sigma_s[:sigma_a[:g]]: a gray infinite medium, or None when
    sigma_s is 0."""
    from .scene import make_volume
    parts = str(spec).split(":")
    sigma_s = float(parts[0])
    if not sigma_s > 0.0:
        return None
    sigma_a = float(parts[1]) if len(parts) > 1 else 0.0
    g = float(parts[2]) if len(parts) > 2 else 0.0
    return make_volume(sigma_s=(sigma_s,) * 3, sigma_a=(sigma_a,) * 3, g=g)


def _uv_emission(scene, hsv: bool) -> None:
    """-x hvs-light / texture-light: every light's emission becomes the HSV
    ramp or a texture (butterfly.jpg from the working directory as the
    reference has it, else a procedural two-color ramp), scaled by the
    luminance of its color (reference cli.rs:409-429)."""
    import numpy as np
    lum = np.array([0.212671, 0.715160, 0.072169], np.float32)
    tex_id = -1
    if not hsv:
        try:
            from .utils import image as rimage
            img = np.asarray(rimage.load("butterfly.jpg"), np.float32)
        except OSError:       # missing or unreadable (PIL's errors are OSError)
            yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 63.0
            img = np.stack([xx, yy, 0.5 * (1 - xx)], -1)
        if scene.textures is None:
            scene.textures = img[None]
        else:
            th = max(scene.textures.shape[1], img.shape[0])
            tw = max(scene.textures.shape[2], img.shape[1])

            def pad(a):
                out = np.zeros((a.shape[0], th, tw, 3), np.float32)
                out[:, :a.shape[1], :a.shape[2]] = a
                return out
            scene.textures = np.concatenate([pad(scene.textures),
                                             pad(img[None])], 0)
        tex_id = scene.textures.shape[0] - 1
    for m in scene.meshes:
        if m.is_light:
            m.emission_scale = float((m.emission * lum).sum()) or 1.0
            m.emission_kind = 1 if hsv else 2
            m.emission_tex = tex_id


def load_scene_arg(args):
    """The host scene of the scene argument, with -s, -m and -x applied."""
    from .models import cornell_box, door_box, veach_mis
    from .scene import resize_camera
    from .scene.loaders import load_scene
    builtin = {"cbox": cornell_box, "veach_mis": veach_mis,
               "door_box": door_box}
    scene = (builtin[args.scene]() if args.scene in builtin
             else load_scene(args.scene))
    if args.scale_image != 1.0:
        cam = scene.camera
        scene.camera = resize_camera(cam, int(cam.width * args.scale_image),
                                     int(cam.height * args.scale_image))
    medium = _medium(args.medium)
    if medium is not None:
        scene.volume = medium
    hsv = "hvs-light" in args.xtra_options
    if hsv or "texture-light" in args.xtra_options:
        _uv_emission(scene, hsv)
    return scene


def _render_film(args, sd, integ, seed, sampler, log, mesh=None):
    """The film of the run: -e, then -a, then --guiding, then --adaptive,
    then one render, as the reference's main dispatches
    (rustlight_tpu/cli.py:474-553), over `mesh` if given."""
    from .integrators import IntegratorPathTracing, SplattingIntegrator
    from .integrators.meta import (IntegratorAverage, IntegratorEqualTime,
                                   _render_once)
    if args.guiding and (args.average is not None
                         or args.equal_time is not None):
        # under -a/-e the guide table persists across passes (and -a dumps
        # checkpoint it, so that --resume continues bit for bit)
        from .integrators.guiding import IntegratorGuidedPath
        if type(integ) is not IntegratorPathTracing:
            raise SystemExit("--guiding needs the `path` integrator")
        integ = IntegratorGuidedPath(integ)
        log.info("Guided path tracing: table persists across passes")
    if args.equal_time is not None:
        # -e is milliseconds, as the reference's (equal_time.rs:5)
        meta = IntegratorEqualTime(integ, target_s=args.equal_time / 1e3,
                                   spp_per_pass=args.nbsamples, mesh=mesh,
                                   progress=args.progress)
        film = meta.render(sd, seed=seed, verbose=True)
        log.info("Achieved spp: %d", meta.achieved_spp)
        return film
    if args.average is not None:
        kw = dict(spp_per_pass=args.nbsamples,
                  dump_base=args.output.rsplit(".", 1)[0],
                  resume=args.resume, progress=args.progress, mesh=mesh)
        if args.average == "inf":
            # forever, a dump a pass (avg.rs:21): stop with Ctrl-C and
            # continue later with --resume
            meta = IntegratorAverage(integ, **kw)
        elif args.average.endswith("s"):
            meta = IntegratorAverage(integ, timeout_s=float(args.average[:-1]),
                                     **kw)
        else:
            meta = IntegratorAverage(integ, nb_passes=int(args.average), **kw)
        try:
            return meta.render(sd, seed=seed, verbose=True)
        except KeyboardInterrupt:
            if meta.infinite:
                log.info("interrupted; last dump kept at %s_<n>.pfm",
                         meta.dump_base)
            raise
    if args.guiding:
        from .integrators.guiding import render_guided
        if type(integ) is not IntegratorPathTracing:
            raise SystemExit("--guiding needs the `path` integrator")
        return render_guided(sd, integ, args.nbsamples, seed,
                             verbose=mesh is None or mesh.rank == 0,
                             mesh=mesh)
    if args.adaptive:
        from .integrators.common import render_adaptive
        if isinstance(integ, SplattingIntegrator) or hasattr(integ, "render"):
            raise SystemExit(
                "--adaptive needs a per-pixel MC integrator "
                "(path/ao/direct/...); splatting and self-driving "
                "integrators allocate their own budgets")
        return render_adaptive(sd, integ, args.nbsamples, seed,
                               verbose=mesh is None or mesh.rank == 0,
                               mesh=mesh)
    return _render_once(sd, integ, args.nbsamples, seed, sampler=sampler,
                        mesh=mesh)


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if any(x in _NOT_PORTED_XTRA for x in args.xtra_options):
        raise SystemExit("--xtra-options is not ported yet")
    if args.command in _NOT_PORTED:
        raise SystemExit(f"integrator {args.command!r} is not ported yet")
    rng = args.random_number_generator
    seed = 0
    if rng.startswith("independent:"):
        seed = int(rng.split(":")[1])
    # as the reference: any name but stratified is the independent sampler
    sampler = "stratified" if rng.startswith("stratified") else "independent"
    with _logging(args) as log:
        n, backend = _mesh_size(args, log)
        if n <= 1:
            return _run(args, seed, sampler, log)
        from .parallel import run_on_mesh
        log.info("Sharding over %d %s ranks (-t %d)", n, backend,
                 args.threads)
        cpu = backend == "gloo"
        return run_on_mesh(n, _rank_run, args, seed, sampler,
                           backend=backend, device="cpu" if cpu else None,
                           timeout=RANK_TIMEOUT_S,
                           threads=max(1, (os.cpu_count() or 1) // n)
                           if cpu else None)


# a mesh run's deadline, and the longest a rank waits in a collective
RANK_TIMEOUT_S = 7 * 24 * 3600.0


@contextlib.contextmanager
def _logging(args, quiet: bool = False):
    """The package's log (INFO) on stderr, or with -l only in that file;
    `quiet` (a rank other than 0) logs errors alone."""
    fmt = "%(levelname)s %(module)s - %(message)s"
    log = logging.getLogger("rustlight_tpu_torch")
    log.setLevel(logging.ERROR if quiet else logging.INFO)
    if not args.log:
        logging.basicConfig(stream=sys.stderr, format=fmt)
        yield log
        return
    handler = logging.FileHandler(args.log)
    handler.setFormatter(logging.Formatter(fmt))
    log.addHandler(handler)
    log.propagate = False
    try:
        yield log
    finally:
        log.removeHandler(handler)
        log.propagate = True
        handler.close()


def _mesh_size(args, log):
    """-t: (ranks, backend). On the card min(-t, cards) NCCL ranks, on the
    CPU min(-t, CPU cores) gloo ranks; 1 without -t or with one device."""
    if args.threads is None or args.threads <= 1:
        return 1, None
    import torch
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    n = min(args.threads,
            torch.cuda.device_count() if cuda else (os.cpu_count() or 1))
    if n <= 1:
        log.info("-t %d: one %s device, rendering without a mesh",
                 args.threads, dev.type)
    return n, "nccl" if cuda else "gloo"


def _rank_run(mesh, args, seed, sampler) -> int:
    """One rank of a -t run (run_on_mesh's function)."""
    with _logging(args, quiet=mesh.rank != 0) as log:
        return _run(args, seed, sampler, log, mesh)


def _run(args, seed, sampler, log, mesh=None) -> int:
    """Load, render and write the run of `args` (over `mesh`, on its
    device, if given: rank 0 writes)."""
    t0 = time.time()
    scene = load_scene_arg(args)
    device = args.device if mesh is None else mesh.device
    sd = scene.compile(device=device, use_shading_normals=(
        "no-shading" not in args.xtra_options),
        use_ats="ats" in args.xtra_options)
    t_compile = time.time() - t0
    log.info("Scene compiled: %d triangles", sd.geom.n_tris)
    integ = build_integrator(args)
    t1 = time.time()
    film = _render_film(args, sd, integ, seed, sampler, log, mesh)
    t_render = time.time() - t1
    log.info("Elapsed Integrator: %.3fs", t_render)
    if mesh is not None and mesh.rank != 0:
        return 0
    if args.feature_aovs:
        from .integrators.common import render_feature_aovs
        film.buffers.update(render_feature_aovs(sd, spp=8, seed=seed))
        log.info("Feature AOVs rendered (albedo/normal/depth)")
    t2 = time.time()
    film.save(args.output)
    if args.aovs and len(film.buffers) > 1:
        film.dump_all(args.output)
        log.info("Wrote AOVs: %s", ", ".join(sorted(film.buffers)))
    log.info("Wrote %s (total %.3fs)", args.output, time.time() - t0)
    if args.profile:
        import json
        import torch
        dev = torch.device(args.device)
        with open(args.profile, "w") as f:
            json.dump({
                "scene_compile_s": round(t_compile, 4),
                "integrator_s": round(t_render, 4),
                "save_s": round(time.time() - t2, 4),
                "total_s": round(time.time() - t0, 4),
                "n_triangles": int(sd.geom.n_tris),
                "resolution": [sd.camera.width, sd.camera.height],
                "spp": args.nbsamples,
                "integrator": args.command,
                "backend": dev.type,
                "n_devices": (torch.cuda.device_count() if dev.type == "cuda"
                              else 1),
            }, f, indent=1)
        log.info("Wrote profile %s", args.profile)
    print(f"scene {t1 - t0:.2f}s, render {t_render:.2f}s "
          f"({args.nbsamples} spp on {args.device}) -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

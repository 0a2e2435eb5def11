"""Command-line renderer: the ported subset of rustlight_tpu/cli.py.

Usage: python -m rustlight_tpu_torch.cli cbox -n 64 -o out.pfm path -m 6
       python -m rustlight_tpu_torch.cli cbox -n 4 -o ao.pfm ao -d 2

Flags keep the reference CLI's names. Ported so far: the built-in `cbox`
scene, the `path` integrator with -m/-n/-r/-x/-s (strategies all, bsdf,
emitter), the `ao` integrator with -d/--distance (`inf` for no limit) and
-c/--normal-correction, -n/--nbsamples, -o/--output (.pfm),
-s/--scale-image and -r/--random-number-generator independent[:seed].
`--device` names the torch device to render on. The reference's other
global flags (-a -e -t -m -l -x --progress --resume --adaptive --guiding
--aovs --feature-aovs --profile) are declared with its defaults: a flag
left at its default is accepted, any other value exits with code 1 and
"<flag> is not ported yet". So does every other scene, sampler or
integrator subcommand of the reference.
"""
from __future__ import annotations

import argparse
import sys
import time

# integrator subcommands of the reference CLI that have no port yet
_NOT_PORTED = ("direct", "light-tracing", "light", "vpl",
               "vol-primitivies", "vol-primitives", "plane-single",
               "uncorrelated-plane-single", "point-normal", "gradient-path",
               "gradient-path-explicit", "pssmlt", "erpt", "smcmc")
# global flags of the reference CLI that have no port yet, with its names
# and defaults (rustlight_tpu/cli.py:44-89)
_NOT_PORTED_FLAGS = (
    (("-a", "--average"), dict(default=None)),
    (("--progress",), dict(action="store_true")),
    (("--resume",), dict(action="store_true")),
    (("--adaptive",), dict(action="store_true")),
    (("--guiding",), dict(action="store_true")),
    (("--aovs",), dict(action="store_true")),
    (("--feature-aovs",), dict(action="store_true")),
    (("--profile",), dict(metavar="OUT.json", default=None)),
    (("-t", "--threads"), dict(type=int, default=None)),
    (("-e", "--equal-time"), dict(type=float, default=None)),
    (("-m", "--medium"), dict(default="0.0")),
    (("-l", "--log"), dict(default=None)),
    (("-x", "--xtra-options"),
     dict(action="append", default=[],
          choices=["ats", "no-shading", "hvs-light", "texture-light"])),
)


def _inf_or(s, conv=int):
    """'inf' sentinel parsing, as the reference CLI does."""
    if s is None or s == "inf":
        return None
    return conv(s)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rustlight_tpu_torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("scene", help="builtin scene: cbox")
    ap.add_argument("-n", "--nbsamples", type=int, default=1)
    ap.add_argument("-o", "--output", default="out.pfm")
    ap.add_argument("-s", "--scale-image", type=float, default=1.0)
    ap.add_argument("-r", "--random-number-generator", default="independent",
                    help="independent[:seed]")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda, cuda:1, cpu)")
    for names, kw in _NOT_PORTED_FLAGS:
        ap.add_argument(*names, **kw, help="not ported yet")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("path")
    p.add_argument("-m", "--max-depth", default="inf")
    p.add_argument("-n", "--min-depth", default="0")
    p.add_argument("-r", "--rr-depth", default="0")
    p.add_argument("-x", "--single-scattering", action="store_true")
    p.add_argument("-s", "--strategy", default="all",
                   choices=["all", "bsdf", "emitter"])
    p = sub.add_parser("ao")
    p.add_argument("-d", "--distance", default="1.0")
    p.add_argument("-c", "--normal-correction", action="store_true")
    for name in _NOT_PORTED:
        q = sub.add_parser(name)
        q.add_argument("rest", nargs=argparse.REMAINDER)
    return ap


def build_integrator(args):
    from .integrators import IntegratorAO, IntegratorPathTracing
    if args.command == "ao":
        return IntegratorAO(max_distance=_inf_or(args.distance, float),
                            normal_correction=args.normal_correction)
    return IntegratorPathTracing(
        min_depth=_inf_or(args.min_depth), max_depth=_inf_or(args.max_depth),
        rr_depth=_inf_or(args.rr_depth), strategy=args.strategy,
        single_scattering=args.single_scattering)


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    for names, _ in _NOT_PORTED_FLAGS:
        dest = names[-1].lstrip("-").replace("-", "_")
        if getattr(args, dest) != ap.get_default(dest):
            raise SystemExit(f"{names[-1]} is not ported yet")
    if args.command not in ("path", "ao"):
        raise SystemExit(f"integrator {args.command!r} is not ported yet")
    if args.scene != "cbox":
        raise SystemExit(f"scene {args.scene!r} is not ported yet")
    rng = args.random_number_generator
    if rng.split(":")[0] != "independent":
        raise SystemExit(f"sampler {rng!r} is not ported yet")
    seed = int(rng.split(":")[1]) if ":" in rng else 0

    from .integrators import render
    from .models import cornell_box

    t0 = time.time()
    scene = cornell_box()
    # image scale (reference Camera::scale_image): the sample-space mapping
    # is resolution independent, so only the pixel grid changes
    cam = scene.camera
    scene.camera = cam._replace(width=int(cam.width * args.scale_image),
                                height=int(cam.height * args.scale_image))
    sd = scene.compile(device=args.device)
    integ = build_integrator(args)
    t1 = time.time()
    film = render(sd, integ, args.nbsamples, seed=seed)
    t2 = time.time()
    film.save(args.output)
    print(f"scene {t1 - t0:.2f}s, render {t2 - t1:.2f}s "
          f"({args.nbsamples} spp on {args.device}) -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

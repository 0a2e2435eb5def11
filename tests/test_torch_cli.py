"""The port's render entry point and CLI surface against the JAX package's.

  - integrators/common.py:render calls an integrator's `prepare(scene)` once
    per render, before either route, as rustlight_tpu/integrators/
    common.py:144-145 does (a stub integrator on each route);
  - every global flag of rustlight_tpu/cli.py's parser is declared by the
    port's under the same name and with the same default: left at its
    default it parses; -t 2 on the CPU renders over two gloo ranks, the
    image the shards' single-process renders concatenated; the flags
    ported with the meta integrators (-a, -e, -l,
    --progress, --resume, --adaptive, --guiding, --feature-aovs, --profile)
    render cbox 8x8 on the CPU, -e counts milliseconds, --profile writes
    the JAX CLI's keys, `-a N smcmc` keeps the chains, and --guiding and
    --adaptive refuse the integrators they cannot drive;
  - the port offers no subcommand the reference lacks (`avg` is none);
  - the light tracer, the medium (-m), single scattering (path -x) and the
    naive strategy (path -s naive) render at 32x32 on the CPU to .exr
    files that both packages read alike, and the `path` and
    `light-tracing` subcommands take the reference's flags;
  - `vpl`, `vol-primitives` (`vol-primitivies`), `plane-single`,
    `uncorrelated-plane-single` and `point-normal` take the reference's
    flags, build the reference's integrators (point-normal's strategy
    table name by name) and render cbox 8x8 at 1 spp on the CPU; point-
    normal's -k without ATS tables renders the image it renders without.
"""
import argparse
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rustlight_tpu.cli import build_parser as jax_build_parser
from rustlight_tpu_torch import cli
from rustlight_tpu_torch.integrators import render

ROOT = Path(__file__).resolve().parents[1]
# global flags both CLIs implement
PORTED = {"help", "nbsamples", "output", "scale_image",
          "random_number_generator", "medium", "aovs"}
# the global flags ported with the meta integrators: argv (given the run's
# directory) and the files the run leaves there besides its output
META_FLAGS = {
    "average": (lambda d: ["-a", "2"], ["x_1.pfm", "x_2.pfm", "x_time.csv"]),
    "progress": (lambda d: ["-a", "2", "--progress"],
                 ["x_1.pfm", "x_2.pfm", "x_time.csv"]),
    "resume": (lambda d: ["-a", "1", "--resume"], ["x_1.pfm", "x_time.csv"]),
    "adaptive": (lambda d: ["--adaptive", "-n", "12"], []),
    "guiding": (lambda d: ["--guiding", "-n", "2"], []),
    "feature_aovs": (lambda d: ["--feature-aovs", "--aovs"], [
        f"x_{k}.pfm" for k in ("albedo", "depth", "normal", "primal")]),
    "profile": (lambda d: ["--profile", str(d / "p.json")], ["p.json"]),
    "equal_time": (lambda d: ["-e", "5"], []),
    "log": (lambda d: ["-l", str(d / "log.txt")], ["log.txt"]),
}


class _Stub:
    """An integrator that records its calls and renders black."""

    def __init__(self):
        self.calls = []

    def prepare(self, scene):
        self.calls.append(("prepare", scene))


class _BlockStub(_Stub):
    def compute_block(self, scene, pix, stream, spp):
        self.calls.append(("compute_block", spp))
        return torch.zeros((pix.shape[0], 3))


class _PixelStub(_Stub):
    def compute_pixel(self, scene, pix, stream):
        self.calls.append(("compute_pixel",))
        return torch.zeros((pix.shape[0], 3))


@pytest.mark.parametrize("stub, spp, work", [
    (_BlockStub, 3, [("compute_block", 3)]),
    (_PixelStub, 3, [("compute_pixel",)] * 3)], ids=["persistent", "per-pass"])
def test_render_prepares_the_integrator_once(stub, spp, work):
    scene = SimpleNamespace(camera=SimpleNamespace(width=4, height=2),
                            device="cpu")
    integ = stub()
    film = render(scene, integ, spp=spp)
    assert film["primal"].shape == (2, 4, 3)
    assert integ.calls == [("prepare", scene)] + work


def _global_flags():
    """The reference parser's global optional flags: (dest, option strings,
    default, action)."""
    ap = jax_build_parser()
    return [(a.dest, a.option_strings, a.default, a)
            for a in ap._actions
            if a.option_strings
            and not isinstance(a, argparse._SubParsersAction)]


def _other_value(action):
    """A value of the reference's flag that is not its default."""
    if isinstance(action, argparse._StoreTrueAction):
        return []
    if action.choices:
        return [action.choices[0]]
    if action.type is int:
        return ["2"]
    if action.type is float:
        return ["5"]
    return ["0.5"] if action.default == "0.0" else ["x.json"]


FLAGS = _global_flags()


@pytest.mark.parametrize("dest", [f[0] for f in FLAGS])
def test_every_reference_global_flag_is_declared(dest):
    _, names, default, _ = next(f for f in FLAGS if f[0] == dest)
    port = {a.dest: a for a in cli.build_parser()._actions}
    assert dest in port and port[dest].option_strings == names
    if dest == "help":
        return
    assert port[dest].default == default
    args = cli.build_parser().parse_args(["cbox", "path"])
    assert getattr(args, dest) == default


@pytest.mark.parametrize("dest", [f[0] for f in FLAGS if f[0] not in PORTED])
def test_unported_flag_exits_not_ported(dest, tmp_path):
    """-x/--xtra-options was refused for its first value, ats, until the
    ATS light tree was ported: now it renders a tiny image instead. So do
    the flags of the meta integrators (META_FLAGS), each leaving its files,
    and -t/--threads, whose two gloo ranks render the persistent route's
    shards, each on stream_fold(stream_fold(base, d), 0)."""
    _, names, _, action = next(f for f in FLAGS if f[0] == dest)
    argv = ["cbox", names[-1], *_other_value(action), "--device", "cpu",
            "path", "-m", "2"]
    if dest in META_FLAGS:
        flags, files = META_FLAGS[dest]
        assert cli.main(["cbox", *flags(tmp_path), "-s", "0.015625", "-o",
                         str(tmp_path / "x.pfm"), "--device", "cpu", "path",
                         "-m", "2"]) == 0
        assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
            files + ["x.pfm"])
        return
    if dest == "threads":
        from rustlight_tpu_torch.parallel.render import _padded_grid
        from rustlight_tpu_torch.utils.film import accumulate_safe
        from rustlight_tpu_torch.utils.image import read_pfm
        from rustlight_tpu_torch.utils.rng import make_stream, stream_fold
        out = tmp_path / "x.pfm"
        assert cli.main(argv[:3] + ["-s", "0.015625", "-n", "2", "-o",
                                    str(out)] + argv[3:]) == 0
        assert sorted(p.name for p in tmp_path.iterdir()) == ["x.pfm"]
        sd = cli.load_scene_arg(cli.build_parser().parse_args(
            ["cbox", "-s", "0.015625", "path"])).compile(device="cpu")
        integ = cli.build_integrator(cli.build_parser().parse_args(
            ["cbox", "path", "-m", "2"]))
        pix = torch.as_tensor(_padded_grid(8, 8, 2))
        base = make_stream(0, "cpu")
        acc = torch.cat([accumulate_safe(integ.compute_block(
            sd, pix[32 * d:32 * (d + 1)], stream_fold(stream_fold(base, d),
                                                      0), 2))
            for d in range(2)])
        np.testing.assert_array_equal(
            read_pfm(str(out)), (acc.reshape(8, 8, 3) / 2).numpy())
        return
    if dest == "xtra_options":
        assert argv[2] == "ats"
        assert cli.main(argv[:-3] + ["-s", "0.015625", "-o",
                                     str(tmp_path / "x.pfm")]
                        + argv[-3:]) == 0
        return
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == f"{names[-1]} is not ported yet"


def test_no_subcommand_beyond_the_reference():
    def commands(ap):
        sub = next(a for a in ap._actions
                   if isinstance(a, argparse._SubParsersAction))
        return set(sub.choices)

    ours, theirs = commands(cli.build_parser()), commands(jax_build_parser())
    assert "avg" not in ours and ours <= theirs
    with pytest.raises(SystemExit) as e:
        cli.main(["cbox", "avg"])
    assert e.value.code == 2


@pytest.mark.parametrize("argv", [
    ["cbox", "-n", "2", "-s", "0.0625", "direct", "-b", "1", "-l", "1"],
    ["veach_mis", "-n", "2", "-s", "0.125", "path", "-m", "8"]],
    ids=["cbox-direct", "veach_mis-path"])
def test_cli_renders_an_exr_both_packages_read_alike(tmp_path, argv):
    from rustlight_tpu.utils.image import read_exr as jax_read_exr
    from rustlight_tpu_torch.utils.image import read_exr
    out = tmp_path / "out.exr"
    assert cli.main([argv[0], "-o", str(out), "--device", "cpu",
                     *argv[1:]]) == 0
    img = read_exr(out)
    assert img.shape == ((32, 32, 3) if argv[0] == "cbox" else (24, 32, 3))
    assert np.all(np.isfinite(img)) and img.mean() > 0.02
    np.testing.assert_array_equal(img, jax_read_exr(out))


def test_direct_flags_match_the_reference():
    def flags(ap):
        sub = next(a for a in ap._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {a.dest: (a.option_strings, a.default, a.type)
                for a in sub.choices["direct"]._actions if a.dest != "help"}
    assert flags(cli.build_parser()) == flags(jax_build_parser())
    args = cli.build_parser().parse_args(["cbox", "direct", "-b", "3",
                                          "-l", "2"])
    integ = cli.build_integrator(args)
    assert (integ.nb_bsdf_samples, integ.nb_light_samples) == (3, 2)


@pytest.mark.parametrize("argv, floor", [
    (["light", "-m", "8"], 0.02),
    (["-m", "0.0025", "path", "-m", "8"], 0.005),
    (["-m", "0.0025:0.001:0.5", "path", "-x", "-n", "1", "-m", "2"], 1e-4),
    (["path", "-s", "naive", "-m", "4"], 0.02)],
    ids=["light", "medium-path", "medium-single", "naive"])
def test_cli_renders_the_slice_both_packages_read_alike(tmp_path, argv,
                                                        floor):
    from rustlight_tpu.utils.image import read_exr as jax_read_exr
    from rustlight_tpu_torch.utils.image import read_exr
    out = tmp_path / "out.exr"
    assert cli.main(["cbox", "-n", "2", "-s", "0.0625", "-o", str(out),
                     "--device", "cpu", *argv]) == 0
    img = read_exr(out)
    assert img.shape == (32, 32, 3)
    assert np.all(np.isfinite(img)) and img.mean() > floor
    np.testing.assert_array_equal(img, jax_read_exr(out))


@pytest.mark.parametrize("command", ["path", "light-tracing"])
def test_path_and_light_flags_match_the_reference(command):
    def flags(ap):
        sub = next(a for a in ap._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {a.dest: (a.option_strings, a.default, a.type, a.choices)
                for a in sub.choices[command]._actions if a.dest != "help"}
    assert flags(cli.build_parser()) == flags(jax_build_parser())


def test_cli_builds_the_reference_integrators():
    from rustlight_tpu.cli import build_integrator as jax_build_integrator
    for argv in (["cbox", "light", "-m", "5", "-s", "volume"],
                 ["cbox", "light-tracing", "-n", "1", "-r", "inf"],
                 ["cbox", "path", "-x", "-s", "naive", "-m", "3"]):
        ours = cli.build_integrator(cli.build_parser().parse_args(argv))
        theirs = jax_build_integrator(jax_build_parser().parse_args(argv))
        assert type(ours).__name__ == type(theirs).__name__
        # nee_rr spells its default apart ("default" / "auto"): both resolve
        # it per scene in _nee_rr_for
        ours, theirs = vars(ours), vars(theirs)
        assert set(ours) <= set(theirs)
        assert {k: v for k, v in ours.items() if k != "nee_rr"} == {
            k: theirs[k] for k in ours if k != "nee_rr"}
    assert cli._medium("0.0") is None
    vol = cli._medium("0.5:0.25:0.3")
    np.testing.assert_array_equal(vol.sigma_s, np.full(3, 0.5, np.float32))
    np.testing.assert_array_equal(vol.sigma_a, np.full(3, 0.25, np.float32))
    assert vol.phase_g == np.float32(0.3)


@pytest.mark.parametrize("argv, shape, floor", [
    (["examples/envglass.xml", "-s", "0.03125", "path", "-m", "4"], (12, 16),
     1e-3),
    (["examples/caustic.pbrt", "-s", "0.0357143", "direct"], (12, 16), 1e-3),
    (["examples/fog_box.xml", "-s", "0.0416667", "light", "-m", "4"],
     (12, 16), 1e-3),
    (["door_box", "-s", "0.4", "path", "-m", "8"], (12, 16), 0.0),
    (["tmp.obj", "-s", "0.03125", "ao", "-d", "inf"], (16, 16), 1e-3)],
    ids=["xml", "pbrt", "xml-medium-light", "door_box", "obj"])
def test_cli_renders_scene_files(tmp_path, argv, shape, floor):
    """Each scene-file kind (and door_box) through the port's CLI on the
    CPU, at a film of about 16x12: a finite image both packages read
    alike. The OBJ scene (a tmp box, no lights) renders `ao`; door_box is
    lit only through its doorway, so 2 spp may find little light."""
    from rustlight_tpu.utils.image import read_exr as jax_read_exr
    from rustlight_tpu_torch.utils.image import read_exr
    if argv[0] == "tmp.obj":
        (tmp_path / "tmp.obj").write_text(
            "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\nv 1 0 1\n"
            "f 1 2 3 4\nf 1 5 6 2\n")
        argv = [str(tmp_path / "tmp.obj")] + argv[1:]
    else:
        argv = [argv[0] if argv[0] == "door_box"
                else str(ROOT / argv[0])] + argv[1:]
    out = tmp_path / "out.exr"
    assert cli.main([argv[0], "-n", "2", "-o", str(out), "--device", "cpu",
                     *argv[1:]]) == 0
    img = read_exr(out)
    assert img.shape == shape + (3,)
    assert np.all(np.isfinite(img)) and img.mean() > floor
    np.testing.assert_array_equal(img, jax_read_exr(out))


def test_scale_image_rederives_the_camera():
    """-s keeps the file's aspect ratio through resize_camera, and -m keeps
    a loaded medium unless it sets one."""
    from rustlight_tpu_torch.scene import resize_camera
    from rustlight_tpu_torch.scene.loaders import load_scene
    path = str(ROOT / "examples" / "fog_box.xml")
    sc = cli.load_scene_arg(cli.build_parser().parse_args(
        [path, "-s", "0.125", "path"]))
    want = resize_camera(load_scene(path).camera, 48, 36)
    assert (sc.camera.width, sc.camera.height) == (48, 36)
    np.testing.assert_array_equal(sc.camera.sample_to_camera,
                                  want.sample_to_camera)
    assert sc.volume is not None and sc.volume.phase_g == np.float32(0.4)
    sc = cli.load_scene_arg(cli.build_parser().parse_args(
        [path, "-m", "0.5", "path"]))
    assert float(sc.volume.sigma_s[0]) == 0.5


@pytest.mark.parametrize("xtra", [["no-shading"], ["hvs-light"],
                                  ["texture-light"]])
def test_cli_xtra_options(tmp_path, xtra):
    """-x no-shading renders without shading normals (a different image on
    envglass's spheres); hvs-light and texture-light turn the cbox light's
    emission into the HSV ramp or a texture (the procedural ramp: no
    butterfly.jpg in the working directory), scaled by its luminance."""
    from rustlight_tpu_torch.utils.image import read_exr
    scene = (str(ROOT / "examples" / "envglass.xml") if xtra == ["no-shading"]
             else "cbox")
    scale = "0.03125" if xtra == ["no-shading"] else "0.0625"
    imgs = []
    for x in ([], xtra):
        out = tmp_path / f"{len(x)}.exr"
        argv = [scene, "-n", "2", "-s", scale, "-o", str(out), "--device",
                "cpu"]
        for v in x:
            argv += ["-x", v]
        assert cli.main(argv + ["path", "-m", "3"]) == 0
        imgs.append(read_exr(out))
    assert np.all(np.isfinite(imgs[1])) and imgs[1].mean() > 1e-3
    assert not np.array_equal(imgs[0], imgs[1])
    args = cli.build_parser().parse_args(
        ["cbox", *sum((["-x", v] for v in xtra), []), "path"])
    sc = cli.load_scene_arg(args)
    lights = [m for m in sc.meshes if m.is_light]
    kind = {"no-shading": 0, "hvs-light": 1, "texture-light": 2}[xtra[0]]
    assert lights and all(m.emission_kind == kind for m in lights)
    if kind == 2:
        assert sc.textures.shape[0] == 1 and lights[0].emission_tex == 0


def test_cli_refuses_ats(tmp_path, monkeypatch):
    """-x ats, refused before the ATS light tree was ported, now renders
    through the tree (its descent runs): a lit, finite image, the port's
    render of the scene compiled with use_ats. On cbox the tree's two
    leaves (the light quad's triangles) share one box, so the descent
    picks each with probability 1/2, as the flux cdf does: the image is
    also the one without -x ats."""
    from rustlight_tpu_torch.integrators import IntegratorPathTracing, render
    from rustlight_tpu_torch.models import cornell_box
    from rustlight_tpu_torch.scene import emitters
    from rustlight_tpu_torch.utils.image import read_exr
    calls = []
    descend = emitters.ats_sample
    monkeypatch.setattr(emitters, "ats_sample", lambda *a: calls.append(
        a[1].shape[0]) or descend(*a))
    out = tmp_path / "ats.exr"
    assert cli.main(["cbox", "-x", "no-shading", "-x", "ats", "-n", "2",
                     "-s", "0.03125", "-o", str(out), "--device", "cpu",
                     "path", "-m", "3"]) == 0
    assert calls and set(calls) == {16 * 16}
    img = read_exr(out)
    assert img.shape == (16, 16, 3) and np.all(np.isfinite(img))
    assert img.mean() > 1e-2
    integ = IntegratorPathTracing(max_depth=3)
    sd = cornell_box(16, 16).compile(device="cpu", use_ats=True,
                                     use_shading_normals=False)
    assert sd.ats is not None and sd.ats.depth == 1
    np.testing.assert_array_equal(render(sd, integ, 2)["primal"], img)
    plain = cornell_box(16, 16).compile(device="cpu",
                                        use_shading_normals=False)
    np.testing.assert_array_equal(render(plain, integ, 2)["primal"], img)


NEW_COMMANDS = ("vpl", "vol-primitivies", "vol-primitives", "plane-single",
                "uncorrelated-plane-single", "point-normal")


def _subflags(ap, command):
    sub = next(a for a in ap._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.dest: (a.option_strings, a.default, a.type, a.choices)
            for a in sub.choices[command]._actions if a.dest != "help"}


@pytest.mark.parametrize("command", NEW_COMMANDS)
def test_volumetric_and_vpl_flags_match_the_reference(command):
    assert _subflags(cli.build_parser(), command) == _subflags(
        jax_build_parser(), command)


PN_NAMES = sorted(cli._PN_STRATEGIES) + ["kulla"]


@pytest.mark.parametrize("argv", [
    ["vpl"], ["vpl", "-m", "4", "-r", "2", "-b", "0.5", "-n2", "64"],
    ["vol-primitivies"], ["vol-primitives", "-p", "Beams", "-n2", "64",
                          "-m", "5"],
    ["vol-primitives", "-p", "planes"], ["vol-primitives", "-p", "VRL"],
    ["plane-single"], ["uncorrelated-plane-single", "-n2", "32"],
    *(["plane-single", "-s", s] for s in cli._PLANE_STRATEGIES),
    ["uncorrelated-plane-single", "-s", "discrete_mis"],
    ["point-normal", "-w", "TPN", "-W", "B", "-z", "-k", "0.5", "-x"],
    *(["point-normal", "-s", s] for s in PN_NAMES)],
    ids=lambda a: "-".join(a))
def test_cli_builds_the_reference_volumetric_integrators(argv):
    from rustlight_tpu.cli import build_integrator as jax_build_integrator
    ours = cli.build_integrator(cli.build_parser().parse_args(["cbox", *argv]))
    theirs = jax_build_integrator(jax_build_parser().parse_args(
        ["cbox", *argv]))
    assert type(ours).__name__ == type(theirs).__name__
    ours = {k: v for k, v in vars(ours).items() if not k.startswith("_")}
    assert ours == {k: vars(theirs)[k] for k in ours}
    if argv[0] == "point-normal" and len(argv) == 3:
        want = {"kulla": ("tr", "equiangular")}.get(argv[2])
        assert ours["strategies"] == (want or cli._PN_STRATEGIES[argv[2]])


@pytest.mark.parametrize("argv", [
    ["vpl", "-m", "4", "-n2", "32"],
    ["-m", "0.0025", "vpl", "-m", "4", "-n2", "32"],
    *(["-m", "0.0025", "vol-primitives", "-p", p, "-m", "4", "-n2", "64"]
      for p in ("bre", "beams", "planes", "vrl")),
    ["-m", "0.0025", "plane-single", "-n2", "32"],
    ["-m", "0.0025", "uncorrelated-plane-single", "-s", "cmis"],
    ["-m", "0.0025", "point-normal", "-s", "pn_best_ex", "-W", "B"]],
    ids=lambda a: "-".join(a))
def test_cli_renders_the_volumetric_integrators(tmp_path, argv):
    """cbox 8x8, 1 spp on the CPU: a finite image that both packages read
    alike (the small radius of the reference CLI's primitives leaves BRE
    and beams nearly black at this size)."""
    from rustlight_tpu.utils.image import read_exr as jax_read_exr
    from rustlight_tpu_torch.utils.image import read_exr
    out = tmp_path / "out.exr"
    assert cli.main(["cbox", "-n", "1", "-s", "0.015625", "-o", str(out),
                     "--device", "cpu", *argv]) == 0
    img = read_exr(out)
    assert img.shape == (8, 8, 3) and np.all(np.isfinite(img))
    assert img.min() >= 0.0
    np.testing.assert_array_equal(img, jax_read_exr(out))


def test_point_normal_splitting_without_ats_renders_the_ordinary_route(
        tmp_path):
    """-k takes the ATS traversal only with ATS tables (rustlight_tpu/
    integrators/point_normal.py: compute_pixel); without them the image is
    the one rendered without -k."""
    from rustlight_tpu_torch.utils.image import read_exr
    imgs = []
    for k in ([], ["-k", "0.5"]):
        out = tmp_path / f"pn{len(k)}.exr"
        assert cli.main(["cbox", "-n", "1", "-s", "0.015625", "-m", "0.0025",
                         "-o", str(out), "--device", "cpu", "point-normal",
                         *k]) == 0
        imgs.append(read_exr(out))
    assert imgs[0].mean() > 0
    np.testing.assert_array_equal(imgs[0], imgs[1])


SLICE_COMMANDS = ("gradient-path", "gradient-path-explicit", "pssmlt", "erpt",
                  "smcmc")


def test_only_smcmc_is_refused():
    """SMCMC and -x ats were the last refused subcommand and -x value, and
    -t/--threads the last refused global flag: every one is ported now."""
    assert cli._NOT_PORTED == ()
    assert cli._NOT_PORTED_XTRA == ()
    assert not hasattr(cli, "_NOT_PORTED_FLAGS")


@pytest.mark.parametrize("command", SLICE_COMMANDS)
def test_gradient_and_mcmc_flags_match_the_reference(command):
    assert _subflags(cli.build_parser(), command) == _subflags(
        jax_build_parser(), command)


def _plain(obj):
    return {k: v for k, v in vars(obj).items()
            if isinstance(v, (int, float, str, type(None)))
            and not k.startswith("_")
            and k not in ("record_accepts", "accepts", "visits", "tfs",
                          "init_accepts", "init_tfs", "flushed")}


@pytest.mark.parametrize("argv", [
    ["gradient-path"], ["gradient-path", "-m", "5", "-n", "2", "-i", "9",
                        "--strategy-recons", "bagging"],
    ["gradient-path-explicit"],
    ["gradient-path-explicit", "-m", "4", "--strategy-recons", "weighted",
     "--min-survival", "0.25"],
    ["pssmlt"], ["pssmlt", "-m", "6", "-p", "0.5", "-b", "4096", "-s", "bsdf"],
    ["erpt"], ["erpt", "-k", "-e2", "3", "-c", "8", "-m", "4"],
    ["smcmc"], ["smcmc", "-m", "4", "-p", "0.5", "--recons-smcmc", "naive",
                "--init", "independent", "-s", "bsdf"]],
    ids=lambda a: "-".join(a))
def test_cli_builds_the_reference_gradient_and_mcmc_integrators(argv):
    from rustlight_tpu.cli import build_integrator as jax_build_integrator
    ours = cli.build_integrator(cli.build_parser().parse_args(["cbox", *argv]))
    theirs = jax_build_integrator(jax_build_parser().parse_args(
        ["cbox", *argv]))
    assert type(ours).__name__ == type(theirs).__name__
    assert _plain(ours) == {k: vars(theirs)[k] for k in _plain(ours)}
    inner = getattr(ours, "integrator", None)
    if inner is not None:
        # nee_rr spells its default apart ("default" / "auto"): both resolve
        # to the same per-scene choice
        want = {k: vars(theirs.integrator)[k] for k in _plain(inner)}
        assert {**_plain(inner), "nee_rr": 0} == {**want, "nee_rr": 0}


@pytest.mark.parametrize("argv", [
    ["gradient-path", "-m", "3"], ["gradient-path-explicit", "-m", "3"],
    ["pssmlt", "-m", "3", "-b", "256"], ["erpt", "-m", "3", "-c", "4"],
    ["smcmc", "-m", "3"]],
    ids=lambda a: a[0])
def test_cli_renders_the_gradient_and_mcmc_integrators(tmp_path, argv):
    """cbox 8x8 (ERPT 32x32: its 65,536 normalization samples go in
    batches of w h), 2 spp on the CPU: a finite, lit image that both
    packages read alike; with --aovs the gradient tracers also write their
    buffers as <output>_<name>.exr."""
    from rustlight_tpu.utils.image import read_exr as jax_read_exr
    from rustlight_tpu_torch.utils.image import read_exr
    out = tmp_path / "out.exr"
    side = 32 if argv[0] == "erpt" else 8
    assert cli.main(["cbox", "-n", "2", "-s", str(side / 512), "-o",
                     str(out), "--aovs", "--device", "cpu", *argv]) == 0
    img = read_exr(out)
    assert img.shape == (side, side, 3) and np.all(np.isfinite(img))
    assert img.mean() > 0.01
    np.testing.assert_array_equal(img, jax_read_exr(out))
    aovs = sorted(p.name for p in tmp_path.iterdir() if p.name != "out.exr")
    if argv[0].startswith("gradient"):
        assert aovs == sorted(f"out_{k}.exr" for k in (
            "primal", "primal_raw", "very_direct", "gradient_x",
            "gradient_y"))
        np.testing.assert_array_equal(read_exr(tmp_path / "out_primal.exr"),
                                      img)
    else:
        assert aovs == []    # a film of one buffer writes no AOVs


def test_cli_stratified_sampler(tmp_path):
    """-r stratified renders through the stratified passes: another image
    than the independent sampler's, both lit and finite."""
    from rustlight_tpu_torch.utils.image import read_exr
    imgs = {}
    for rng in ("stratified", "independent"):
        out = tmp_path / f"{rng}.exr"
        assert cli.main(["cbox", "-n", "4", "-s", "0.03125", "-o", str(out),
                         "-r", rng, "--device", "cpu", "path", "-m",
                         "4"]) == 0
        imgs[rng] = read_exr(out)
        assert np.all(np.isfinite(imgs[rng])) and imgs[rng].mean() > 0.02
    assert np.abs(imgs["stratified"] - imgs["independent"]).max() > 1e-3


def test_film_dump_all_names(tmp_path):
    from rustlight_tpu_torch.utils.film import Film
    from rustlight_tpu_torch.utils.image import read_pfm
    film = Film(2, 1)
    film.buffers["primal"] = np.ones((1, 2, 3), np.float32)
    film.buffers["relerr"] = np.full((1, 2, 3), 2.0, np.float32)
    film.dump_all(str(tmp_path / "img.pfm"), suffix="_3")
    assert read_pfm(tmp_path / "img_relerr_3.pfm").mean() == 2.0
    assert read_pfm(tmp_path / "img_primal_3.pfm").mean() == 1.0


@pytest.mark.parametrize("argv", [
    ["-a", "2", "--progress"], ["-a", "inf"], ["-a", "1s"], ["-e", "5"],
    ["--resume", "-a", "3"], ["--adaptive", "-n", "16"],
    ["--guiding", "-n", "4"], ["--guiding", "-a", "2"], ["--feature-aovs"],
    ["--profile", "p.json"], ["-l", "log.txt"]], ids=lambda a: "".join(a))
def test_meta_flags_parse_as_the_reference(argv):
    ours = vars(cli.build_parser().parse_args(["cbox", *argv, "path"]))
    theirs = vars(jax_build_parser().parse_args(["cbox", *argv, "path"]))
    assert {k: ours[k] for k in theirs} == theirs


def test_equal_time_is_milliseconds(tmp_path, monkeypatch):
    from rustlight_tpu_torch.integrators import meta
    seen = {}
    real = meta.IntegratorEqualTime

    def spy(integ, target_s, **kw):
        seen["target_s"] = target_s
        seen["meta"] = real(integ, target_s, **kw)
        return seen["meta"]
    monkeypatch.setattr(meta, "IntegratorEqualTime", spy)
    assert cli.main(["cbox", "-e", "250", "-s", "0.015625", "-o",
                     str(tmp_path / "e.pfm"), "--device", "cpu", "path",
                     "-m", "2"]) == 0
    assert seen["target_s"] == 0.25 and seen["meta"].achieved_spp >= 1


def test_profile_writes_the_reference_keys(tmp_path):
    import json
    out = tmp_path / "p.json"
    assert cli.main(["cbox", "-n", "2", "-s", "0.015625", "-o",
                     str(tmp_path / "x.pfm"), "--profile", str(out),
                     "--device", "cpu", "path", "-m", "2"]) == 0
    prof = json.loads(out.read_text())
    assert sorted(prof) == sorted([
        "scene_compile_s", "integrator_s", "save_s", "total_s",
        "n_triangles", "resolution", "spp", "integrator", "backend",
        "n_devices"])
    assert prof["backend"] == "cpu" and prof["n_devices"] == 1
    assert prof["resolution"] == [8, 8] and prof["spp"] == 2
    assert prof["n_triangles"] > 0 and prof["integrator"] == "path"


@pytest.mark.parametrize("average, keep", [(None, False), ("2", True)])
def test_average_keeps_smcmc_chains(average, keep):
    from rustlight_tpu.cli import build_integrator as jax_build_integrator
    argv = ["cbox"] + (["-a", average] if average else []) + ["smcmc"]
    ours = cli.build_integrator(cli.build_parser().parse_args(argv))
    theirs = jax_build_integrator(jax_build_parser().parse_args(argv))
    assert ours.keep_chains is theirs.keep_chains is keep
    assert ours.averaging is theirs.averaging is (not keep)


@pytest.mark.parametrize("argv, message", [
    (["--guiding", "ao"], "--guiding needs the `path` integrator"),
    (["--guiding", "-a", "2", "direct"],
     "--guiding needs the `path` integrator"),
    (["--adaptive", "light"], "--adaptive needs a per-pixel MC integrator"),
    (["--adaptive", "smcmc"], "--adaptive needs a per-pixel MC integrator")],
    ids=lambda a: "-".join(a) if isinstance(a, list) else None)
def test_meta_refusals(tmp_path, argv, message):
    with pytest.raises(SystemExit) as e:
        cli.main(["cbox", "-s", "0.015625", "-o", str(tmp_path / "x.pfm"),
                  "--device", "cpu", *argv])
    assert str(e.value.code).startswith(message)


def test_cli_average_resume_and_guided_table(tmp_path):
    """-a 1 then -a 3 --resume equals -a 3, for the guided path tracer,
    whose table is checkpointed beside the dumps."""
    from rustlight_tpu_torch.utils.image import read_pfm

    def run(name, *flags):
        assert cli.main(["cbox", "-n", "1", "-s", "0.015625", "-o",
                         str(tmp_path / f"{name}.pfm"), "--guiding", *flags,
                         "--device", "cpu", "path", "-m", "3"]) == 0
        return read_pfm(tmp_path / f"{name}.pfm")
    full = run("full", "-a", "3")
    run("res", "-a", "1")
    assert (tmp_path / "res_state.npz").exists()
    np.testing.assert_array_equal(run("res", "-a", "3", "--resume"), full)
    np.testing.assert_array_equal(read_pfm(tmp_path / "res_3.pfm"), full)

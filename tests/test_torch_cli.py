"""The port's render entry point and CLI surface against the JAX package's.

  - integrators/common.py:render calls an integrator's `prepare(scene)` once
    per render, before either route, as rustlight_tpu/integrators/
    common.py:144-145 does (a stub integrator on each route);
  - every global flag of rustlight_tpu/cli.py's parser is declared by the
    port's under the same name and with the same default: left at its
    default it parses, and a flag the port has not ported exits with code 1
    and "<flag> is not ported yet" for any other value;
  - the port offers no subcommand the reference lacks (`avg` is none).
"""
import argparse
from types import SimpleNamespace

import pytest
import torch

from rustlight_tpu.cli import build_parser as jax_build_parser
from rustlight_tpu_torch import cli
from rustlight_tpu_torch.integrators import render

# global flags both CLIs implement
PORTED = {"help", "nbsamples", "output", "scale_image",
          "random_number_generator"}


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
def test_unported_flag_exits_not_ported(dest):
    _, names, _, action = next(f for f in FLAGS if f[0] == dest)
    argv = ["cbox", names[-1], *_other_value(action), "--device", "cpu",
            "path", "-m", "2"]
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

"""Whole runs of the harness on the CPU (the look for a card skipped), at a
tiny film: a sound run comes out correct, and each fault a render cell can
have, planted under the timed path, comes out not correct; so does the
control, the reference in bfloat16 put in the renderer's place."""
import time

import numpy as np
import pytest
import torch

from portbench import check, port, run
from portbench.scene import build_arrays, load_config

MIX = {"integrator": "path", "route": "persistent", "width": 16,
       "height": 9, "spp_per_pass": 2, "check": {"pixels": 100,
                                                  "passes": 3}}
VIEW = dict(MIX, route="per_pass", spp_per_pass=1,
            check={"pixels": 100, "passes": 4})


def _run(bench, cell, seconds=3.0):
    return run.run_cell(bench, cell, 3_000_000_019, seconds, False,
                        torch.device("cpu"), time.perf_counter(),
                        log=lambda s: None)


def _stale(real):
    """A pass that returns its state unchanged: the previous pass's film."""
    last = {}

    def fn(sd, integ, spp, seed, route):
        img = last.get("img")
        if img is None:
            img = real(sd, integ, spp, seed, route)
        last["img"] = img
        return img
    return fn


def _half_samples(real):
    """Half of each pixel's samples left out, the mean over the rest."""
    def fn(sd, integ, spp, seed, route):
        return real(sd, integ, max(1, spp // 2), seed, route)
    return fn


def _half_rows(real):
    """Half of the batch (every other row of pixels) left out, filled with
    the rows rendered."""
    def fn(sd, integ, spp, seed, route):
        img = real(sd, integ, spp, seed, route).copy()
        img[1::2] = img[0::2][: img[1::2].shape[0]]
        return img
    return fn


def _altered(real):
    """An answer altered where it is produced: the film off by 1%."""
    def fn(sd, integ, spp, seed, route):
        return real(sd, integ, spp, seed, route) * np.float32(1.01)
    return fn


def _control(real):
    """The control: the plain reference computed in bfloat16, one precision
    below the configuration's float32, as the pass's whole film."""
    cfg = load_config("cbox")
    arrays = build_arrays(cfg)

    def fn(sd, integ, spp, seed, route):
        mix = dict(MIX, route=route, spp_per_pass=spp)
        w, h = mix["width"], mix["height"]
        v = check.reference_values(arrays, cfg, mix, [seed],
                                   np.arange(w * h), "cpu", torch.bfloat16)
        return v[0].reshape(h, w, 3).astype(np.float32)
    return fn


@pytest.mark.parametrize("mix", [MIX, VIEW], ids=["persistent", "per_pass"])
def test_sound_run_is_correct(tiny_cell, mix):
    res = _run(*tiny_cell("cbox", mix))
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"msamples_s", "frame_ms_p95", "setup_s"}
    assert list(res)[-1] == "checks"


# a pass of one sample a pixel has no half of its samples to leave out
FAULTS = [(f, m, f"{f.__name__[1:]}-{mid}")
          for m, mid in ((MIX, "persistent"), (VIEW, "per_pass"))
          for f in (_stale, _half_samples, _half_rows, _altered, _control)
          if not (f is _half_samples and m["spp_per_pass"] == 1)]


@pytest.mark.parametrize("fault,mix", [f[:2] for f in FAULTS],
                         ids=[f[2] for f in FAULTS])
def test_fault_is_not_correct(tiny_cell, monkeypatch, fault, mix):
    monkeypatch.setattr(port, "render_pass", fault(port.render_pass))
    res = _run(*tiny_cell("cbox", mix))
    assert res["attempted"] >= 2      # a stale pass shows from the second
    assert not res["correct"], res["checks"]
    assert res["checks"]["off_share"]["value"] > 0.1

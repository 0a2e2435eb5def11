"""The plain reference against the renderer at a tiny film on the CPU: the
films of every route the cells drive, pixel by pixel, with the same seeds.
The renderer runs its kernels' plain versions here; on the card each run
of the benchmark makes the same comparison at the cells' own sizes."""
import numpy as np
import pytest
import torch

from portbench import check, port
from portbench.reference.integrators import path as ri
from portbench.reference import scene as rs
from portbench.scene import build_arrays, load_config

CASES = [  # config, integrator, route, width, height, spp
    ("cbox", "path", "persistent", 24, 14, 3),
    ("cbox", "path", "per_pass", 24, 14, 2),
    ("cbox", "ao", "per_pass", 24, 14, 4),
    ("grid122k", "path", "persistent", 8, 5, 2),
    ("grid122k", "path", "per_pass", 8, 5, 1),
    ("grid122k", "ao", "per_pass", 8, 5, 2),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_reference_replays_the_renderer(case):
    name, kind, route, w, h, spp = case
    cfg = load_config(name)
    arrays = build_arrays(cfg)
    sd = port.compile_scene(arrays, w, h, "cpu")
    integ = port.make_integrator(kind, cfg["integrators"][kind])
    seed = 2_147_483_659          # over 2^31
    img = port.render_pass(sd, integ, spp, seed, route)
    traffic = {"integrator": kind, "route": route, "width": w, "height": h,
               "spp_per_pass": spp}
    ref = check.reference_values(arrays, cfg, traffic, [seed],
                                 np.arange(w * h), "cpu")[0]
    got = img.reshape(-1, 3)
    assert check.off_share(got, ref, 1e-3, 1e-4) == 0.0
    assert np.allclose(got.mean(), ref.mean(), rtol=1e-5)


def test_reference_mean_converges_to_the_renderers():
    """Statistically too: the means of independent renders of both sides,
    seeded apart, agree within their noise."""
    cfg = load_config("cbox")
    arrays = build_arrays(cfg)
    sd = port.compile_scene(arrays, 16, 9, "cpu")
    integ = port.make_integrator("path", cfg["integrators"]["path"])
    ours = [port.render_pass(sd, integ, 4, s, "persistent").mean()
            for s in range(6)]
    sc = rs.build(arrays, 16, 9, "cpu")
    lanes = torch.arange(16 * 9)
    theirs = [ri.path_block(sc, 1000 + s, lanes, 4, 6, None).mean().item()
              for s in range(6)]
    spread = np.std(ours + theirs) / np.sqrt(6)
    assert abs(np.mean(ours) - np.mean(theirs)) < 4 * spread + 1e-6


@pytest.mark.parametrize("case", [c for c in CASES if c[2] != "per_pass"
                                  or c[1] == "ao" or c[0] == "cbox"],
                         ids=lambda c: "-".join(map(str, c[:3])))
def test_control_in_bfloat16_fails_the_limit(case):
    """The reference one precision below float32 reads far over the limit
    of every cell (the control of the comparison; its chip readings at the
    cells' sizes are in PERF.md)."""
    name, kind, route, w, h, spp = case
    cfg = load_config(name)
    arrays = build_arrays(cfg)
    traffic = {"integrator": kind, "route": route, "width": w, "height": h,
               "spp_per_pass": spp}
    px = np.arange(w * h)
    ref = check.reference_values(arrays, cfg, traffic, [7, 8], px, "cpu")
    low = check.reference_values(arrays, cfg, traffic, [7, 8], px, "cpu",
                                 torch.bfloat16)
    limit = max(check.load_limits(c)["off_share"] for c in
                ("cbox.path.hd", "cbox.view.hd", "grid122k.path.hd",
                 "grid122k.ao.hd"))
    assert check.off_share(low, ref, 1e-3, 1e-4) > 10 * limit

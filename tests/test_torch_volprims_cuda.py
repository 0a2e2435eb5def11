"""VPL and the volumetric estimators on the card against the CPU; no JAX
import, so that it runs on a machine with a card:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_volprims_cuda.py

It skips without a card.
"""
import numpy as np
import pytest
import torch

from rustlight_tpu_torch.integrators import (IntegratorPointNormal,
                                             IntegratorSinglePlane,
                                             IntegratorVolPrimitives,
                                             IntegratorVPL, render)
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.scene import make_volume

PIX_FRAC, PIX_RTOL, MEAN_RTOL = 0.99, 1e-3, 1e-4
W = H = 16
MEDIUM = dict(sigma_s=(0.0025,) * 3)   # tools/regression.py's cbox_medium
# tools/regression.py's integrators of the rows cbox_path/vpl and
# cbox_medium_single/*, cbox_medium_prims/* (:100, :124-139)
ROWS = {
    "vpl": lambda: IntegratorVPL(nb_vpl=256, max_depth=6, hard_cap=6),
    "point-normal": lambda: IntegratorPointNormal(
        strategies=("tr", "equiangular")),
    "plane-single": lambda: IntegratorSinglePlane(nb_primitive=256),
    "vrl": lambda: IntegratorVolPrimitives(nb_primitive=1024, max_depth=6,
                                           hard_cap=6, primitives="vrl",
                                           radius=8.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tech", sorted(ROWS))
def test_card_renders_the_rows_like_the_cpu(tech):
    """The row's integrator on cbox 16x16 in the rows' medium (VPL without
    it), 2 spp, on the card against the CPU: PIX_FRAC of the pixels within
    PIX_RTOL, means within MEAN_RTOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sc = cornell_box(W, H)
    if tech != "vpl":
        sc.volume = make_volume(**MEDIUM)
    imgs = [render(sc.compile(device=dev), ROWS[tech](), 2,
                   seed=0)["primal"] for dev in ("cuda", "cpu")]
    assert imgs[1].mean() > 0
    rel = np.abs(imgs[0] - imgs[1]) / np.maximum(np.abs(imgs[1]), 1e-4)
    assert (rel.max(-1) <= PIX_RTOL).mean() >= PIX_FRAC
    assert abs(imgs[0].mean() - imgs[1].mean()) <= MEAN_RTOL * imgs[1].mean()

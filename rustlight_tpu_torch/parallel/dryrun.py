"""One step of each decomposition over n ranks on tiny shapes: the port's
counterpart of `__graft_entry__.dryrun_multichip`.

    python -m rustlight_tpu_torch.parallel.dryrun 4 [--device cuda|cpu]
        [--backend nccl|gloo]

The card (NCCL, a rank a card) by default; `--device cpu` runs gloo ranks
on the CPU, and without a card nothing else runs.

P1 (one sharded step of the path tracer on cbox 16x16), P2/P6 (the sharded
light tracer), P3 (PSSMLT's chains split over the ranks) and P4 (SMCMC's
tile chains in row bands, four schedule steps so that the vertical
exchange runs): every film finite and the same on every rank, and P4's
exchange sending boundary rows only (2 rows of each exchanged array a
vertical step).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _dryrun_rank(mesh, device):
    import torch
    from ..integrators import IntegratorLightTracing, IntegratorPathTracing
    from ..integrators.mcmc import IntegratorPSSMLT, IntegratorSMCMC
    from ..integrators.mcmc.smcmc import SCHEDULE
    from ..models import cornell_box
    from .mesh import gather_objects
    from .render import (_padded_grid, render_splat_sharded,
                         render_step_sharded)

    scene = cornell_box(16, 16).compile(device=device)
    integ = IntegratorPathTracing(max_depth=3)
    out = {}
    pix = _padded_grid(16, 16, mesh.size)
    acc = render_step_sharded(scene, integ, mesh, pix, seed=0)
    if acc.shape != (pix.shape[0], 3) or not bool(torch.isfinite(acc).all()):
        raise AssertionError(f"P1: bad radiance {tuple(acc.shape)}")
    out["p1"] = acc.cpu().numpy()
    lt = IntegratorLightTracing(max_depth=3)
    out["p2"] = render_splat_sharded(scene, lt, n_paths=mesh.size * 64,
                                     mesh=mesh)["primal"]
    mlt = IntegratorPSSMLT(integ, nb_samples_norm=512,
                           nb_chains=mesh.size * 32)
    out["p3"] = mlt.render(scene, spp=2, seed=0, mesh=mesh)["primal"]
    spp = 4
    sm = IntegratorSMCMC(integ, recons="naive")
    out["p4"] = sm.render(scene, spp=spp, seed=0, mesh=mesh)["primal"]
    v_steps = sum(1 for s in range(spp)
                  if SCHEDULE[s % len(SCHEDULE)] is not None
                  and SCHEDULE[s % len(SCHEDULE)][0] == "v")
    # u [w, d], ua, tf and tf_p [w] a row, each way
    want = (0 if mesh.size == 1
            else v_steps * 2 * 16 * (sm.pss_dims + 3))
    if sm.exchange_moved != want:
        raise AssertionError(f"P4: the exchange sent {sm.exchange_moved} "
                             f"elements, boundary rows are {want}")
    for k, v in out.items():
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"{k}: non-finite film")
    films = gather_objects(mesh, {k: v for k, v in out.items() if k != "p1"})
    for k in films[0]:
        if any(not np.array_equal(f[k], films[0][k]) for f in films):
            raise AssertionError(f"{k}: the ranks' films differ")
    return {"moved": sm.exchange_moved, "means": {
        k: float(np.mean(v)) for k, v in out.items()}}


def dryrun_multichip(n: int, backend=None, device="cuda") -> dict:
    """The dryrun over n ranks: NCCL ranks a card each on "cuda" (the
    default), gloo ranks on "cpu" (or every gloo rank on one named card).
    Without a card only device="cpu" runs; the card raises. Returns rank
    0's summary: the films' means and the elements P4's exchange sent."""
    from .mesh import _card_or_raise, run_on_mesh
    cuda = torch.device(device).type == "cuda"
    if cuda:
        _card_or_raise("dryrun_multichip")
    backend = backend or ("nccl" if cuda else "gloo")
    gloo = backend == "gloo"
    return run_on_mesh(n, _dryrun_rank_main, device if gloo else None,
                       backend=backend, device=device if gloo else None,
                       timeout=600.0, threads=None if cuda else 1)


def _dryrun_rank_main(mesh, device):
    return _dryrun_rank(mesh, mesh.device if device is None else device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"])
    a = ap.parse_args(argv)
    print(dryrun_multichip(a.n, a.backend, a.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())

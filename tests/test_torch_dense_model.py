"""The dense kernels' order of work: its plain model on the CPU, its
kernels on a card.

`ops/dense_trace.py:dense_model` follows csrc/dense_trace.cu step by step
in torch: the staged rows (a triangle with a non-finite w made dead, the
d sums without their + 0 * w), the closest hit's cap min(tfar, best t),
the any hit's exact rejects before the division (sign and magnitude, for
rays with tnear >= 0) and its stop at the first hit. On the Cornell box's
rows, on random 1,000- and 257-triangle soups (rays made from
`numpy.random.default_rng(seed)`, with inert and empty lanes) and on every
planted boundary set of `planted_sets` (a hit's t exactly at tfar and one
ulp either side, exactly at tnear; -No = +0 and -0; |Nd| at 1e-20 and one
ulp either side; equal t at two indices in both orders; tfar inf and
subnormal; tnear < 0; inert and empty lanes; rows with inf or NaN;
products that overflow) it must equal the plain versions
`dense_closest_ref` / `dense_anyhit_ref` bit for bit (torch.equal; no
near-tie excuse).

A test marked `cuda` holds the kernels to the plain versions on the same
sets on a card (expected bit for bit). It imports nothing of JAX, so on a
card without JAX it runs with
`python -m pytest --noconftest -m cuda tests/test_torch_dense_model.py`.
"""
import numpy as np
import pytest
import torch

from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.ops import dense_trace as dt
from rustlight_tpu_torch.scene.geometry import TriMesh, build_geometry_tables

torch.set_num_threads(2)

N_RAYS = 2048
PLANTED = sorted(dt.planted_sets())


def _rays(seed, lo, hi, n=N_RAYS):
    """Rays from points in the box [lo, hi] in random directions, with
    bounded (k % 5 == 1), inert (k % 7 == 3, tfar = 0) and empty (k % 11
    == 5, tnear >= tfar) lanes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = np.arange(n)
    span = float(np.linalg.norm(np.subtract(hi, lo)))
    tnear = np.full(n, 1e-4, np.float32)
    tfar = np.full(n, np.inf, np.float32)
    tfar[k % 5 == 1] = rng.uniform(0.05, 1.0, (k % 5 == 1).sum()) * span
    tfar[k % 7 == 3] = 0.0
    tnear[k % 11 == 5], tfar[k % 11 == 5] = 0.5 * span, 0.25 * span
    return o, d, tnear, tfar


def _case(name):
    """(rows, o, d, tnear, tfar) as numpy arrays."""
    if name == "cbox":
        rows = cornell_box(8, 8).compile(device="cpu").geom.inter_rows
        return (rows.numpy(), *_rays(1, (-20.0, -20.0, -800.0),
                                     (576.0, 568.8, 559.2)))
    if name.startswith("planted/"):
        return dt.planted_sets()[name.split("/")[1]]
    n_tris = int(name[len("soup"):])
    rng = np.random.default_rng(2)
    verts = rng.uniform(0.0, 1.0, (3 * n_tris, 3)).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    rows = build_geometry_tables([TriMesh(verts, idx)], [-1]).inter_rows
    return (rows, *_rays(3, (-0.2,) * 3, (1.2,) * 3))


def _check_model(case):
    args = [torch.as_tensor(x) for x in _case(case)]
    (t, idx, u, v), counts = dt.dense_model(*args)
    occ, counts_any = dt.dense_model(*args, anyhit=True)
    for got, want in zip((t, idx, u, v), dt.dense_closest_ref(*args)):
        assert torch.equal(got, want), case
    assert torch.equal(occ, dt.dense_anyhit_ref(*args)), case
    return args, counts, counts_any


@pytest.mark.parametrize("case", ["cbox", "soup1000", "soup257"])
def test_model_matches_plain_versions(case):
    args, counts, counts_any = _check_model(case)
    tfar = args[4]
    assert torch.isfinite(dt.dense_closest_ref(*args)[0]).sum() > N_RAYS // 8
    # the cap drops the barycentrics of triangles behind the best hit, and
    # the any hit's rejects drop tests before the division
    assert counts["bary"] < counts["divided"] == counts["tests"] - counts["nd"]
    assert counts_any["rejected"] > counts_any["tests"] // 4
    assert counts["tests"] == int((args[3] < tfar).sum()) * args[0].shape[0]


@pytest.mark.parametrize("case", PLANTED)
def test_model_matches_plain_versions_on_planted_sets(case):
    _check_model("planted/" + case)


def test_planted_sets_reach_their_boundaries():
    """The planted cases do what they are planted for, by the plain
    versions' arithmetic."""
    sets = dt.planted_sets()
    # caps: (tnear, tfar) pairs around the nearest t of each aimed ray
    rows, o, d, tnear, tfar = (torch.as_tensor(x) for x in sets["caps"])
    t, idx, _, _ = dt.dense_closest_ref(rows, o, d, tnear, tfar)
    k = o.shape[0] // 12
    best = tfar[:k]
    t = t.view(12, k)
    assert torch.isfinite(best).all()
    assert not torch.isfinite(t[0]).any()        # tfar = t: nothing nearer
    assert torch.equal(t[1], best)               # tfar one ulp above
    assert not torch.isfinite(t[2]).any()        # tfar one ulp below
    assert torch.equal(t[3], best)               # tfar = inf
    assert (t[4] > best).all()                   # tnear = t
    assert torch.equal(t[5], best)               # tnear one ulp below
    assert (t[6] > best).all()                   # tnear one ulp above
    assert not torch.isfinite(t[9:11]).any()     # inert and empty lanes
    # one triangle at two indices: the lower one wins
    assert (idx == 7).sum() == 0 and (idx == 3).sum() > 0
    # ties in both orders: where both are hit, at the same t, the lower
    # index wins, with its own u
    for name in ("tie_ab", "tie_ba"):
        r = [torch.as_tensor(x) for x in sets[name]]
        t, idx, u, _ = dt.dense_closest_ref(*r)
        tt, _, _, valid = dt._chunk_test(*r)
        tie = valid.all(1)
        assert tie.any() and torch.equal(tt[tie, 0], tt[tie, 1])
        assert (idx[tie] == 0).all()
        uw = float(r[0][0, 1, 3])
        assert torch.equal(u[tie], (r[1][tie, 0] + uw) + 0.0)
    # -No = +0 and -0: no hit for tnear >= 0, a hit at t = +-0 for tnear < 0
    for name in ("zero_num", "neg_zero_num"):
        r = [torch.as_tensor(x) for x in sets[name]]
        t, _, _, _ = dt.dense_closest_ref(*r)
        hit = torch.isfinite(t)
        assert hit.any() and (r[3][hit] < 0).all() and (t[hit] == 0).all()
        n4 = r[0][0, 0]
        no = ((r[1][:, 0] * n4[0] + r[1][:, 1] * n4[1]) + r[1][:, 2] * n4[2]
              + n4[3])
        assert (no == 0).all()
        assert torch.signbit(no).any() == (name == "neg_zero_num")
        assert (~torch.signbit(no)).any()
    # |Nd| = 1e-20 misses, one ulp above hits, one ulp below misses
    r = [torch.as_tensor(x) for x in sets["nd_limit"]]
    _, idx, _, _ = dt.dense_closest_ref(*r)
    assert set(idx.tolist()) <= {1, 4} and (idx == 1).any()
    # a subnormal t hits below a subnormal tfar, and not at or above it
    r = [torch.as_tensor(x) for x in sets["subnormal"]]
    t, _, _, _ = dt.dense_closest_ref(*r)
    hit = torch.isfinite(t)
    assert hit.any() and not hit.all() and (t[hit] < r[4][hit]).all()
    assert (t[hit] < 1.17549435e-38).all()
    # rows with inf or NaN are never hit; the plain row behind them is
    r = [torch.as_tensor(x) for x in sets["nonfinite"]]
    _, idx, _, _ = dt.dense_closest_ref(*r)
    assert (idx == r[0].shape[0] - 1).all()


def test_staged_rows_mark_nonfinite_triangles():
    rows = torch.as_tensor(dt.planted_sets()["nonfinite"][0])
    staged = dt.staged_rows(rows)
    dead = ~torch.isfinite(rows[:, :, 3]).all(1)
    assert dead.sum() == 9 and torch.isnan(staged[dead, 0]).all()
    for a, b in ((staged[~dead], rows[~dead]), (staged[:, 1:], rows[:, 1:])):
        assert torch.allclose(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions_on_every_set():
    """On a card: the CUDA kernels against their plain versions on the
    Cornell box, the soups and every planted set, bit for bit, each launch
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    for case in ["cbox", "soup1000", "soup257"] + [
            "planted/" + p for p in PLANTED]:
        args = [torch.as_tensor(x, device="cuda") for x in _case(case)]
        before = dict(dt.LAUNCHES)
        closest = dt.dense_closest(*args)
        occ = dt.dense_anyhit(*args)
        torch.cuda.synchronize()
        assert dt.LAUNCHES["dense_closest"] == before["dense_closest"] + 1
        assert dt.LAUNCHES["dense_anyhit"] == before["dense_anyhit"] + 1
        for a, b in zip(closest, dt.dense_closest_ref(*args)):
            assert torch.equal(a, b), case
        assert torch.equal(occ, dt.dense_anyhit_ref(*args)), case

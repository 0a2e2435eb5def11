"""The split form of the pair kernels K8 (P threads a pair over runs of one
cluster) and the split tensor-core visit of the two-level walk K5: the
layout, the order of work and the launch rules on the CPU; the kernels on a
card.

`ops/pair_trace.py:_cluster_runs` lays the live pairs out by cluster in
runs of a given length; a numpy statement of the rule (stable by cluster
id, each cluster padded to whole runs, the rest -1 up to the bound
m + (run - 1) n_real) must give it slot for slot at runs of 32 (the
parent's tensor-core layout) and 64 (the split form's). `pair_split_model`
runs the split form's order of work in torch (the split visit of
ops/walk_trace.py at P threads a pair over each run's one cluster); it must
equal the plain versions pair_closest_ref / pair_anyhit_ref bit for bit at
P = 4 and 8, on the pairs of sphere_grid(3000, 16, 16)'s walk tables at
km = 8 and 2, and on clusters with exact ties planted across the P lanes'
columns (tests/test_torch_walk_split.py:_clusters). The split tensor-core
visit merges the partials of W = P warps a set in column order
(`_merge_parts`), at the W that K5's and K8's production forms give.
`launch_geometry` and the form rules raise ValueError for a form that is
not built.

Tests marked `cuda` hold the split form against the parent's kernels and
the plain version, and the split tensor-core forms of K8 and K5 against
their one-thread ones, bit for bit on a card. Nothing here imports JAX:
`python -m pytest --noconftest -m cuda tests/test_torch_pair_split.py`.
"""
import numpy as np
import pytest
import torch

from rustlight_tpu_torch.accel import pair_walk as pw
from rustlight_tpu_torch.ops import pair_trace as pt
from rustlight_tpu_torch.ops import walk_hier as wh
from rustlight_tpu_torch.ops import walk_trace as wk
from test_torch_walk_split import (N_CLUSTERS, _Tables, _clusters, _constant,
                                   _same, _tile_rays)

K = wk.K
KMS = (8, 2)
PS = (4, 8)
NR = 1024


@pytest.fixture(scope="module")
def grid():
    """sphere_grid(3000, 16, 16)'s walk tables (14 of 128 clusters real)
    and NR rays from numpy (seed 11): half from a point in front of the
    grid, half from random points inside it, a few inert and empty lanes."""
    from rustlight_tpu_torch.models import sphere_grid
    wt = sphere_grid(3000, 16, 16).compile(device="cpu").geom.walk
    lo, hi = wt.world_lo.numpy(), wt.world_hi.numpy()
    rng = np.random.default_rng(11)
    o = rng.uniform(lo, hi, (NR, 3)).astype(np.float32)
    o[: NR // 2] = (lo + hi) / 2 + np.array([0, 0, -2.0]) * (hi - lo)
    d = rng.normal(size=(NR, 3))
    d[: NR // 2] = rng.uniform(lo, hi, (NR // 2, 3)) - o[: NR // 2]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tnear = np.full(NR, 1e-4, np.float32)
    tfar = np.full(NR, np.inf, np.float32)
    k = np.arange(NR)
    tfar[k % 7 == 3] = 0.0
    tfar[k % 5 == 1] = rng.uniform(1.0, 6.0, (k % 5 == 1).sum())
    tnear[k % 11 == 5], tfar[k % 11 == 5] = 4.0, 3.0
    return wt, [torch.as_tensor(x) for x in (o, d, tnear, tfar)]


def _pairs(wt, rays, km):
    return pw._make_pairs(wt, *rays, km)[0]


def _runs_np(n_real, cid, run):
    """The layout rule in numpy: the live pairs (cid in [0, n_real)) stably
    sorted by cluster id, each cluster's pairs padded with -1 to whole runs,
    then -1 up to the bound m + (run - 1) n_real in whole 64-slot tiles."""
    m = cid.shape[0]
    bound = -(-(m + (run - 1) * n_real) // 64) * 64
    out = []
    for c in range(n_real):
        k = np.nonzero(cid == c)[0]
        if k.size:
            out += list(k) + [-1] * (-k.size % run)
    return np.array(out + [-1] * (bound - len(out)), np.int32)


@pytest.mark.parametrize("run", [32, 64])
@pytest.mark.parametrize("km", KMS)
def test_cluster_runs_layout(grid, km, run):
    """Every live pair in exactly one slot, each run of one cluster and of
    `run` slots, its first slot a real pair, pads -1, inert pairs absent,
    the slots within the bound; slot for slot the numpy rule."""
    wt, rays = grid
    cid = _pairs(wt, rays, km)[4]
    n_real = int(wt.n_real)
    perm = pt._cluster_runs(n_real, cid, run).numpy()
    c = cid.numpy()
    live = np.nonzero((c >= 0) & (c < n_real))[0]
    assert 0 < live.size < c.size
    assert perm.shape[0] == -(-(c.size + (run - 1) * n_real) // 64) * 64
    real = perm[perm >= 0]
    np.testing.assert_array_equal(np.sort(real), live)
    runs = perm.reshape(-1, run)
    used = runs[:, 0] >= 0
    # the runs in use come first, each of one cluster
    assert not used[np.argmin(used):].any()
    for r in runs[used]:
        assert len(set(c[r[r >= 0]])) == 1
        # pads only at a run's end
        assert (r >= 0).sum() == np.argmin(np.append(r >= 0, False))
    assert (runs[~used] == -1).all()
    np.testing.assert_array_equal(perm, _runs_np(n_real, c, run))
    if run == pt._RUN:
        assert torch.equal(pt._cluster_runs(n_real, cid), torch.as_tensor(perm))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("km", KMS)
def test_split_model_equals_plain_versions(grid, km, p):
    """The split form's order of work at p threads a pair on the grid's
    pairs at km = 8 and 2: bit for bit pair_closest_ref / pair_anyhit_ref."""
    wt, rays = grid
    pairs = _pairs(wt, rays, km)
    ref = pt.pair_closest_ref(wt, *pairs)
    assert int((ref[1] >= 0).sum()) > 100
    assert _same(pt.pair_split_model(wt, *pairs, p, False), ref[:4])
    occ = pt.pair_anyhit_ref(wt, *pairs)[0]
    assert 0 < int(occ.sum()) < ref[4]
    assert torch.equal(pt.pair_split_model(wt, *pairs, p, True), occ)


@pytest.mark.parametrize("p", PS)
def test_split_model_planted_ties(p):
    """Pairs on clusters whose triangles are copied to columns of other
    residues mod 4 and 8 and whose quads are hit on a shared edge, with
    rays aimed at the ties, inert cluster ids mixed in: the lower column
    wins as in the plain version, bit for bit."""
    rows, ids, aims = _clusters(9)
    box = torch.full((3, N_CLUSTERS), 2.0)
    wt = _Tables(rows, ids, -box, box)
    # rays aimed at cluster 0's six ties, four in five of them paired with
    # cluster 0, the others with another cluster or an inert id
    o, d, tnear, tfar = (x.reshape(-1, *x.shape[2:]).contiguous()
                         for x in _tile_rays(10, aims[:6], aimed=1.0))
    rng = np.random.default_rng(12)
    other = rng.integers(-1, N_CLUSTERS + 1, o.shape[0])
    cid = torch.as_tensor(np.where(np.arange(o.shape[0]) % 5 == 4, other, 0)
                          .astype(np.int32))
    tfar = torch.where(tfar > 0, tfar, float("inf"))
    ref = pt.pair_closest_ref(wt, o, d, tnear, tfar, cid)
    t, _, _, valid = wk._test_clusters(
        rows[cid.clamp(0, N_CLUSTERS - 1).long()], o[:, None], d[:, None],
        tnear[:, None], tfar[:, None])
    t2 = torch.topk(torch.where(valid, t, float("inf"))[:, 0], 2, dim=-1,
                    largest=False).values
    live = (cid >= 0) & (cid < N_CLUSTERS)
    tied = live & torch.isfinite(t2[:, 0]) & (t2[:, 0] == t2[:, 1])
    assert int(tied.sum()) >= 8
    assert _same(pt.pair_split_model(wt, o, d, tnear, tfar, cid, p, False),
                 ref[:4])
    assert torch.equal(pt.pair_split_model(wt, o, d, tnear, tfar, cid, p,
                                           True),
                       pt.pair_anyhit_ref(wt, o, d, tnear, tfar, cid)[0])


@pytest.mark.parametrize("name", ["walk_hier_closest", "walk_hier_anyhit",
                                  "pair"])
def test_tc_merge_at_the_production_warps(name):
    """The split tensor-core visit's merge over the W = P warps of a 32-ray
    set that K5's production forms (P = 4 closest, 8 any hit) and K8's
    give, on the planted ties: the plain visit's winner, the lowest column
    on tied t."""
    p = (pt.PRODUCTION_FORM if name == "pair"
         else wk.PRODUCTION_FORMS[name])[0]
    rows, ids, aims = _clusters(13)
    o, d, tnear, tfar = _tile_rays(14, aims[:6], aimed=1.0)
    csel = torch.zeros(o.shape[0], dtype=torch.int64)
    cap = torch.where(tfar > 0, tfar, float("inf"))
    best = (cap.clone(), torch.full(cap.shape, -1, dtype=torch.int32),
            torch.zeros_like(cap), torch.zeros_like(cap))
    want_t, want_i = wk._visit_closest(rows, ids, csel, o, d, tnear, best)[:2]
    t, _, _, valid = wk._test_clusters(rows[csel], o, d, tnear,
                                       torch.full_like(cap, float("inf")))
    got_t, got_j = wk._merge_parts(t, valid, cap, p)
    hit = got_j < K
    assert int(hit.sum()) > 64
    assert torch.equal(hit, want_i >= 0)
    assert torch.equal(ids[0][got_j[hit]], want_i[hit])
    assert torch.equal(got_t[hit].view(torch.int32),
                       want_t[hit].view(torch.int32))


def test_pair_launch_geometry_and_forms():
    """The split forms' threads and dynamic shared memory with either test;
    the laboratory forms only with `lab` and their own test; any other form
    raises; PRODUCTION_FORM and MMA_FORM name csrc/pair_trace.cu's PAIR_P
    and PAIR_MMA_P."""
    assert pt.PRODUCTION_FORM == (_constant("pair_trace.cu", "PAIR_P"), 1,
                                  False)
    assert pt.MMA_FORM == (_constant("pair_trace.cu", "PAIR_MMA_P"), 1,
                           False)
    p = pt.PRODUCTION_FORM[0]
    assert pt.launch_geometry(pt.PRODUCTION_FORM) == (64 * p, K * 48)
    p = pt.MMA_FORM[0]
    assert pt.launch_geometry(pt.MMA_FORM, True) == (
        64 * p, K * 48 + wk.mma_scratch_bytes(p))
    for mxu, built, lab in ((False, pt.PRODUCTION_FORM, pt.LAB_FORMS),
                            (True, pt.MMA_FORM, pt.LAB_MMA_FORMS)):
        for form in lab:
            threads, smem = pt.launch_geometry(form, mxu, lab=True)
            assert threads == 64 * form[0]
            assert smem == (2 if form[2] else 1) * K * 48 + (
                wk.mma_scratch_bytes(form[0]) if mxu else 0)
            with pytest.raises(ValueError, match="not built"):
                pt.launch_geometry(form, mxu)
        for form in (pt.LAB_MMA_FORMS if not mxu else pt.LAB_FORMS):
            if form not in lab and form != built:
                with pytest.raises(ValueError, match="not built"):
                    pt.launch_geometry(form, mxu, lab=True)
    for bad in ((16, 1, False), (8, 2, False), (8, 1, True), (3, 1, False)):
        for mxu in (False, True):
            with pytest.raises(ValueError, match="not built"):
                pt.launch_geometry(bad, mxu, lab=True)


def test_pair_form_keyword_rules(grid):
    """_form takes only ONE_THREAD_FORM (the parent's kernels); on the CPU
    every form runs the plain version; and through the whole pair walk."""
    wt, rays = grid
    pairs = _pairs(wt, rays, 2)
    one = wk.ONE_THREAD_FORM
    before = dict(pt.LAUNCHES)
    for mxu in (False, True):
        assert _same(pt.pair_closest(wt, *pairs, mxu, _form=one),
                     pt.pair_closest(wt, *pairs, mxu))
        assert torch.equal(pt.pair_anyhit(wt, *pairs, mxu, _form=one),
                           pt.pair_anyhit(wt, *pairs, mxu))
        for bad in (pt.PRODUCTION_FORM, (8, False)):
            with pytest.raises(ValueError, match="_form takes only"):
                pt.pair_closest(wt, *pairs, mxu, _form=bad)
            with pytest.raises(ValueError, match="_form takes only"):
                pt.pair_anyhit(wt, *pairs, mxu, _form=bad)
    assert pt.LAUNCHES == before
    rh = pw._pairs_impl(wt, *rays, False, 2, _form=one)
    assert _same(rh, pw._pairs_impl(wt, *rays, False, 2))
    with pytest.raises(ValueError, match="_form takes only"):
        pw._pairs_impl(wt, *rays, True, 2, _form=(8, 1, False))


def test_hier_mxu_forms():
    """K5 with mxu: the production form (split tensor-core visit) with its
    scratch before the super heap; the one-thread form on request; a form
    not built raises."""
    one = wk.ONE_THREAD_FORM
    for name in ("walk_hier_closest", "walk_hier_anyhit"):
        form = wk.PRODUCTION_FORMS[name]
        assert wk._resolve_form(name, None, True) == form
        assert wk._resolve_form(name, one, True) == one
        for sp in (256, wh.MAX_CLUSTERS // wh.SUP):
            threads, smem = wk.launch_geometry(name, form, sp, True)
            assert threads == 64 * form[0]
            assert smem == K * 48 + wk.mma_scratch_bytes(form[0]) + 4 * sp
            assert wk.static_smem(name, form) + smem <= 232_448
            assert wk.launch_geometry(name, one, sp, True) == (64, 4 * sp)
        for bad in ((form[0], True), (8 if form[0] == 4 else 4, False)):
            with pytest.raises(ValueError, match="not built"):
                wk.launch_geometry(name, bad, 256, True)
        with pytest.raises(ValueError, match="_form takes only"):
            wk._resolve_form(name, form, True)


def _cuda_grid():
    """sphere_grid(3000, 16, 16) on the card, and 4,096 rays as the grid
    fixture makes them (seed 11)."""
    from rustlight_tpu_torch.accel import walk as tw
    from rustlight_tpu_torch.models import sphere_grid
    sd = sphere_grid(3000, 16, 16).compile(device="cuda")
    wt = sd.geom.walk
    lo, hi = wt.world_lo.cpu().numpy(), wt.world_hi.cpu().numpy()
    rng = np.random.default_rng(11)
    n = 4096
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    o[: n // 2] = (lo + hi) / 2 + np.array([0, 0, -2.0]) * (hi - lo)
    d = rng.normal(size=(n, 3))
    d[: n // 2] = rng.uniform(lo, hi, (n // 2, 3)) - o[: n // 2]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tnear = np.full(n, 1e-4, np.float32)
    tfar = np.full(n, np.inf, np.float32)
    tfar[np.arange(n) % 7 == 3] = 0.0
    rays = [torch.as_tensor(x, device="cuda") for x in (o, d, tnear, tfar)]
    return wt, tw._prepare(wt, *rays)[:4]


@pytest.mark.cuda
def test_cuda_pair_split_and_tc_split_match():
    """On a card: K8's split form against the parent's kernels and the plain
    version at km = 8 and 2, and the split tensor-core forms of K8 and K5
    against their one-thread tensor-core kernels, bit for bit; each launch
    counted, the parents' as P1 too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    wt, srt = _cuda_grid()
    one = wk.ONE_THREAD_FORM
    for km in KMS:
        pairs = _pairs(wt, srt, km)
        ref = pt.pair_closest_ref(wt, *pairs)[:4]
        occ = pt.pair_anyhit_ref(wt, *pairs)[0]
        before, p1 = dict(pt.LAUNCHES), dict(pt.P1_LAUNCHES)
        got = [pt.pair_closest(wt, *pairs), pt.pair_anyhit(wt, *pairs),
               pt.pair_closest(wt, *pairs, _form=one),
               pt.pair_anyhit(wt, *pairs, _form=one)]
        torch.cuda.synchronize()
        assert pt.LAUNCHES["pair_closest"] == before["pair_closest"] + 2
        assert pt.P1_LAUNCHES["pair_anyhit"] == p1["pair_anyhit"] + 1
        assert _same(got[0], ref) and _same(got[2], ref)
        assert torch.equal(got[1], occ) and torch.equal(got[3], occ)
        for mxu_fn in (pt.pair_closest, pt.pair_anyhit):
            split = mxu_fn(wt, *pairs, True)
            single = mxu_fn(wt, *pairs, True, _form=one)
            torch.cuda.synchronize()
            split = split if isinstance(split, tuple) else (split,)
            single = single if isinstance(single, tuple) else (single,)
            assert _same(split, single), (km, mxu_fn.__name__)
    for fn in (wh.walk_hier_closest, wh.walk_hier_anyhit):
        split, single = fn(wt, *srt, True), fn(wt, *srt, True, _form=one)
        torch.cuda.synchronize()
        split = split if isinstance(split, tuple) else (split,)
        single = single if isinstance(single, tuple) else (single,)
        assert _same(split, single), fn.__name__

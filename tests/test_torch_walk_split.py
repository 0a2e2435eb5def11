"""The split form of the tile walk (P threads a ray, the ring of cluster
rows): its plain model and its launch geometry, on the CPU; its kernels on
a card.

The split kernels (csrc/walk_flat.cuh, walk_trace.cu, walk_hier.cu) test a
visit's 384 triangles with P threads a ray, lane q scanning the columns
j = q (mod P) under the serial rule, then keep the least t, and the lowest
column among equal t, over the P lanes. `ops/walk_trace.py:
_visit_closest_split` / `_visit_anyhit_split` model that visit in torch; on
random clusters made from `numpy.random.default_rng(seed)` they must equal
the plain visits `_visit_closest` / `_visit_anyhit` (the ones the plain
walks and the one-thread-a-ray kernels compute) bit for bit at P = 1, 2, 4,
8, with exact ties planted: one triangle at two columns, and rays aimed at
the edge two triangles share. `launch_geometry` must take every tile-walk
table the wrappers accept (Cp up to 2^14; K5's Sp at 5.7M triangles) and
raise past the card's 232,448 B a block, and `PRODUCTION_FORMS` must name
the forms that csrc/ builds.

The sub-tiled walk K6 (csrc/walk_sub.cu) takes the same split visit at P
threads a ray in each group: with `_visit_closest_split` /
`_visit_anyhit_split` in place of the serial visits, the plain walk at a
tile of 64 / sub rays (ops/walk_sub.py's plain version) must give the same
results bit for bit at P = 2, 4, 8 and every sub, on the planted ties and
on tiles whose groups stop far apart (half of them after one pair of
visits, the other half after visiting every cluster: the named barriers'
case). The split tensor-core visit merges W column slices in order
(`_merge_parts`), which keeps the lowest column on tied t.
`ops/walk_sub.py:launch_geometry` and PRODUCTION_FORMS / MMA_FORMS are
held to csrc/walk_sub.cu as K3's are to its sources.

Tests marked `cuda` hold both built forms (one thread a ray, and the
production form of `PRODUCTION_FORMS`) of K3/K4 and K5, and of the lab's
counted and floor walks, to their plain versions on a card (expected bit
for bit); K6's forms at every sub to its plain version; and the split
tensor-core forms of K3/K4 and K6 to their one-thread tensor-core kernels
(bit for bit). They import nothing of JAX, so on a card without JAX they
run with `python -m pytest --noconftest -m cuda
tests/test_torch_walk_split.py`.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rustlight_tpu_torch.ops import walk_hier as wh
from rustlight_tpu_torch.ops import walk_lab as wl
from rustlight_tpu_torch.ops import walk_sub as wsub
from rustlight_tpu_torch.ops import walk_trace as wk
from rustlight_tpu_torch.scene.geometry import _baldwin_weber_rows

K = wk.K
PS = (1, 2, 4, 8)
N_CLUSTERS, TILES, RAYS = 3, 4, 64
MAX_SMEM = 232_448
# grid5p7M: 18,816 clusters in 147 supers, padded to 256
GRID5P7M_SP = 256


def _rows(p0, p1, p2):
    """Baldwin-Weber rows [T, 3, 4] of triangles p0, p1, p2 [T, 3]."""
    e1, e2 = p1 - p0, p2 - p0
    n = np.cross(e1, e2)
    ng = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    return _baldwin_weber_rows(p0, e1, e2, ng)


def _clusters(seed):
    """N_CLUSTERS clusters of K small random triangles in [-1, 1]^3, with
    ties planted in each: triangle a copied to column b for column pairs of
    every residue mod 2, 4 and 8, and a quad cut along its diagonal at two
    more columns. Returns rows [C, K, 3, 4], ids [C, K], and the centres of
    the copied triangles and the midpoints of the shared edges [M, 3]."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (N_CLUSTERS * K, 3)).astype(np.float32)
    p = [c + rng.normal(0, 0.15, c.shape).astype(np.float32) for _ in range(3)]
    rows = _rows(*p).reshape(N_CLUSTERS, K, 3, 4)
    aims = []
    for ci in range(N_CLUSTERS):
        for a, b in ((3, 4), (10, 12), (20, 24), (40, 48), (101, 357)):
            rows[ci, b] = rows[ci, a]
            aims.append(c[ci * K + a])
        # a quad in the plane z = z0 cut along its diagonal: columns 200, 201
        z0 = rng.uniform(-0.5, 0.5)
        q = np.array([[-.3, -.3, z0], [.3, -.3, z0], [.3, .3, z0],
                      [-.3, .3, z0]], np.float32) + rng.uniform(-.5, .5, 3)
        tri = _rows(q[[0, 0]], q[[1, 2]], q[[2, 3]])
        rows[ci, 200], rows[ci, 201] = tri[0], tri[1]
        aims.append((q[0] + q[2]) / 2)
    ids = np.arange(N_CLUSTERS * K, dtype=np.int32).reshape(N_CLUSTERS, K)
    return (torch.as_tensor(rows), torch.as_tensor(ids),
            np.asarray(aims, np.float32))


def _tile_rays(seed, aims, aimed=0.5):
    """TILES tiles of RAYS rays from outside [-1, 1]^3: a share `aimed` at
    the planted ties, the others at random points; tnear 1e-4, tfar inf or
    finite, a few inert (tfar = 0) and empty (tnear >= tfar) lanes."""
    rng = np.random.default_rng(seed)
    n = TILES * RAYS
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 2] = -3.0
    target = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    half = int(n * aimed)
    target[:half] = aims[rng.integers(0, len(aims), half)]
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tnear = np.full(n, 1e-4, np.float32)
    tfar = np.full(n, np.inf, np.float32)
    k = np.arange(n)
    tfar[k % 5 == 1] = rng.uniform(2.0, 5.0, (k % 5 == 1).sum())
    tfar[k % 7 == 3] = 0.0
    tnear[k % 11 == 5], tfar[k % 11 == 5] = 4.0, 3.0
    return [torch.as_tensor(x).reshape(TILES, RAYS, *x.shape[1:])
            for x in (o, d.astype(np.float32), tnear, tfar)]


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_visit_equals_serial_visit(seed):
    """Three visits a tile (the best of each the cap of the next): the split
    model equals _visit_closest / _visit_anyhit bit for bit at every P,
    ties included."""
    rows, ids, aims = _clusters(seed)
    o, d, tnear, tfar = _tile_rays(seed + 10, aims)
    rng = np.random.default_rng(seed + 20)
    csels = [torch.as_tensor(rng.integers(0, N_CLUSTERS, TILES))
             for _ in range(3)]
    best0 = (tfar.clone(), torch.full(tfar.shape, -1, dtype=torch.int32),
             torch.zeros_like(tfar), torch.zeros_like(tfar))
    occ0 = torch.zeros(tfar.shape, dtype=torch.bool)
    serial, occ = best0, occ0
    steps = []
    for csel in csels:
        serial = wk._visit_closest(rows, ids, csel, o, d, tnear, serial)
        occ = wk._visit_anyhit(rows, csel, o, d, tnear, tfar, occ)
        steps.append((serial, occ))
    hits = int((serial[1] >= 0).sum())
    assert hits > TILES * RAYS // 4 and int(occ.sum()) >= hits
    for p in PS:
        split, socc = best0, occ0
        for csel, (want, want_occ) in zip(csels, steps):
            split = wk._visit_closest_split(rows, ids, csel, o, d, tnear,
                                            split, p)
            socc = wk._visit_anyhit_split(rows, csel, o, d, tnear, tfar,
                                          socc, p)
            assert _same(split, want), p
            assert torch.equal(socc, want_occ), p


def test_planted_ties_pick_the_lowest_column():
    """A triangle copied to a higher column (in another lane's subset at
    some P) and the two halves of a quad hit on their shared edge: every P
    picks what the serial scan picks, the lower column on exact ties."""
    rows, ids, aims = _clusters(5)
    # cluster 0's six planted ties
    o, d, tnear, tfar = _tile_rays(6, aims[:6], aimed=1.0)
    csel = torch.zeros(TILES, dtype=torch.int64)
    tfar = torch.full_like(tfar, float("inf"))
    best = (tfar.clone(), torch.full(tfar.shape, -1, dtype=torch.int32),
            torch.zeros_like(tfar), torch.zeros_like(tfar))
    want = wk._visit_closest(rows, ids, csel, o, d, tnear, best)
    # exact ties occur: rays whose two nearest valid t are equal
    t, _, _, valid = wk._test_clusters(rows[csel], o, d, tnear, tfar)
    t2 = torch.topk(torch.where(valid, t, float("inf")), 2, dim=-1,
                    largest=False).values
    tied = torch.isfinite(t2[..., 0]) & (t2[..., 0] == t2[..., 1])
    assert int(tied.sum()) >= 8
    for p in PS:
        assert _same(wk._visit_closest_split(rows, ids, csel, o, d, tnear,
                                             best, p), want), p


def test_launch_geometry_bounds():
    """Threads and dynamic shared memory per kernel and form: Cp up to 2^14
    fits both forms of K3/K4, grid5p7M's Sp and the two-level walk's
    ceiling fit K5, a heap past the card's limit raises, and so does a form
    that is not built."""
    one = wk.ONE_THREAD_FORM
    for name in ("walk_closest", "walk_anyhit"):
        for form in (one, wk.PRODUCTION_FORMS[name]):
            p, ring = form
            threads, smem = wk.launch_geometry(name, form, 1 << 14)
            assert threads == 64 * p
            assert smem == (4 << 14) + (0 if form == one
                                        else (2 if ring else 1) * K * 48)
            assert wk.static_smem(name, form) + smem <= MAX_SMEM
            with pytest.raises(ValueError, match="shared memory"):
                wk.launch_geometry(name, form, MAX_SMEM // 4)
    for name in ("walk_hier_closest", "walk_hier_anyhit"):
        for form in (one, wk.PRODUCTION_FORMS[name]):
            for sp in (GRID5P7M_SP, wh.MAX_CLUSTERS // wh.SUP):
                threads, smem = wk.launch_geometry(name, form, sp)
                assert threads == 64 * form[0]
                assert wk.static_smem(name, form) + smem <= MAX_SMEM
            with pytest.raises(ValueError, match="shared memory"):
                wk.launch_geometry(name, form, MAX_SMEM // 4)
    # the ring's two slots leave room for a heap of about 48,000 entries
    ring = wk.PRODUCTION_FORMS["walk_anyhit"]
    assert ring[1]
    assert wk.launch_geometry("walk_anyhit", ring, 48_000)[1] < MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        wk.launch_geometry("walk_anyhit", ring, 48_400)
    p, ring = wk.PRODUCTION_FORMS["walk_closest"]
    assert wk.launch_geometry("walk_floor", (p, ring), 0) == (
        64 * p, (2 if ring else 1) * K * 48)
    for name in ("walk_closest", "walk_anyhit", "walk_hier_closest",
                 "walk_hier_anyhit"):
        p, ring = wk.PRODUCTION_FORMS[name]
        assert p > 1
        for bad in ((3, ring), (1, True), (16, ring), (p, not ring),
                    (p // 2, ring)):
            with pytest.raises(ValueError, match="not built"):
                wk.launch_geometry(name, bad, 512)


def _constant(src, name):
    """The value of `constexpr int|bool name = value;` in csrc/`src`."""
    text = (Path(wk.__file__).parents[1] / "csrc" / src).read_text()
    m = re.search(rf"constexpr (int|bool) {name} = (\w+);", text)
    assert m, (src, name)
    return int(m.group(2)) if m.group(1) == "int" else m.group(2) == "true"


def test_production_forms_match_the_sources():
    """PRODUCTION_FORMS names the split forms csrc/ builds: the P and ring
    constants of walk_flat.cuh (K3/K4) and walk_hier.cu (K5, no ring)."""
    forms = wk.PRODUCTION_FORMS
    assert forms["walk_closest"] == (_constant("walk_flat.cuh", "CLOSEST_P"),
                                     _constant("walk_flat.cuh",
                                               "CLOSEST_RING"))
    assert forms["walk_anyhit"] == (_constant("walk_flat.cuh", "ANYHIT_P"),
                                    _constant("walk_flat.cuh", "ANYHIT_RING"))
    assert forms["walk_hier_closest"] == (
        _constant("walk_hier.cu", "HIER_CLOSEST_P"), False)
    assert forms["walk_hier_anyhit"] == (
        _constant("walk_hier.cu", "HIER_ANYHIT_P"), False)


def test_form_keyword_rules():
    """_form is private and takes only ONE_THREAD_FORM, with either test
    and with the wide pop, which has a split form too; on the CPU both
    forms run the plain walk."""
    rows, ids, aims = _clusters(3)

    class Tables:
        n_clusters = n_real = N_CLUSTERS
        lo = torch.full((3, N_CLUSTERS), -2.0)
        hi = torch.full((3, N_CLUSTERS), 2.0)

    wt = Tables()
    wt.rows = rows.reshape(-1, 3, 4).contiguous()
    wt.ids = ids.reshape(-1).contiguous()
    o, d, tnear, tfar = (x.reshape(-1, *x.shape[2:]).contiguous()
                         for x in _tile_rays(4, aims))
    one = wk.ONE_THREAD_FORM
    ref = wk.walk_closest(wt, o, d, tnear, tfar)
    assert _same(wk.walk_closest(wt, o, d, tnear, tfar, _form=one), ref)
    assert _same(wk.walk_closest(wt, o, d, tnear, tfar, mxu=True, _form=one),
                 wk.walk_closest(wt, o, d, tnear, tfar, mxu=True))
    assert torch.equal(wk.walk_anyhit(wt, o, d, tnear, tfar, _form=one),
                       wk.walk_anyhit(wt, o, d, tnear, tfar))
    for form in (wk.PRODUCTION_FORMS["walk_closest"], (4, True)):
        with pytest.raises(ValueError, match="_form takes only"):
            wk.walk_closest(wt, o, d, tnear, tfar, _form=form)
    with pytest.raises(ValueError, match="_form takes only"):
        wk.walk_anyhit(wt, o, d, tnear, tfar, mxu=True, _form=(8, True))
    assert torch.equal(wk.walk_anyhit(wt, o, d, tnear, tfar, wide=True,
                                      _form=one),
                       wk.walk_anyhit(wt, o, d, tnear, tfar, wide=True))
    with pytest.raises(ValueError, match="_form takes only"):
        wk.walk_anyhit(wt, o, d, tnear, tfar, wide=True, _form=(8, True))


class _Tables:
    """Walk tables of clusters given as rows [C, K, 3, 4] and boxes."""

    def __init__(self, rows, ids, lo, hi):
        self.n_clusters = self.n_real = rows.shape[0]
        self.rows = rows.reshape(-1, 3, 4).contiguous()
        self.ids = ids.reshape(-1).contiguous()
        self.lo, self.hi = lo.contiguous(), hi.contiguous()


def _planted_tables(seed):
    """The planted-tie clusters of _clusters in one box [-2, 2]^3 each,
    and TILES tiles of rays half aimed at the ties, flattened."""
    rows, ids, aims = _clusters(seed)
    box = torch.full((3, N_CLUSTERS), 2.0)
    rays = [x.reshape(-1, *x.shape[2:]).contiguous()
            for x in _tile_rays(seed + 1, aims)]
    return _Tables(rows, ids, -box, box), rays


def _split_walks(monkeypatch, p):
    """The plain walks with the split visit at p threads a ray."""
    monkeypatch.setattr(wk, "_visit_closest",
                        lambda rows, ids, csel, o, d, tnear, best, *_:
                        wk._visit_closest_split(rows, ids, csel, o, d, tnear,
                                                best, p))
    monkeypatch.setattr(wk, "_visit_anyhit",
                        lambda rows, csel, o, d, tnear, tfar, occ, *_:
                        wk._visit_anyhit_split(rows, csel, o, d, tnear, tfar,
                                               occ, p))


@pytest.mark.parametrize("p", [2, 4, 8])
def test_sub_split_model_equals_plain_walk(monkeypatch, p):
    """K6's split order of work (each group's walk with the split visit at
    p threads a ray) equals walk_sub_*_ref bit for bit at every sub, on
    the planted ties and on tiles whose groups stop far apart."""
    cases = [_planted_tables(7), wsub.planted_tiles(tiles=TILES)]
    want = {(c, sub): (wsub.walk_sub_closest_ref(wt, *rays, sub),
                       wsub.walk_sub_anyhit_ref(wt, *rays, sub))
            for c, (wt, rays) in enumerate(cases) for sub in wsub.SUBS}
    _split_walks(monkeypatch, p)
    for (c, sub), (closest, anyhit) in want.items():
        wt, rays = cases[c]
        got = wsub.walk_sub_closest_ref(wt, *rays, sub)
        assert _same(got[:4], closest[:4]) and got[4] == closest[4]
        occ, visits = wsub.walk_sub_anyhit_ref(wt, *rays, sub)
        assert torch.equal(occ, anyhit[0]) and visits == anyhit[1]


def test_planted_tiles_stop_far_apart():
    """The named barriers' case: in every tile the groups of the first 32
    rays stop after one pair of visits, those of the last 32 visit every
    cluster, at every sub."""
    wt, rays = wsub.planted_tiles(tiles=TILES)
    for sub in wsub.SUBS:
        (t, tri, _, _), visits = wk._walk_ref(wt, *rays, False,
                                              tile=RAYS // sub)
        per = visits.view(TILES, sub)
        assert bool((per[:, :sub // 2] == 2).all()), sub
        assert bool((per[:, sub // 2:] >= wsub.PLANTED_CLUSTERS).all()), sub
        near = (torch.arange(TILES * RAYS) % RAYS) < RAYS // 2
        assert bool((tri[near] >= 0).all() and (tri[~near] < 0).all())
        assert bool((tri[near] < K).all())


@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_tc_merge_keeps_the_lowest_column(w):
    """The split tensor-core visit's merge over w column slices gives the
    serial scan's winner, the lowest column on tied t, with ties planted
    inside and across the slices."""
    rows, ids, aims = _clusters(11)
    # the same triangle at columns in two slices of every w
    for a, b in ((5, 380), (50, 300), (90, 200)):
        rows[:, b] = rows[:, a]
    aims = np.concatenate([aims, [_centre(rows[0, a]) for a in (5, 50, 90)]])
    o, d, tnear, tfar = _tile_rays(12, aims, aimed=0.8)
    csel = torch.zeros(TILES, dtype=torch.int64)
    tfar = torch.full_like(tfar, float("inf"))
    best = (tfar.clone(), torch.full(tfar.shape, -1, dtype=torch.int32),
            torch.zeros_like(tfar), torch.zeros_like(tfar))
    want_t, want_i = wk._visit_closest(rows, ids, csel, o, d, tnear, best)[:2]
    t, _, _, valid = wk._test_clusters(rows[csel], o, d, tnear, tfar)
    tm = torch.where(valid, t, float("inf"))
    t2 = torch.topk(tm, 2, dim=-1, largest=False).values
    assert int((torch.isfinite(t2[..., 0]) & (t2[..., 0] == t2[..., 1]))
               .sum()) >= 8
    got_t, got_j = wk._merge_parts(t, valid, tfar, w)
    hit = got_j < K
    assert torch.equal(hit, want_i >= 0)
    assert torch.equal(ids[0][got_j[hit]], want_i[hit])
    assert torch.equal(got_t[hit].view(torch.int32),
                       want_t[hit].view(torch.int32))


def _centre(row):
    """A point inside the triangle of Baldwin-Weber row `row` [3, 4]: the
    solution of N.x = -N3, U.x = -U3 + 1/3, V.x = -V3 + 1/3."""
    a = row[:, :3].double().numpy()
    b = -row[:, 3].double().numpy() + np.array([0.0, 1 / 3, 1 / 3])
    return np.linalg.solve(a, b).astype(np.float32)


def test_mxu_resolves_to_the_split_form():
    """mxu=True takes the production split form in K3/K4, K5 and K6 (the
    tensor-core visit split over warps by columns); `_form=ONE_THREAD_FORM`
    still reaches the one-thread kernel; the lab's tensor-core visit stays
    one thread a ray."""
    one = wk.ONE_THREAD_FORM
    for name in ("walk_closest", "walk_anyhit", "walk_hier_closest",
                 "walk_hier_anyhit"):
        assert wk._resolve_form(name, None, True) == wk.PRODUCTION_FORMS[name]
        assert wk._resolve_form(name, None, False) == wk.PRODUCTION_FORMS[name]
        assert wk._resolve_form(name, one, True) == one
    assert wk.PRODUCTION_FORMS["walk_hier_closest"][0] > 1
    for name in ("walk_sub_closest", "walk_sub_anyhit"):
        for sub in wsub.SUBS:
            assert wsub._resolve_form(name, sub, None, True) == (
                wsub.MMA_FORMS[name][sub])
            assert wsub._resolve_form(name, sub, None, False) == (
                wsub.PRODUCTION_FORMS[name][sub])
            assert wsub._resolve_form(name, sub, one, True) == one
        with pytest.raises(ValueError, match="_form takes only"):
            wsub._resolve_form(name, 2, (8, False), False)
    assert wsub.MMA_FORMS["walk_sub_closest"][2][0] > 1
    # on the CPU every form runs the plain walk
    wt, rays = _planted_tables(3)
    for sub in wsub.SUBS:
        for mxu in (False, True):
            assert _same(wsub.walk_sub_closest(wt, *rays, sub, mxu,
                                               _form=one),
                         wsub.walk_sub_closest(wt, *rays, sub, mxu))
            assert torch.equal(wsub.walk_sub_anyhit(wt, *rays, sub, mxu,
                                                    _form=one),
                               wsub.walk_sub_anyhit(wt, *rays, sub, mxu))


def test_sub_launch_geometry():
    """K6's threads and dynamic shared memory per form: the heaps, the
    staged slots, the split tensor-core visit's scratch; a tensor-core form
    whose warp would span groups, or past the card's limit, raises; every
    production form fits the reference's largest resident table."""
    cp = wsub.MAX_VMEM_CLUSTERS
    for sub in wsub.SUBS:
        assert wsub.launch_geometry(sub, wk.ONE_THREAD_FORM, cp) == (
            64, 4 * sub * cp)
        for p in wsub.SPLIT_PS:
            assert wsub.launch_geometry(sub, (p, False), cp) == (
                64 * p, 4 * sub * cp)
            staged = 4 * sub * cp + sub * K * 48
            if wsub.static_smem(sub, (p, True)) + staged <= MAX_SMEM:
                assert wsub.launch_geometry(sub, (p, True), cp)[1] == staged
            if 64 // sub * p < 32:
                with pytest.raises(ValueError, match="no form"):
                    wsub.launch_geometry(sub, (p, False), cp, mxu=True)
            else:
                assert wsub.launch_geometry(sub, (p, False), cp, True)[1] == (
                    4 * sub * cp + 256 + 16 * 64 * p)
        with pytest.raises(ValueError, match="no form"):
            wsub.launch_geometry(sub, (3, False), cp)
        with pytest.raises(ValueError, match="shared memory"):
            wsub.launch_geometry(sub, (8, False), MAX_SMEM // 4 // sub)
        for table in (wsub.PRODUCTION_FORMS, wsub.MMA_FORMS):
            for name in table:
                form = table[name][sub]
                _, smem = wsub.launch_geometry(sub, form, cp,
                                               table is wsub.MMA_FORMS)
                assert wsub.static_smem(sub, form) + smem <= MAX_SMEM
    # the tile's rays, then two sets of a group's partials a group
    assert [wsub.static_smem(s, (p, False)) for s in (2, 8)
            for p in (1, 8)] == [2064, 2176, 2112, 2176]


def _forms(name):
    """csrc/walk_sub.cu's `constexpr SubForm name[3] = {{p, stage}, ...};`
    as {sub: (p, stage)}."""
    text = (Path(wk.__file__).parents[1] / "csrc" / "walk_sub.cu").read_text()
    m = re.search(rf"constexpr SubForm {name}\[3\] = \{{(.*?)\}};", text)
    assert m, name
    pairs = re.findall(r"\{(\d+), (true|false)\}", m.group(1))
    assert len(pairs) == 3, name
    return {sub: (int(p), st == "true") for sub, (p, st) in
            zip(wsub.SUBS, pairs)}


def test_sub_forms_match_the_sources():
    """PRODUCTION_FORMS and MMA_FORMS of ops/walk_sub.py name the forms
    csrc/walk_sub.cu builds."""
    for kind in ("closest", "anyhit"):
        name = f"walk_sub_{kind}"
        assert wsub.PRODUCTION_FORMS[name] == _forms(f"{kind.upper()}_FORMS")
        assert wsub.MMA_FORMS[name] == _forms(f"{kind.upper()}_MMA_FORMS")


@pytest.mark.cuda
def test_cuda_split_kernels_match_plain_versions():
    """On a card: K3/K4 and K5 in both built forms (one thread a ray and
    the production form), and the counted and floor walks in both, against
    their plain versions on
    sphere_grid(3000, 16, 16)'s tables (14 clusters), camera and spread
    rays sorted by the walk: bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from rustlight_tpu_torch.accel import walk as tw
    from rustlight_tpu_torch.models import sphere_grid
    sd = sphere_grid(3000, 16, 16).compile(device="cuda")
    wt = sd.geom.walk
    lo, hi = wt.world_lo.cpu().numpy(), wt.world_hi.cpu().numpy()
    rng = np.random.default_rng(0)
    n = 4096
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    o[: n // 2] = ((lo + hi) / 2
                   + np.array([0, 0, -2.0], np.float32) * (hi - lo))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] = rng.uniform(lo, hi, (n // 2, 3)) - o[: n // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tnear = np.full(n, 1e-4, np.float32)
    tfar = np.full(n, np.inf, np.float32)
    tfar[np.arange(n) % 7 == 3] = 0.0
    rays = [torch.as_tensor(x, device="cuda")
            for x in (o, d.astype(np.float32), tnear, tfar)]
    srt = tw._prepare(wt, *rays)[:4]
    closest = wk.walk_closest_ref(wt, *srt)[:4]
    occ = wk.walk_anyhit_ref(wt, *srt)[0]
    hier = wh.walk_hier_closest_ref(wt, *srt)[:4]
    hier_occ = wh.walk_hier_anyhit_ref(wt, *srt)[0]
    counted = wl.walk_closest_counted_ref(wt, *srt)
    floor = wl.walk_floor_ref(wt, *srt, 9)
    assert int((closest[1] >= 0).sum()) > n // 4
    # None: the production forms
    for form in (wk.ONE_THREAD_FORM, None):
        before = dict(wk.LAUNCHES), dict(wh.LAUNCHES)
        got = [wk.walk_closest(wt, *srt, _form=form),
               wk.walk_anyhit(wt, *srt, _form=form),
               wh.walk_hier_closest(wt, *srt, _form=form),
               wh.walk_hier_anyhit(wt, *srt, _form=form),
               wl.walk_closest_counted(wt, *srt, _form=form),
               wl.walk_floor(wt, *srt, 9, _form=form)]
        torch.cuda.synchronize()
        assert wk.LAUNCHES["walk_closest"] == before[0]["walk_closest"] + 1
        assert wh.LAUNCHES["walk_hier_anyhit"] == (
            before[1]["walk_hier_anyhit"] + 1)
        assert _same(got[0], closest), form
        assert torch.equal(got[1], occ), form
        assert _same(got[2], hier), form
        assert torch.equal(got[3], hier_occ), form
        assert _same(got[4], counted), form
        assert _same(got[5], floor), form


@pytest.mark.cuda
def test_cuda_sub_and_tc_split_kernels_match():
    """On a card: K6 in its production form and its one-thread form at
    every sub against its plain version, bit for bit, on
    sphere_grid(3000, 16, 16)'s tables and on the planted tiles whose groups stop far
    apart (the named barriers); the split tensor-core forms of K3/K4 and K6 against
    their one-thread tensor-core kernels, bit for bit, and each launch
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from rustlight_tpu_torch.accel import walk as tw
    from rustlight_tpu_torch.models import sphere_grid
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = sphere_grid(3000, 16, 16).compile(device="cuda")
    wt = sd.geom.walk
    lo, hi = wt.world_lo.cpu().numpy(), wt.world_hi.cpu().numpy()
    rng = np.random.default_rng(1)
    n = 4096
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tnear = np.full(n, 1e-4, np.float32)
    tfar = np.full(n, np.inf, np.float32)
    tfar[np.arange(n) % 7 == 3] = 0.0
    rays = [torch.as_tensor(x, device="cuda")
            for x in (o, d.astype(np.float32), tnear, tfar)]
    grid = (wt, tw._prepare(wt, *rays)[:4])
    stop = wsub.planted_tiles("cuda", tiles=TILES)
    one = wk.ONE_THREAD_FORM
    for wt_, srt in (grid, stop):
        for sub in wsub.SUBS:
            closest = wsub.walk_sub_closest_ref(wt_, *srt, sub)[:4]
            occ = wsub.walk_sub_anyhit_ref(wt_, *srt, sub)[0]
            for form in (one, None):
                before = dict(wsub.LAUNCHES)
                got = (wsub.walk_sub_closest(wt_, *srt, sub, _form=form),
                       wsub.walk_sub_anyhit(wt_, *srt, sub, _form=form))
                torch.cuda.synchronize()
                assert wsub.LAUNCHES["walk_sub_closest"] == (
                    before["walk_sub_closest"] + 1)
                assert _same(got[0], closest), (sub, form)
                assert torch.equal(got[1], occ), (sub, form)
            mma = [(wsub.walk_sub_closest(wt_, *srt, sub, True, _form=f),
                    wsub.walk_sub_anyhit(wt_, *srt, sub, True, _form=f))
                   for f in (one, None)]
            torch.cuda.synchronize()
            assert _same(mma[0][0], mma[1][0]), sub
            assert torch.equal(mma[0][1], mma[1][1]), sub
        if wt_ is wt:
            k3 = [(wk.walk_closest(wt_, *srt, mxu=True, _form=f),
                   wk.walk_anyhit(wt_, *srt, mxu=True, _form=f))
                  for f in (one, None)]
            torch.cuda.synchronize()
            assert _same(k3[0][0], k3[1][0])
            assert torch.equal(k3[0][1], k3[1][1])
            assert int((k3[1][0][1] >= 0).sum()) > n // 8

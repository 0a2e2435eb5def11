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

A test marked `cuda` holds both built forms (one thread a ray, and the
production form of `PRODUCTION_FORMS`) of K3/K4 and K5, and of the lab's
counted and floor walks, to their plain versions on a card (expected bit
for bit). It imports nothing of JAX, so on a card without JAX it runs
with `python -m pytest --noconftest -m cuda tests/test_torch_walk_split.py`.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rustlight_tpu_torch.ops import walk_hier as wh
from rustlight_tpu_torch.ops import walk_lab as wl
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
    """_form is private and takes only ONE_THREAD_FORM: the tensor-core
    visit keeps one thread a ray, the wide pop has one form, and on the CPU
    both forms run the plain walk."""
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
    with pytest.raises(ValueError, match="one form"):
        wk.walk_anyhit(wt, o, d, tnear, tfar, wide=True, _form=one)


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

"""The split forms of the sparse-visit walk K7 and of the wide pop K3w: their
plain models and launch geometry on the CPU; their kernels on a card.

K7's split kernel (csrc/walk_sparse.cu) runs a dense visit (more than
SPARSE_CAP = 16 flagged rays) as K3's split visit, P threads a ray, and a
sparse one as 16 slots of P x 64 / 16 lanes, slot k taking the k-th flagged
ray and lane q the columns q, q + lanes, ..., then the least (t, column)
over the slot's lanes (the any hit: their ballot).
`ops/walk_sparse.py:_visit_closest_sparse_split` models the closest hit's
visit; it must equal the serial visit of the plain walk bit for bit at
P = 4 and 8, on clusters with planted ties (test_torch_walk_split.py:
_clusters) and on visits with exactly 16 and 17 flagged rays, and the walk
with them must equal walk_sparse_*_ref. K3w's split pop takes the least
(bits << 32 | column) over NT threads (`_pop_min_wide_threads`): the
lowest column among equal entries, and column 0 on an empty heap, as the
plain pop. `launch_geometry` of both must take every table the wrappers
accept, in each heap, and raise past the card's 232,448 B a block;
PRODUCTION_FORMS must name the forms csrc/ builds.

Tests marked `cuda` hold the production and one-thread forms of K7 and K3w
(both heaps, the _dot4 and the tensor-core test) to each other and to the
plain versions on a card, bit for bit, K3w also with fewer blocks than
tiles. Nothing here imports JAX: on a card
`python -m pytest --noconftest -m cuda tests/test_torch_walk_split_sparse.py`.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rustlight_tpu_torch.ops import walk_sparse as ws
from rustlight_tpu_torch.ops import walk_trace as wk
from test_torch_walk_split import (N_CLUSTERS, RAYS, TILES, _clusters, _same,
                                   _tile_rays)

K = wk.K
MAX_SMEM = 232_448
# grid5p7M's clusters, padded
GRID5P7M_CP = 18_816


def _tied(rows, csel, o, d, tnear, tfar):
    """Rays [TILES, RAYS] whose two nearest valid hits in cluster csel [TILES]
    have equal t."""
    t, _, _, valid = wk._test_clusters(rows[csel], o, d, tnear, tfar)
    t2 = torch.topk(torch.where(valid, t, float("inf")), 2, dim=-1,
                    largest=False).values
    return torch.isfinite(t2[..., 0]) & (t2[..., 0] == t2[..., 1])


def _flag(rng, counts, first):
    """Tested masks [TILES, RAYS] as the walk hands them to a visit: tile g
    flags counts[g] rays, those of `first` [TILES, RAYS] before the others
    (in a random order), and a tile flagging more than SPARSE_CAP tests
    every ray (the dense branch)."""
    flags = torch.zeros((TILES, RAYS), dtype=torch.bool)
    for g, c in enumerate(counts):
        order = np.lexsort((rng.random(RAYS), ~first[g].numpy()))
        flags[g, torch.as_tensor(order[:c])] = True
    dense = flags.sum(dim=1) > ws.SPARSE_CAP
    return flags | dense[:, None]


@pytest.mark.parametrize("p", [4, 8])
def test_sparse_split_visit_equals_serial_visit(p):
    """Three visits a tile, the best of each the cap of the next, with 16,
    17, 1 and 0 flagged rays (the rays tied in the visited cluster flagged
    first): the split model equals the serial visits bit for bit. The rays
    aim at cluster 0's planted ties, which the first visit takes."""
    rows, ids, aims = _clusters(2)
    o, d, tnear, tfar = _tile_rays(12, aims[:6], aimed=1.0)
    tfar[:, ::3] = float("inf")
    rng = np.random.default_rng(22)
    steps = []
    for k in range(3):
        csel = torch.as_tensor(rng.integers(0, N_CLUSTERS, TILES) if k
                               else np.zeros(TILES, np.int64))
        tied = _tied(rows, csel, o, d, tnear, tfar)
        steps.append((csel, _flag(rng, (16, 17, 1, 0), tied), tied))
    best = (tfar.clone(), torch.full(tfar.shape, -1, dtype=torch.int32),
            torch.zeros_like(tfar), torch.zeros_like(tfar))
    occ = torch.zeros(tfar.shape, dtype=torch.bool)
    split = best
    for csel, tested, _ in steps:
        best = wk._visit_closest(rows, ids, csel, o, d, tnear, best, tested)
        occ = wk._visit_anyhit(rows, csel, o, d, tnear, tfar, occ, tested)
        split = ws._visit_closest_sparse_split(rows, ids, csel, o, d, tnear,
                                               split, tested, p)
        assert _same(split, best)
    # the sparse tile took hits, and ties lie among its tested rays
    assert int((best[1][0] >= 0).sum()) >= 6
    assert int((best[1][1] >= 0).sum()) > 16
    assert not bool((best[1][3] >= 0).any() or occ[3].any())
    _, tested, tied = steps[0]
    assert int((tied[0] & tested[0]).sum()) >= 4


def _sparse_split_walks(monkeypatch, p):
    """The plain closest-hit walk with K7's split visit at p threads a
    ray."""
    monkeypatch.setattr(
        wk, "_visit_closest",
        lambda rows, ids, csel, o, d, tnear, best, tested, *_:
        ws._visit_closest_sparse_split(rows, ids, csel, o, d, tnear, best,
                                       tested, p))


class _Tables:
    """Walk tables of clusters given as rows [C, K, 3, 4] in one box."""

    def __init__(self, rows, ids, box):
        self.n_clusters = self.n_real = rows.shape[0]
        self.rows = rows.reshape(-1, 3, 4).contiguous()
        self.ids = ids.reshape(-1).contiguous()
        self.lo = torch.full((3, rows.shape[0]), -box)
        self.hi = torch.full((3, rows.shape[0]), box)


def _cases():
    rows, ids, aims = _clusters(7)
    rays = [x.reshape(-1, *x.shape[2:]).contiguous()
            for x in _tile_rays(8, aims)]
    return [(_Tables(rows, ids, 2.0), rays), ws.planted_tiles(tiles=TILES)]


@pytest.mark.parametrize("p", [4, 8])
def test_sparse_split_order_of_work_equals_plain_walk(monkeypatch, p):
    """K7's split order of work (the closest-hit walk with the split visit
    at p threads a ray) equals walk_sparse_closest_ref bit for bit, counts
    included, on the planted ties and on the tiles that flag 16 and 17
    rays."""
    cases = _cases()
    want = [ws.walk_sparse_closest_ref(wt, *r) for wt, r in cases]
    _sparse_split_walks(monkeypatch, p)
    for (wt, rays), closest in zip(cases, want):
        got = ws.walk_sparse_closest_ref(wt, *rays)
        assert _same(got[:4], closest[:4]) and got[4:] == closest[4:]


def test_planted_tiles_flag_16_and_17():
    """Every planted tile flags exactly 16 rays for cluster 0 (a sparse
    visit) and 17 for cluster 1 (a dense one); the walk visits all three
    clusters of every tile, takes both branches, and the rays hit, ties
    among them."""
    wt, rays = ws.planted_tiles(tiles=TILES)
    tiles = [x.reshape(TILES, RAYS, *x.shape[1:]) for x in rays]
    _, flags = wk._tile_entries(wt.lo, wt.hi, wt.n_real, *tiles,
                                with_rays=True)
    counts = flags.sum(dim=1)
    assert bool((counts[:, 0] == 16).all() and (counts[:, 1] == 17).all())
    assert bool((counts[:, 2] > 17).all())
    t, tri, _, _, visits, few, tested, flagged = ws.walk_sparse_closest_ref(
        wt, *rays)
    assert visits >= 3 * TILES and 0 < few < visits
    live = rays[3] > 0
    assert int((tri >= 0).sum()) > 0.85 * int(live.sum())
    assert not bool((tri[~live] >= 0).any())
    rows = wt.rows.view(-1, 3, 4)
    o, d, tnear = rays[0], rays[1], rays[2]
    allrows = rows.view(1, -1, 3, 4)
    tt, _, _, valid = wk._test_clusters(allrows, o[None], d[None], tnear[None],
                                        torch.full_like(tnear[None],
                                                        float("inf")))
    t2 = torch.topk(torch.where(valid, tt, float("inf")), 2, dim=-1,
                    largest=False).values[0]
    tied = torch.isfinite(t2[:, 0]) & (t2[:, 0] == t2[:, 1])
    lane = torch.arange(rays[0].shape[0]) % RAYS
    assert int((tied & (lane < 16)).sum()) >= 2
    assert int(tied.sum()) >= 12


def _heaps(nt):
    """Heaps [G, C] of plain entry bits with equal least entries planted in
    different threads' columns (c and c + 1, c + nt - 1, c + nt), some
    rows all empty."""
    rng = np.random.default_rng(nt)
    cp = 3 * nt + 37
    bits = rng.integers(0x3F000000, 0x40000000, (6, cp)).astype(np.int32)
    bits[rng.random((6, cp)) < 0.3] = wk._INF_BITS
    for g, c in enumerate((5, 17, nt - 3)):
        for col in (c, c + 1, c + nt - 1, c + nt):
            bits[g, col] = 0x3E000000
    bits[3:5] = wk._INF_BITS
    bits[5, 2 * nt + 7] = 0
    bits[5, nt] = 0
    return torch.as_tensor(bits)


@pytest.mark.parametrize("nt", [64, 256, 512])
def test_wide_pop_model_lowest_column_and_empty(nt):
    """The split wide pop over nt threads pops what the plain wide pop pops,
    pop after pop until the heap is empty and past it: the lowest column
    among equal entries, column 0 on an empty heap."""
    ent = _heaps(nt)
    a, b = ent.clone(), ent.clone()
    first = None
    for k in range(ent.shape[1] + 3):
        bits_a, col_a, a = wk._pop_min(a, 0)
        bits_b, col_b, b = wk._pop_min_wide_threads(b, nt)
        assert torch.equal(bits_a, bits_b) and torch.equal(col_a, col_b), k
        assert torch.equal(a, b), k
        first = (bits_a, col_a) if first is None else first
    assert first[1][:3].tolist() == [5, 17, nt - 3]
    assert first[1][3:5].tolist() == [0, 0]
    assert int(first[1][5]) == nt and int(first[0][5]) == 0
    # past the last entry every pop gives +inf bits at column 0
    assert bool((bits_a == wk._INF_BITS).all() and (col_a == 0).all())


def test_launch_geometry_split_sparse_and_wide():
    """Threads and dynamic shared memory of the split K7 and K3w: K7 fits
    the reference's largest resident table (640 clusters) in both forms;
    K3w's heaps fit shared memory at grid5p7M's 18,816 clusters in every
    form and test, and device memory to the wide pop's 2^17; past the
    card's limit it raises."""
    cp = 640
    for name in ws.PRODUCTION_FORMS:
        for form in (wk.ONE_THREAD_FORM, ws.PRODUCTION_FORMS[name]):
            p, ring = form
            threads, smem = ws.launch_geometry(name, form, cp)
            slots = 0 if form == wk.ONE_THREAD_FORM else (2 if ring else 1)
            assert (threads, smem) == (64 * p, slots * K * 48 + 12 * cp)
            assert ws.static_smem(form) + smem <= MAX_SMEM
            with pytest.raises(ValueError, match="shared memory"):
                ws.launch_geometry(name, form, MAX_SMEM // 12)
        with pytest.raises(ValueError, match="not built"):
            ws.launch_geometry(name, (4, ws.PRODUCTION_FORMS[name][1]), cp)
    assert ws.launch_geometry("walk_sparse_closest", (4, False), cp,
                              lab=True)[0] == 256
    for name in wk._WIDE:
        for form in (wk.ONE_THREAD_FORM, wk.PRODUCTION_FORMS[name]):
            for mxu in (False, True):
                split = form != wk.ONE_THREAD_FORM
                blocks, glob, smem = wk._wide_heap(
                    name, form, mxu, GRID5P7M_CP, 65_536, "shared")
                assert blocks == 1024 and not glob
                assert wk.static_smem(name, form) + smem <= MAX_SMEM
                blocks, glob, smem2 = wk._wide_heap(
                    name, form, mxu, wk.MAX_WIDE_CLUSTERS, 65_536, "global")
                assert glob and smem2 == smem - 4 * GRID5P7M_CP
                assert smem2 == (0 if not split else (
                    (2 if form[1] else 1) * K * 48
                    + (wk.mma_scratch_bytes(form[0]) if mxu else 0)))
                with pytest.raises(ValueError, match="shared memory"):
                    wk._wide_heap(name, form, mxu, wk.MAX_WIDE_CLUSTERS,
                                  65_536, "shared")
                # the default, in either form: shared up to
                # _WIDE_SHARED_MAX entries
                most = wk._WIDE_SHARED_MAX
                for cp in (most, most + 1):
                    assert wk._wide_heap(name, form, mxu, cp, 65_536,
                                         None)[1] == (cp > most)


def _constant(src, name):
    """The value of `constexpr int|bool name = value;` in csrc/`src`."""
    text = (Path(wk.__file__).parents[1] / "csrc" / src).read_text()
    m = re.search(rf"constexpr (int|bool) {name} = (\w+);", text)
    assert m, (src, name)
    return int(m.group(2)) if m.group(1) == "int" else m.group(2) == "true"


def test_sparse_and_wide_forms_match_the_sources():
    """PRODUCTION_FORMS of ops/walk_sparse.py and the wide entries of
    ops/walk_trace.py name the forms csrc/ builds, and the wide pop's split
    form takes the tensor-core visit (_MMA_SPLIT)."""
    for kind in ("closest", "anyhit"):
        k = kind.upper()
        assert ws.PRODUCTION_FORMS[f"walk_sparse_{kind}"] == (
            _constant("walk_sparse.cu", f"SPARSE_{k}_P"),
            _constant("walk_sparse.cu", f"SPARSE_{k}_RING"))
        assert wk.PRODUCTION_FORMS[f"walk_{kind}_wide"] == (
            _constant("walk_trace.cu", f"WIDE_{k}_P"),
            _constant("walk_trace.cu", f"WIDE_{k}_RING"))
        assert f"walk_{kind}_wide" in wk._MMA_SPLIT
    assert ws.SPARSE_CAP == ws.SLOTS == _constant("walk_sparse.cu", "SLOTS")


def test_form_keyword_rules_sparse_and_wide():
    """_form takes only ONE_THREAD_FORM in K7 and K3w, with either test of
    K3w; on the CPU every form runs the plain walk."""
    one = wk.ONE_THREAD_FORM
    for wt, rays in _cases():
        for fn in (ws.walk_sparse_closest, ws.walk_sparse_anyhit):
            assert _same(fn(wt, *rays, _form=one), fn(wt, *rays))
            with pytest.raises(ValueError, match="_form takes only"):
                fn(wt, *rays, _form=(8, True))
        for mxu in (False, True):
            assert _same(wk.walk_closest(wt, *rays, wide=True, mxu=mxu,
                                         _form=one),
                         wk.walk_closest(wt, *rays, wide=True, mxu=mxu))
            with pytest.raises(ValueError, match="_form takes only"):
                wk.walk_anyhit(wt, *rays, wide=True, mxu=mxu, _form=(8, True))
    assert wk._resolve_form("walk_closest_wide", None, True) == (
        wk.PRODUCTION_FORMS["walk_closest_wide"])


def _grid_rays(seed):
    """sphere_grid(3000, 16, 16)'s tables on the card and 4,096 camera and
    spread rays sorted by the walk, with inert lanes."""
    from rustlight_tpu_torch.accel import walk as tw
    from rustlight_tpu_torch.models import sphere_grid
    sd = sphere_grid(3000, 16, 16).compile(device="cuda")
    wt = sd.geom.walk
    lo, hi = wt.world_lo.cpu().numpy(), wt.world_hi.cpu().numpy()
    rng = np.random.default_rng(seed)
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
    return wt, tw._prepare(wt, *rays)[:4]


@pytest.mark.cuda
def test_cuda_sparse_split_kernels_match():
    """On a card: K7 in its production form and its one-thread form against
    its plain version, bit for bit, on sphere_grid(3000, 16, 16)'s tables
    and on the planted tiles that flag 16 and 17 rays; each launch
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    for wt, srt in (_grid_rays(0), ws.planted_tiles("cuda", tiles=64)):
        closest = ws.walk_sparse_closest_ref(wt, *srt)
        occ = ws.walk_sparse_anyhit_ref(wt, *srt)[0]
        assert 0 < closest[5] < closest[4]
        for form in (wk.ONE_THREAD_FORM, None):
            before = dict(ws.LAUNCHES)
            got = (ws.walk_sparse_closest(wt, *srt, _form=form),
                   ws.walk_sparse_anyhit(wt, *srt, _form=form))
            torch.cuda.synchronize()
            assert ws.LAUNCHES["walk_sparse_closest"] == (
                before["walk_sparse_closest"] + 1)
            assert _same(got[0], closest[:4]), form
            assert torch.equal(got[1], occ), form


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1024, 5])
def test_cuda_wide_split_kernels_match(monkeypatch, blocks):
    """On a card: K3w in its production form and its one-thread form, with
    each heap, against its plain version bit for bit; the split
    tensor-core forms against the one-thread tensor-core kernels bit for
    bit; each launch counted. At most `blocks` blocks a launch: 1,024, the
    default, gives each of the 64 tiles its own block; 5 makes each block
    walk 12 or 13 tiles, its feed's copies and mbarrier phases carried from
    one tile to the next."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    monkeypatch.setattr(wk, "_WIDE_BLOCKS", blocks)
    torch.backends.cuda.matmul.allow_tf32 = False
    wt, srt = _grid_rays(1)
    closest = wk.walk_closest_ref(wt, *srt, wide=True)[:4]
    occ = wk.walk_anyhit_ref(wt, *srt, wide=True)[0]
    one = wk.ONE_THREAD_FORM
    for heap in ("shared", "global"):
        for form in (one, None):
            before = dict(wk.LAUNCHES)
            got = (wk.walk_closest(wt, *srt, wide=True, heap=heap, _form=form),
                   wk.walk_anyhit(wt, *srt, wide=True, heap=heap, _form=form))
            torch.cuda.synchronize()
            assert wk.LAUNCHES["walk_closest_wide"] == (
                before["walk_closest_wide"] + 1)
            assert _same(got[0], closest), (heap, form)
            assert torch.equal(got[1], occ), (heap, form)
        mma = [(wk.walk_closest(wt, *srt, wide=True, heap=heap, mxu=True,
                                _form=f),
                wk.walk_anyhit(wt, *srt, wide=True, heap=heap, mxu=True,
                               _form=f)) for f in (one, None)]
        torch.cuda.synchronize()
        assert _same(mma[0][0], mma[1][0]), heap
        assert torch.equal(mma[0][1], mma[1][1]), heap
        assert int((mma[1][0][1] >= 0).sum()) > 512

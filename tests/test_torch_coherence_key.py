"""The walk's incidence coherence key (ops/coherence_key.py, csrc/
coherence_key.cu) and the counters of which key a sorted walk call takes.

On the CPU (where the wrapper takes the plain version, which
tests/test_torch_walk.py:test_sort_keys_match_jax holds to the JAX
package's key): the kernel's launch count does not move, and under the
recorder (utils/tracing.py) a spread and a point-origin wavefront count one
`walk.key.incidence` and one `walk.key.morton`; with it off, neither.

Tests marked `cuda` hold the kernel to its plain version on a card: the
soup's tables, synthetic bounds of 393, 2,048 and 5,000 clusters (one
stage, a full stage, stages with an edge), lane counts that are not
multiples of 256, and a wavefront with 80% inert lanes, NaN and
axis-parallel directions; counts equal on every lane, the major key on at
least INC_KEY_FRAC, two launches identical, and a sorted walk over the
kernel's key equal to the unsorted walk. They import nothing of JAX, so on
a card without JAX they run with `python -m pytest --noconftest -m cuda
tests/test_torch_coherence_key.py`.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import profiler as ap

from rustlight_tpu_torch.accel import walk as tw
from rustlight_tpu_torch.ops import coherence_key as ck
from rustlight_tpu_torch.scene.geometry import TriMesh, build_geometry_tables
from rustlight_tpu_torch.utils import tracing

from walk_soup import _rays, _soup_mesh, _t

INC_KEY_FRAC = 0.999     # as tests/test_torch_walk.py
BIG = 1e30               # the tables' pad bounds (accel/walk.py:_BIG)


@pytest.fixture(scope="module")
def soup():
    verts, idx, centers = _soup_mesh()
    return build_geometry_tables([TriMesh(verts, idx)], [-1]).walk, centers


class _Profiled:
    """A CPU profiler session, stopped as portbench/trace.py stops its own
    (tests/test_torch_tracing.py)."""

    def __enter__(self):
        self._p = ap.profile(use_cpu=True, use_kineto=True)
        self._p._prepare_trace()
        self._p._start_trace()
        return self

    def __exit__(self, *exc):
        torch.autograd._disable_profiler()
        return False


def test_cpu_takes_the_plain_version(soup):
    walk, centers = soup
    wt = tw.walk_tables_to(walk, "cpu")
    rays = [_t(x) for x in _rays(centers, seed=2)]
    before = dict(ck.LAUNCHES)
    got = ck.incidence_key(wt, *rays)
    assert ck.LAUNCHES == before
    for a, b in zip(got, ck.incidence_key_ref(wt, *rays)):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        ck.incidence_key(wt, rays[0].double(), *rays[1:])
    with pytest.raises(ValueError):
        ck.incidence_key(wt, rays[0][:, :2], *rays[1:])


def test_key_counters(soup):
    walk, centers = soup
    wt = tw.walk_tables_to(walk, "cpu")
    spread = [_t(x) for x in _rays(centers, seed=3)]
    point = [x.clone() for x in spread]
    point[0][:] = point[0][0]
    # a session of its own, then the recorder off: nothing is counted
    tracing.counters()
    with _Profiled():
        tracing.count("test.session")
    for rays in (spread, point):
        tw._prepare(wt, *rays)
    c = tracing.counters()
    assert c == {"test.session": 1}
    with _Profiled():
        for rays in (spread, point):
            tw._prepare(wt, *rays)
        tw._prepare(wt, *spread, sort_rays=False)     # unsorted: no key
    c = tracing.counters()
    assert c["walk.key.incidence"] == 1 and c["walk.key.morton"] == 1


# ------------------------------------------------------------------ the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _synthetic_tables(c, seed, device):
    """c real clusters of random boxes in [-4, 4]^3 (sides 0.01 to 1.5),
    padded to a multiple of 128 with the tables' far pads."""
    rng = np.random.default_rng(seed)
    cp = -(-c // 128) * 128
    lo = np.full((3, cp), BIG, np.float32)
    hi = np.full((3, cp), BIG, np.float32)
    lo[:, :c] = rng.uniform(-4.0, 3.5, (3, c))
    hi[:, :c] = lo[:, :c] + rng.uniform(0.01, 1.5, (3, c))
    return SimpleNamespace(n_real=c, lo=_t(lo, device), hi=_t(hi, device))


def _wavefront(n, seed, device, inert=0.0):
    """n rays from inside the boxes' range in random directions, a third of
    them with an axis-parallel direction (one or two components +-0), a
    bounded tfar on a fifth; `inert` of the lanes with tfar <= 0 and
    NaN directions on some of those and some live ones."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    k = np.arange(n)
    d[k % 3 == 0, 0] = 0.0
    d[k % 6 == 0, 1] = -0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tnear = np.full(n, 1e-4, np.float32)
    tfar = np.full(n, np.inf, np.float32)
    tfar[k % 5 == 2] = rng.uniform(0.5, 6.0, (k % 5 == 2).sum())
    if inert:
        dead = rng.random(n) < inert
        tfar[dead] = np.where(rng.random(dead.sum()) < 0.5, 0.0, -1.0)
    d[k % 97 == 4] = np.nan
    return [_t(x, device) for x in (o, d, tnear, tfar)]


def _assert_key_equal(wt, rays):
    maj, cnt = ck.incidence_key(wt, *rays)
    rmaj, rcnt = ck.incidence_key_ref(wt, *rays)
    assert torch.equal(cnt, rcnt), (cnt != rcnt).sum()
    same = (maj == rmaj).float().mean().item()
    assert same >= INC_KEY_FRAC, same
    maj2, cnt2 = ck.incidence_key(wt, *rays)
    assert torch.equal(maj, maj2) and torch.equal(cnt, cnt2)
    return cnt


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(soup, monkeypatch):
    """The kernel against its plain version (run on the card too) on the
    soup's tables and on synthetic bounds across shared-memory stages."""
    dev = _cuda()
    walk, centers = soup
    wt = tw.walk_tables_to(walk, dev)
    rays = [_t(x, dev) for x in _rays(centers, seed=5)]
    before = ck.LAUNCHES["incidence_key"]
    ref = ck.incidence_key_ref
    # a CUDA tensor never takes the plain version
    monkeypatch.setattr(ck, "incidence_key_ref", None)
    got = ck.incidence_key(wt, *rays)
    monkeypatch.setattr(ck, "incidence_key_ref", ref)
    assert ck.LAUNCHES["incidence_key"] == before + 1
    assert got[0].device.type == "cuda"
    cnt = _assert_key_equal(wt, rays)
    assert cnt.max() > 1
    for c, n, inert in ((393, 70_001, 0.0), (2048, 4_099, 0.0),
                        (5000, 9_999, 0.0), (393, 65_537, 0.8),
                        (5000, 1_000, 0.8)):
        wt_c = _synthetic_tables(c, seed=c, device=dev)
        rays = _wavefront(n, seed=n, device=dev, inert=inert)
        cnt = _assert_key_equal(wt_c, rays)
        live = rays[3] > 0
        assert not cnt[~live].any() and cnt[live].float().mean() > 1
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_sorted_walk_equals_unsorted_walk(soup):
    """Sorted by the kernel's key, walked and put back in lane order: the
    same answers as the unsorted walk."""
    dev = _cuda()
    walk, centers = soup
    wt = tw.walk_tables_to(walk, dev)
    args = [_t(x, dev) for x in _rays(centers, seed=4)]
    before = ck.LAUNCHES["incidence_key"]
    a = tw._walk_impl(wt, *args, False, sort_rays=True)
    b = tw._walk_impl(wt, *args, False, sort_rays=False)
    assert ck.LAUNCHES["incidence_key"] == before + 1
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(tw._walk_impl(wt, *args, True),
                       tw._walk_impl(wt, *args, True, sort_rays=False))

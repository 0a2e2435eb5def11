"""Per-ray traversal by ray-cluster pairs; port of the host and XLA side of
rustlight_tpu/accel/pair_walk.py.

The tile walk (accel/walk.py) tests a whole tile against every cluster any
of its rays enters. Here each ray is paired with its own nearest clusters:

  1. shortlist: per ray, the km nearest clusters it enters by slab entry
     (torch.topk over [block, Cp] entry matrices), and the (km+1)-th entry
     as a cutoff;
  2. pair kernels (ops/pair_trace.py, K8): each (ray, cluster) pair's
     closest hit, or any hit, inside its one cluster;
  3. reduce: per ray the least t over its km pairs, then the lowest
     triangle id among equal t;
  4. fallback: a hit at t <= cutoff is the closest (a cluster holding a
     nearer one would have entered the shortlist). Rays that overflow (a
     finite cutoff) and miss or hit beyond it go through the tile walk
     once more, every other lane inert (tfar = 0), unsorted.

Rays are sorted by the morton key first, so that neighbouring pairs share
clusters. Taken for tables whose option is `pair` (accel/dense.py); it
takes tables of at most MAX_VMEM_CLUSTERS clusters, as the reference takes
resident tables only.
"""
from __future__ import annotations

import torch

from ..ops.pair_trace import PAIR_TILE, pair_anyhit, pair_closest
from ..ops.native import count_rays
from ..ops.walk_sub import check_resident
from ..ops.walk_trace import _ray_entries, _slab_inv
from .dense import RayHit
from .walk import _default_range, _sort_key, _unsort, _walk_impl

KM = 8                   # shortlist length
_BIGI = 1 << 30          # the cluster id of an unfilled shortlist slot
_INT_MAX = (1 << 31) - 1
_BLOCK = 4096            # rays per [block, Cp] entry matrix


def _entries_block(wt, o, d, tnear, tfar, km: int):
    """Shortlist of one block of rays against every cluster: (cids [b, km]
    int32, _BIGI where fewer than km clusters are entered; cutoff [b], the
    (km+1)-th nearest entry, inf if there is none)."""
    ent = _ray_entries(wt.lo, wt.hi, o[None], _slab_inv(d)[None],
                       tnear[None], tfar[None])[0]                  # [b, Cp]
    real = torch.arange(ent.shape[1], device=o.device) < int(wt.n_real)
    ent = torch.where(real & torch.isfinite(ent), ent, float("inf"))
    neg, idx = torch.topk(-ent, km + 1, dim=1)
    ents = -neg
    cids = torch.where(torch.isfinite(ents[:, :km]), idx[:, :km].int(), _BIGI)
    return cids, ents[:, km]


def _shortlist(wt, o, d, tnear, tfar, km: int, block: int = _BLOCK):
    """The shortlist of a whole wavefront, in blocks of rays so that the
    [block, Cp] entry matrix stays bounded."""
    parts = [_entries_block(wt, o[s:s + block], d[s:s + block],
                            tnear[s:s + block], tfar[s:s + block], km)
             for s in range(0, o.shape[0], block)]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def _make_pairs(wt, o, d, tnear, tfar, km: int):
    """The pairs of sorted rays: ((o, d, tnear, tfar, cid) of [n * km]
    pairs padded to whole tiles with inert pairs, cutoff [n])."""
    dev = o.device
    cids, cutoff = _shortlist(wt, o, d, tnear, tfar, km)
    pad = (-o.shape[0] * km) % PAIR_TILE
    po, pd = o.repeat_interleave(km, dim=0), d.repeat_interleave(km, dim=0)
    ptn, ptf = tnear.repeat_interleave(km), tfar.repeat_interleave(km)
    pcid = cids.reshape(-1)
    if pad:
        po = torch.cat([po, torch.zeros((pad, 3), device=dev)])
        pd = torch.cat([pd, torch.ones((pad, 3), device=dev)])
        ptn = torch.cat([ptn, torch.full((pad,), float("inf"), device=dev)])
        ptf = torch.cat([ptf, torch.zeros(pad, device=dev)])
        pcid = torch.cat([pcid, torch.full((pad,), _BIGI, dtype=torch.int32,
                                           device=dev)])
    return (po.contiguous(), pd.contiguous(), ptn, ptf,
            pcid.contiguous()), cutoff


def _pairs_impl(wt, o, d, tnear, tfar, any_hit: bool, km: int = None):
    """Closest hit (RayHit) or occlusion ([n] bool) of a wavefront by pairs
    over device walk tables; km defaults to the tables' option."""
    check_resident(wt, "the pair walk")
    if km is None:
        km = wt.options.km
    if not 0 < km < int(wt.n_clusters):
        raise ValueError(f"km must lie in [1, {int(wt.n_clusters) - 1}], "
                         f"got {km}")
    n = o.shape[0]
    # sanitize as the tile walk does
    tfar = torch.where(tfar > 0.0, tfar, 0.0)
    tnear = torch.where(tnear >= 0.0, tnear, float("inf"))
    kmaj, kmin = _sort_key(wt, torch.where(torch.isfinite(o), o, 0.0),
                           torch.where(torch.isfinite(d), d, 0.0))
    order = torch.sort((kmaj.long() << 32) | kmin.long(), stable=True).indices
    o, d = o[order].contiguous(), d[order].contiguous()
    tnear, tfar = tnear[order].contiguous(), tfar[order].contiguous()
    count_rays(tfar)
    pairs, cutoff = _make_pairs(wt, o, d, tnear, tfar, km)
    m = n * km
    overflow = torch.isfinite(cutoff)
    # the fallback's tile walk runs with the tables' other options
    retrace = wt._replace(options=wt.options._replace(pair=False))

    mxu = bool(wt.options.mxu_tritest)
    if any_hit:
        occ = pair_anyhit(wt, *pairs, mxu=mxu)[:m].reshape(n, km).any(dim=1)
        # an overflowing ray not yet occluded may be blocked by a cluster
        # off its shortlist
        fb = ~occ & overflow
        occ_fb = _walk_impl(retrace, o, d, tnear, torch.where(fb, tfar, 0.0),
                            True, sort_rays=False)
        return _unsort(occ | (fb & occ_fb), order, n)

    t, tri, u, v = (x[:m].reshape(n, km)
                    for x in pair_closest(wt, *pairs, mxu=mxu))
    tm = torch.where(tri >= 0, t, float("inf"))
    bt = tm.amin(dim=1)
    first = tm == bt[:, None]
    btri = torch.where(first, tri, _INT_MAX).amin(dim=1)
    sel = first & (tri == btri[:, None])
    bu = torch.where(sel, u, 0.0).sum(dim=1)
    bv = torch.where(sel, v, 0.0).sum(dim=1)
    hit = torch.isfinite(bt)
    fb = overflow & (bt >= cutoff)
    rh = _walk_impl(retrace, o, d, tnear, torch.where(fb, tfar, 0.0), False,
                    sort_rays=False)
    bt = torch.where(fb, rh.t, bt)
    btri = torch.where(fb, rh.tri, torch.where(hit, btri, -1))
    bu, bv = torch.where(fb, rh.u, bu), torch.where(fb, rh.v, bv)
    bt, btri, bu, bv = (_unsort(x, order, n) for x in (bt, btri, bu, bv))
    return RayHit(t=bt, tri=btri, u=bu, v=bv, hit=btri >= 0)


def intersect_pairs(wt, o, d, tnear=None, tfar=None, km: int = None) -> RayHit:
    """Closest hit of rays (o, d) [n, 3] over device walk tables, by
    pairs."""
    return _pairs_impl(wt, o, d, *_default_range(o, tnear, tfar), False, km)


def occluded_pairs(wt, o, d, tnear=None, tfar=None, km: int = None):
    """Any hit of rays (o, d) over device walk tables, by pairs; True =
    blocked."""
    return _pairs_impl(wt, o, d, *_default_range(o, tnear, tfar), True, km)

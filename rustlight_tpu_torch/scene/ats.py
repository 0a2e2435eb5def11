"""Adaptive-tree-splitting (ATS) light BVH; port of
rustlight_tpu/scene/ats.py.

A PBRT-v4-style light hierarchy over the emissive triangles: each
triangle's proxy bounds (box, axis cone theta_o / theta_e, flux phi), cone
unions, and the SAOH bucket build (12 buckets, the solid-angle measure
momega), recursive on the host in numpy, with the JAX package's table
layout. On the device, importance-driven descents sample a triangle
(`ats_sample` from a shading point, `ats_sample_ray` from a camera-ray
segment), a parent walk gives its pdf (`ats_pdf`), and the variance-driven
splitting traversal (`ats_sample_split`) returns a set of lights a ray in
K fixed slots. Enabled by `-x ats`.

The reference's descents are `while_loop`s until every lane sits at a
leaf; read on the host, that test would cost a sync per level. Here they
run the tree's depth (`AtsTables.depth`, known when the tables are built
or uploaded) as a fixed count: a lane that has reached its leaf stays
there, so the result is the reference's. The splitting traversal's
iteration count depends on the data: it tests `any(running)` every
CHECK_EVERY iterations, and an iteration after a lane stops changes none
of its slots.
"""
from __future__ import annotations

import sys
from typing import Any, NamedTuple

import numpy as np
import torch

from ..utils.vec import cross, dot, length, normalize

_PI = np.pi
EPSILON_ATS = 1e-4
# iterations of the splitting traversal between two host-side checks
CHECK_EVERY = 8


# ----------------------------------------------------------------- host build

def _cone_union(wa, ca, wb, cb):
    """Direction-cone union of unit axes with cosines (emitter.rs:857-898)."""
    ta, tb = np.arccos(np.clip(ca, -1, 1)), np.arccos(np.clip(cb, -1, 1))
    td = np.arccos(np.clip(np.dot(wa, wb), -1, 1))
    if min(td + tb, _PI) <= ta:
        return wa, ca
    if min(td + ta, _PI) <= tb:
        return wb, cb
    to = (ta + td + tb) / 2.0
    if to >= _PI:
        return np.array([0.0, 0.0, 1.0]), -1.0
    wr = np.cross(wa, wb)
    if np.dot(wr, wr) == 0.0:
        return np.array([0.0, 0.0, 1.0]), -1.0
    wr = wr / np.linalg.norm(wr)
    tr = to - ta
    c, s = np.cos(tr), np.sin(tr)
    # Rodrigues rotation of wa around wr by tr
    w = wa * c + np.cross(wr, wa) * s + wr * np.dot(wr, wa) * (1 - c)
    return w, np.cos(to)


class _LB:
    """Light bounds of a node: box, cone, flux, squared flux, light count."""
    __slots__ = ("lo", "hi", "w", "phi", "phi_sqr", "cos_o", "cos_e", "nl")

    def __init__(self, lo, hi, w, phi, cos_o, cos_e, phi_sqr=None, nl=1):
        self.lo, self.hi, self.w = lo, hi, w
        self.phi = phi
        self.phi_sqr = phi * phi if phi_sqr is None else phi_sqr
        self.cos_o, self.cos_e = cos_o, cos_e
        self.nl = nl

    @staticmethod
    def union(a, b):
        if a.phi == 0.0:
            return b
        if b.phi == 0.0:
            return a
        w, cos_o = _cone_union(a.w, a.cos_o, b.w, b.cos_o)
        cos_e = min(a.cos_e, b.cos_e)
        return _LB(np.minimum(a.lo, b.lo), np.maximum(a.hi, b.hi), w,
                   a.phi + b.phi, cos_o, cos_e,
                   phi_sqr=a.phi_sqr + b.phi_sqr, nl=a.nl + b.nl)

    def area(self):
        d = np.maximum(self.hi - self.lo, 0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def momega(self):
        to = np.arccos(np.clip(self.cos_o, -1, 1))
        te = np.arccos(np.clip(self.cos_e, -1, 1))
        tw = min(to + te, _PI)
        return (2 * _PI * (1 - np.cos(to))
                + _PI / 2 * (2 * tw * np.sin(to) - np.cos(to - 2 * tw)
                             - 2 * to * np.sin(to) + np.cos(to)))


class AtsTables(NamedTuple):
    """Flattened light tree: numpy on the host (`build_ats`), tensors on a
    device (`ats_to`). Children come before their parent; the root is a
    node index. `depth` is the deepest leaf's number of ancestors."""
    n_nodes: int
    root: int
    depth: int
    left: Any          # [m] int32 (-1 at a leaf)
    right: Any         # [m] int32
    parent: Any        # [m] int32 (-1 at the root)
    leaf_tri: Any      # [m] global triangle id (-1 at an internal node)
    lo: Any            # [m, 3] f32
    hi: Any            # [m, 3]
    w: Any             # [m, 3] cone axis
    cos_o: Any         # [m]
    cos_e: Any         # [m]
    phi: Any           # [m] flux
    tri_leaf: Any      # [t_pad] int32 leaf of each emissive triangle (-1 else)
    tri_area_inv: Any  # [t_pad] f32 1 / area
    phi_sqr: Any       # [m] sum of squared proxy fluxes (split variance)
    nl: Any            # [m] f32 number of lights under the node

# the columns of the JAX package's AtsTables, in its order
COLUMNS = ("left", "right", "parent", "leaf_tri", "lo", "hi", "w", "cos_o",
           "cos_e", "phi", "tri_leaf", "tri_area_inv", "phi_sqr", "nl")


def tree_depth(parent) -> int:
    """The deepest node's number of ancestors; parents come after their
    children in the table, so one pass from the root end fills it."""
    parent = np.asarray(parent)
    d = np.zeros(len(parent), np.int64)
    for i in range(len(parent) - 1, -1, -1):
        if parent[i] >= 0:
            d[i] = d[parent[i]] + 1
    return int(d.max()) if len(d) else 0


def build_ats(geom, emitters) -> AtsTables:
    """Build from the flattened geometry and emitter tables (numpy)."""
    eid = np.asarray(geom.emitter_id[: geom.n_tris])
    tris = np.nonzero(eid >= 0)[0]
    if len(tris) == 0:
        raise ValueError("ATS needs surface emitters")
    v0 = np.asarray(geom.v0[: geom.n_tris])
    e1 = np.asarray(geom.e1[: geom.n_tris])
    e2 = np.asarray(geom.e2[: geom.n_tris])
    ng = np.asarray(geom.n_g[: geom.n_tris])
    area = np.asarray(geom.area[: geom.n_tris])
    le = np.asarray(emitters.tri_emission[: geom.n_tris])

    # per-triangle proxies (emitter.rs convert_light_proxy:731-780):
    # phi = channel_max(Le) * area, theta_o = 0, theta_e = pi/2
    proxies = []
    for t in tris:
        ps = np.stack([v0[t], v0[t] + e1[t], v0[t] + e2[t]])
        proxies.append((int(t), _LB(ps.min(0), ps.max(0), ng[t],
                                    float(le[t].max() * area[t]), 1.0, 0.0)))

    nodes = []

    def build(items):
        if len(items) == 1:
            t, b = items[0]
            nodes.append(dict(left=-1, right=-1, parent=-1, tri=t, b=b))
            return len(nodes) - 1
        cent = np.stack([(it[1].lo + it[1].hi) * 0.5 for it in items])
        clo, chi = cent.min(0), cent.max(0)
        glo = np.min([it[1].lo for it in items], 0)
        ghi = np.max([it[1].hi for it in items], 0)
        gsize = np.maximum(ghi - glo, 1e-20)

        nb = 12
        best = (np.inf, -1, -1)
        for dim in range(3):
            if chi[dim] == clo[dim]:
                continue
            off = (cent[:, dim] - clo[dim]) / (chi[dim] - clo[dim])
            bidx = np.minimum((nb * off).astype(int), nb - 1)
            bucket = [None] * nb
            for i, it in enumerate(items):
                b = bucket[bidx[i]]
                bucket[bidx[i]] = it[1] if b is None else _LB.union(b, it[1])
            for i in range(nb - 1):
                l = r = None
                for j in range(i + 1):
                    if bucket[j] is not None:
                        l = bucket[j] if l is None else _LB.union(l, bucket[j])
                for j in range(i + 1, nb):
                    if bucket[j] is not None:
                        r = bucket[j] if r is None else _LB.union(r, bucket[j])
                if l is None or r is None:
                    continue
                kr = gsize.max() / gsize[dim]
                cost = kr * (l.phi * l.momega() * l.area()
                             + r.phi * r.momega() * r.area())
                if 0.0 < cost < best[0]:
                    best = (cost, dim, i)

        if best[1] < 0:
            mid = len(items) // 2
            items.sort(key=lambda it: (it[1].lo + it[1].hi)[0])
            l_items, r_items = items[:mid], items[mid:]
        else:
            dim, cut = best[1], best[2]
            off = (cent[:, dim] - clo[dim]) / (chi[dim] - clo[dim])
            bidx = np.minimum((nb * off).astype(int), nb - 1)
            l_items = [it for i, it in enumerate(items) if bidx[i] <= cut]
            r_items = [it for i, it in enumerate(items) if bidx[i] > cut]
            if not l_items or not r_items:
                mid = len(items) // 2
                l_items, r_items = items[:mid], items[mid:]

        li = build(l_items)
        ri = build(r_items)
        nodes.append(dict(
            left=li, right=ri, parent=-1, tri=-1,
            b=_LB.union(nodes[li]["b"], nodes[ri]["b"])))
        idx = len(nodes) - 1
        nodes[li]["parent"] = idx
        nodes[ri]["parent"] = idx
        return idx

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        root = build(list(proxies))
    finally:
        sys.setrecursionlimit(old)

    t_pad = geom.n_pad
    tri_leaf = np.full(t_pad, -1, np.int32)
    for i, nd in enumerate(nodes):
        if nd["tri"] >= 0:
            tri_leaf[nd["tri"]] = i
    tri_area_inv = np.zeros(t_pad, np.float32)
    tri_area_inv[tris] = 1.0 / np.maximum(area[tris], 1e-20)

    def col(f, dtype=np.float32):
        return np.asarray([f(nd) for nd in nodes], dtype)

    parent = col(lambda nd: nd["parent"], np.int32)
    return AtsTables(
        n_nodes=len(nodes), root=root, depth=tree_depth(parent),
        left=col(lambda nd: nd["left"], np.int32),
        right=col(lambda nd: nd["right"], np.int32),
        parent=parent,
        leaf_tri=col(lambda nd: nd["tri"], np.int32),
        lo=col(lambda nd: nd["b"].lo), hi=col(lambda nd: nd["b"].hi),
        w=col(lambda nd: nd["b"].w),
        cos_o=col(lambda nd: nd["b"].cos_o),
        cos_e=col(lambda nd: nd["b"].cos_e),
        phi=col(lambda nd: nd["b"].phi),
        tri_leaf=tri_leaf, tri_area_inv=tri_area_inv,
        phi_sqr=col(lambda nd: nd["b"].phi_sqr),
        nl=col(lambda nd: nd["b"].nl),
    )


def ats_to(ats, device) -> AtsTables:
    """Upload host tables (this module's or the JAX package's, read by
    attribute) to `device`; the depth is recomputed from `parent`."""
    cols = {f: torch.as_tensor(np.ascontiguousarray(getattr(ats, f)),
                               device=device) for f in COLUMNS}
    return AtsTables(n_nodes=int(ats.n_nodes), root=int(ats.root),
                     depth=tree_depth(ats.parent), **cols)


# --------------------------------------------------------------- device ops

def _take(table, idx):
    """table[idx], the index clipped to the table as the reference's takes."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]


def _cos_sub(sa, ca, sb, cb):
    return torch.where(ca > cb, 1.0, ca * cb + sa * sb)


def _sin_sub(sa, ca, sb, cb):
    return torch.where(ca > cb, 1.0, sa * cb - ca * sb)


def _sin_of(c):
    return torch.sqrt(torch.clamp(1.0 - c ** 2, min=0.0))


def _subtended_cos(lo, hi, p):
    """cos of the cone subtending the node's bounding sphere from p (-1 when
    p is inside)."""
    center = 0.5 * (lo + hi)
    radius = 0.5 * length(hi - lo)
    dist2 = dot(p - center, p - center)
    inside = dist2 < radius ** 2
    sin_u2 = torch.clamp(radius ** 2 / torch.clamp(dist2, min=1e-20), 0.0, 1.0)
    return torch.where(inside, -1.0,
                       torch.sqrt(torch.clamp(1.0 - sin_u2, min=0.0)))


def _node_importance(ats: AtsTables, node, p, n=None):
    """importance_point for node ids [n] (emitter.rs:1034-1107)."""
    lo, hi = _take(ats.lo, node), _take(ats.hi, node)
    w = _take(ats.w, node)
    phi = _take(ats.phi, node)
    cos_o = _take(ats.cos_o, node)
    cos_e = _take(ats.cos_e, node)

    pc = 0.5 * (lo + hi)
    dvec = p - pc
    d2 = torch.clamp(dot(dvec, dvec), min=EPSILON_ATS)
    wi = dvec / torch.sqrt(d2)[:, None]
    cos_t = dot(w, wi)
    sin_t = _sin_of(cos_t)

    cos_u = _subtended_cos(lo, hi, p)
    sin_u = _sin_of(cos_u)
    sin_o = _sin_of(cos_o)
    cos_x = _cos_sub(sin_t, cos_t, sin_o, cos_o)
    sin_x = _sin_sub(sin_t, cos_t, sin_o, cos_o)
    cos_p = _cos_sub(sin_x, cos_x, sin_u, cos_u)
    ok = cos_p > cos_e

    imp = phi * cos_p / d2
    if n is not None:
        cos_i = torch.abs(dot(wi, n))
        imp = imp * _cos_sub(_sin_of(cos_i), cos_i, sin_u, cos_u)
    return torch.where(ok, torch.clamp(imp, min=0.0), 0.0)


def _ats_descend(ats: AtsTables, imp_fn, u):
    """Stochastic importance descent from the root (emitter.rs:1361-1399),
    `ats.depth` levels. Returns (tri, pdf_sel)."""
    lanes = u.shape[0]
    node = torch.full((lanes,), ats.root, dtype=torch.int32, device=u.device)
    pdf = torch.ones(lanes, dtype=torch.float32, device=u.device)
    r = u
    for _ in range(ats.depth):
        is_leaf = _take(ats.leaf_tri, node) >= 0
        l = _take(ats.left, node)
        rgt = _take(ats.right, node)
        il = imp_fn(torch.clamp(l, min=0))
        ir = imp_fn(torch.clamp(rgt, min=0))
        tot = il + ir
        p_l = torch.where(tot > 0.0, il / torch.clamp(tot, min=1e-30), 0.5)
        go_left = r < p_l
        r_new = torch.where(go_left, r / torch.clamp(p_l, min=1e-20),
                            (r - p_l) / torch.clamp(1.0 - p_l, min=1e-20))
        r_new = torch.clamp(r_new, 0.0, 1.0 - 1e-7)
        node_new = torch.where(go_left, l, rgt)
        pdf_new = pdf * torch.where(go_left, p_l, 1.0 - p_l)
        node = torch.where(is_leaf, node, node_new)
        pdf = torch.where(is_leaf, pdf, pdf_new)
        r = torch.where(is_leaf, r, r_new)
    return _take(ats.leaf_tri, node), pdf


def ats_sample(ats: AtsTables, p, n, u):
    """Descent by point importance from shading points p [n, 3] with
    normals n (emitter.rs:1361-1399). Returns (tri, pdf_sel)."""
    return _ats_descend(ats, lambda nd: _node_importance(ats, nd, p, n), u)


def ats_pdf(ats: AtsTables, tri, p, n):
    """Parent-walk pdf of having sampled `tri` from p (emitter.rs:
    1319-1359), `ats.depth` levels; 0 where tri is not an emissive
    triangle."""
    leaf = _take(ats.tri_leaf, torch.clamp(tri, min=0))
    valid = (tri >= 0) & (leaf >= 0)
    node = leaf
    pdf = torch.ones(p.shape[0], dtype=torch.float32, device=p.device)
    for _ in range(ats.depth):
        par = _take(ats.parent, torch.clamp(node, min=0))
        active = par >= 0
        l = _take(ats.left, torch.clamp(par, min=0))
        rgt = _take(ats.right, torch.clamp(par, min=0))
        il = _node_importance(ats, torch.clamp(l, min=0), p, n)
        ir = _node_importance(ats, torch.clamp(rgt, min=0), p, n)
        tot = il + ir
        p_l = torch.where(tot > 0.0, il / torch.clamp(tot, min=1e-30), 0.5)
        step = torch.where(l == node, p_l, 1.0 - p_l)
        node = torch.where(active, par, node)
        pdf = torch.where(active, pdf * step, pdf)
    return torch.where(valid, pdf, 0.0)


# ----------------------------------------------- ray-segment importance

def _node_importance_ray(ats: AtsTables, node, o, d, tmax):
    """importance_ray for node ids (emitter.rs:975-1032): a node's
    importance for the whole segment [o, o + d tmax], by the reference's
    equiangular-plane construction; tmax is finite (scene hits cap it)."""
    lo, hi = _take(ats.lo, node), _take(ats.hi, node)
    w = _take(ats.w, node)
    phi = _take(ats.phi, node)
    cos_o = _take(ats.cos_o, node)
    cos_e = _take(ats.cos_e, node)

    pc = 0.5 * (lo + hi)
    # the closest point on the segment to the cluster center
    t = torch.clamp(dot(d, pc - o), min=0.0)
    t = torch.minimum(t, tmax)
    closest = o + d * t[:, None]
    d2 = torch.clamp(dot(pc - closest, pc - closest), min=EPSILON_ATS)
    d_min = torch.sqrt(d2)

    v0 = normalize(o - pc)
    v1 = normalize(o + d * tmax[:, None] - pc)
    up = cross(v0, v1)
    up_l = length(up)[:, None]
    degenerate = up_l[:, 0] < 1e-12   # v0 ~ v1: a zero-extent segment plane
    up = up / torch.clamp(up_l, min=1e-20)
    o0 = v0
    o1 = cross(up, v0)

    dot_o0 = dot(o0, w)
    dot_o1 = dot(o1, w)
    l1 = torch.sqrt(torch.clamp(dot_o0 ** 2 + dot_o1 ** 2, min=1e-20))
    cos_phi0 = dot_o0 / l1
    sin_phi0 = _sin_of(cos_phi0)
    outside = (dot_o1 < 0.0) | (dot(v0, v1) < cos_phi0) | degenerate
    cos_tmin = torch.where(
        outside, torch.maximum(dot(v0, w), dot(v1, w)),
        dot(o0 * cos_phi0[:, None] + o1 * sin_phi0[:, None], w))
    theta_min = torch.arccos(torch.clamp(cos_tmin, -1.0, 1.0))

    theta_o = torch.arccos(torch.clamp(cos_o, -1.0, 1.0))
    theta_e = torch.arccos(torch.clamp(cos_e, -1.0, 1.0))
    theta_u = torch.arccos(torch.clamp(_subtended_cos(lo, hi, closest),
                                       -1.0, 1.0))
    theta_p = torch.clamp(theta_min - theta_o - theta_u, min=0.0)
    imp = torch.clamp(phi * torch.cos(theta_p) / d_min, min=0.0)
    return torch.where(theta_p >= theta_e, 0.0, imp)


def ats_sample_ray(ats: AtsTables, o, d, tmax, u):
    """Descent by ray-segment importance (random_sample_emitter_position_ray,
    emitter.rs:1731-1756). Returns (tri, pdf_sel)."""
    return _ats_descend(
        ats, lambda nd: _node_importance_ray(ats, nd, o, d, tmax), u)


def _variance_g_ray(ats: AtsTables, node, o, d, tmax):
    """Expectation and variance of 1/d over the segment for a node's
    bounding sphere (emitter.rs:1679-1715): eg = (ln b - ln a) / (b - a),
    vg = 1 / (a b), a / b the least / largest sphere-surface distances (the
    far point clamped at 10 units along the ray, as the reference)."""
    lo, hi = _take(ats.lo, node), _take(ats.hi, node)
    c = 0.5 * (lo + hi)
    r = 0.5 * length(hi - lo)

    b1 = dot(o - c, o - c)
    p_far = o + d * torch.clamp(tmax, max=10.0)[:, None]
    b2 = dot(p_far - c, p_far - c)
    b = torch.maximum(b1, b2)
    b = torch.where(b < r ** 2, EPSILON_ATS,
                    torch.clamp(torch.sqrt(b) - r, min=EPSILON_ATS))

    t = torch.minimum(torch.clamp(dot(d, c - o), min=0.0), tmax)
    a_p = o + d * t[:, None] - c
    a2 = dot(a_p, a_p)
    a = torch.where(a2 < r ** 2, EPSILON_ATS,
                    torch.clamp(torch.sqrt(a2) - r, min=EPSILON_ATS))

    diff = b - a
    far = torch.abs(diff) > 1e-12
    eg = torch.where(far, (torch.log(b) - torch.log(a))
                     / torch.where(far, diff, 1.0),
                     1.0 / torch.clamp(a, min=EPSILON_ATS))
    vg = 1.0 / torch.clamp(a * b, min=1e-20)
    return eg, vg


def ats_sample_split(ats: AtsTables, o, d, tmax, u, u_stack,
                     splitting_factor: float, max_lights: int = 8):
    """Variance-driven splitting traversal (sample_split,
    emitter.rs:1401-1487): a node whose energy-and-geometry variance measure
    falls below `splitting_factor` goes down both children, any other picks
    one child by ray importance. Returns (tri [n, K], pdf_sel [n, K], valid
    [n, K], overflow [n]) in K = max_lights slots.

    The reference's recursion is a bounded explicit stack ([n, D] node, pdf
    and r, D = K + 32); a pushed branch takes its random from `u_stack`
    [n, D]. Past K selected lights a lane drops the rest and sets its
    overflow flag."""
    n = u.shape[0]
    dev = u.device
    D = max_lights + 32
    K = max_lights
    imp = lambda nd: _node_importance_ray(ats, nd, o, d, tmax)

    out_tri = torch.full((n, K), -1, dtype=torch.int32, device=dev)
    out_pdf = torch.zeros((n, K), dtype=torch.float32, device=dev)
    st_node = torch.zeros((n, D), dtype=torch.int32, device=dev)
    st_pdf = torch.zeros((n, D), dtype=torch.float32, device=dev)
    st_r = torch.zeros((n, D), dtype=torch.float32, device=dev)
    node = torch.full((n,), ats.root, dtype=torch.int32, device=dev)
    pdf = torch.ones(n, dtype=torch.float32, device=dev)
    r = u
    sp = torch.zeros(n, dtype=torch.int32, device=dev)     # stack size
    cnt = torch.zeros(n, dtype=torch.int32, device=dev)    # lights selected
    running = torch.ones(n, dtype=torch.bool, device=dev)
    overflow = torch.zeros(n, dtype=torch.bool, device=dev)
    d_iota = torch.arange(D, dtype=torch.int32, device=dev)[None, :]
    k_iota = torch.arange(K, dtype=torch.int32, device=dev)[None, :]

    def step():
        nonlocal node, pdf, r, sp, cnt, running, overflow
        nonlocal out_tri, out_pdf, st_node, st_pdf, st_r
        leaf_tri = _take(ats.leaf_tri, node)
        is_leaf = leaf_tri >= 0

        # a leaf emits a slot where its importance is positive
        emit = running & is_leaf & (imp(node) > 0.0)
        can = emit & (cnt < K)
        slot = (k_iota == cnt[:, None]) & can[:, None]
        out_tri = torch.where(slot, leaf_tri[:, None], out_tri)
        out_pdf = torch.where(slot, pdf[:, None], out_pdf)
        overflow = overflow | (emit & (cnt >= K))
        cnt = cnt + can.to(torch.int32)

        # an internal node splits or chooses one child
        l = _take(ats.left, node)
        rgt = _take(ats.right, node)
        phi = _take(ats.phi, node)
        phi_sqr = _take(ats.phi_sqr, node)
        nl = torch.clamp(_take(ats.nl, node), min=1.0)
        ve = phi_sqr / nl - (phi / nl) ** 2
        eg, vg = _variance_g_ray(ats, node, o, d, tmax)
        sm = ve * vg + ve * eg ** 2 + phi ** 2 * vg
        split_measure = (1.0 / (1.0 + nl * nl * sm)) ** 0.25
        do_split = split_measure < splitting_factor

        il = imp(torch.clamp(l, min=0))
        ir = imp(torch.clamp(rgt, min=0))
        tot = il + ir
        dead_int = running & (~is_leaf) & (~do_split) & (tot <= 0.0)
        p_l = torch.where(tot > 0.0, il / torch.clamp(tot, min=1e-30), 0.5)
        go_left = r < p_l
        ch_node = torch.where(go_left, l, rgt)
        ch_pdf = pdf * torch.where(go_left, p_l, 1.0 - p_l)
        ch_r = torch.clamp(torch.where(
            go_left, r / torch.clamp(p_l, min=1e-20),
            (r - p_l) / torch.clamp(1.0 - p_l, min=1e-20)), 0.0, 1.0 - 1e-7)

        # split: push the left child with a fresh random, go right
        pushing = running & (~is_leaf) & do_split & (sp < D)
        sslot = (d_iota == sp[:, None]) & pushing[:, None]
        st_node = torch.where(sslot, l[:, None], st_node)
        st_pdf = torch.where(sslot, pdf[:, None], st_pdf)
        push_r = torch.sum(torch.where(sslot, u_stack, 0.0), -1)
        st_r = torch.where(sslot, push_r[:, None], st_r)
        sp = sp + pushing.to(torch.int32)

        node_n = torch.where(is_leaf, node,
                             torch.where(do_split, rgt, ch_node))
        pdf_n = torch.where(is_leaf | do_split, pdf, ch_pdf)
        r_n = torch.where(is_leaf | do_split, r, ch_r)

        # pop the stack after a leaf or a dead branch
        want_pop = (running & is_leaf) | dead_int
        has_stack = sp > 0
        pop = want_pop & has_stack
        psel = (d_iota == (sp - 1)[:, None]) & pop[:, None]
        node = torch.where(pop, torch.sum(torch.where(psel, st_node, 0), -1),
                           node_n).to(torch.int32)
        pdf = torch.where(pop, torch.sum(torch.where(psel, st_pdf, 0.0), -1),
                          pdf_n)
        r = torch.where(pop, torch.sum(torch.where(psel, st_r, 0.0), -1), r_n)
        sp = sp - pop.to(torch.int32)
        running = running & ~(want_pop & (~has_stack))

    # a lane processes each node at most once: the tree's size bounds it
    it, cap = 0, ats.n_nodes + CHECK_EVERY
    while it < cap and bool(torch.any(running)):
        for _ in range(CHECK_EVERY):
            step()
        it += CHECK_EVERY
    return out_tri, out_pdf, out_tri >= 0, overflow

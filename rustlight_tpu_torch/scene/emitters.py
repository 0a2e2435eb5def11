"""Emitters as flat atom tables with a single flux CDF; port of the triangle
atoms of rustlight_tpu/scene/emitters.py.

Each emissive triangle is one atom; a mesh's selection weight (the channel
max of its flux) is spread over its triangles by area, so the area pdf of a
sampled point is sel_pdf(mesh)/mesh_area, as in the reference. Point,
directional, point-normal and environment atoms, and uv-dependent emission,
are not ported yet: building or uploading them raises NotImplementedError.
`sample_position` and `sample_emission_direction` start the light tracer's
paths on the triangle atoms.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple

import math

import numpy as np
import torch

from ..utils.distribution import (Distribution1D, build_distribution_1d_np,
                                  distribution_to, pdf_discrete_1d,
                                  sample_discrete_1d)
from ..utils.frame import make_frame, to_world
from ..utils.vec import dot, length
from ..utils.warps import cosine_sample_hemisphere, uniform_sample_triangle

ATOM_TRI = 0   # the reference's other atom kinds (1-4) are not ported


class EmitterTables(NamedTuple):
    n_atoms: int
    has_env: bool
    atom_cdf: Distribution1D  # over atoms
    atom_kind: Any            # [a] int32
    atom_ref: Any             # [a] int32 global triangle id
    tri_emission: Any         # [t, 3] radiance Le
    tri_pdf_area: Any         # [t] area-domain direct pdf; 0 if not emissive
    tri_atom: Any             # [t] int32 atom id (-1 if none)
    bsphere_center: Any       # [3]
    bsphere_radius: Any       # scalar (pre-scaled x1.1)


class LightSample(NamedTuple):
    """NEE record (reference LightSampling)."""
    p: Any         # [n, 3] point on the light
    n: Any         # [n, 3] light normal
    d: Any         # [n, 3] unit direction shading point -> light
    dist: Any      # [n]
    pdf: Any       # [n] solid-angle pdf
    weight: Any    # [n, 3] Le * G / pdf
    is_delta: Any  # [n] bool
    valid: Any     # [n]
    tri: Any       # [n] sampled triangle (-1 otherwise)


class PositionSample(NamedTuple):
    """Emission origin of a light path (reference SampledPosition + flux)."""
    p: Any         # [n, 3]
    n: Any         # [n, 3]
    pdf_area: Any  # [n]
    weight: Any    # [n, 3] flux estimate (Phi / pdf, selection included)
    kind: Any      # [n] atom kind
    atom: Any      # [n] atom id
    valid: Any     # [n]


def build_emitter_tables(meshes, mesh_emitter_id: List[int], t_pad: int,
                         bsphere_center=(0, 0, 0),
                         bsphere_radius=1.0) -> EmitterTables:
    """Flatten the emissive triangles into atoms (numpy)."""
    kinds, refs, weights = [], [], []
    tri_emission = np.zeros((t_pad, 3), np.float32)
    tri_pdf_area = np.zeros((t_pad,), np.float32)
    tri_atom = np.full((t_pad,), -1, np.int32)

    tri_base = 0
    for mi, m in enumerate(meshes):
        nt = m.n_triangles
        if mesh_emitter_id[mi] >= 0 and m.is_light:
            areas = m.triangle_areas()
            total = areas.sum()
            flux_scalar = float(np.max(m.flux()))
            w = flux_scalar * areas / max(total, 1e-30)
            for k in range(nt):
                kinds.append(ATOM_TRI)
                refs.append(tri_base + k)
                weights.append(w[k])
            tri_emission[tri_base:tri_base + nt] = m.emission
        tri_base += nt

    n_atoms = len(kinds)
    if n_atoms == 0:
        # no emitters: single dummy atom with zero weight
        kinds, refs, weights = [ATOM_TRI], [0], [0.0]
        n_atoms = 1

    atom_cdf = build_distribution_1d_np(np.asarray(weights, np.float32))
    probs = atom_cdf.cdf[1:] - atom_cdf.cdf[:-1]
    for ai, (k, r) in enumerate(zip(kinds, refs)):
        if k == ATOM_TRI and probs[ai] > 0.0:
            tri_atom[r] = ai
    tri_base = 0
    for mi, m in enumerate(meshes):
        nt = m.n_triangles
        if mesh_emitter_id[mi] >= 0 and m.is_light:
            areas = m.triangle_areas()
            for k in range(nt):
                ai = tri_atom[tri_base + k]
                if ai >= 0 and areas[k] > 0:
                    tri_pdf_area[tri_base + k] = probs[ai] / areas[k]
        tri_base += nt

    return EmitterTables(
        n_atoms=n_atoms, has_env=False, atom_cdf=atom_cdf,
        atom_kind=np.asarray(kinds, np.int32),
        atom_ref=np.asarray(refs, np.int32),
        tri_emission=tri_emission, tri_pdf_area=tri_pdf_area,
        tri_atom=tri_atom,
        bsphere_center=np.asarray(bsphere_center, np.float32),
        bsphere_radius=np.float32(bsphere_radius * 1.1),
    )


def emitters_to(em, device) -> EmitterTables:
    """Upload numpy emitter tables (this module's or the JAX package's, read
    by attribute) to `device`; raises for atoms not ported yet."""
    kinds = np.asarray(em.atom_kind)
    if em.has_env or np.any(kinds != ATOM_TRI):
        raise NotImplementedError(
            "only triangle emitters are ported so far (no point, "
            "directional, point-normal or environment lights)")
    if getattr(em, "has_em_uv", False):
        raise NotImplementedError("uv-dependent emission is not ported yet")

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype), device=device)
    return EmitterTables(
        n_atoms=int(em.n_atoms), has_env=False,
        atom_cdf=distribution_to(em.atom_cdf, device),
        atom_kind=t(em.atom_kind, np.int32), atom_ref=t(em.atom_ref, np.int32),
        tri_emission=t(em.tri_emission, np.float32),
        tri_pdf_area=t(em.tri_pdf_area, np.float32),
        tri_atom=t(em.tri_atom, np.int32),
        bsphere_center=t(em.bsphere_center, np.float32),
        bsphere_radius=t(em.bsphere_radius, np.float32),
    )


def sample_light(em: EmitterTables, geom, p_ref, u_sel, u_pos) -> LightSample:
    """NEE sample toward one emitter atom per lane.

    p_ref [n, 3] shading points; u_sel [n]; u_pos [n, 2]. weight = Le * G /
    pdf with the selection pdf folded in, ready to multiply by f."""
    atom = sample_discrete_1d(em.atom_cdf, u_sel)
    sel_pdf = pdf_discrete_1d(em.atom_cdf, atom)
    kind = em.atom_kind[atom]
    tri = em.atom_ref[atom]
    b = uniform_sample_triangle(u_pos)
    p_tri = geom.v0[tri] + b[..., 0:1] * geom.e1[tri] + b[..., 1:2] * geom.e2[tri]
    n_tri = geom.n_g[tri]
    le = em.tri_emission[tri]

    delta_v = p_tri - p_ref
    dist = length(delta_v)
    d = delta_v / torch.clamp(dist, min=1e-20)[:, None]
    cos_l = torch.clamp(dot(n_tri, -d), min=0.0)
    g = torch.where(dist > 0.0, cos_l / torch.clamp(dist ** 2, min=1e-20), 0.0)
    pdf_area = sel_pdf / torch.clamp(geom.area[tri], min=1e-20)
    pdf = torch.where(g > 0.0, pdf_area * dist ** 2
                      / torch.clamp(cos_l, min=1e-20), 0.0)
    weight = torch.where((g > 0.0)[:, None],
                         le * (g / torch.clamp(pdf_area, min=1e-30))[:, None],
                         0.0)
    valid = (g > 0.0) & (sel_pdf > 0.0)
    return LightSample(p=p_tri, n=n_tri, d=d, dist=dist, pdf=pdf,
                       weight=torch.where(valid[:, None], weight, 0.0),
                       is_delta=torch.zeros_like(valid), valid=valid,
                       tri=torch.where(kind == ATOM_TRI, tri, -1))


def direct_pdf_tri(em: EmitterTables, tri_id, p_ref, p_hit, n_hit, d):
    """Solid-angle NEE pdf of hitting emissive triangle tri_id from p_ref
    (Mesh::direct_pdf x selection)."""
    pdf_area = em.tri_pdf_area[torch.clamp(tri_id, min=0)]
    cos_l = torch.clamp(dot(n_hit, -d), min=0.0)
    delta = p_hit - p_ref
    dist2 = dot(delta, delta)
    pdf = torch.where(cos_l > 0.0,
                      pdf_area * dist2 / torch.clamp(cos_l, min=1e-20), 0.0)
    return torch.where(tri_id >= 0, pdf, 0.0)


def emitted_radiance(em: EmitterTables, geom, tri_id, d):
    """Le seen along -d when hitting triangle tri_id (front side only)."""
    t = torch.clamp(tri_id, min=0)
    front = dot(geom.n_g[t], -d) > 0.0
    return torch.where((front & (tri_id >= 0))[:, None], em.tri_emission[t], 0.0)


def sample_position(em: EmitterTables, geom, u_sel, u_pos) -> PositionSample:
    """Emission origin for light paths: an atom by flux, a uniform point on
    its triangle; weight Phi = Le * pi / pdf_area with the selection pdf
    folded in."""
    atom = sample_discrete_1d(em.atom_cdf, u_sel)
    sel_pdf = pdf_discrete_1d(em.atom_cdf, atom)
    kind = em.atom_kind[atom]
    tri = em.atom_ref[atom]
    b = uniform_sample_triangle(u_pos)
    p = geom.v0[tri] + b[..., 0:1] * geom.e1[tri] + b[..., 1:2] * geom.e2[tri]
    pdf_area = sel_pdf / torch.clamp(geom.area[tri], min=1e-20)
    weight = em.tri_emission[tri] * (
        math.pi / torch.clamp(pdf_area, min=1e-30))[:, None]
    valid = sel_pdf > 0.0
    return PositionSample(p=p, n=geom.n_g[tri], pdf_area=pdf_area,
                          weight=torch.where(valid[:, None], weight, 0.0),
                          kind=kind, atom=atom, valid=valid)


def sample_emission_direction(em: EmitterTables, ps: PositionSample, u):
    """Cosine-weighted direction about the origin's normal (perfect
    importance sampling of a diffuse emitter, weight 1).
    Returns (d_world [n, 3], pdf [n], weight [n, 3])."""
    d_loc = cosine_sample_hemisphere(u)
    d = to_world(make_frame(ps.n), d_loc)
    pdf = torch.clamp(d_loc[..., 2], min=0.0) / math.pi
    weight = torch.where((d_loc[..., 2] >= 0.0)[:, None], 1.0, 0.0) \
        * torch.ones_like(ps.p)
    return d, pdf, weight

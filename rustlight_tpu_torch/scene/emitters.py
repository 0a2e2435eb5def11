"""Emitters as flat atom tables with a single flux CDF; port of
rustlight_tpu/scene/emitters.py.

Every sampleable atom (each emissive triangle, each point light, each
directional light, each point-normal light and the environment) is one row
of a flat table with one CDF. A mesh's selection weight (the channel max of
its flux) is spread over its triangles by area, so the area pdf of a sampled
point is sel_pdf(mesh)/mesh_area, as in the reference. Triangle hits map
back to atoms through a per-triangle table.

Point, directional and point-normal atoms are delta emitters: NEE only,
never MIS'd against BSDF hits. The environment (a constant color or a
textured latitude-longitude map, sampled by luminance * sin theta) is the
last atom; `env_radiance` and `env_direction_pdf` give the escaped-ray term
and its MIS pdf. A triangle's emission may depend on its uv (the
reference's HSV and texture emission kinds); `emitted_radiance`,
`sample_light` and `sample_position` evaluate it at the hit or sampled
point. `sample_position` and `sample_emission_direction` start the light
tracer's paths on any atom. With the ATS light tree (scene/ats.py),
`sample_light_ats` picks an emissive triangle by a descent of the tree and
`direct_pdf_tri_ats` gives the matching pdf; they see triangles only, as
the reference's.

Each atom kind's branch runs only where the tables hold such an atom
(`EmitterTables.kinds`); a branch selects its lanes by kind, so skipping
an absent kind changes no lane.
"""
from __future__ import annotations

from typing import Any, FrozenSet, List, NamedTuple, Optional

import math

import numpy as np
import torch

from ..utils.distribution import (Distribution1D, Distribution2D,
                                  build_distribution_1d_np,
                                  build_distribution_2d_np, distribution_2d_to,
                                  distribution_to, pdf_discrete_1d,
                                  sample_continuous_2d, sample_discrete_1d)
from ..utils.frame import make_frame, to_world
from ..utils.vec import dot, length
from ..utils.warps import (concentric_sample_disk, cosine_sample_hemisphere,
                           sample_uniform_sphere, to_spherical_coordinates,
                           uniform_sample_triangle)
from .ats import ats_pdf, ats_sample

ATOM_TRI = 0
ATOM_POINT = 1
ATOM_DIR = 2
ATOM_ENV = 3
ATOM_PN = 4     # point + normal, cosine falloff (reference emitter.rs:252-298)

_PI = math.pi
_LUM = np.array([0.212671, 0.715160, 0.072169], np.float32)


class EmitterTables(NamedTuple):
    n_atoms: int
    has_env: bool
    env_textured: bool
    has_em_uv: bool          # some triangle's emission depends on its uv
    kinds: FrozenSet[int]    # the atom kinds present
    atom_cdf: Distribution1D  # over atoms
    atom_kind: Any           # [a] int32
    atom_ref: Any            # [a] int32 triangle id / light index
    tri_emission: Any        # [t, 3] Le (the mean Le for uv-dependent kinds)
    tri_pdf_area: Any        # [t] area-domain direct pdf; 0 if not emissive
    tri_atom: Any            # [t] int32 atom id (-1 if none)
    tri_em_kind: Any         # [t] int32: 0 color, 1 HSV, 2 texture
    tri_em_scale: Any        # [t] f32
    tri_em_tex: Any          # [t] int32 atlas slot
    tex_atlas: Any           # [k, th, tw, 3] or None (no uv-dependent kind)
    point_pos: Any           # [p, 3]
    point_intensity: Any     # [p, 3]
    dir_direction: Any       # [d, 3] unit, from the light into the world
    dir_intensity: Any       # [d, 3]
    pn_pos: Any              # [q, 3]
    pn_normal: Any           # [q, 3] unit
    pn_intensity: Any        # [q, 3]
    env_color: Any           # [3] constant color
    env_img: Any             # [h, w, 3] (ones if constant)
    env_cdf: Distribution2D  # over luminance * sin theta
    env_lum_int: Any         # scalar: the marginal's func_int
    bsphere_center: Any      # [3]
    bsphere_radius: Any      # scalar (pre-scaled x1.1)


class LightSample(NamedTuple):
    """NEE record (reference LightSampling)."""
    p: Any         # [n, 3] point on the light
    n: Any         # [n, 3] light normal (0 for point lights)
    d: Any         # [n, 3] unit direction shading point -> light
    dist: Any      # [n]
    pdf: Any       # [n] solid-angle pdf (the discrete pick for delta atoms)
    weight: Any    # [n, 3] Le * G / pdf
    is_delta: Any  # [n] bool: point, directional, point-normal
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


def _env_table(env_image):
    """(image, Distribution2D) of a textured environment: luminance *
    sin theta at each row's center."""
    img = np.asarray(env_image, np.float32)
    h = img.shape[0]
    sin_w = np.sin((np.arange(h) + 0.5) * np.pi / h)[:, None]
    return img, build_distribution_2d_np((img * _LUM).sum(-1) * sin_w)


def build_emitter_tables(meshes, mesh_emitter_id: List[int], t_pad: int,
                         points: Optional[List] = None,
                         directionals: Optional[List] = None,
                         point_normals: Optional[List] = None,
                         env_constant=None, env_image=None,
                         bsphere_center=(0, 0, 0), bsphere_radius=1.0,
                         textures=None) -> EmitterTables:
    """Flatten the emitters into atoms (numpy). points: [(pos, intensity)],
    directionals: [(direction, intensity)], point_normals: [(pos, normal,
    intensity)]; env_image [h, w, 3] takes priority over env_constant."""
    points = points or []
    directionals = directionals or []
    point_normals = point_normals or []
    has_env = env_constant is not None or env_image is not None
    env_textured = env_image is not None

    kinds, refs, weights = [], [], []
    tri_emission = np.zeros((t_pad, 3), np.float32)
    tri_pdf_area = np.zeros((t_pad,), np.float32)
    tri_atom = np.full((t_pad,), -1, np.int32)
    tri_em_kind = np.zeros((t_pad,), np.int32)
    tri_em_scale = np.ones((t_pad,), np.float32)
    tri_em_tex = np.full((t_pad,), -1, np.int32)
    has_em_uv = False

    tri_base = 0
    for mi, m in enumerate(meshes):
        nt = m.n_triangles
        if mesh_emitter_id[mi] >= 0 and m.is_light:
            areas = m.triangle_areas()
            total = areas.sum()
            flux_scalar = float(np.max(m.flux(textures)))
            w = flux_scalar * areas / max(total, 1e-30)
            for k in range(nt):
                kinds.append(ATOM_TRI)
                refs.append(tri_base + k)
                weights.append(w[k])
            tri_emission[tri_base:tri_base + nt] = m.mean_emission(textures)
            ek = int(getattr(m, "emission_kind", 0))
            if ek != 0:
                has_em_uv = True
                tri_em_kind[tri_base:tri_base + nt] = ek
                tri_em_scale[tri_base:tri_base + nt] = m.emission_scale
                tri_em_tex[tri_base:tri_base + nt] = m.emission_tex
        tri_base += nt

    for pi, (_, inten) in enumerate(points):
        kinds.append(ATOM_POINT)
        refs.append(pi)
        weights.append(float(np.max(np.asarray(inten) * 4.0 * np.pi)))
    for di, (_, inten) in enumerate(directionals):
        kinds.append(ATOM_DIR)
        refs.append(di)
        area = np.pi * (bsphere_radius * 1.1) ** 2
        weights.append(float(np.max(np.asarray(inten) * area)))
    for qi, (_, _, inten) in enumerate(point_normals):
        kinds.append(ATOM_PN)
        refs.append(qi)
        # the reference's flux() = 2 * intensity (emitter.rs:283-289)
        weights.append(float(np.max(np.asarray(inten) * 2.0)))

    if has_env:
        if env_textured:
            # the flux from the image as given (float64 after the sin
            # weights), the CDF from its float32 copy, as the reference
            h = env_image.shape[0]
            sin_w = np.sin((np.arange(h) + 0.5) * np.pi / h)[:, None]
            lum_img = (env_image * _LUM).sum(-1) * sin_w
            flux_scalar = (np.pi * (bsphere_radius * 1.1) ** 2
                           * float(lum_img.mean()))
            env_img, env_cdf = _env_table(env_image)
        else:
            flux_scalar = (float(np.max(np.asarray(env_constant))) * np.pi
                           * (bsphere_radius * 1.1) ** 2)
        kinds.append(ATOM_ENV)
        refs.append(0)
        weights.append(flux_scalar)
    if not env_textured:
        env_img = np.ones((1, 1, 3), np.float32)
        env_cdf = build_distribution_2d_np(np.ones((1, 1)))

    if not kinds:
        # no emitters: one dummy atom of zero weight
        kinds, refs, weights = [ATOM_TRI], [0], [0.0]

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

    def arr(x, shape):
        a = np.asarray(x, np.float32)
        return a if a.size else np.zeros(shape, np.float32)

    def unit(v):
        return v / np.linalg.norm(np.asarray(v, np.float32))

    return EmitterTables(
        n_atoms=len(kinds), has_env=has_env, env_textured=env_textured,
        has_em_uv=has_em_uv, kinds=frozenset(kinds), atom_cdf=atom_cdf,
        atom_kind=np.asarray(kinds, np.int32),
        atom_ref=np.asarray(refs, np.int32),
        tri_emission=tri_emission, tri_pdf_area=tri_pdf_area,
        tri_atom=tri_atom, tri_em_kind=tri_em_kind,
        tri_em_scale=tri_em_scale, tri_em_tex=tri_em_tex,
        tex_atlas=(np.asarray(textures, np.float32)
                   if (has_em_uv and textures is not None) else None),
        point_pos=arr([p for p, _ in points], (1, 3)),
        point_intensity=arr([i for _, i in points], (1, 3)),
        dir_direction=arr([unit(d) for d, _ in directionals], (1, 3)),
        dir_intensity=arr([i for _, i in directionals], (1, 3)),
        pn_pos=arr([p for p, _, _ in point_normals], (0, 3)),
        pn_normal=arr([unit(n) for _, n, _ in point_normals], (0, 3)),
        pn_intensity=arr([i for _, _, i in point_normals], (0, 3)),
        env_color=np.asarray(env_constant if env_constant is not None
                             else (0, 0, 0), np.float32),
        env_img=env_img, env_cdf=env_cdf, env_lum_int=env_cdf.marginal_int,
        bsphere_center=np.asarray(bsphere_center, np.float32),
        bsphere_radius=np.float32(bsphere_radius * 1.1),
    )


def emitters_to(em, device) -> EmitterTables:
    """Upload numpy emitter tables (this module's or the JAX package's, read
    by attribute) to `device`."""
    def t(x, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x, dtype)),
                               device=device)

    def opt(name, shape, dtype=np.float32, fill=0):
        """A column the JAX package's tables may leave as None."""
        x = getattr(em, name, None)
        return t(np.full(shape, fill, dtype) if x is None else x, dtype)

    t_pad = np.asarray(em.tri_emission).shape[0]
    atlas = getattr(em, "tex_atlas", None)
    return EmitterTables(
        n_atoms=int(em.n_atoms), has_env=bool(em.has_env),
        env_textured=bool(em.env_textured),
        has_em_uv=bool(getattr(em, "has_em_uv", False)),
        kinds=frozenset(int(k) for k in np.asarray(em.atom_kind)),
        atom_cdf=distribution_to(em.atom_cdf, device),
        atom_kind=t(em.atom_kind, np.int32), atom_ref=t(em.atom_ref, np.int32),
        tri_emission=t(em.tri_emission), tri_pdf_area=t(em.tri_pdf_area),
        tri_atom=t(em.tri_atom, np.int32),
        tri_em_kind=opt("tri_em_kind", (t_pad,), np.int32),
        tri_em_scale=opt("tri_em_scale", (t_pad,), fill=1),
        tri_em_tex=opt("tri_em_tex", (t_pad,), np.int32, -1),
        tex_atlas=None if atlas is None else t(atlas),
        point_pos=t(em.point_pos), point_intensity=t(em.point_intensity),
        dir_direction=t(em.dir_direction), dir_intensity=t(em.dir_intensity),
        pn_pos=opt("pn_pos", (0, 3)), pn_normal=opt("pn_normal", (0, 3)),
        pn_intensity=opt("pn_intensity", (0, 3)),
        env_color=t(em.env_color), env_img=t(em.env_img),
        env_cdf=distribution_2d_to(em.env_cdf, device),
        env_lum_int=t(em.env_lum_int),
        bsphere_center=t(em.bsphere_center),
        bsphere_radius=t(em.bsphere_radius),
    )


# ------------------------------------------------------------ device ops

def _rows(table, idx):
    """table[idx] with idx clamped to the table, as the reference's takes
    clip: lanes of another atom kind read some row and are masked later."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1)]


def _sphere_exit_t(center, radius, o, d):
    """Distance to the far intersection with the bounding sphere."""
    oc = o - center
    b = dot(oc, d)
    c = dot(oc, oc) - radius ** 2
    return -b + torch.sqrt(torch.clamp(b * b - c, min=0.0))


def _env_texel(em: EmitterTables, d):
    """(row, column, v) of the environment texel seen along d."""
    theta, phi = to_spherical_coordinates(d)
    u = torch.clamp(phi / (2 * _PI), 0.0, 1.0 - 1e-7)
    v = torch.clamp(theta / _PI, 0.0, 1.0 - 1e-7)
    h, w = em.env_img.shape[:2]
    xi = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    yi = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return yi, xi, v


def env_radiance(em: EmitterTables, d):
    """Escaped-ray radiance (reference enviroment_luminance)."""
    if not em.has_env:
        return torch.zeros_like(d)
    if not em.env_textured:
        return em.env_color.expand(d.shape)
    yi, xi, _ = _env_texel(em, d)
    return em.env_img[yi, xi]


def _env_sel_pdf(em: EmitterTables):
    """Selection probability of the env atom (always the last atom)."""
    return em.atom_cdf.cdf[em.n_atoms] - em.atom_cdf.cdf[em.n_atoms - 1]


def env_direction_pdf(em: EmitterTables, d):
    """Solid-angle pdf of sampling direction d from the environment,
    selection included."""
    if not em.has_env:
        return torch.zeros_like(d[..., 0])
    sel = _env_sel_pdf(em)
    if not em.env_textured:
        return torch.full_like(d[..., 0], 1.0 / (4.0 * _PI)) * sel
    yi, xi, v = _env_texel(em, d)
    cell = em.env_cdf.func[yi, xi] / torch.clamp(em.env_cdf.marginal_int,
                                                 min=1e-30)
    sin_t = torch.sin(_PI * v)
    pdf = torch.where(sin_t > 0.0, cell / (2.0 * _PI ** 2 * sin_t), 0.0)
    return pdf * sel


def _sample_env_direction(em: EmitterTables, uv):
    """(d, color, solid-angle pdf), selection pdf NOT included."""
    if not em.env_textured:
        return (sample_uniform_sphere(uv), em.env_color.expand(uv.shape[0], 3),
                torch.full_like(uv[..., 0], 1.0 / (4.0 * _PI)))
    h, w = em.env_img.shape[:2]
    xy = sample_continuous_2d(em.env_cdf, uv)
    x = torch.clamp(xy[..., 0], 0.0, w - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.0)
    xi = x.to(torch.int64)
    yi = y.to(torch.int64)
    color = em.env_img[yi, xi]
    cell = em.env_cdf.func[yi, xi] / torch.clamp(em.env_cdf.marginal_int,
                                                 min=1e-30)
    phi = (2.0 * _PI / w) * x
    theta = (_PI / h) * y
    st, ct = torch.sin(theta), torch.cos(theta)
    d = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    pdf = torch.where(st > 0.0, cell / (2.0 * _PI ** 2 * st), 0.0)
    color = torch.where((st > 0.0)[..., None], color, 0.0)
    return d, color, pdf


def _emission_at(em: EmitterTables, kind, scale, tex, base_le, uv):
    """uv-dependent emission (the reference's Mesh::emit): kind 0 =
    constant `base_le`, 1 = the HSV ramp x * red + (1 - x) * green over u,
    2 = a texture atlas lookup."""
    x = torch.remainder(torch.abs(uv[..., 0]), 1.0)
    hsv = scale[:, None] * torch.stack([x, 1.0 - x, torch.zeros_like(x)], -1)
    le = torch.where((kind == 1)[:, None], hsv, base_le)
    if em.tex_atlas is not None:
        k, th, tw, _ = em.tex_atlas.shape
        fu = uv[..., 0] - torch.floor(uv[..., 0])
        fv = uv[..., 1] - torch.floor(uv[..., 1])
        xi = torch.clamp((fu * tw).to(torch.int64), 0, tw - 1)
        yi = torch.clamp(((1.0 - fv) * th).to(torch.int64), 0, th - 1)
        img = torch.clamp(tex, 0, k - 1).to(torch.int64)
        texel = em.tex_atlas[img, yi, xi] * scale[:, None]
        le = torch.where((kind == 2)[:, None], texel, le)
    return le


def _tri_uv_at(vuv, b):
    """Interpolated uv at barycentric b from per-corner uvs [n, 3, 2]."""
    w0 = (1.0 - b[..., 0] - b[..., 1])[:, None]
    return vuv[:, 0] * w0 + vuv[:, 1] * b[..., 0:1] + vuv[:, 2] * b[..., 1:2]


def _tri_le(em: EmitterTables, geom, tri, b):
    """Le at barycentric b of triangle tri (uv-dependent where it is)."""
    le = em.tri_emission[tri]
    if em.has_em_uv:
        le = _emission_at(em, em.tri_em_kind[tri], em.tri_em_scale[tri],
                          em.tri_em_tex[tri], le, _tri_uv_at(geom.vuv[tri], b))
    return le


def _pick(em: EmitterTables, u_sel):
    """An atom by flux: (atom, selection pdf, kind, ref)."""
    atom = sample_discrete_1d(em.atom_cdf, u_sel)
    return (atom, pdf_discrete_1d(em.atom_cdf, atom), em.atom_kind[atom],
            em.atom_ref[atom])


def _triangle_sample(em: EmitterTables, geom, ref, sel_pdf, p_ref, u_pos):
    """A uniform point on triangle `ref` (clamped to the table) picked with
    probability sel_pdf: (p, n, d, dist, solid-angle pdf, Le G / pdf,
    valid)."""
    tri = torch.clamp(ref, 0, geom.v0.shape[0] - 1)
    b = uniform_sample_triangle(u_pos)
    p = geom.v0[tri] + b[..., 0:1] * geom.e1[tri] + b[..., 1:2] * geom.e2[tri]
    nrm = geom.n_g[tri]
    le = _tri_le(em, geom, tri, b)
    delta_v = p - p_ref
    dist = length(delta_v)
    d = delta_v / torch.clamp(dist, min=1e-20)[:, None]
    cos_l = torch.clamp(dot(nrm, -d), min=0.0)
    g = torch.where(dist > 0.0, cos_l / torch.clamp(dist ** 2, min=1e-20), 0.0)
    pdf_area = sel_pdf / torch.clamp(geom.area[tri], min=1e-20)
    pdf = torch.where(g > 0.0, pdf_area * dist ** 2
                      / torch.clamp(cos_l, min=1e-20), 0.0)
    weight = torch.where((g > 0.0)[:, None],
                         le * (g / torch.clamp(pdf_area, min=1e-30))[:, None],
                         0.0)
    return p, nrm, d, dist, pdf, weight, (g > 0.0) & (sel_pdf > 0.0)


def sample_light(em: EmitterTables, geom, p_ref, u_sel, u_pos) -> LightSample:
    """NEE sample toward one emitter atom per lane.

    p_ref [n, 3] shading points; u_sel [n]; u_pos [n, 2]. weight = Le * G /
    pdf with the selection pdf folded in, ready to multiply by f."""
    n = p_ref.shape[0]
    atom, sel_pdf, kind, ref = _pick(em, u_sel)
    sel_c = torch.clamp(sel_pdf, min=1e-30)[:, None]

    # ---- surface triangle atom
    p, nrm, d, dist, pdf, weight, valid = _triangle_sample(
        em, geom, ref, sel_pdf, p_ref, u_pos)
    is_delta = torch.zeros(n, dtype=torch.bool, device=p_ref.device)
    tri_out = torch.where(kind == ATOM_TRI, ref, -1)

    def take(m, p_, n_, d_, dist_, pdf_, w_, valid_, delta):
        nonlocal p, nrm, d, dist, pdf, weight, valid, is_delta
        m3 = m[:, None]
        p = torch.where(m3, p_, p)
        nrm = torch.where(m3, n_, nrm)
        d = torch.where(m3, d_, d)
        dist = torch.where(m, dist_, dist)
        pdf = torch.where(m, pdf_, pdf)
        weight = torch.where(m3, w_, weight)
        valid = torch.where(m, valid_, valid)
        if delta:
            is_delta = is_delta | m

    if ATOM_POINT in em.kinds:
        pp = _rows(em.point_pos, ref)
        dv = pp - p_ref
        dist_p = length(dv)
        take(kind == ATOM_POINT, pp, 0.0,
             dv / torch.clamp(dist_p, min=1e-20)[:, None], dist_p, sel_pdf, _rows(em.point_intensity, ref)
             / torch.clamp(dist_p ** 2, min=1e-20)[:, None] / sel_c,
             sel_pdf > 0.0, True)
    if ATOM_DIR in em.kinds:
        dd = _rows(em.dir_direction, ref)
        take(kind == ATOM_DIR, p_ref - em.bsphere_radius * dd, dd, -dd,
             em.bsphere_radius.expand(n), sel_pdf,
             _rows(em.dir_intensity, ref) / sel_c, sel_pdf > 0.0, True)
    if ATOM_PN in em.kinds:
        # the reference leaves its direct_sample as todo!(): the natural
        # cosine falloff I * max(n.(-d), 0) / d^2, as the JAX package has it
        pp = _rows(em.pn_pos, ref)
        pnn = _rows(em.pn_normal, ref)
        dv = pp - p_ref
        dist_q = length(dv)
        d_q = dv / torch.clamp(dist_q, min=1e-20)[:, None]
        cos_q = torch.clamp(dot(pnn, -d_q), min=0.0)
        take(kind == ATOM_PN, pp, pnn, d_q, dist_q, sel_pdf,
             _rows(em.pn_intensity, ref)
             * (cos_q / torch.clamp(dist_q ** 2, min=1e-20))[:, None] / sel_c,
             (sel_pdf > 0.0) & (cos_q > 0.0), True)
    if em.has_env:
        d_e, color_e, pdf_e = _sample_env_direction(em, u_pos)
        t_exit = _sphere_exit_t(em.bsphere_center, em.bsphere_radius, p_ref,
                                d_e)
        p_e = p_ref + d_e * t_exit[:, None]
        n_e = em.bsphere_center - p_e
        n_e = n_e / torch.clamp(length(n_e), min=1e-20)[:, None]
        pdf_full = pdf_e * sel_pdf
        take(kind == ATOM_ENV, p_e, n_e, d_e, t_exit, pdf_full,
             color_e / torch.clamp(pdf_full, min=1e-30)[:, None],
             pdf_full > 0.0, False)

    return LightSample(p=p, n=nrm, d=d, dist=dist, pdf=pdf,
                       weight=torch.where(valid[:, None], weight, 0.0),
                       is_delta=is_delta, valid=valid, tri=tri_out)


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


def emitted_radiance(em: EmitterTables, geom, tri_id, d, uv=None):
    """Le seen along -d when hitting triangle tri_id (front side only).
    Pass the hit uv to evaluate uv-dependent emission kinds exactly."""
    t = torch.clamp(tri_id, min=0)
    le = em.tri_emission[t]
    if em.has_em_uv and uv is not None:
        le = _emission_at(em, em.tri_em_kind[t], em.tri_em_scale[t],
                          em.tri_em_tex[t], le, uv)
    front = dot(geom.n_g[t], -d) > 0.0
    return torch.where((front & (tri_id >= 0))[:, None], le, 0.0)


def sample_position(em: EmitterTables, geom, u_sel, u_pos) -> PositionSample:
    """Emission origin for light paths: an atom by flux, then a uniform point
    on its triangle (weight Phi = Le * pi / pdf_area), the light's position,
    a point on the bounding disk facing a directional light, or on the
    bounding sphere for the environment; selection pdf folded in."""
    n = u_sel.shape[0]
    atom, sel_pdf, kind, ref = _pick(em, u_sel)
    sel_c = torch.clamp(sel_pdf, min=1e-30)[:, None]
    tri = torch.clamp(ref, 0, geom.v0.shape[0] - 1)
    b = uniform_sample_triangle(u_pos)
    p = geom.v0[tri] + b[..., 0:1] * geom.e1[tri] + b[..., 1:2] * geom.e2[tri]
    nrm = geom.n_g[tri]
    pdf_area = sel_pdf / torch.clamp(geom.area[tri], min=1e-20)
    weight = _tri_le(em, geom, tri, b) * (
        _PI / torch.clamp(pdf_area, min=1e-30))[:, None]
    valid = sel_pdf > 0.0

    if ATOM_POINT in em.kinds:
        m = (kind == ATOM_POINT)[:, None]
        p = torch.where(m, _rows(em.point_pos, ref), p)
        nrm = torch.where(m, 0.0, nrm)
        weight = torch.where(m, _rows(em.point_intensity, ref) * (4.0 * _PI)
                             / sel_c, weight)
    if ATOM_PN in em.kinds:
        # Phi = pi * I for radiant intensity I * cos, the energy-consistent
        # value the JAX package keeps (the reference's flux() = 2I feeds a
        # todo!()'d sample_direction)
        m = kind == ATOM_PN
        p = torch.where(m[:, None], _rows(em.pn_pos, ref), p)
        nrm = torch.where(m[:, None], _rows(em.pn_normal, ref), nrm)
        weight = torch.where(m[:, None], _rows(em.pn_intensity, ref) * _PI
                             / sel_c, weight)
        pdf_area = torch.where(m, sel_pdf, pdf_area)
    if ATOM_DIR in em.kinds:
        m = kind == ATOM_DIR
        dd = _rows(em.dir_direction, ref)
        disk = concentric_sample_disk(u_pos)
        poff = to_world(make_frame(dd), torch.stack(
            [disk[..., 0], disk[..., 1], torch.zeros_like(disk[..., 0])],
            dim=-1)) * em.bsphere_radius
        p_d = em.bsphere_center - dd * em.bsphere_radius + poff
        disk_area = _PI * em.bsphere_radius ** 2
        p = torch.where(m[:, None], p_d, p)
        nrm = torch.where(m[:, None], dd, nrm)
        weight = torch.where(m[:, None], _rows(em.dir_intensity, ref)
                             * disk_area / sel_c, weight)
        pdf_area = torch.where(m, sel_pdf / disk_area, pdf_area)
    if em.has_env:
        m = kind == ATOM_ENV
        d_sph = sample_uniform_sphere(u_pos)
        p_e = em.bsphere_center - d_sph * em.bsphere_radius
        area_sph = 4.0 * _PI * em.bsphere_radius ** 2
        if em.env_textured:
            w_e = torch.ones_like(p) * (
                area_sph / torch.clamp(em.env_lum_int, min=1e-30))
        else:
            w_e = em.env_color.expand(n, 3) * area_sph * _PI
        p = torch.where(m[:, None], p_e, p)
        nrm = torch.where(m[:, None], d_sph, nrm)
        weight = torch.where(m[:, None], w_e / sel_c, weight)
        pdf_area = torch.where(m, sel_pdf / area_sph, pdf_area)

    return PositionSample(p=p, n=nrm, pdf_area=pdf_area,
                          weight=torch.where(valid[:, None], weight, 0.0),
                          kind=kind, atom=atom, valid=valid)


def sample_emission_direction(em: EmitterTables, ps: PositionSample, u):
    """Direction from a sampled emission origin: cosine about the normal
    for surfaces, point-normal lights and the environment (perfect
    importance sampling, weight 1), uniform over the sphere for point
    lights, the light's own direction for directional ones.
    Returns (d_world [n, 3], pdf [n], weight [n, 3])."""
    d_loc = cosine_sample_hemisphere(u)
    d = to_world(make_frame(ps.n), d_loc)
    pdf = torch.clamp(d_loc[..., 2], min=0.0) / _PI
    weight = torch.where((d_loc[..., 2] >= 0.0)[:, None], 1.0, 0.0) \
        * torch.ones_like(ps.p)
    if ATOM_POINT in em.kinds:
        m = ps.kind == ATOM_POINT
        d = torch.where(m[:, None], sample_uniform_sphere(u), d)
        pdf = torch.where(m, 1.0 / (4.0 * _PI), pdf)
        weight = torch.where(m[:, None], 1.0, weight)
    if ATOM_DIR in em.kinds:
        m = ps.kind == ATOM_DIR
        d = torch.where(m[:, None], ps.n, d)
        pdf = torch.where(m, 1.0, pdf)
        weight = torch.where(m[:, None], 1.0, weight)
    return d, pdf, weight


# ------------------------------------------------------------ ATS variants

def sample_light_ats(em: EmitterTables, geom, ats, p_ref, n_ref, u_sel,
                     u_pos) -> LightSample:
    """NEE through the ATS light tree: a descent picks a triangle by its
    importance from (p_ref, n_ref), then a uniform point on it (the
    reference's sample_light with ATS, emitter.rs:1629-1648)."""
    tri, sel_pdf = ats_sample(ats, p_ref, n_ref, u_sel)
    p, nrm, d, dist, pdf, weight, valid = _triangle_sample(
        em, geom, tri, sel_pdf, p_ref, u_pos)
    valid = valid & (tri >= 0)
    return LightSample(p=p, n=nrm, d=d, dist=dist, pdf=pdf,
                       weight=torch.where(valid[:, None], weight, 0.0),
                       is_delta=torch.zeros_like(valid), valid=valid, tri=tri)


def direct_pdf_tri_ats(em: EmitterTables, geom, ats, tri_id, p_ref, p_hit,
                       n_hit, d):
    """Solid-angle NEE pdf of hitting tri_id from p_ref under ATS selection
    (direct_pdf_tri x the tree's pdf, emitter.rs:1567-1601; the reference
    passes no normal to the tree here)."""
    sel = ats_pdf(ats, tri_id, p_ref, None)
    area_inv = ats.tri_area_inv[torch.clamp(tri_id, min=0)]
    cos_l = torch.clamp(dot(n_hit, -d), min=0.0)
    delta = p_hit - p_ref
    dist2 = dot(delta, delta)
    pdf = torch.where(cos_l > 0.0,
                      sel * area_inv * dist2 / torch.clamp(cos_l, min=1e-20),
                      0.0)
    return torch.where(tri_id >= 0, pdf, 0.0)

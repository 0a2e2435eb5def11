"""Volumetric many-light estimators over photon primitives: BRE (photon
points), photon beams, photon planes and virtual ray lights; port of
rustlight_tpu/integrators/vol_primitives.py.

Phase 1 traces light paths through the medium (radiance transport) and
records each edge and vertex; phase 2 gathers the primitives along the
camera rays:

  BRE    a 2D kernel around photon points: Tr(w) phase / (pi r^2)
  beams  the edge-edge 1D kernel: Tr(w) sigma_s phase / sin / (2 r)
  planes the 0D kernel with the plane-ray Jacobian (and the beams that
         leave a surface)
  VRL    point-point Monte Carlo on virtual ray lights, with radiance
         Russian roulette (and the beams that leave a surface)

Every camera ray meets every primitive: the primitives are cut into chunks
of `prim_chunk`, each chunk's [n, chunk] pairs are evaluated at once and
each chunk adds its own sum to the accumulator, as the reference's scan
does. VRL draws three (n, prim_chunk) uniforms a chunk, so the chunk size
is part of its random bits. Planes and VRL trace a shadow ray a pair, a
chunk's rays in one call; the pairs that cannot contribute (outside the
plane, or not taken by the roulette) go as inert rays, which the kernels
skip, and the result is the reference's, which traces them all.
Short-beam semantics (a beam is as long as its sampled free flight) and
the reference's convention that a primitive carries the path flux at its
origin vertex are kept.

Draws: the light paths on stream_fold(stream, 4242): u_sel, u_pos (n, 2),
u_dir (n, 2), then each bounce u_med, u_b (n, 2), u_rr; on the pixel's
stream u_pix (n, 2), then for VRL three (n, prim_chunk) uniforms a chunk.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..accel import intersect_rays, visible
from ..bsdfs import bsdf_sample
from ..bsdfs.table import TRANSPORT_RADIANCE
from ..scene import (fill_hit, generate_rays, sample_emission_direction,
                     sample_position)
from ..scene.scene import offset_ray_origin
from ..scene.volume import phase_eval, phase_sample, volume_sample_distance
from ..utils.frame import to_world
from ..utils.rng import stream_fold, stream_next, stream_next2d
from ..utils.vec import channel_max, cross, dot, length

# vertex kinds along light paths
V_NONE = 0
V_LIGHT = 1
V_SURFACE = 2
V_VOLUME = 3


class LightPathRecord(NamedTuple):
    """Per-edge records of a light-path wavefront in the medium. Edge e
    goes from vertex e to vertex e + 1; arrays are [paths, cap (+1),
    ...]."""
    vkind: Any        # [p, cap+1] vertex kinds (slot 0: the emitter)
    vpos: Any         # [p, cap+1, 3]
    vflux: Any        # [p, cap+1, 3] flux arriving at the vertex
    vdin: Any         # [p, cap+1, 3] incoming direction (to the previous)
    edir: Any         # [p, cap, 3] edge direction (vertex k -> k+1)
    edist: Any        # [p, cap] real (clamped) distance
    econt: Any        # [p, cap] continued (unclamped) distance
    evalid: Any       # [p, cap]
    n_paths: int


def trace_volume_light_paths(scene, n, cap, stream, rr_depth=0,
                             max_depth=None) -> LightPathRecord:
    """`n` light paths through the medium for `cap` bounces, dead or
    alive, recording their edges and vertices."""
    vol = scene.volume
    u_sel, stream = stream_next(stream, (n,))
    u_pos, stream = stream_next2d(stream, (n,))
    ps = sample_position(scene.emitters, scene.geom, u_sel, u_pos)
    flux = ps.weight

    u_dir, stream = stream_next2d(stream, (n,))
    d, pdf_dir, _ = sample_emission_direction(scene.emitters, ps, u_dir)
    o = offset_ray_origin(ps.p, ps.n, d)
    alive = ps.valid & (pdf_dir > 0.0)

    rec = {k: [] for k in ("vkind", "vpos", "vflux", "vdin", "edir", "edist",
                           "econt", "evalid")}
    rec["vkind"].append(torch.where(ps.valid, V_LIGHT, V_NONE))
    rec["vpos"].append(ps.p)
    rec["vflux"].append(flux)
    rec["vdin"].append(-d)
    for k in range(cap):
        rh = intersect_rays(scene.geom, o, d)
        hit = fill_hit(scene, o, d, rh)
        u_med, stream = stream_next(stream, (n,))
        sd = volume_sample_distance(vol, torch.where(rh.hit, rh.t, 1e8), u_med)
        scattered = alive & (~sd.exited)
        surface = alive & hit.valid & sd.exited
        p_scatter = o + d * sd.t[:, None]

        new_flux = flux * sd.w
        for key, v in (
                ("edir", d), ("edist", sd.t), ("econt", sd.continued_t),
                ("evalid", alive),
                ("vkind", torch.where(scattered, V_VOLUME,
                                      torch.where(surface, V_SURFACE,
                                                  V_NONE))),
                ("vpos", torch.where(scattered[:, None], p_scatter, hit.p)),
                ("vflux", new_flux), ("vdin", -d)):
            rec[key].append(v)

        # bounce
        u_b, stream = stream_next2d(stream, (n,))
        bs = bsdf_sample(scene.materials, hit.mat, hit.uv, hit.wi, u_b,
                         TRANSPORT_RADIANCE)
        d_ph, w_ph, pdf_ph = phase_sample(vol.phase_g, -d, u_b)
        wo_world = torch.where(scattered[:, None], d_ph,
                               to_world(hit.frame, bs.wo))
        weight = torch.where(scattered[:, None], w_ph, bs.weight)
        valid_dir = torch.where(scattered, pdf_ph > 0.0, bs.valid)
        flux_next = new_flux * weight

        u_rr, stream = stream_next(stream, (n,))
        keep = torch.ones_like(alive)
        if rr_depth is not None and (k + 1) >= rr_depth:
            rr_p = torch.clamp(channel_max(flux_next) / torch.clamp(
                channel_max(new_flux), min=1e-30), max=0.95)
            keep = u_rr < rr_p
            flux_next = flux_next * torch.where(
                keep, 1.0 / torch.clamp(rr_p, min=1e-8), 1.0)[:, None]

        alive_new = ((scattered | surface) & valid_dir & keep
                     & (channel_max(flux_next) > 0.0))
        if max_depth is not None and not k + 1 < max_depth:
            alive_new = torch.zeros_like(alive_new)
        o_new = torch.where(scattered[:, None], p_scatter,
                            offset_ray_origin(hit.p, hit.n_g, wo_world))
        an = alive_new[:, None]
        o = torch.where(an, o_new, o)
        d = torch.where(an, wo_world, d)
        flux = torch.where(an, flux_next, flux)
        alive = alive_new

    return LightPathRecord(**{k: torch.stack(v, 1) for k, v in rec.items()},
                           n_paths=n)


def _chunks(arrs: Dict[str, Any], chunk: int):
    """The flat primitive arrays in chunks of `chunk`, the last padded with
    zeros (invalid primitives)."""
    total = next(iter(arrs.values())).shape[0]
    n_chunks = max(1, (total + chunk - 1) // chunk)
    pad = n_chunks * chunk - total
    if pad:
        arrs = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])], 0)
                for k, v in arrs.items()}
    for i in range(n_chunks):
        yield {k: v[i * chunk:(i + 1) * chunk] for k, v in arrs.items()}


def _tr(vol, dist):
    """exp(-sigma_t dist) for pairwise distances [n, c] -> [n, c, 3]."""
    return torch.exp(-vol.sigma_t * dist[..., None])


class IntegratorVolPrimitives:
    """primitives in {"bre", "beams", "planes", "vrl"}."""

    def __init__(self, nb_primitive: int = 1024,
                 max_depth: Optional[int] = None,
                 rr_depth: Optional[int] = 0, primitives: str = "bre",
                 radius: float = 1e-3, prim_chunk: int = 64,
                 hard_cap: int = 8):
        if primitives not in ("bre", "beams", "planes", "vrl"):
            raise ValueError(f"unknown primitives {primitives!r}")
        self.nb_primitive = nb_primitive
        self.max_depth = max_depth
        self.rr_depth = rr_depth
        self.primitives = primitives
        self.radius = radius
        self.prim_chunk = prim_chunk
        self.cap = hard_cap if max_depth is None else min(hard_cap, max_depth)

    # ---------------------------------------------------------- primitives
    def _collect(self, rec: LightPathRecord):
        """Flatten the records into the primitive arrays of the mode."""
        p, cp1 = rec.vkind.shape
        cap = cp1 - 1

        def flat(x):
            return x.reshape((p * cap,) + tuple(x.shape[2:]))

        vk0 = rec.vkind[:, :-1]      # each edge's origin vertex
        vk1 = rec.vkind[:, 1:]       # its end
        out = {}
        if self.primitives == "bre":
            out["photon"] = dict(
                valid=flat(vk1 == V_VOLUME) & flat(rec.evalid),
                pos=flat(rec.vpos[:, 1:]),
                d_in=flat(rec.vdin[:, 1:]),
                radiance=flat(rec.vflux[:, 1:]))
        else:
            from_surface = (vk0 == V_LIGHT) | (vk0 == V_SURFACE)
            bmask = flat(rec.evalid) & flat(vk0 != V_NONE)
            if self.primitives == "planes":
                # only the beams that leave a surface (only_from_surface)
                bmask = (bmask & flat(from_surface | (vk1 != V_VOLUME))
                         & flat(from_surface))
            out["beam"] = dict(
                valid=bmask,
                o=flat(rec.vpos[:, :-1]),
                d=flat(rec.edir),
                length=flat(rec.edist),
                radiance=flat(rec.vflux[:, :-1]),
                from_surface=flat(from_surface))
        if self.primitives == "planes":
            # a plane spans two consecutive edges out of volume vertices k
            # and k + 1
            if cap < 3:
                raise ValueError("planes need at least 3 bounces")
            m = ((rec.vkind[:, 1:cap - 1] == V_VOLUME)
                 & (rec.vkind[:, 2:cap] == V_VOLUME)
                 & rec.evalid[:, 1:cap - 1] & rec.evalid[:, 2:cap])

            def fl2(x):
                return x.reshape((p * (cap - 2),) + tuple(x.shape[2:]))
            out["plane"] = dict(
                valid=fl2(m),
                o=fl2(rec.vpos[:, 1:cap - 1]),
                d0=fl2(rec.edir[:, 1:cap - 1]),
                d1=fl2(rec.edir[:, 2:cap]),
                length0=fl2(rec.econt[:, 1:cap - 1]),
                length1=fl2(rec.econt[:, 2:cap]),
                radiance=fl2(rec.vflux[:, 1:cap - 1]))
        return out

    # ------------------------------------------------------------- gathers
    def _gather_bre(self, scene, o, d, tfar, photons, norm):
        vol = scene.volume
        r2 = self.radius ** 2
        kern = 1.0 / (math.pi * r2)
        li = torch.zeros_like(o)
        for c in _chunks(photons, self.prim_chunk):
            pos = c["pos"]                                # [vc, 3]
            dp = pos[None] - o[:, None]
            t = dot(dp, d[:, None])
            on_seg = (t > 0.0) & (t <= tfar[:, None])
            closest = o[:, None] + d[:, None] * t[..., None]
            dist2 = torch.sum((pos[None] - closest) ** 2, -1)
            inside = on_seg & (dist2 <= r2) & c["valid"][None]
            ph = phase_eval(vol.phase_g, -d[:, None], c["d_in"][None])
            contrib = c["radiance"][None] * _tr(vol, t) * ph[..., None] * kern
            li = li + torch.where(inside[..., None], contrib, 0.0).sum(1)
        return li * norm

    def _beam_its(self, o, d, tfar, bo, bd, blen):
        """The edge-edge intersection of every ray with every beam of a
        chunk: (u, v, w, sin, valid), each [n, vc]."""
        d1d2c = cross(d[:, None], bd[None])
        sin2 = dot(d1d2c, d1d2c)
        ad = dot(bo[None] - o[:, None], d1d2c)
        near = ad * ad < (self.radius ** 2) * sin2
        d1d2 = dot(d[:, None], bd[None])
        dd_m1 = d1d2 * d1d2 - 1.0
        non_par = torch.abs(dd_m1) >= 1e-5
        d1o1 = dot(d, o)[:, None]
        d1o2 = dot(d[:, None], bo[None])
        w = ((d1o1 - d1o2 - d1d2 * (dot(bd[None], o[:, None])
                                    - dot(bd, bo)[None]))
             / torch.where(non_par, dd_m1, 1.0))
        ok_w = (w > 1e-4) & (w < tfar[:, None])
        v = (w + d1o1 - d1o2) / torch.where(torch.abs(d1d2) > 1e-9, d1d2, 1.0)
        ok_v = (v > 0.0) & (v < blen[None]) & torch.isfinite(v)
        sin_t = torch.sqrt(torch.clamp(sin2, min=1e-20))
        u = torch.abs(ad) / sin_t
        return u, v, w, sin_t, near & non_par & ok_w & ok_v

    def _gather_beams(self, scene, o, d, tfar, beams, norm,
                      surface_only=False):
        vol = scene.volume
        li = torch.zeros_like(o)
        for c in _chunks(beams, self.prim_chunk):
            _, _, w, sin_t, valid = self._beam_its(o, d, tfar, c["o"], c["d"],
                                                   c["length"])
            valid = valid & c["valid"][None]
            if surface_only:
                valid = valid & c["from_surface"][None]
            ph = phase_eval(vol.phase_g, -d[:, None], -c["d"][None])
            wgt = (1.0 / sin_t) * (0.5 / self.radius)
            contrib = (c["radiance"][None] * vol.sigma_s * _tr(vol, w)
                       * (ph * wgt)[..., None])
            li = li + torch.where(valid[..., None], contrib, 0.0).sum(1)
        return li * norm

    def _gather_vrls(self, scene, o, d, tfar, beams, norm, stream):
        """The beams that leave a volume vertex as VRLs: point-point Monte
        Carlo with radiance Russian roulette."""
        vol = scene.volume
        n = o.shape[0]
        vc = self.prim_chunk
        vol_beam = beams["valid"] & (~beams["from_surface"])
        avg_rad = torch.mean(torch.where(vol_beam,
                                         channel_max(beams["radiance"]), 0.0))
        avg_rad = avg_rad / torch.clamp(torch.mean(vol_beam.to(torch.float32)),
                                        min=1e-8)
        li = torch.zeros_like(o)
        for c in _chunks(beams, vc):
            u1, stream = stream_next(stream, (n, vc))
            u2, stream = stream_next(stream, (n, vc))
            u3, stream = stream_next(stream, (n, vc))
            valid = c["valid"][None] & (~c["from_surface"][None])
            rr = torch.clamp((channel_max(c["radiance"])
                              / torch.clamp(avg_rad, min=1e-20)) * 0.01,
                             max=1.0)[None]
            take = (u3 < rr) & valid
            t_cam = tfar[:, None] * u1
            t_vrl = c["length"][None] * u2
            inv_pdf = c["length"][None] * tfar[:, None]
            p_vrl = c["o"][None] + c["d"][None] * t_vrl[..., None]
            p_cam = o[:, None] + d[:, None] * t_cam[..., None]
            delta = p_vrl - p_cam
            dist = length(delta)
            dirv = delta / torch.clamp(dist, min=1e-20)[..., None]
            vis = visible(scene.geom, p_cam.reshape(-1, 3),
                          p_vrl.reshape(-1, 3),
                          mask=take.reshape(-1)).reshape(n, vc)
            ph_v = phase_eval(vol.phase_g, -c["d"][None], -dirv)
            ph_c = phase_eval(vol.phase_g, -d[:, None], dirv)
            contrib = (c["radiance"][None] * vol.sigma_s ** 2
                       * _tr(vol, t_cam) * _tr(vol, dist)
                       * (ph_v * ph_c * inv_pdf
                          / torch.clamp(dist * dist, min=1e-20))[..., None])
            contrib = contrib / torch.clamp(rr, min=1e-20)[..., None]
            li = li + torch.where((take & vis)[..., None], contrib, 0.0).sum(1)
        return li * norm, stream

    def _gather_planes(self, scene, o, d, tfar, planes, norm):
        vol = scene.volume
        n = o.shape[0]
        li = torch.zeros_like(o)
        for c in _chunks(planes, self.prim_chunk):
            vc = c["o"].shape[0]
            e0 = c["d0"] * c["length0"][:, None]
            e1 = c["d1"] * c["length1"][:, None]
            pvec = cross(d[:, None], e1[None])
            det = dot(e0[None], pvec)
            ok = torch.abs(det) >= 1e-5
            inv_det = 1.0 / torch.where(ok, det, 1.0)
            tvec = o[:, None] - c["o"][None]
            t0 = dot(tvec, pvec) * inv_det
            qvec = cross(tvec, e0[None])
            t1 = dot(d[:, None], qvec) * inv_det
            t_cam = dot(e1[None], qvec) * inv_det
            ok = (ok & (t0 >= 0.0) & (t0 <= 1.0) & (t1 >= 0.0) & (t1 <= 1.0)
                  & (t_cam > 1e-4) & (t_cam < tfar[:, None]) & c["valid"][None])
            p_its = o[:, None] + d[:, None] * t_cam[..., None]
            p0 = (c["o"][None]
                  + c["d0"][None] * (t0 * c["length0"][None])[..., None])
            vis = visible(scene.geom, p0.reshape(-1, 3),
                          p_its.reshape(-1, 3),
                          mask=ok.reshape(-1)).reshape(n, vc)
            ph = phase_eval(vol.phase_g, -d[:, None], -c["d1"][None])
            inv_jac = 1.0 / torch.clamp(torch.abs(dot(
                c["d0"][None], cross(c["d1"][None], -d[:, None]))), min=1e-10)
            contrib = (c["radiance"][None] * vol.sigma_s ** 2
                       * _tr(vol, t_cam) * (ph * inv_jac)[..., None])
            li = li + torch.where((ok & vis)[..., None], contrib, 0.0).sum(1)
        return li * norm

    # --------------------------------------------------------------- main
    def compute_pixel(self, scene, pix, stream):
        if scene.volume is None:
            raise ValueError("vol_primitives needs a medium (-m)")
        n = pix.shape[0]
        n_paths = max(1, self.nb_primitive // max(1, self.cap))
        rec = trace_volume_light_paths(
            scene, n_paths, self.cap, stream_fold(stream, 4242),
            rr_depth=self.rr_depth, max_depth=self.max_depth)
        prims = self._collect(rec)
        norm = 1.0 / n_paths

        u_pix, stream = stream_next2d(stream, (n,))
        o, d = generate_rays(scene.camera, pix.to(torch.float32) + u_pix)
        rh = intersect_rays(scene.geom, o, d)
        tfar = torch.where(rh.hit, rh.t, 1e8)

        if self.primitives == "bre":
            return self._gather_bre(scene, o, d, tfar, prims["photon"], norm)
        if self.primitives == "beams":
            return self._gather_beams(scene, o, d, tfar, prims["beam"], norm)
        if self.primitives == "vrl":
            li = self._gather_beams(scene, o, d, tfar, prims["beam"], norm,
                                    surface_only=True)
            li_vrl, _ = self._gather_vrls(scene, o, d, tfar, prims["beam"],
                                          norm, stream)
            return li + li_vrl
        li = self._gather_beams(scene, o, d, tfar, prims["beam"], norm)
        return li + self._gather_planes(scene, o, d, tfar, prims["plane"],
                                        norm)

"""Virtual point lights (instant radiosity); port of
rustlight_tpu/integrators/vpl.py.

The shoot pass traces nb_vpl // (cap + 1) light paths and deposits one VPL
slot per vertex: the emitter vertex, then a surface VPL at each non-delta
surface hit or a volume VPL where the path scatters in the medium (bounces
use the radiance transport). The gather pass evaluates every shading point
against every VPL: the [pixels x VPL chunk] pairs are flattened, pixel
major, and each chunk adds its own sum to the accumulator, as the
reference's scan over chunks of `vpl_chunk` does. Each chunk's shadow rays
go to the trace kernels in one call.

Draws: generate_vpls on stream_fold(stream, 999): u_sel, u_pos (n, 2),
u_dir (n, 2), then each bounce u_med (only with a medium), u_b (n, 2),
u_rr; then on the pixel's stream u_pix (n, 2) and, with a medium, u_med.

`clamping_factor` clamps the geometry term's squared distance from below
(None keeps the reference's behavior).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from ..accel import intersect_rays, visible
from ..bsdfs import bsdf_eval, bsdf_is_smooth, bsdf_sample
from ..bsdfs.table import TRANSPORT_IMPORTANCE, TRANSPORT_RADIANCE
from ..scene import (emitted_radiance, env_radiance, fill_hit, generate_rays,
                     sample_emission_direction, sample_position)
from ..scene.emitters import ATOM_DIR
from ..scene.scene import offset_ray_origin
from ..scene.volume import (phase_eval, phase_sample, transmittance,
                            volume_sample_distance)
from ..utils.frame import to_world
from ..utils.rng import stream_fold, stream_next, stream_next2d
from ..utils.vec import channel_max, dot

VPL_NONE = 0
VPL_EMITTER = 1
VPL_EMITTER_INF = 2
VPL_SURFACE = 3
VPL_VOLUME = 4


class VplSet(NamedTuple):
    kind: Any      # [v] int32
    pos: Any       # [v, 3]
    n: Any         # [v, 3] emitter or shading normal; for a volume VPL the
                   # incoming direction; for an infinite one its direction
    frame_t: Any   # [v, 3]
    frame_b: Any   # [v, 3]
    wi: Any        # [v, 3] local incoming direction at surface VPLs
    uv: Any        # [v, 2]
    mat: Any       # [v] material id
    radiance: Any  # [v, 3] flux carried to the vertex
    norm: float    # 1 / paths shot


def _pairs_p(x, vc):
    """Pixel side of the [n, vc] pairs, flattened pixel major."""
    return x.repeat_interleave(vc, dim=0)


def _pairs_v(x, n):
    """VPL side of the [n, vc] pairs."""
    return x.repeat((n,) + (1,) * (x.dim() - 1))


class IntegratorVPL:
    def __init__(self, nb_vpl: int = 128, max_depth: Optional[int] = None,
                 rr_depth: Optional[int] = 0,
                 clamping_factor: Optional[float] = None,
                 vpl_chunk: int = 16, hard_cap: int = 8):
        self.nb_vpl = nb_vpl
        self.max_depth = max_depth
        self.rr_depth = rr_depth
        self.clamping = clamping_factor
        self.vpl_chunk = vpl_chunk
        self.cap = hard_cap if max_depth is None else min(hard_cap, max_depth)

    # ------------------------------------------------------------ shoot pass
    def generate_vpls(self, scene, stream) -> VplSet:
        """Shoot max(1, nb_vpl // (cap + 1)) light paths for `cap` bounces,
        dead or alive, one VPL slot a vertex, slot major."""
        n = max(1, self.nb_vpl // (self.cap + 1))
        vol = scene.volume
        u_sel, stream = stream_next(stream, (n,))
        u_pos, stream = stream_next2d(stream, (n,))
        ps = sample_position(scene.emitters, scene.geom, u_sel, u_pos)
        flux = ps.weight
        dev = flux.device

        zero3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        kind0 = torch.where(ps.valid, torch.where(ps.kind == ATOM_DIR,
                                                  VPL_EMITTER_INF, VPL_EMITTER),
                            VPL_NONE).to(torch.int32)
        slots = dict(kind=[kind0], pos=[ps.p], n=[ps.n], frame_t=[zero3],
                     frame_b=[zero3], wi=[zero3],
                     uv=[torch.zeros((n, 2), dtype=torch.float32, device=dev)],
                     mat=[torch.zeros(n, dtype=torch.int32, device=dev)],
                     radiance=[flux])

        u_dir, stream = stream_next2d(stream, (n,))
        d, pdf_dir, w_dir = sample_emission_direction(scene.emitters, ps, u_dir)
        throughput = flux * w_dir
        o = offset_ray_origin(ps.p, ps.n, d)
        alive = ps.valid & (pdf_dir > 0.0)

        for k in range(self.cap):
            rh = intersect_rays(scene.geom, o, d)
            hit = fill_hit(scene, o, d, rh)
            if vol is not None:
                u_med, stream = stream_next(stream, (n,))
                sdm = volume_sample_distance(
                    vol, torch.where(rh.hit, rh.t, 1e8), u_med)
                scattered = alive & (~sdm.exited)
                throughput = throughput * sdm.w
                p_scatter = o + d * sdm.t[:, None]
            else:
                scattered = torch.zeros_like(alive)
            lane = alive & hit.valid & (~scattered)
            smooth = bsdf_is_smooth(scene.materials, hit.mat)
            t, b, _ = hit.frame
            kind = torch.where(lane & (~smooth), VPL_SURFACE, VPL_NONE)
            pos, nrm = hit.p, hit.n_s
            if vol is not None:
                kind = torch.where(scattered, VPL_VOLUME, kind)
                pos = torch.where(scattered[:, None], p_scatter, pos)
                nrm = torch.where(scattered[:, None], -d, nrm)  # d_in
            for key, v in (("kind", kind.to(torch.int32)), ("pos", pos),
                           ("n", nrm), ("frame_t", t), ("frame_b", b),
                           ("wi", hit.wi), ("uv", hit.uv), ("mat", hit.mat),
                           ("radiance", throughput)):
                slots[key].append(v)

            u_b, stream = stream_next2d(stream, (n,))
            bs = bsdf_sample(scene.materials, hit.mat, hit.uv, hit.wi, u_b,
                             TRANSPORT_RADIANCE)
            wo_world = to_world(hit.frame, bs.wo)
            weight = bs.weight
            valid_dir = bs.valid
            if vol is not None:
                d_ph, w_ph, pdf_ph = phase_sample(vol.phase_g, -d, u_b)
                wo_world = torch.where(scattered[:, None], d_ph, wo_world)
                weight = torch.where(scattered[:, None], w_ph, weight)
                valid_dir = torch.where(scattered, pdf_ph > 0.0, valid_dir)
            new_thr = throughput * weight
            u_rr, stream = stream_next(stream, (n,))
            keep = torch.ones_like(alive)
            if self.rr_depth is not None and (k + 1) >= self.rr_depth:
                rr_p = torch.clamp(channel_max(new_thr), max=0.95)
                keep = u_rr < rr_p
                new_thr = new_thr * torch.where(
                    keep, 1.0 / torch.clamp(rr_p, min=1e-8), 1.0)[:, None]
            alive_new = ((lane | scattered) & valid_dir & keep
                         & (channel_max(new_thr) > 0.0))
            if self.max_depth is not None and not k + 1 < self.max_depth:
                alive_new = torch.zeros_like(alive_new)
            o_new = offset_ray_origin(hit.p, hit.n_g, wo_world)
            if vol is not None:
                o_new = torch.where(scattered[:, None], p_scatter, o_new)
            an = alive_new[:, None]
            o = torch.where(an, o_new, o)
            d = torch.where(an, wo_world, d)
            throughput = torch.where(an, new_thr, throughput)
            alive = alive_new

        return VplSet(**{k: torch.cat(v, 0) for k, v in slots.items()},
                      norm=1.0 / n)

    # ----------------------------------------------------------- gather pass
    def _gather_chunk(self, scene, hit, recv_ok, c, recv_scattered=None,
                      recv_p=None, recv_d=None):
        """The summed contributions of one chunk of VPLs `c` (fields [vc,
        ...]) at every receiver: [n, 3]."""
        n = hit.p.shape[0]
        vc = c["kind"].shape[0]
        vol = scene.volume

        def bp(x):
            return _pairs_p(x, vc)

        def bv(x):
            return _pairs_v(x, n)

        p_here = hit.p
        if recv_scattered is not None:
            p_here = torch.where(recv_scattered[:, None], recv_p, hit.p)
        p_pix = bp(p_here)
        pos_v, nrm_v, rad_v = bv(c["pos"]), bv(c["n"]), bv(c["radiance"])
        delta = pos_v - p_pix
        dist2 = dot(delta, delta)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
        dir_ = delta / dist[:, None]
        kind = bv(c["kind"])
        inf_vpl = kind == VPL_EMITTER_INF
        dir_ = torch.where(inf_vpl[:, None], -nrm_v, dir_)

        # the shading point's BSDF (importance transport)
        ft, fb, fn = (bp(x) for x in hit.frame)
        wo_loc = torch.stack([dot(dir_, ft), dot(dir_, fb), dot(dir_, fn)],
                             -1)
        f_pix = bsdf_eval(scene.materials, bp(hit.mat), bp(hit.uv),
                          bp(hit.wi), wo_loc, TRANSPORT_IMPORTANCE)
        if recv_scattered is not None and vol is not None:
            ph_recv = phase_eval(vol.phase_g, bp(-recv_d), dir_)
            f_pix = torch.where(bp(recv_scattered)[:, None], ph_recv[:, None],
                                f_pix)

        # the VPL's emission toward the shading point: an emitter VPL Le
        # cos / pi, a surface VPL f(wi, -dir) under the radiance transport
        cos_e = torch.clamp(dot(nrm_v, -dir_), min=0.0)
        rad_emit = rad_v * (cos_e / math.pi)[:, None]
        md = torch.stack([dot(-dir_, bv(c["frame_t"])),
                          dot(-dir_, bv(c["frame_b"])),
                          dot(-dir_, nrm_v)], -1)
        f_vpl = bsdf_eval(scene.materials, bv(c["mat"]), bv(c["uv"]),
                          bv(c["wi"]), md, TRANSPORT_RADIANCE)
        rad_surf = rad_v * f_vpl

        # a volume VPL: the phase function at the VPL
        if vol is not None:
            ph_vpl = phase_eval(vol.phase_g, nrm_v, dir_)
            rad_vol = rad_v * ph_vpl[:, None]
            tr_con = transmittance(vol, torch.sqrt(dist2))
        else:
            rad_vol = torch.zeros_like(rad_surf)
            tr_con = 1.0

        g = (1.0 / torch.clamp(dist2, min=self.clamping or 1e-20))[:, None]
        contrib = torch.where(
            (kind == VPL_SURFACE)[:, None], rad_surf * g,
            torch.where((kind == VPL_EMITTER)[:, None], rad_emit * g,
                        torch.where(inf_vpl[:, None], rad_v,
                                    torch.where((kind == VPL_VOLUME)[:, None],
                                                rad_vol * g, 0.0))))
        contrib = contrib * f_pix * tr_con

        # visibility
        o_shadow = offset_ray_origin(p_pix, bp(hit.n_g), dir_)
        if recv_scattered is not None:
            o_shadow = torch.where(bp(recv_scattered)[:, None], p_pix,
                                   o_shadow)
        target = torch.where(inf_vpl[:, None], p_pix + dir_ * 1e7, pos_v)
        ok = bp(recv_ok) & (kind != VPL_NONE)
        vis = visible(scene.geom, o_shadow, target, mask=ok)
        contrib = torch.where((ok & vis)[:, None], contrib, 0.0)
        return contrib.reshape(n, vc, 3).sum(1)

    def _gather_surface(self, scene, hit, front, vpls: VplSet,
                        recv_scattered=None, recv_p=None, recv_d=None):
        """Gather every VPL at the surface hits; lanes flagged in
        recv_scattered gather at the medium point recv_p instead, with the
        phase function toward the camera direction recv_d."""
        vc = self.vpl_chunk
        v_total = vpls.kind.shape[0]
        n_chunks = (v_total + vc - 1) // vc
        pad = n_chunks * vc - v_total
        fields = {k: v for k, v in vpls._asdict().items() if k != "norm"}
        if pad:
            fields = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])], 0)
                      for k, v in fields.items()}
        recv_ok = front & (~bsdf_is_smooth(scene.materials, hit.mat))
        if recv_scattered is not None:
            recv_ok = recv_ok | recv_scattered
        li = torch.zeros((hit.p.shape[0], 3), dtype=torch.float32,
                         device=hit.p.device)
        for i in range(n_chunks):
            c = {k: v[i * vc:(i + 1) * vc] for k, v in fields.items()}
            li = li + self._gather_chunk(scene, hit, recv_ok, c,
                                         recv_scattered, recv_p, recv_d)
        return li * vpls.norm

    def compute_pixel(self, scene, pix, stream):
        n = pix.shape[0]
        vpls = self.generate_vpls(scene, stream_fold(stream, 999))
        u_pix, stream = stream_next2d(stream, (n,))
        o, d = generate_rays(scene.camera, pix.to(torch.float32) + u_pix)
        rh = intersect_rays(scene.geom, o, d)
        hit = fill_hit(scene, o, d, rh)
        front = hit.valid & (hit.wi[..., 2] > 0.0)
        le = emitted_radiance(scene.emitters, scene.geom, hit.tri, d,
                              uv=hit.uv)
        if scene.volume is not None:
            # the camera segment's medium interaction
            u_med, stream = stream_next(stream, (n,))
            sdm = volume_sample_distance(
                scene.volume, torch.where(rh.hit, rh.t, 1e8), u_med)
            scattered = ~sdm.exited
            front = front & (~scattered)
            li = torch.where(front[:, None], le * sdm.w, 0.0)
            gath = self._gather_surface(scene, hit, front, vpls,
                                        recv_scattered=scattered,
                                        recv_p=o + d * sdm.t[:, None],
                                        recv_d=d)
            return li + gath * sdm.w
        li = torch.where((~hit.valid)[:, None],
                         env_radiance(scene.emitters, d), 0.0)
        li = li + torch.where(front[:, None], le, 0.0)
        return li + self._gather_surface(scene, hit, front, vpls)

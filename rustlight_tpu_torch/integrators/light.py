"""Adjoint particle tracing (light tracing) with camera splatting; port of
rustlight_tpu/integrators/light.py.

Light paths start on an emitter atom of any kind (`sample_position`: a
triangle's flux weight is Le * pi / pdf; point, directional, point-normal
and environment atoms start as the reference starts them, and only
triangle atoms splat their vertex 0), bounce by BSDF sampling, and at every vertex connect to the
pinhole camera: the splat is flux * W_e * f(wi, w_cam; Radiance) * the
shading-normal correction (emitter vertices splat flux * W_e * cos / pi).
`render_splat` scatter-adds the splats into the film and scales it by
W * H / paths.

Kept from the reference: bounces use the importance transport while the
splat connection uses the radiance transport with the explicit adjoint
correction factor. In a medium, a scattering lane bounces by the phase
function, and `render_volume` splats its medium vertex through the phase
function; every splat is attenuated by the transmittance to the camera.

Each path is traced for `cap` bounces, dead or alive, as the reference's
`lax.scan` does: a Python loop of `cap` steps with no host read. Draws per
lane, in the reference's order: u_sel, u_pos, u_dir, then each bounce u_med
(only with a medium), u_b (n,2), u_rr.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..accel import intersect_rays, visible
from ..bsdfs import bsdf_eval, bsdf_sample, bsdf_is_smooth
from ..bsdfs.table import TRANSPORT_IMPORTANCE, TRANSPORT_RADIANCE
from ..scene import fill_hit, sample_position, sample_emission_direction
from ..scene.camera import sample_direct
from ..scene.emitters import ATOM_TRI
from ..scene.scene import offset_ray_origin
from ..scene.volume import (phase_eval, phase_sample, transmittance,
                            volume_sample_distance)
from ..utils.frame import to_world, to_local
from ..utils.rng import stream_next, stream_next2d
from ..utils.vec import channel_max, dot, length, normalize
from .common import SplattingIntegrator


class IntegratorLightTracing(SplattingIntegrator):
    def __init__(self, max_depth: Optional[int] = None,
                 min_depth: Optional[int] = None,
                 rr_depth: Optional[int] = 0,
                 render_surface: bool = True,
                 render_volume: bool = False,
                 hard_cap: int = 32):
        self.max_depth = max_depth
        self.min_depth = min_depth or 0
        self.rr_depth = rr_depth
        self.render_surface = render_surface
        self.render_volume = render_volume
        self.cap = hard_cap if max_depth is None else min(hard_cap, max_depth)

    def trace_paths(self, scene, n, stream):
        """Trace n light paths; returns (pixel ids [(cap+1)*n] int32, values
        [(cap+1)*n, 3]), the emitter vertices' splats first, then each
        bounce's. A splat that does not count goes to pixel 0 with value 0."""
        cam = scene.camera
        cam_pos = cam.position
        vol = scene.volume

        def splat_from(p, n_vec, value_rgb, active):
            """Connect p to the camera: (pid, value), zeroed where invalid
            or occluded."""
            w_e, pixel = sample_direct(cam, p)
            o = offset_ray_origin(p, n_vec, normalize(cam_pos - p))
            ok = active & (w_e > 0.0)
            vis = visible(scene.geom, o, cam_pos.expand(p.shape), mask=ok)
            scale = w_e[:, None]
            if vol is not None:
                scale = scale * transmittance(vol, length(cam_pos - p))
            val = value_rgb * scale
            ok = ok & vis
            px = torch.clamp(pixel[:, 0].to(torch.int32), 0, cam.width - 1)
            py = torch.clamp(pixel[:, 1].to(torch.int32), 0, cam.height - 1)
            return (torch.where(ok, py * cam.width + px, 0),
                    torch.where(ok[:, None], val, 0.0))

        # ---- emitter vertex (depth 0)
        u_sel, stream = stream_next(stream, (n,))
        u_pos, stream = stream_next2d(stream, (n,))
        ps = sample_position(scene.emitters, scene.geom, u_sel, u_pos)
        cosl = torch.clamp(dot(ps.n, normalize(cam_pos - ps.p)), min=0.0)
        splat_ok0 = ps.valid & (ps.kind == ATOM_TRI)
        if self.min_depth > 0 or not self.render_surface:
            splat_ok0 = torch.zeros_like(splat_ok0)
        pids, vals = [], []
        pid, val = splat_from(ps.p, ps.n, ps.weight * (cosl / math.pi)[:, None],
                              splat_ok0)
        pids.append(pid)
        vals.append(val)

        # ---- emission direction
        u_dir, stream = stream_next2d(stream, (n,))
        d, pdf_dir, w_dir = sample_emission_direction(scene.emitters, ps, u_dir)
        throughput = ps.weight * w_dir
        o = offset_ray_origin(ps.p, ps.n, d)
        alive = ps.valid & (pdf_dir > 0.0)

        for k in range(self.cap):
            rh = intersect_rays(scene.geom, o, d)
            hit = fill_hit(scene, o, d, rh)
            if vol is not None:
                u_med, stream = stream_next(stream, (n,))
                sd = volume_sample_distance(
                    vol, torch.where(rh.hit, rh.t, 1e8), u_med)
                scattered = alive & (~sd.exited)
                throughput = throughput * sd.w
                p_scatter = o + d * sd.t[:, None]
            else:
                scattered = torch.zeros_like(alive)
            lane = alive & hit.valid & (~scattered)
            depth_ok = (k + 1) >= self.min_depth

            # ---- splat the surface vertex (depth k+1)
            d_cam = normalize(cam_pos - hit.p)
            wo_cam = to_local(hit.frame, d_cam)
            f_cam = bsdf_eval(scene.materials, hit.mat, hit.uv, hit.wi, wo_cam,
                              TRANSPORT_RADIANCE)
            wi_world = to_world(hit.frame, hit.wi)
            # the adjoint shading-normal correction
            num = hit.wi[:, 2] * dot(d_cam, hit.n_g)
            den = wo_cam[:, 2] * dot(wi_world, hit.n_g)
            corr = torch.where(torch.abs(den) > 1e-12, num / den, 0.0)
            smooth = bsdf_is_smooth(scene.materials, hit.mat)
            splat_ok = lane & (~smooth)
            if not (depth_ok and self.render_surface):
                splat_ok = torch.zeros_like(splat_ok)
            pid, val = splat_from(hit.p, hit.n_g,
                                  throughput * f_cam * corr[:, None], splat_ok)

            # ---- splat the medium vertex: the phase function for the BSDF
            if vol is not None:
                d_cam_v = normalize(cam_pos - p_scatter)
                ph = phase_eval(vol.phase_g, -d, d_cam_v)
                splat_ok_v = scattered
                if not (depth_ok and self.render_volume):
                    splat_ok_v = torch.zeros_like(splat_ok_v)
                pid_v, val_v = splat_from(p_scatter, d_cam_v,
                                          throughput * ph[:, None], splat_ok_v)
                pid = torch.where(scattered, pid_v, pid)
                val = torch.where(scattered[:, None], val_v, val)
            pids.append(pid)
            vals.append(val)

            # ---- bounce (importance transport, as the reference)
            u_b, stream = stream_next2d(stream, (n,))
            bs = bsdf_sample(scene.materials, hit.mat, hit.uv, hit.wi, u_b,
                             TRANSPORT_IMPORTANCE)
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
            if self.rr_depth is None:
                keep = torch.ones_like(alive)
            else:
                do_rr = (k + 1) >= self.rr_depth
                rr_p = torch.clamp(channel_max(new_thr), max=0.95)
                keep = (u_rr < rr_p) if do_rr else torch.ones_like(alive)
                if do_rr:
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

        return torch.cat(pids), torch.cat(vals)

"""Gradient-domain path tracing, reconnection shift; port of
rustlight_tpu/integrators/gradient/reconnect.py.

Each of the four offset paths starts one pixel away; at the first bounce
where the base path's current and next vertices and the offset's vertex
are all rough, the offset path reconnects to the base path's next vertex
(geometry-ratio jacobian, BSDF re-evaluated), and from then on rides the
base path's decisions:

  NOT_CONNECTED -> (reconnect) -> RECENTLY_CONNECTED -> CONNECTED

RECENTLY_CONNECTED re-evaluates the base vertex's BSDF with the shifted
incoming direction once; CONNECTED reuses the base path's values scaled by
the pdf ratio. Delta chains take the half-vector copy, realized as a
same-randoms replay of `bsdf_sample` at the offset vertex (exact for delta
lobes). Per-strategy MIS between base and offset follows the reference's
weight algebra, the 1e-4-regularized dead-shift denominator and the
no-light-MIS rule for half-vector shifts included.

Dot products and squared lengths are the port's utils/vec.py forms,
summed in a fixed order, so that the card and the CPU trace the same
reconnections. One wavefront lane a base pixel; the four offset states are carried as
structures of tensors, every per-state branch evaluated for all lanes and
selected by mask. The `very_direct` (camera to light) buffer bypasses the
reconstruction. Each bounce draws, in order, u_sel (n,), u_pos (n, 2),
u_b (n, 2) and u_rr (n,), after the pixel jitter u_pix (n, 2).

Loop shape: the reference's `while_loop` tests any(m_alive) before every
bounce; here the test is read on the host every CHECK_EVERY bounces and
the loop never passes the reference's cap (depth <= hard_cap, depth <
max_depth). A bounce with no base path alive adds nothing.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ...accel import intersect_rays, visible
from ...bsdfs import bsdf_eval, bsdf_pdf, bsdf_sample, bsdf_is_smooth
from ...bsdfs.table import TRANSPORT_IMPORTANCE
from ...scene import (direct_pdf_tri, emitted_radiance, fill_hit,
                      generate_rays, sample_light)
from ...scene.scene import offset_ray_origin
from ...utils.frame import to_local, to_world
from ...utils.rng import make_stream, stream_fold, stream_next, stream_next2d
from ...utils.vec import channel_max, dot, length, length2
from ..common import _pixel_grid
from ..path import CHECK_EVERY
from .path import (_NB_BUFFERS, _OFFSETS, _mesh_pass, _offset_inside,
                   _render_gradient_film, _shift2d)

_DEAD, _NC, _RC, _CN = 0, 1, 2, 3
_TI = TRANSPORT_IMPORTANCE


class _OffState(NamedTuple):
    code: Any   # [n] int32 state
    thr: Any    # [n, 3]
    pdf: Any    # [n]
    its: Any    # Hit at the offset path's own last vertex (NOT_CONNECTED;
    #             the pre-connection vertex while RECENTLY_CONNECTED)


def _sel_hit(mask, a, b):
    """Per-lane select between two Hit records (nested tuples of
    tensors)."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return type(a)(*(_sel_hit(mask, x, y) for x, y in zip(a, b))) \
            if hasattr(a, "_fields") else tuple(
                _sel_hit(mask, x, y) for x, y in zip(a, b))
    m = mask.reshape((-1,) + (1,) * (a.ndim - 1))
    return torch.where(m, a, b)


def _normalize(v):
    return v / torch.clamp(length(v), min=1e-20)[:, None]


def _pick(conds, vals, default):
    """First value whose condition holds, else `default` (nested where)."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        if v.ndim > c.ndim:
            c = c[:, None]
        out = torch.where(c, v, out)
    return out


def reconnection_jacobian(n2, wo_main, t_main, wo_shift, dist_sq_shift):
    """Solid-angle measure ratio |dw'/dw| of moving the predecessor vertex
    x1 -> x1' while the reconnection vertex x2 stays: G(x1'<->x2) /
    G(x1<->x2) with the shared cosine at x1 cancelled,
    |cos(n2, -wo')| t^2 / (|cos(n2, -wo)| d'^2)."""
    return (torch.abs(dot(n2, -wo_shift)) * t_main ** 2
            / torch.clamp(torch.abs(dot(n2, -wo_main)) * dist_sq_shift,
                          min=1e-20))


def _nan_to_zero(x):
    return torch.nan_to_num(x, posinf=0.0)


class IntegratorGradientPathReconnect:
    """`gradient-path`: the reconnection shift."""

    def __init__(self, max_depth: Optional[int] = None,
                 min_depth: Optional[int] = None,
                 recons: str = "uniform", recons_iterations: int = 50,
                 nb_buffers: Optional[int] = None, hard_cap: int = 8):
        self.max_depth = max_depth
        self.min_depth = min_depth
        self.recons = recons
        self.iterations = recons_iterations
        self.hard_cap = hard_cap if max_depth is None else min(hard_cap,
                                                               max_depth)
        self.nb_buffers = nb_buffers or _NB_BUFFERS[recons]

    def _trace_state(self, scene, pixf, dx, dy, w, h):
        """The primary-hit offset state for the displacement (dx, dy)."""
        pixo = pixf + torch.tensor([dx, dy], dtype=torch.float32,
                                   device=pixf.device)
        inside = ((pixo[:, 0] >= 0) & (pixo[:, 0] <= w)
                  & (pixo[:, 1] >= 0) & (pixo[:, 1] <= h))
        o, d = generate_rays(scene.camera, pixo)
        hit = fill_hit(scene, o, d, intersect_rays(scene.geom, o, d))
        n = pixf.shape[0]
        code = torch.where(inside & hit.valid & (hit.wi[:, 2] > 0), _NC,
                           _DEAD).to(torch.int32)
        return _OffState(code=code,
                         thr=torch.ones((n, 3), dtype=torch.float32,
                                        device=pixf.device),
                         pdf=torch.ones(n, dtype=torch.float32,
                                        device=pixf.device), its=hit)

    def compute_pixel_gradient(self, scene, pix, stream, has_delta: bool):
        """One pass: (l_main, [4] l_off, [4] l_grad, very_direct), each
        [n, 3]."""
        n = pix.shape[0]
        w, h = scene.camera.width, scene.camera.height
        geom = scene.geom
        u_pix, stream = stream_next2d(stream, (n,))
        pixf = pix.to(torch.float32) + u_pix
        o_m, d_m = generate_rays(scene.camera, pixf)
        rh = intersect_rays(geom, o_m, d_m)
        mh = fill_hit(scene, o_m, d_m, rh)
        m_alive = rh.hit & mh.valid & (mh.wi[:, 2] > 0)
        offs = [self._trace_state(scene, pixf, dx, dy, w, h)
                for (dy, dx, _, _) in _OFFSETS]
        zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=pix.device)
        c = dict(stream=stream, mh=mh, m_d=d_m,
                 m_thr=torch.ones_like(zeros3),
                 m_pdf=torch.ones(n, dtype=torch.float32, device=pix.device),
                 m_alive=m_alive, offs=offs, l_main=zeros3,
                 l_off=[zeros3] * 4, l_grad=[zeros3] * 4, vdirect=zeros3)
        depth = 1
        while (depth <= self.hard_cap
               and (self.max_depth is None or depth < self.max_depth)):
            if (depth - 1) % CHECK_EVERY == 0 and not bool(
                    torch.any(c["m_alive"])):
                break
            c = self._bounce(scene, c, depth, has_delta)
            depth += 1
        return c["l_main"], c["l_off"], c["l_grad"], c["vdirect"]

    def _bounce(self, scene, c, depth: int, has_delta: bool):
        """One iteration of the reference's loop body: very direct, NEE
        for the base and the four offsets, the BSDF bounce with the shift
        and its state transitions, Russian roulette."""
        mat, em, geom = scene.materials, scene.emitters, scene.geom
        stream = c["stream"]
        mh, m_thr, m_pdf, m_alive = c["mh"], c["m_thr"], c["m_pdf"], \
            c["m_alive"]
        offs = c["offs"]
        n = m_alive.shape[0]
        l_main, l_off, l_grad = c["l_main"], list(c["l_off"]), \
            list(c["l_grad"])
        min_ok = self.min_depth is None or depth >= self.min_depth

        # ---- very direct (camera -> light), depth 1
        le0 = emitted_radiance(em, geom, mh.tri, c["m_d"], uv=mh.uv)
        vdirect = c["vdirect"]
        if depth == 1 and min_ok:
            vdirect = vdirect + torch.where(m_alive[:, None], le0, 0.0)

        m_smooth = bsdf_is_smooth(mat, mh.mat)

        # ================================ NEE
        u_sel, stream = stream_next(stream, (n,))
        u_pos, stream = stream_next2d(stream, (n,))
        ls_m = sample_light(em, geom, mh.p, u_sel, u_pos)
        vis_m = visible(geom, offset_ray_origin(mh.p, mh.n_g, ls_m.d),
                        ls_m.p)
        wo_lm = to_local(mh.frame, ls_m.d)
        f_m = bsdf_eval(mat, mh.mat, mh.uv, mh.wi, wo_lm, _TI)
        pdf_bm = torch.where(vis_m, bsdf_pdf(mat, mh.mat, mh.uv, mh.wi,
                                             wo_lm, _TI), 0.0)
        pm = ls_m.pdf
        rad_m = torch.where((vis_m & ls_m.valid)[:, None], ls_m.weight, 0.0)
        num = pm
        dem = pm + pdf_bm
        main_contrib = m_thr * f_m * rad_m
        cos_lm = dot(ls_m.n, ls_m.d)
        dsq_m = length2(mh.p - ls_m.p)
        nee_on = m_alive & (~m_smooth) & ls_m.valid & (pm > 0.0)
        if not min_ok:
            nee_on = torch.zeros_like(nee_on)

        for i, s in enumerate(offs):
            ratio = s.pdf / torch.clamp(m_pdf, min=1e-30)
            # CONNECTED: the base's values
            dem_cn = ratio * (pm + pdf_bm)
            ctb_cn = s.thr * f_m * rad_m
            # RECENTLY_CONNECTED: the incoming direction re-evaluated
            d_in = _normalize(s.its.p - mh.p)
            wi_l = to_local(mh.frame, d_in)
            ok_rc = (wi_l[:, 2] > 0.0) & vis_m
            f_rc = bsdf_eval(mat, mh.mat, mh.uv, wi_l, wo_lm, _TI)
            pdf_rc = bsdf_pdf(mat, mh.mat, mh.uv, wi_l, wo_lm, _TI)
            dem_rc = torch.where(ok_rc, ratio * (pm + pdf_rc), 0.0)
            ctb_rc = torch.where(ok_rc[:, None], s.thr * f_rc * rad_m, 0.0)
            # NOT_CONNECTED: its own light sample and the jacobian
            s_smooth = bsdf_is_smooth(mat, s.its.mat)
            ls_s = sample_light(em, geom, s.its.p, u_sel, u_pos)
            vis_s = visible(geom, offset_ray_origin(s.its.p, s.its.n_g,
                                                    ls_s.d), ls_s.p)
            rad_s = torch.where(
                (vis_s & ls_s.valid)[:, None],
                ls_s.weight * (ls_s.pdf / torch.clamp(pm, min=1e-30))[:, None],
                0.0)
            wo_ls = to_local(s.its.frame, ls_s.d)
            f_nc = bsdf_eval(mat, s.its.mat, s.its.uv, s.its.wi, wo_ls, _TI)
            pdf_ncb = torch.where(vis_s, bsdf_pdf(
                mat, s.its.mat, s.its.uv, s.its.wi, wo_ls, _TI), 0.0)
            cos_ls = dot(ls_s.n, ls_s.d)
            dsq_s = length2(s.its.p - ls_s.p)
            jac = (torch.abs(cos_ls * dsq_m)
                   / torch.clamp(torch.abs(cos_lm * dsq_s), min=1e-20))
            ok_nc = ~s_smooth
            dem_nc = torch.where(ok_nc, jac * ratio * (ls_s.pdf + pdf_ncb),
                                 0.0)
            ctb_nc = torch.where(ok_nc[:, None],
                                 jac[:, None] * s.thr * f_nc * rad_s, 0.0)
            # the dead shift's regularized denominator
            dem_dead = num / (1e-4 + dem)

            is_cn, is_rc, is_nc = s.code == _CN, s.code == _RC, s.code == _NC
            dem_s = _pick((is_cn, is_rc, is_nc), (dem_cn, dem_rc, dem_nc),
                          dem_dead)
            ctb_s = _pick((is_cn, is_rc, is_nc), (ctb_cn, ctb_rc, ctb_nc),
                          torch.zeros_like(ctb_cn))
            wgt = torch.where(nee_on,
                              num / torch.clamp(dem + dem_s, min=1e-30), 0.0)
            # masked-out lanes may carry inf or NaN: select, then add
            gate = (wgt > 0.0)[:, None]
            wg = wgt[:, None]
            l_main = l_main + torch.where(gate, main_contrib * wg, 0.0)
            l_off[i] = l_off[i] + torch.where(gate, ctb_s * wg, 0.0)
            l_grad[i] = l_grad[i] + torch.where(
                gate, (ctb_s - main_contrib) * wg, 0.0)

        # ================================ BSDF bounce
        u_b, stream = stream_next2d(stream, (n,))
        bs = bsdf_sample(mat, mh.mat, mh.uv, mh.wi, u_b, _TI)
        wo_w = to_world(mh.frame, bs.wo)
        o_new = offset_ray_origin(mh.p, mh.n_g, wo_w)
        rh2 = intersect_rays(geom, o_new, wo_w)
        nh = fill_hit(scene, o_new, wo_w, rh2)
        hit_ok = rh2.hit & nh.valid

        is_l = nh.is_light & (nh.wi[:, 2] > 0.0) & hit_ok
        light_pdf = torch.where(is_l, direct_pdf_tri(em, nh.tri, mh.p, nh.p,
                                                     nh.n_g, wo_w), 0.0)
        rad = torch.where(is_l[:, None],
                          emitted_radiance(em, geom, nh.tri, wo_w, uv=nh.uv),
                          0.0)
        m_pdf_new = m_pdf * bs.pdf
        m_thr_new = m_thr * bs.weight
        m_ok = (m_alive & bs.valid & hit_ok & (m_pdf_new > 0.0)
                & (channel_max(m_thr_new) > 0.0))
        num_b = bs.pdf
        main_contrib_b = m_thr_new * rad
        next_smooth = bsdf_is_smooth(mat, nh.mat)

        new_offs = []
        for i, s in enumerate(offs):
            ratio = s.pdf / torch.clamp(m_pdf, min=1e-30)
            is_cn, is_rc, is_nc = s.code == _CN, s.code == _RC, s.code == _NC

            # CONNECTED
            thr_cn = s.thr * bs.weight
            pdf_cn = s.pdf * bs.pdf
            dem_cn = ratio * (bs.pdf + light_pdf)
            ctb_cn = thr_cn * rad

            # RECENTLY_CONNECTED
            d_in = _normalize(s.its.p - mh.p)
            wi_l = to_local(mh.frame, d_in)
            ok_rc = (~m_smooth) & (wi_l[:, 2] > 0.0)
            f_rc = bsdf_eval(mat, mh.mat, mh.uv, wi_l, bs.wo, _TI)
            pdf_rcb = bsdf_pdf(mat, mh.mat, mh.uv, wi_l, bs.wo, _TI)
            thr_rc = s.thr * f_rc / torch.clamp(bs.pdf, min=1e-30)[:, None]
            pdf_rc = s.pdf * pdf_rcb
            dem_rc = torch.where(ok_rc, ratio * (pdf_rcb + light_pdf), 0.0)
            ctb_rc = torch.where(ok_rc[:, None], thr_rc * rad, 0.0)

            # NOT_CONNECTED -> reconnection
            s_smooth = bsdf_is_smooth(mat, s.its.mat)
            reconn = (~m_smooth) & (~next_smooth) & (~s_smooth) & hit_ok
            dir_sc = nh.p - s.its.p
            dsq = torch.clamp(length2(dir_sc), min=1e-20)
            wo_s = dir_sc / torch.sqrt(dsq)[:, None]
            vis_r = visible(geom, offset_ray_origin(s.its.p, s.its.n_g, wo_s),
                            nh.p)
            jac = reconnection_jacobian(nh.n_g, wo_w, rh2.t, wo_s, dsq)
            wo_s_l = to_local(s.its.frame, wo_s)
            f_re = bsdf_eval(mat, s.its.mat, s.its.uv, s.its.wi, wo_s_l, _TI)
            pdf_reb = bsdf_pdf(mat, s.its.mat, s.its.uv, s.its.wi, wo_s_l,
                               _TI)
            thr_re = s.thr * f_re * (
                jac / torch.clamp(bs.pdf, min=1e-30))[:, None]
            pdf_re = s.pdf * pdf_reb * jac
            sh_em_pdf = torch.where(is_l, direct_pdf_tri(
                em, nh.tri, s.its.p, nh.p, nh.n_g, wo_s), 0.0)
            dem_re = ratio * (pdf_reb + sh_em_pdf)
            ctb_re = thr_re * rad   # rad is 0 where the base missed a light
            ok_re = reconn & vis_r

            # NOT_CONNECTED -> half-vector copy by a same-randoms replay
            hv_ok = is_nc & (~reconn) & m_smooth & s_smooth
            if has_delta:
                bs_s = bsdf_sample(mat, s.its.mat, s.its.uv, s.its.wi, u_b,
                                   _TI)
                thr_hv = s.thr * bs_s.weight * bs_s.pdf[:, None]
                pdf_hv = s.pdf * bs_s.pdf
                wo_sw = to_world(s.its.frame, bs_s.wo)
                o_s = offset_ray_origin(s.its.p, s.its.n_g, wo_sw)
                rh_s = intersect_rays(geom, o_s, wo_sw)
                sh = fill_hit(scene, o_s, wo_sw, rh_s)
                hv_live = hv_ok & bs_s.valid & rh_s.hit & sh.valid
                rad_hv = torch.where(
                    (sh.is_light & hv_live)[:, None],
                    emitted_radiance(em, geom, sh.tri, wo_sw, uv=sh.uv), 0.0)
                ctb_hv = torch.where(hv_live[:, None], thr_hv * rad_hv, 0.0)
                dem_hv = torch.where(hv_live, pdf_hv, 0.0)
            else:
                hv_live = torch.zeros_like(hv_ok)
                thr_hv, pdf_hv = s.thr, s.pdf
                ctb_hv = torch.zeros_like(s.thr)
                dem_hv = torch.zeros_like(s.pdf)

            half_vec = is_nc & (~reconn)
            nc_re = is_nc & reconn
            dem_s = _pick((is_cn, is_rc, nc_re, half_vec),
                          (dem_cn, dem_rc, torch.where(ok_re, dem_re, 0.0),
                           dem_hv), torch.zeros_like(dem_cn))
            ctb_s = _pick((is_cn, is_rc, nc_re & ok_re, half_vec),
                          (ctb_cn, ctb_rc, ctb_re, ctb_hv),
                          torch.zeros_like(ctb_cn))
            # half-vector shifts do not MIS against the light strategy
            main_dem = torch.where(half_vec, num_b, num_b + light_pdf)
            wgt = torch.where(m_ok, num_b / torch.clamp(main_dem + dem_s,
                                                        min=1e-30), 0.0)
            if not min_ok:
                wgt = torch.zeros_like(wgt)
            gate = (wgt > 0.0)[:, None]
            wg = wgt[:, None]
            l_main = l_main + torch.where(gate, main_contrib_b * wg, 0.0)
            l_off[i] = l_off[i] + torch.where(gate, ctb_s * wg, 0.0)
            l_grad[i] = l_grad[i] + torch.where(
                gate, (ctb_s - main_contrib_b) * wg, 0.0)

            # ---- state transitions
            i32 = lambda v: torch.full_like(s.code, v)  # noqa: E731
            new_code = _pick(
                (is_cn, is_rc, nc_re),
                (i32(_CN), torch.where(ok_rc, _CN, _DEAD).to(torch.int32),
                 torch.where(ok_re, _RC, _DEAD).to(torch.int32)),
                torch.where(hv_live, _NC, _DEAD).to(torch.int32))
            new_code = torch.where(m_ok, new_code, _DEAD).to(torch.int32)
            pick_rc = is_rc & ok_rc
            pick_re = nc_re & ok_re
            pick_hv = is_nc & (~reconn) & hv_live
            new_thr = _pick((is_cn, pick_rc, pick_re, pick_hv),
                            (thr_cn, thr_rc, thr_re, thr_hv), s.thr)
            new_pdf = _pick((is_cn, pick_rc, pick_re, pick_hv),
                            (pdf_cn, pdf_rc, pdf_re, pdf_hv), s.pdf)
            new_its = _sel_hit(pick_hv, sh, s.its) if has_delta else s.its
            live = new_code != _DEAD
            new_thr = torch.where(live[:, None], _nan_to_zero(new_thr), 0.0)
            new_pdf = torch.where(live, _nan_to_zero(new_pdf), 0.0)
            new_offs.append(_OffState(code=new_code, thr=new_thr,
                                      pdf=new_pdf, its=new_its))

        # ---- Russian roulette on the base path
        u_rr, stream = stream_next(stream, (n,))
        rr_p = torch.clamp(channel_max(m_thr_new), max=0.95)
        keep = u_rr <= rr_p
        inv = (1.0 / torch.clamp(rr_p, min=1e-8))[:, None]
        m_thr_new = m_thr_new * inv
        new_offs = [o._replace(thr=o.thr * inv) for o in new_offs]
        m_alive_new = m_ok & keep
        an = m_alive_new[:, None]
        return dict(
            stream=stream, mh=_sel_hit(m_alive_new, nh, mh),
            m_d=torch.where(an, wo_w, c["m_d"]),
            m_thr=torch.where(an, m_thr_new, m_thr),
            m_pdf=torch.where(m_alive_new, m_pdf_new, m_pdf),
            m_alive=m_alive_new, offs=new_offs, l_main=l_main, l_off=l_off,
            l_grad=l_grad, vdirect=vdirect)

    def render(self, scene, spp: int, seed: int = 0, mesh=None):
        """`mesh`: each rank traces its row band, and the passes are
        assembled and reconstructed whole on every rank (gradient/path.py:
        _mesh_pass)."""
        w, h = scene.camera.width, scene.camera.height
        base = make_stream(seed, scene.device)
        has_delta = self.has_delta(scene)
        if mesh is None:
            def one_pass(s):
                return self.one_pass(scene, stream_fold(base, s), has_delta)
        else:
            def one_pass(s):
                return _mesh_pass(
                    mesh, scene, stream_fold(base, s),
                    lambda sc, pix, st: self.lanes(sc, pix, st, has_delta),
                    self.assemble)
        return _render_gradient_film(scene, spp, one_pass, self.nb_buffers,
                                     self.recons, self.iterations, w, h)

    @staticmethod
    def has_delta(scene) -> bool:
        """Whether the half-vector replay can matter: some material of the
        scene is smooth (without one its lanes select nothing)."""
        if scene.host is None:
            return True
        return bool(np.any(np.asarray(scene.host.materials.smooth)))

    def one_pass(self, scene, stream, has_delta: bool = True):
        """One sample of every pixel: (primal, gradient_x, gradient_y,
        very_direct), each [n, 3]."""
        w, h = scene.camera.width, scene.camera.height
        pix = torch.as_tensor(_pixel_grid(w, h), device=scene.device)
        return self.assemble(scene, self.lanes(scene, pix, stream,
                                               has_delta))

    def lanes(self, scene, pix, stream, has_delta: bool = True):
        """The per-lane results of the lanes `pix` [m, 2]: [m, 10, 3], the
        main path's radiance, the four offsets', the four gradients and
        the very direct light."""
        l_main, l_off, l_grad, vdir = self.compute_pixel_gradient(
            scene, pix, stream, has_delta)
        return torch.stack([l_main, *l_off, *l_grad, vdir], dim=1)

    def assemble(self, scene, res):
        """The film of one pass from every lane's `lanes` results [n, 10,
        3]: (primal, gradient_x, gradient_y, very_direct), each [n, 3]."""
        w, h = scene.camera.width, scene.camera.height
        n = w * h
        pix = torch.as_tensor(_pixel_grid(w, h), device=scene.device)
        px, py = pix[:, 0], pix[:, 1]
        l_main, vdir = res[:, 0], res[:, 9]
        l_off = [res[:, 1 + i] for i in range(4)]
        l_grad = [res[:, 5 + i] for i in range(4)]
        # the main path contributes at its pixel for each of the four
        # strategies; the offsets land at their displaced pixel
        primal = l_main.reshape(h, w, 3)
        grads = {"x": torch.zeros_like(primal), "y": torch.zeros_like(primal)}
        for i, (dy, dx, axis, sign) in enumerate(_OFFSETS):
            inside = _offset_inside(px, py, dx, dy, w, h)
            offv = torch.where(inside, l_off[i].reshape(h, w, 3), 0.0)
            primal = primal + _shift2d(offv, dy, dx)
            g = l_grad[i].reshape(h, w, 3)
            if sign > 0:
                grads[axis] = grads[axis] + g
            else:
                grads[axis] = grads[axis] - _shift2d(
                    torch.where(inside, g, 0.0), dy, dx)
        return (primal.reshape(n, 3) * 0.25, grads["x"].reshape(n, 3),
                grads["y"].reshape(n, 3), vdir)

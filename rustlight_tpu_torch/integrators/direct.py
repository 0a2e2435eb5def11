"""Direct-lighting integrator with light/BSDF MIS; port of
rustlight_tpu/integrators/direct.py (reference src/integrators/direct.rs:
5-234).

N light samples and M BSDF samples combined with the power heuristic, one
sample of every pixel a call (the per-pass route of `render`). It draws its
uniforms in the reference's order and shapes: u_pix (n, 2), then per light
sample u_sel (n,) and u_pos (n, 2), then per BSDF sample u_b (n, 2), so the
two packages render sample for sample alike. Escaped primary rays see the
environment, and an escaped BSDF sample picks it up under the power
heuristic against the environment's NEE pdf.
"""
from __future__ import annotations

import torch

from ..accel import intersect_rays, visible
from ..bsdfs import bsdf_eval, bsdf_is_smooth, bsdf_pdf, bsdf_sample
from ..bsdfs.table import TRANSPORT_IMPORTANCE
from ..scene import (direct_pdf_tri, emitted_radiance, env_direction_pdf,
                     env_radiance, fill_hit, generate_rays, sample_light)
from ..scene.scene import offset_ray_origin
from ..utils.frame import to_local, to_world
from ..utils.rng import stream_next, stream_next2d
from .common import mis_power


class IntegratorDirect:
    def __init__(self, nb_bsdf_samples: int = 1, nb_light_samples: int = 1):
        self.nb_bsdf_samples = nb_bsdf_samples
        self.nb_light_samples = nb_light_samples

    def compute_pixel(self, scene, pix, stream):
        """One direct-lighting sample of every pixel in pix [n, 2]: [n, 3]."""
        n = pix.shape[0]
        u_pix, stream = stream_next2d(stream, (n,))
        o, d = generate_rays(scene.camera, pix.to(torch.float32) + u_pix)
        rh = intersect_rays(scene.geom, o, d)
        hit = fill_hit(scene, o, d, rh)

        # escaped primary rays see the environment; directly visible emission
        li = torch.where((~hit.valid)[:, None],
                         env_radiance(scene.emitters, d), 0.0)
        front = hit.valid & (hit.wi[..., 2] > 0.0)
        li = li + torch.where(front[:, None], emitted_radiance(
            scene.emitters, scene.geom, hit.tri, d, uv=hit.uv), 0.0)

        w_nb_b = 1.0 / self.nb_bsdf_samples if self.nb_bsdf_samples else 0.0
        w_nb_l = 1.0 / self.nb_light_samples if self.nb_light_samples else 0.0
        smooth = bsdf_is_smooth(scene.materials, hit.mat)
        mats = scene.materials

        # ---------------- light sampling
        for _ in range(self.nb_light_samples):
            u_sel, stream = stream_next(stream, (n,))
            u_pos, stream = stream_next2d(stream, (n,))
            ls = sample_light(scene.emitters, scene.geom, hit.p, u_sel, u_pos)
            wo_l = to_local(hit.frame, ls.d)
            pre_ok = front & (~smooth) & ls.valid
            vis = visible(scene.geom, offset_ray_origin(hit.p, hit.n_g, ls.d),
                          ls.p, mask=pre_ok)
            pdf_b = bsdf_pdf(mats, hit.mat, hit.uv, hit.wi, wo_l,
                             TRANSPORT_IMPORTANCE)
            w = torch.where(ls.is_delta, 1.0,
                            mis_power(ls.pdf * w_nb_l, pdf_b * w_nb_b))
            f = bsdf_eval(mats, hit.mat, hit.uv, hit.wi, wo_l,
                          TRANSPORT_IMPORTANCE)
            ok = pre_ok & vis
            li = li + torch.where(ok[:, None],
                                  f * ls.weight * (w * w_nb_l)[:, None], 0.0)

        # ---------------- BSDF sampling
        for _ in range(self.nb_bsdf_samples):
            u_b, stream = stream_next2d(stream, (n,))
            bs = bsdf_sample(mats, hit.mat, hit.uv, hit.wi, u_b,
                             TRANSPORT_IMPORTANCE)
            d2 = to_world(hit.frame, bs.wo)
            o2 = offset_ray_origin(hit.p, hit.n_g, d2)
            rh2 = intersect_rays(scene.geom, o2, d2)
            hit2 = fill_hit(scene, o2, d2, rh2)

            # hit an area light (emitted_radiance checks the front side)
            le2 = emitted_radiance(scene.emitters, scene.geom, hit2.tri, d2,
                                   uv=hit2.uv)
            pdf_l = direct_pdf_tri(scene.emitters, hit2.tri, o2, hit2.p,
                                   hit2.n_g, d2)
            w = torch.where(bs.is_delta, 1.0,
                            mis_power(bs.pdf * w_nb_b, pdf_l * w_nb_l))
            ok = front & bs.valid & hit2.valid
            li = li + torch.where(ok[:, None],
                                  bs.weight * le2 * (w * w_nb_b)[:, None], 0.0)

            # escaped toward the environment
            if scene.emitters.has_env:
                pdf_env = env_direction_pdf(scene.emitters, d2)
                w_env = torch.where(bs.is_delta, 1.0, mis_power(
                    bs.pdf * w_nb_b, pdf_env * w_nb_l))
                ok_env = front & bs.valid & (~hit2.valid)
                li = li + torch.where(
                    ok_env[:, None], bs.weight * env_radiance(
                        scene.emitters, d2) * (w_env * w_nb_b)[:, None], 0.0)
        return li

"""Single-scattering photon planes from rectangular lights (Deng et al.
2019); port of rustlight_tpu/integrators/plane_single.py, with its
uncorrelated variant.

Plane types:
  UV      the whole light rectangle swept along the emission direction,
          weight pi Le / sigma_s (the distance importance-sampled)
  UT, VT  one light edge x the emission direction, weight pi edge Le
  UAlphaT a random line through the rectangle x the direction, weight
          pi Le area / line length
Strategies: one type (uv, ut, vt, ualpha), `average` (1/3 each of UV, UT,
VT), `dmis` (discrete MIS over them, inverse-contribution weights) and
`cmis` (continuous MIS of UAlphaT, closed form).

The planes form a pool that every camera ray meets, in chunks of
`plane_chunk` (each chunk's [n, chunk] pairs at once, each chunk's sum
added to the accumulator, as the reference's scan does); the uncorrelated
variant makes one private plane a lane and sample. `prepare` reads the
rectangles from the scene's host tables (`extract_rect_lights`) and
uploads them once to the scene's device; nothing is read back from the
device.

Draws: u_pix (n, 2); the planes on stream_fold(stream, 5): u_sel, u_d (2),
u_t, smp (2), s_alpha, `count` lanes each (the pool's size, or n).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..accel import intersect_rays, visible
from ..scene import generate_rays
from ..scene.volume import phase_eval, volume_sample_distance
from ..utils.frame import make_frame, to_world
from ..utils.rng import stream_fold, stream_next, stream_next2d
from ..utils.vec import cross, dot, length
from ..utils.warps import cosine_sample_hemisphere

PLANE_UV = 0
PLANE_UT = 1
PLANE_VT = 2
PLANE_UALPHA = 3

STRATEGIES = ("uv", "ut", "vt", "average", "dmis", "ualpha", "cmis")
_KINDS = {"uv": [PLANE_UV], "ut": [PLANE_UT], "vt": [PLANE_VT],
          "average": [PLANE_UV, PLANE_UT, PLANE_VT],
          "dmis": [PLANE_UV, PLANE_UT, PLANE_VT],
          "ualpha": [PLANE_UALPHA], "cmis": [PLANE_UALPHA]}


def extract_rect_lights(scene) -> Dict[str, np.ndarray]:
    """The rectangular emitters of a host scene (this package's or the JAX
    package's numpy SceneData, read by attribute): each emissive mesh must
    be a quad of two triangles sharing v0, as the reference requires."""
    geom = scene.geom
    eid = np.asarray(geom.emitter_id[: geom.n_tris])
    mid = np.asarray(geom.mesh_id[: geom.n_tris])
    v0 = np.asarray(geom.v0[: geom.n_tris])
    e1 = np.asarray(geom.e1[: geom.n_tris])
    e2 = np.asarray(geom.e2[: geom.n_tris])
    le = np.asarray(scene.emitters.tri_emission[: geom.n_tris])

    lights = {"o": [], "u": [], "v": [], "u_l": [], "v_l": [], "n": [], "e": []}
    for m in np.unique(mid[eid >= 0]):
        tris = np.nonzero((mid == m) & (eid >= 0))[0]
        if len(tris) != 2:
            raise ValueError("plane_single supports rectangular emitters only")
        t0, t1 = tris
        u_vec = e1[t0]          # p1 - p0
        v_vec = e2[t1]          # p3 - p0 (the make_quad layout)
        u_l = np.linalg.norm(u_vec)
        v_l = np.linalg.norm(v_vec)
        u_n = u_vec / u_l
        v_n = v_vec / v_l
        lights["o"].append(v0[t0])
        lights["u"].append(u_n)
        lights["v"].append(v_n)
        lights["u_l"].append(u_l)
        lights["v_l"].append(v_l)
        lights["n"].append(np.cross(u_n, v_n))
        lights["e"].append(le[t0])
    return {k: np.asarray(v, np.float32) for k, v in lights.items()}


def _clip01(x):
    return (x >= 0.0) & (x <= 1.0)


class IntegratorSinglePlane:
    def __init__(self, nb_primitive: int = 512, strategy: str = "average",
                 plane_chunk: int = 64, uncorrelated: bool = False):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        self.nb_primitive = nb_primitive
        self.strategy = strategy
        self.plane_chunk = plane_chunk
        self.uncorrelated = uncorrelated
        self._rect = None

    def prepare(self, scene):
        """Read the rectangles from the scene's host tables and upload them
        to its device (the render drivers call this before tracing)."""
        src = scene.host if getattr(scene, "host", None) is not None else scene
        self._rect = {k: torch.as_tensor(v, device=scene.device)
                      for k, v in extract_rect_lights(src).items()}

    def _rect_lights(self):
        if self._rect is None:
            raise RuntimeError(
                "IntegratorSinglePlane.prepare(scene) must run before tracing "
                "(the render drivers call it automatically)")
        return self._rect

    # ------------------------------------------------------- plane sampling
    def _gen_planes(self, scene, rl, kinds, count, stream):
        """`count` planes of each kind in `kinds`: {kind: fields}."""
        vol = scene.volume
        dev = rl["o"].device
        n_lights = rl["o"].shape[0]
        u_sel, stream = stream_next(stream, (count,))
        lid = torch.clamp((u_sel * n_lights).to(torch.int32), 0,
                          n_lights - 1).long()
        lo, lu, lv, ln = (rl[k][lid] for k in ("o", "u", "v", "n"))
        lul, lvl, lem = rl["u_l"][lid], rl["v_l"][lid], rl["e"][lid]

        u_d, stream = stream_next2d(stream, (count,))
        d = to_world(make_frame(ln), cosine_sample_hemisphere(u_d))
        u_t, stream = stream_next(stream, (count,))
        sd = volume_sample_distance(
            vol, torch.full((count,), 1e8, dtype=torch.float32, device=dev),
            u_t)
        t_sampled = sd.continued_t
        smp, stream = stream_next2d(stream, (count,))
        s_alpha, stream = stream_next(stream, (count,))

        out = {}
        for kind in kinds:
            if kind == PLANE_UV:
                o = lo + d * t_sampled[:, None]
                d0, d1, l0, l1 = lu, lv, lul, lvl
                w = math.pi * lem / torch.clamp(vol.sigma_s, min=1e-20)
            elif kind == PLANE_VT:
                o = lo + lu * (lul * smp[:, 0])[:, None]
                d0, d1, l0, l1 = lv, d, lvl, t_sampled
                w = math.pi * lul[:, None] * lem
            elif kind == PLANE_UT:
                o = lo + lv * (lvl * smp[:, 1])[:, None]
                d0, d1, l0, l1 = lu, d, lul, t_sampled
                w = math.pi * lvl[:, None] * lem
            else:  # UAlphaT: a random line across the rectangle
                alpha = math.pi * s_alpha
                o2 = torch.stack([smp[:, 0] * lul, smp[:, 1] * lvl], -1)
                d2 = torch.stack([torch.cos(alpha), torch.sin(alpha)], -1)
                size = torch.stack([lul, lvl], -1)

                def hit2d(d2_, o2_):
                    safe = torch.where(torch.abs(d2_) > 1e-12, d2_,
                                       torch.where(d2_ >= 0, 1e-12, -1e-12))
                    tmax = torch.maximum((-o2_) / safe, (size - o2_) / safe)
                    return o2_ + d2_ * torch.amin(tmax, -1, keepdim=True)

                p1 = hit2d(d2, o2)
                p2 = hit2d(-d2, o2)
                p1w = lo + lu * p1[:, 0:1] + lv * p1[:, 1:2]
                p2w = lo + lu * p2[:, 0:1] + lv * p2[:, 1:2]
                uvec = p2w - p1w
                ulen = torch.clamp(length(uvec), min=1e-8)
                o = p1w
                d0, d1, l0, l1 = uvec / ulen[:, None], d, ulen, t_sampled
                w = math.pi * lem * (lul * lvl / ulen)[:, None]
            out[kind] = dict(o=o, d0=d0, d1=d1, l0=l0, l1=l1, w=w, lid=lid,
                             valid=torch.ones(count, dtype=torch.bool,
                                              device=dev))
        return out, stream

    def _plane_contrib(self, scene, rl, plane, kind, o, d, tfar):
        """Every ray against one chunk of planes: the summed contributions,
        [n, 3]."""
        vol = scene.volume
        n = o.shape[0]
        vc = plane["o"].shape[0]
        e0 = plane["d0"] * plane["l0"][:, None]
        e1 = plane["d1"] * plane["l1"][:, None]
        pvec = cross(d[:, None], e1[None])
        det = dot(e0[None], pvec)
        ok = torch.abs(det) >= 1e-6
        inv_det = 1.0 / torch.where(ok, det, 1.0)
        tvec = o[:, None] - plane["o"][None]
        t0 = dot(tvec, pvec) * inv_det
        qvec = cross(tvec, e0[None])
        t1 = dot(d[:, None], qvec) * inv_det
        t_cam = dot(e1[None], qvec) * inv_det
        ok = (ok & _clip01(t0) & _clip01(t1) & (t_cam > 1e-4)
              & (t_cam < tfar[:, None]) & plane["valid"][None])

        p_hit = o[:, None] + d[:, None] * t_cam[..., None]
        lid = plane["lid"]
        lo, lu, lv = (rl[k][lid][None] for k in ("o", "u", "v"))
        if kind == PLANE_UV:
            p_light = (lo + lu * (t0 * plane["l0"][None])[..., None]
                       + lv * (t1 * plane["l1"][None])[..., None])
        else:
            p_light = plane["o"][None] + plane["d0"][None] \
                * (t0 * plane["l0"][None])[..., None]

        vis = visible(scene.geom, p_hit.reshape(-1, 3),
                      p_light.reshape(-1, 3),
                      mask=ok.reshape(-1)).reshape(n, vc)
        tr = torch.exp(-vol.sigma_t * t_cam[..., None])
        dl = p_light - p_hit
        dl = dl / torch.clamp(length(dl), min=1e-12)[..., None]
        rho = phase_eval(vol.phase_g, -d[:, None], dl)

        jac = torch.abs(dot(cross(plane["d1"], plane["d0"])[None],
                             d[:, None]))
        flux = plane["w"][None] / torch.clamp(jac, min=1e-12)[..., None]

        if self.strategy == "average":
            w_mis = torch.full_like(jac, 1.0 / 3.0)
        elif self.strategy == "dmis":
            # the three types' contributions for the pair
            lem = rl["e"][lid][None]
            lul = rl["u_l"][lid][None]
            lvl = rl["v_l"][lid][None]
            sig = torch.mean(vol.sigma_s)
            d_pl = -dl  # light -> hit
            j_ut = torch.abs(dot(cross(d_pl, lu), d[:, None]))
            j_vt = torch.abs(dot(cross(d_pl, lv), d[:, None]))
            lem_avg = torch.mean(lem, -1)
            c_uv = (math.pi * lem_avg / torch.clamp(sig, min=1e-20)
                    / torch.clamp(torch.abs(dot(cross(lv, lu),
                                                 d[:, None])), min=1e-12))
            c_ut = math.pi * lvl * lem_avg / torch.clamp(j_ut, min=1e-12)
            c_vt = math.pi * lul * lem_avg / torch.clamp(j_vt, min=1e-12)

            def inv(c):
                return torch.where((c > 0) & torch.isfinite(c), 1.0 / c, 0.0)
            c_self = {PLANE_UV: c_uv, PLANE_UT: c_ut, PLANE_VT: c_vt}[kind]
            w_mis = inv(c_self) / torch.clamp(inv(c_uv) + inv(c_ut)
                                              + inv(c_vt), min=1e-30)
            w_mis = torch.where(torch.isfinite(w_mis), w_mis, 0.0)
        elif self.strategy == "cmis":
            d1 = plane["d1"][None]
            w_cmis = 1.0 / torch.clamp(
                (2.0 / math.pi) * torch.sqrt(
                    dot(cross(lu, d1), d[:, None]) ** 2
                    + dot(cross(lv, d1), d[:, None]) ** 2), min=1e-12)
            flux = plane["w"][None] * w_cmis[..., None]
            w_mis = torch.ones_like(jac)
        else:
            w_mis = torch.ones_like(jac)

        contrib = flux * tr * (w_mis * rho)[..., None] * vol.sigma_s
        return torch.where((ok & vis)[..., None], contrib, 0.0).sum(1)

    def _contrib_private(self, scene, rl, one, kind, o, d, tfar):
        """Each lane against its own plane (the uncorrelated variant)."""
        vol = scene.volume
        e0 = one["d0"] * one["l0"][:, None]
        e1 = one["d1"] * one["l1"][:, None]
        pvec = cross(d, e1)
        det = dot(e0, pvec)
        ok = torch.abs(det) >= 1e-6
        inv_det = 1.0 / torch.where(ok, det, 1.0)
        tvec = o - one["o"]
        t0 = dot(tvec, pvec) * inv_det
        qvec = cross(tvec, e0)
        t1 = dot(d, qvec) * inv_det
        t_cam = dot(e1, qvec) * inv_det
        ok = (ok & _clip01(t0) & _clip01(t1) & (t_cam > 1e-4)
              & (t_cam < tfar))
        p_hit = o + d * t_cam[:, None]
        lid = one["lid"]
        if kind == PLANE_UV:
            p_light = (rl["o"][lid] + rl["u"][lid] * (t0 * one["l0"])[:, None]
                       + rl["v"][lid] * (t1 * one["l1"])[:, None])
        else:
            p_light = one["o"] + one["d0"] * (t0 * one["l0"])[:, None]
        vis = visible(scene.geom, p_hit, p_light, mask=ok)
        tr = torch.exp(-vol.sigma_t * t_cam[:, None])
        dl = p_light - p_hit
        dl = dl / torch.clamp(length(dl), min=1e-12)[:, None]
        rho = phase_eval(vol.phase_g, -d, dl)
        jac = torch.abs(dot(cross(one["d1"], one["d0"]), d))
        flux = one["w"] / torch.clamp(jac, min=1e-12)[:, None]
        w_mis = 1.0 / 3.0 if self.strategy in ("average", "dmis") else 1.0
        contrib = flux * tr * (rho * w_mis)[:, None] * vol.sigma_s
        return torch.where((ok & vis)[:, None], contrib, 0.0)

    # ---------------------------------------------------------------- main
    def compute_pixel(self, scene, pix, stream):
        if scene.volume is None:
            raise ValueError("plane_single needs a medium (-m)")
        rl = self._rect_lights()
        n = pix.shape[0]
        n_lights = rl["o"].shape[0]

        u_pix, stream = stream_next2d(stream, (n,))
        o, d = generate_rays(scene.camera, pix.to(torch.float32) + u_pix)
        rh = intersect_rays(scene.geom, o, d)
        tfar = torch.where(rh.hit, rh.t, 1e8)
        kinds = _KINDS[self.strategy]

        if self.uncorrelated:
            planes, _ = self._gen_planes(scene, rl, kinds, n,
                                         stream_fold(stream, 5))
            li = torch.zeros_like(o)
            for kind in kinds:
                li = li + self._contrib_private(scene, rl, planes[kind], kind,
                                                o, d, tfar)
            return li * n_lights

        rounds = max(1, self.nb_primitive)
        planes, _ = self._gen_planes(scene, rl, kinds, rounds,
                                     stream_fold(stream, 5))
        vc = self.plane_chunk
        n_chunks = (rounds + vc - 1) // vc
        pad = n_chunks * vc - rounds
        li = torch.zeros_like(o)
        for kind in kinds:
            pl = planes[kind]
            if pad:
                pl = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])], 0)
                      for k, v in pl.items()}
            li_k = torch.zeros_like(o)
            for i in range(n_chunks):
                c = {k: v[i * vc:(i + 1) * vc] for k, v in pl.items()}
                li_k = li_k + self._plane_contrib(scene, rl, c, kind, o, d,
                                                  tfar)
            li = li + li_k
        return li * (n_lights / rounds)

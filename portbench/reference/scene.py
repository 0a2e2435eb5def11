"""The reference's scene: flat triangle tables worked out from the config's
plain arrays, a pinhole camera, brute-force intersection (every ray
against every triangle, Moller-Trumbore, in blocks of triangles), and each
triangle's material, evaluated and sampled by its kind's module
(reference/materials/<kind>.py).

Plain PyTorch and NumPy; nothing here comes from the renderer under test.
Every float tensor is in `dtype`, so that the same code computed in a lower
precision is the control of the comparison.
"""
from __future__ import annotations

import importlib
import math
from typing import NamedTuple

import numpy as np
import torch

EPSILON = 1e-4          # the ray's near distance
SHADOW_SHORT = 1e-3     # a shadow ray stops this share short of its target
# elements of one [rays, triangles] block of the brute-force test, by device
BLOCK_ELEMS = {"cuda": 1 << 25, "cpu": 1 << 22}


class RefScene(NamedTuple):
    v0: torch.Tensor        # [t, 3]
    e1: torch.Tensor        # [t, 3]
    e2: torch.Tensor        # [t, 3]
    n_g: torch.Tensor       # [t, 3] unit geometric normal, e1 x e2
    vn: torch.Tensor        # [t, 3, 3] corner normals (n_g where none)
    has_n: torch.Tensor     # [t] bool
    mat_kind: torch.Tensor  # [t] int64 index into `bsdfs`
    mat_params: torch.Tensor  # [t, P] the material's parameters
    emission: torch.Tensor  # [t, 3]
    is_light: torch.Tensor  # [t] bool
    light_tri: torch.Tensor  # [l] int64 emissive triangles
    light_cdf: torch.Tensor  # [l + 1] float64 selection cdf
    light_prob: torch.Tensor  # [l] selection probability
    pdf_area: torch.Tensor  # [t] area pdf of NEE (0 off the lights)
    area: torch.Tensor      # [t]
    cam_o: torch.Tensor     # [3]
    cam_rot: torch.Tensor   # [3, 3] columns: right, up, forward
    width: int
    height: int
    tan_half: float         # tan(fov / 2), fov along x
    dtype: torch.dtype
    bsdfs: tuple            # the material kinds' modules


def build(arrays, width: int, height: int, device, dtype=torch.float32):
    """RefScene from the config's plain arrays (portbench.scene.SceneArrays)
    at a film of width x height."""
    v0s, e1s, e2s, ngs, vns, hasn, kinds, emi, lit, areas, flux = (
        [] for _ in range(11))
    bsdfs, mats = [], []      # kinds in order of first use; (kind, params)
    for spec in arrays.materials:
        mod = importlib.import_module(
            f"{__package__}.materials.{spec['kind']}")
        if mod not in bsdfs:
            bsdfs.append(mod)
        mats.append((bsdfs.index(mod), mod.params(spec)))
    n_par = max(len(par) for _, par in mats)
    mat_par = np.asarray([par + [0.0] * (n_par - len(par))
                          for _, par in mats], np.float64)
    for m in arrays.meshes:
        v = np.asarray(m.vertices, np.float64)
        idx = np.asarray(m.indices)
        p0, p1, p2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
        e1, e2 = p1 - p0, p2 - p0
        cr = np.cross(e1, e2)
        ln = np.linalg.norm(cr, axis=-1)
        ng = cr / np.maximum(ln, 1e-30)[:, None]
        v0s.append(p0)
        e1s.append(e1)
        e2s.append(e2)
        ngs.append(ng)
        if m.normals is not None:
            nrm = np.asarray(m.normals, np.float64)
            vns.append(np.stack([nrm[idx[:, k]] for k in range(3)], 1))
            hasn.append(np.ones(len(idx), bool))
        else:
            vns.append(np.repeat(ng[:, None, :], 3, axis=1))
            hasn.append(np.zeros(len(idx), bool))
        kinds.append(np.full(len(idx), mats[m.material][0], np.int64))
        le = np.asarray(m.emission, np.float64)
        emi.append(np.tile(le, (len(idx), 1)))
        light = bool(np.any(le > 0))
        lit.append(np.full(len(idx), light))
        areas.append(0.5 * ln)
        # a light's triangle is picked by its share of the flux: the
        # channel max of Le times pi times its area
        flux.append(np.max(le) * np.pi * 0.5 * ln if light
                    else np.zeros(len(idx)))
    cat = np.concatenate
    mat_id = cat([np.full(len(m.indices), m.material) for m in arrays.meshes])
    area = cat(areas)
    w = cat(flux)
    light_tri = np.nonzero(w > 0)[0]
    prob = w[light_tri] / w[light_tri].sum()
    cdf = np.concatenate([[0.0], np.cumsum(prob)])
    cdf[-1] = 1.0
    pdf_area = np.zeros(len(area))
    pdf_area[light_tri] = prob / area[light_tri]

    cam = arrays.camera
    o = np.asarray(cam["origin"], np.float64)
    fwd = np.asarray(cam["target"], np.float64) - o
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(cam["up"], np.float64)
    right = np.cross(up / np.linalg.norm(up), fwd)
    right /= np.linalg.norm(right)
    new_up = np.cross(fwd, right)
    if cam.get("fov_axis", "x") != "x":
        raise ValueError("the reference camera takes a fov along x")

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dt)
    return RefScene(
        v0=t(cat(v0s)), e1=t(cat(e1s)), e2=t(cat(e2s)), n_g=t(cat(ngs)),
        vn=t(cat(vns)), has_n=t(cat(hasn), torch.bool),
        mat_kind=t(cat(kinds), torch.int64), mat_params=t(mat_par[mat_id]),
        emission=t(cat(emi)), is_light=t(cat(lit), torch.bool),
        light_tri=t(light_tri, torch.int64),
        light_cdf=t(cdf, torch.float64), light_prob=t(prob),
        pdf_area=t(pdf_area), area=t(area), cam_o=t(o),
        cam_rot=t(np.stack([right, new_up, fwd], 1)),
        width=int(width), height=int(height),
        tan_half=math.tan(math.radians(float(cam["fov"])) / 2.0),
        dtype=dtype, bsdfs=tuple(bsdfs))


def dot(a, b):
    return (a * b).sum(-1)


def pixel_coords(sc: RefScene, lanes):
    """Flat pixel indices y * width + x -> their corners (x, y) [n, 2]."""
    return torch.stack([lanes % sc.width, lanes // sc.width], -1).to(sc.dtype)


def camera_rays(sc: RefScene, px):
    """Continuous pixel positions [n, 2] -> (origins, unit directions) of a
    pinhole whose fov spans the film's width: in the camera's frame
    (right, up, forward), x / z = (2 px / w - 1) tan(fov / 2) and
    y / z = (1 - 2 py / h) tan(fov / 2) h / w."""
    a = sc.width / sc.height
    sx = px[:, 0] / sc.width
    sy = px[:, 1] / sc.height
    x = (2.0 * sx - 1.0) * sc.tan_half
    y = (1.0 - 2.0 * sy) * sc.tan_half / a
    d = torch.stack([x, y, torch.ones_like(x)], -1)
    d = d / torch.sqrt(dot(d, d))[:, None]
    d = d @ sc.cam_rot.T
    return sc.cam_o.expand(d.shape), d


def _blocks(sc: RefScene, n_rays: int):
    t = sc.v0.shape[0]
    elems = BLOCK_ELEMS.get(sc.v0.device.type, BLOCK_ELEMS["cpu"])
    step = max(1, min(t, elems // max(n_rays, 1)))
    for lo in range(0, t, step):
        yield lo, min(t, lo + step)


def _test(sc: RefScene, o, d, tnear, tfar, lo, hi):
    """Moller-Trumbore of every ray against triangles [lo, hi): (t with inf
    where no hit, u, v), each [n, hi - lo]."""
    v0, e1, e2 = sc.v0[lo:hi][None], sc.e1[lo:hi][None], sc.e2[lo:hi][None]
    dd = d[:, None, :]
    pvec = torch.cross(dd.expand(-1, e2.shape[1], -1),
                       e2.expand(d.shape[0], -1, -1), dim=-1)
    det = dot(e1, pvec)
    ok = det != 0.0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = o[:, None, :] - v0
    u = dot(tvec, pvec) * inv
    qvec = torch.cross(tvec, e1.expand(d.shape[0], -1, -1), dim=-1)
    v = dot(dd, qvec) * inv
    t = dot(e2, qvec) * inv
    ok = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > tnear[:, None]) & (t < tfar[:, None]))
    return torch.where(ok, t, torch.full_like(t, math.inf)), u, v


def closest(sc: RefScene, o, d, tnear, tfar):
    """(t, triangle, u, v, hit) of the closest hit in (tnear, tfar)."""
    n = o.shape[0]
    best_t = torch.full((n,), math.inf, dtype=sc.dtype, device=o.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    best_u = torch.zeros((n,), dtype=sc.dtype, device=o.device)
    best_v = torch.zeros_like(best_u)
    for lo, hi in _blocks(sc, n):
        t, u, v = _test(sc, o, d, tnear, tfar, lo, hi)
        bt, bi = torch.min(t, dim=1)
        take = bt < best_t
        rows = torch.arange(n, device=o.device)
        best_t = torch.where(take, bt, best_t)
        best_i = torch.where(take, bi + lo, best_i)
        best_u = torch.where(take, u[rows, bi], best_u)
        best_v = torch.where(take, v[rows, bi], best_v)
    return best_t, best_i, best_u, best_v, torch.isfinite(best_t)


def occluded(sc: RefScene, o, d, tnear, tfar):
    """True where some triangle is hit in (tnear, tfar)."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for lo, hi in _blocks(sc, o.shape[0]):
        t, _, _ = _test(sc, o, d, tnear, tfar, lo, hi)
        occ = occ | torch.isfinite(t).any(dim=1)
    return occ


class Hit(NamedTuple):
    valid: torch.Tensor
    tri: torch.Tensor
    p: torch.Tensor
    n_g: torch.Tensor     # geometric normal, turned toward the shading one
    n_s: torch.Tensor
    frame: tuple
    wi: torch.Tensor      # local direction back along the ray
    is_light: torch.Tensor


def make_frame(n):
    """Orthonormal basis (t, b, n) around unit normals (Duff et al. 2017)."""
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return t, bt, n


def to_local(frame, v):
    return torch.stack([dot(v, frame[0]), dot(v, frame[1]),
                        dot(v, frame[2])], -1)


def to_world(frame, v):
    return (frame[0] * v[:, 0:1] + frame[1] * v[:, 1:2]
            + frame[2] * v[:, 2:3])


def shade(sc: RefScene, o, d, t, tri, u, v, valid) -> Hit:
    """The hit record: position, normals interpolated from the corners, both
    turned toward the ray on two-sided (non-emitting) surfaces."""
    tri = torch.clamp(tri, min=0)
    b0 = 1.0 - u - v
    n_g = sc.n_g[tri]
    vn = sc.vn[tri]
    has_n = sc.has_n[tri]
    n_raw = (vn[:, 0] * b0[:, None] + vn[:, 1] * u[:, None]
             + vn[:, 2] * v[:, None])
    n_g = torch.where((has_n & (dot(n_g, n_raw) < 0.0))[:, None], -n_g, n_g)
    l2 = dot(n_raw, n_raw)[:, None]
    n_s = torch.where(l2 > 0.0, n_raw / torch.sqrt(torch.clamp(l2, min=1e-30)),
                      n_g)
    n_s = torch.where(has_n[:, None], n_s, n_g)
    is_light = sc.is_light[tri]
    flip = ((~is_light) & (dot(d, n_s) > 0.0))[:, None]
    n_s = torch.where(flip, -n_s, n_s)
    n_g = torch.where(flip, -n_g, n_g)
    p = o + d * torch.where(valid, t, torch.zeros_like(t))[:, None]
    frame = make_frame(n_s)
    return Hit(valid=valid, tri=tri, p=p, n_g=n_g, n_s=n_s, frame=frame,
               wi=to_local(frame, -d), is_light=is_light)


def offset_origin(p, n_g, d):
    """A ray origin off the surface, to the side d leaves by."""
    eps = (1e-4 + 2e-5 * torch.amax(torch.abs(p), dim=-1))[:, None]
    sign = torch.where(dot(n_g, d) >= 0.0, 1.0, -1.0).to(p.dtype)[:, None]
    return p + n_g * eps * sign


def cosine_hemisphere(u):
    """Cosine-weighted direction about +z (Shirley-Chiu concentric disk)."""
    uo = 2.0 * u - 1.0
    ux, uy = uo[:, 0], uo[:, 1]
    use_x = torch.abs(ux) > torch.abs(uy)
    r = torch.where(use_x, ux, uy)
    sx = torch.where(ux == 0.0, torch.ones_like(ux), ux)
    sy = torch.where(uy == 0.0, torch.ones_like(uy), uy)
    theta = torch.where(use_x, (math.pi / 4) * (uy / sx),
                        math.pi / 2 - (math.pi / 4) * (ux / sy))
    x, y = torch.cos(theta) * r, torch.sin(theta) * r
    zero = (ux == 0.0) & (uy == 0.0)
    x = torch.where(zero, torch.zeros_like(x), x)
    y = torch.where(zero, torch.zeros_like(y), y)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return torch.stack([x, y, z], -1)


def _by_kind(sc: RefScene, tri, call):
    """Each material kind's `call(module, params)`, taken on the lanes whose
    triangle's material is of that kind."""
    par = sc.mat_params[tri]
    out = call(sc.bsdfs[0], par)
    for k, mod in enumerate(sc.bsdfs[1:], 1):
        sel = sc.mat_kind[tri] == k
        out = tuple(torch.where(sel.view(-1, *[1] * (b.dim() - 1)), b, a)
                    for a, b in zip(out, call(mod, par)))
    return out


def bsdf_eval(sc: RefScene, tri, wi, wo):
    """(f times the cosine of wo [n, 3], pdf [n]) of local directions."""
    return _by_kind(sc, tri, lambda mod, p: mod.evaluate(p, wi, wo))


def bsdf_sample(sc: RefScene, tri, wi, u):
    """(wo, f cos / pdf [n, 3], pdf [n], delta [n], ok [n]) for u [n, 2]."""
    return _by_kind(sc, tri, lambda mod, p: mod.sample(p, wi, u))

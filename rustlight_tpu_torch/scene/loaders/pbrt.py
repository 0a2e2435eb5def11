"""PBRT-v3 scene loader (subset); port of
rustlight_tpu/scene/loaders/pbrt.py.

Reference: src/scene_loader.rs:76-315 (via the external pbrt_rs crate).
Supported: LookAt/Transform/ConcatTransform/Translate/Rotate/Scale stacks,
Camera "perspective" (fov, Fov::Y + flip=false as the reference does,
scene_loader.rs:291), Film resolution, AttributeBegin/End,
Material matte/plastic/glass/mirror/metal/substrate/uber,
MakeNamedMaterial/NamedMaterial, AreaLightSource "diffuse",
LightSource point/distant/infinite, Shape trianglemesh/plymesh/sphere,
Texture imagemap/checkerboard/constant on the diffuse slot ("texture Kd"
references; reference bsdf_pbrt texture conversion, src/bsdfs/mod.rs:293-386).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ... import bsdfs
from ..camera import make_camera
from ..geometry import TriMesh, make_sphere
from ..scene import Scene
from .ply import load_ply

_TOKEN_RE = re.compile(r'"[^"]*"|\[|\]|[^\s"\[\]]+')


def _tokenize(text: str):
    for line in text.splitlines():
        h = line.find("#")
        if h >= 0:
            line = line[:h]
        for t in _TOKEN_RE.findall(line):
            yield t


def _translate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (x, y, z)
    return m


def _scale(x, y, z):
    return np.diag([x, y, z, 1.0]).astype(np.float32)


def _rotate(angle, x, y, z):
    a = np.deg2rad(angle)
    axis = np.asarray([x, y, z], np.float32)
    axis /= np.linalg.norm(axis)
    c, s = np.cos(a), np.sin(a)
    t = 1 - c
    X, Y, Z = axis
    r = np.array([
        [t * X * X + c, t * X * Y - s * Z, t * X * Z + s * Y],
        [t * X * Y + s * Z, t * Y * Y + c, t * Y * Z - s * X],
        [t * X * Z - s * Y, t * Y * Z + s * X, t * Z * Z + c]], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r
    return m


def _look_at(eye, look, up):
    """pbrt LookAt: builds camera-to-world (pbrt book 2.7.7)."""
    eye = np.asarray(eye, np.float32)
    d = np.asarray(look, np.float32) - eye
    d /= np.linalg.norm(d)
    up = np.asarray(up, np.float32)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return m


class _Params(dict):
    def rgb(self, name, default):
        v = self.get(name)
        if v is None:
            return default
        if np.isscalar(v):
            return (float(v),) * 3
        v = np.asarray(v, np.float32).ravel()
        return tuple(v[:3]) if v.size >= 3 else (float(v[0]),) * 3

    def flt(self, name, default):
        v = self.get(name)
        if v is None:
            return default
        return float(np.asarray(v).ravel()[0])

    def ints(self, name):
        v = self.get(name)
        return None if v is None else np.asarray(v, np.int64).astype(np.int32)

    def flts(self, name):
        v = self.get(name)
        return None if v is None else np.asarray(v, np.float32)

    def str_(self, name):
        v = self.get(name)
        if isinstance(v, list) and v:
            v = v[0]
        return None if v is None else str(v)


def _kd_kwargs(p: _Params, name, default, texs):
    """Resolve a possibly texture-referencing color parameter into
    (constant color, MaterialDesc texture kwargs) for the diffuse slot."""
    v = p.get(name)
    if isinstance(v, list) and len(v) == 1:
        v = v[0]
    if isinstance(v, str) and texs and v in texs:
        spec = dict(texs[v])
        kd = spec.pop("kd_override", default)
        return kd, spec
    return p.rgb(name, default), {}


def _material_from(kind: str, p: _Params, texs=None) -> bsdfs.MaterialDesc:
    """PBRT material -> archetype (reference bsdf_pbrt, bsdfs/mod.rs:293-386)."""
    if kind == "matte":
        kd, tkw = _kd_kwargs(p, "Kd", (0.5, 0.5, 0.5), texs)
        return bsdfs.diffuse(kd, **tkw)
    if kind in ("plastic", "uber"):
        rough = p.flt("roughness", 0.1)
        kd, tkw = _kd_kwargs(p, "Kd", (0.25,) * 3, texs)
        return bsdfs.substrate(kd=kd,
                               ks=p.rgb("Ks", (0.25,) * 3),
                               alpha=_remap_roughness(rough), **tkw)
    if kind == "glass":
        return bsdfs.glass(int_ior=p.flt("eta", p.flt("index", 1.5)), ext_ior=1.0,
                           kt=p.rgb("Kt", (1, 1, 1)), ks=p.rgb("Kr", (1, 1, 1)))
    if kind == "mirror":
        return bsdfs.metal(ks=p.rgb("Kr", (0.9,) * 3), alpha=0.0)
    if kind == "metal":
        rough = p.flt("roughness", 0.01)
        return bsdfs.metal(eta_c=p.rgb("eta", (0.2, 0.92, 1.1)),
                           k_c=p.rgb("k", (3.9, 2.45, 2.14)),
                           alpha=_remap_roughness(rough))
    if kind == "substrate":
        kd, tkw = _kd_kwargs(p, "Kd", (0.5,) * 3, texs)
        return bsdfs.substrate(kd=kd,
                               ks=p.rgb("Ks", (0.5,) * 3),
                               alpha=_remap_roughness(p.flt("uroughness",
                                                            p.flt("roughness", 0.1))),
                               **tkw)
    return bsdfs.diffuse((0.5, 0.5, 0.5))


def _remap_roughness(r: float) -> float:
    """PBRT roughness->alpha remap (reference bsdfs/mod.rs:259-270)."""
    r = max(r, 1e-3)
    x = np.log(r)
    return float(1.62142 + 0.819955 * x + 0.1734 * x * x
                 + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)


def _transform_mesh(mesh, ctm):
    """Apply a 4x4 transform to a TriMesh in place (normals by the
    inverse-transpose)."""
    v4 = np.concatenate(
        [mesh.vertices, np.ones((len(mesh.vertices), 1), np.float32)], -1)
    mesh.vertices = (v4 @ ctm.T)[:, :3]
    if mesh.normals is not None:
        nrm_m = np.linalg.inv(ctm[:3, :3]).T
        nn = mesh.normals @ nrm_m.T
        ln = np.linalg.norm(nn, axis=-1, keepdims=True)
        mesh.normals = nn / np.maximum(ln, 1e-20)


def load_pbrt(path) -> Scene:
    path = Path(path)
    toks = list(_tokenize(path.read_text(errors="ignore")))
    i = 0
    n = len(toks)

    def peek():
        return toks[i] if i < n else None

    def nxt():
        nonlocal i
        t = toks[i]
        i += 1
        return t

    def read_value():
        nonlocal i
        if toks[i] == "[":
            i += 1
            vals = []
            while toks[i] != "]":
                vals.append(_atom(toks[i]))
                i += 1
            i += 1
            return vals
        v = _atom(toks[i])
        i += 1
        return v

    def _atom(t):
        if t.startswith('"'):
            return t.strip('"')
        try:
            return float(t)
        except ValueError:
            return t

    def read_params():
        p = _Params()
        while i < n and toks[i].startswith('"'):
            decl = nxt().strip('"')
            parts = decl.split()
            name = parts[-1]
            p[name] = read_value()
        return p

    scene = Scene()
    ctm = np.eye(4, dtype=np.float32)
    stack: List[tuple] = []
    cur_mat: Optional[int] = None
    cur_emit = np.zeros(3, np.float32)
    # object instancing (reference scene_loader.rs:185-199): ObjectBegin
    # records shapes into a prototype list; ObjectInstance stamps a copy
    # with the instance CTM composed on top of the creation transform
    cur_object: Optional[str] = None
    objects: Dict[str, list] = {}
    named: Dict[str, int] = {}
    tex_specs: Dict[str, dict] = {}
    atlas: List[np.ndarray] = []
    cam_to_world = np.eye(4, dtype=np.float32)
    fov = 90.0
    res = [512, 512]
    in_world = False

    def ensure_mat():
        nonlocal cur_mat
        if cur_mat is None:
            cur_mat = scene.add_material(bsdfs.diffuse((0.5, 0.5, 0.5)))
        return cur_mat

    while i < n:
        t = nxt()
        if t == "LookAt":
            # pbrt: CTM *= world-to-camera; Camera later inverts the CTM
            vals = [float(nxt()) for _ in range(9)]
            ctm = ctm @ np.linalg.inv(_look_at(vals[0:3], vals[3:6], vals[6:9]))
        elif t == "Transform":
            vals = read_value()
            ctm = np.asarray(vals, np.float32).reshape(4, 4).T
        elif t == "ConcatTransform":
            vals = read_value()
            ctm = ctm @ np.asarray(vals, np.float32).reshape(4, 4).T
        elif t == "Translate":
            ctm = ctm @ _translate(float(nxt()), float(nxt()), float(nxt()))
        elif t == "Scale":
            ctm = ctm @ _scale(float(nxt()), float(nxt()), float(nxt()))
        elif t == "Rotate":
            ctm = ctm @ _rotate(float(nxt()), float(nxt()), float(nxt()), float(nxt()))
        elif t == "Camera":
            kind = nxt().strip('"')
            p = read_params()
            fov = p.flt("fov", 90.0)
            cam_to_world = np.linalg.inv(ctm)
        elif t == "Film":
            nxt()
            p = read_params()
            res = [int(p.flt("xresolution", 512)), int(p.flt("yresolution", 512))]
        elif t in ("Integrator", "Sampler", "PixelFilter", "Accelerator"):
            nxt()
            read_params()
        elif t == "WorldBegin":
            in_world = True
            ctm = np.eye(4, dtype=np.float32)
        elif t in ("AttributeBegin", "TransformBegin", "ObjectBegin"):
            stack.append((ctm.copy(), cur_mat, cur_emit.copy(), cur_object))
            if t == "ObjectBegin":
                cur_object = nxt().strip('"')
                objects.setdefault(cur_object, [])
        elif t in ("AttributeEnd", "TransformEnd", "ObjectEnd"):
            if stack:
                ctm, cur_mat, cur_emit, cur_object = stack.pop()
        elif t == "Material":
            kind = nxt().strip('"')
            p = read_params()
            cur_mat = scene.add_material(_material_from(kind, p, tex_specs))
        elif t == "MakeNamedMaterial":
            name = nxt().strip('"')
            p = read_params()
            kind = p.get("type", "matte")
            named[name] = scene.add_material(
                _material_from(str(kind), p, tex_specs))
        elif t == "NamedMaterial":
            cur_mat = named.get(nxt().strip('"'))
        elif t == "Texture":
            tname = nxt().strip('"')
            nxt()   # value type (spectrum/float/color)
            tclass = nxt().strip('"')
            p = read_params()
            from ...bsdfs.table import TEX_BITMAP, TEX_CHECKER
            spec = dict(tex_scale=(p.flt("uscale", 1.0), p.flt("vscale", 1.0)),
                        tex_offset=(p.flt("udelta", 0.0), p.flt("vdelta", 0.0)))
            if tclass == "imagemap":
                try:
                    from ...utils import image as _rimage
                    img = np.asarray(
                        _rimage.load(path.parent / p.str_("filename")),
                        np.float32)[..., :3]
                    atlas.append(img)
                    spec.update(tex_kind=TEX_BITMAP, tex_img=len(atlas) - 1)
                except Exception:
                    spec["kd_override"] = (0.5, 0.5, 0.5)
            elif tclass == "checkerboard":
                spec.update(tex_kind=TEX_CHECKER,
                            kd_override=p.rgb("tex1", (0.1,) * 3),
                            tex_c1=p.rgb("tex2", (0.9,) * 3))
            elif tclass == "constant":
                spec["kd_override"] = p.rgb("value", (0.5, 0.5, 0.5))
            else:   # scale/mix/...: constant-fold to a midtone
                spec["kd_override"] = (0.5, 0.5, 0.5)
            tex_specs[tname] = spec
        elif t == "AreaLightSource":
            nxt()
            p = read_params()
            cur_emit = np.asarray(p.rgb("L", (1, 1, 1)), np.float32) \
                * np.asarray(p.rgb("scale", (1, 1, 1)), np.float32)
        elif t == "LightSource":
            kind = nxt().strip('"')
            p = read_params()
            if kind == "point":
                frm = p.flts("from")
                pos = (ctm @ np.append(frm if frm is not None else [0, 0, 0], 1.0))[:3]
                scene.point_lights.append((pos, p.rgb("I", (1, 1, 1))))
            elif kind == "distant":
                frm = p.flts("from"); to = p.flts("to")
                frm = frm if frm is not None else np.zeros(3)
                to = to if to is not None else np.array([0, 0, 1.0])
                d = (to - frm)
                d = d / np.linalg.norm(d)
                scene.directional_lights.append((d, p.rgb("L", (1, 1, 1))))
            elif kind == "infinite":
                scene.env_constant = np.asarray(p.rgb("L", (1, 1, 1)), np.float32)
        elif t == "Shape":
            kind = nxt().strip('"')
            p = read_params()
            mesh = None
            if kind == "trianglemesh":
                pts = p.flts("P").reshape(-1, 3)
                idx = p.ints("indices").reshape(-1, 3)
                nrm = p.flts("N")
                uv = p.flts("uv")
                if uv is None:
                    uv = p.flts("st")
                mesh = TriMesh(
                    vertices=pts, indices=idx,
                    normals=None if nrm is None else nrm.reshape(-1, 3),
                    uvs=None if uv is None else uv.reshape(-1, 2),
                    material=ensure_mat(), emission=cur_emit.copy())
            elif kind in ("plymesh", "plyfile"):
                fname = p.str_("filename")
                mesh = load_ply(path.parent / fname, material=ensure_mat(),
                                emission=cur_emit.copy())
            elif kind == "sphere":
                mesh = make_sphere((0, 0, 0), p.flt("radius", 1.0),
                                   material=ensure_mat(),
                                   emission=tuple(cur_emit))
            if mesh is not None:
                _transform_mesh(mesh, ctm)
                if cur_object is not None:
                    # prototype shape: recorded, not added to the scene
                    objects[cur_object].append(mesh)
                else:
                    scene.add_mesh(mesh)
        elif t == "ObjectInstance":
            oname = nxt().strip('"')
            # instance-to-world CTM composes on top of the prototype's
            # creation transform (pbrt TransformedPrimitive semantics;
            # reference scene_loader.rs:185-199)
            import copy as _copy
            for proto in objects.get(oname, ()):
                inst = _copy.deepcopy(proto)
                _transform_mesh(inst, ctm)
                scene.add_mesh(inst)
        elif t in ("WorldEnd", "ReverseOrientation"):
            pass
        elif t == "Include":
            inc = nxt().strip('"')
            toks[i:i] = list(_tokenize((path.parent / inc).read_text(errors="ignore")))
            n = len(toks)
        # unknown directives are skipped silently

    # Fov::Y + flip=false for pbrt (reference scene_loader.rs:291)
    scene.camera = make_camera(res[0], res[1], fov=fov, to_world=cam_to_world,
                               fov_axis="y", flip=False)
    if atlas:
        th = max(a.shape[0] for a in atlas)
        tw = max(a.shape[1] for a in atlas)

        def pad(a):
            out = np.zeros((th, tw, 3), np.float32)
            out[: a.shape[0], : a.shape[1]] = a
            return out

        scene.textures = np.stack([pad(a) for a in atlas])
    return scene

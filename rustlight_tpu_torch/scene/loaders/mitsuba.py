"""Mitsuba 0.x/2.x XML scene loader (subset); port of
rustlight_tpu/scene/loaders/mitsuba.py.

Reference: src/scene_loader.rs:317-795 (via the external mitsuba_rs crate):
PLY/OBJ/rectangle/sphere/cube shapes (spheres tessellated 32x32,
scene_loader.rs:598-665), point emitters, area lights, constant/envmap
emitters, homogeneous media, and the common BSDF set. Camera built with the
file's fovAxis and flip=true (scene_loader.rs:333-337).
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ... import bsdfs
from ..camera import make_camera
from ..geometry import TriMesh, make_sphere, make_box, make_quad
from ..scene import Scene
from ..volume import make_volume
from .obj import load_obj
from .ply import load_ply


def _parse_rgb(s: str):
    s = s.replace(",", " ")
    v = [float(x) for x in s.split()]
    if len(v) == 1:
        v = v * 3
    return tuple(v[:3])


def _child_value(node, name, default=None, conv=float):
    for tag in ("float", "integer", "string", "boolean"):
        for c in node.findall(tag):
            if c.get("name") == name:
                v = c.get("value")
                if conv is bool:
                    return v.lower() == "true"
                return conv(v)
    return default


def _child_rgb(node, name, default=None):
    for tag in ("rgb", "srgb", "spectrum"):
        for c in node.findall(tag):
            if c.get("name") == name:
                return _parse_rgb(c.get("value"))
    return default


def _parse_transform(node) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    if node is None:
        return m
    for c in node:
        tag = c.tag.lower()
        if tag == "matrix":
            vals = [float(x) for x in c.get("value").replace(",", " ").split()]
            t = np.asarray(vals, np.float32).reshape(4, 4)
            m = t @ m
        elif tag == "lookat":
            origin = np.asarray(_parse_rgb(c.get("origin")), np.float32)
            target = np.asarray(_parse_rgb(c.get("target")), np.float32)
            up = np.asarray(_parse_rgb(c.get("up", "0,1,0")), np.float32)
            d = target - origin
            d /= np.linalg.norm(d)
            right = np.cross(up / np.linalg.norm(up), d)
            right /= np.linalg.norm(right)
            new_up = np.cross(d, right)
            t = np.eye(4, dtype=np.float32)
            t[:3, 0] = right
            t[:3, 1] = new_up
            t[:3, 2] = d
            t[:3, 3] = origin
            m = t @ m
        elif tag == "translate":
            t = np.eye(4, dtype=np.float32)
            t[:3, 3] = [float(c.get(a, 0)) for a in "xyz"]
            m = t @ m
        elif tag == "scale":
            if c.get("value") is not None:
                s = [float(c.get("value"))] * 3
            else:
                s = [float(c.get(a, 1)) for a in "xyz"]
            m = np.diag(s + [1.0]).astype(np.float32) @ m
        elif tag == "rotate":
            axis = np.asarray([float(c.get(a, 0)) for a in "xyz"], np.float32)
            axis /= np.linalg.norm(axis)
            ang = np.deg2rad(float(c.get("angle", 0)))
            cc, ss = np.cos(ang), np.sin(ang)
            t_ = 1 - cc
            X, Y, Z = axis
            r = np.array([
                [t_ * X * X + cc, t_ * X * Y - ss * Z, t_ * X * Z + ss * Y],
                [t_ * X * Y + ss * Z, t_ * Y * Y + cc, t_ * Y * Z - ss * X],
                [t_ * X * Z - ss * Y, t_ * Y * Z + ss * X, t_ * Z * Z + cc]],
                np.float32)
            t = np.eye(4, dtype=np.float32)
            t[:3, :3] = r
            m = t @ m
    return m


def _tex_kwargs(node, name, ctx):
    """Texture child on the diffuse slot (reference bsdf_mts texture
    conversion): bitmap -> atlas slot, checkerboard -> procedural."""
    if ctx is None:
        return None
    for tex in node.findall("texture"):
        if tex.get("name") != name:
            continue
        tkind = tex.get("type")
        if tkind == "bitmap":
            try:
                from ...utils import image as _rimage
                from ...bsdfs.table import TEX_BITMAP
                fn = _child_value(tex, "filename", None, conv=str)
                img = np.asarray(_rimage.load(ctx["dir"] / fn),
                                 np.float32)[..., :3]
                ctx["atlas"].append(img)
                us = _child_value(tex, "uscale", 1.0) or 1.0
                vs = _child_value(tex, "vscale", 1.0) or 1.0
                return dict(tex_kind=TEX_BITMAP,
                            tex_img=len(ctx["atlas"]) - 1,
                            tex_scale=(us, vs))
            except Exception:
                return None
        if tkind == "checkerboard":
            from ...bsdfs.table import TEX_CHECKER
            return dict(tex_kind=TEX_CHECKER,
                        tex_c1=_child_rgb(tex, "color1", (0.2,) * 3),
                        kd=_child_rgb(tex, "color0", (0.4,) * 3))
    return None


def _bsdf_desc(node, ctx=None) -> bsdfs.MaterialDesc:
    """Mitsuba bsdf -> archetype (reference bsdf_mts, bsdfs/mod.rs:498-612)."""
    kind = node.get("type", "diffuse")
    if kind == "twosided":
        inner = node.find("bsdf")
        return _bsdf_desc(inner, ctx) if inner is not None else bsdfs.diffuse()
    if kind in ("diffuse", "roughdiffuse"):
        tkw = _tex_kwargs(node, "reflectance", ctx)
        if tkw is not None:
            kd = tkw.pop("kd", (0.5, 0.5, 0.5))
            return bsdfs.diffuse(kd, **tkw)
        return bsdfs.diffuse(_child_rgb(node, "reflectance", (0.5,) * 3))
    if kind in ("dielectric", "thindielectric", "roughdielectric"):
        # IORs may be numeric or named ("water", "bk7", ... —
        # glass.rs:6-34); read as raw strings and resolve through the table
        from ...bsdfs.fresnel import resolve_ior
        return bsdfs.glass(
            int_ior=resolve_ior(_child_value(node, "intIOR", None, conv=str),
                                1.5046),
            ext_ior=resolve_ior(_child_value(node, "extIOR", None, conv=str),
                                1.000277))
    if kind in ("conductor", "roughconductor"):
        alpha = _child_value(node, "alpha", 0.1 if kind == "roughconductor" else 0.0)
        dist = _child_value(node, "distribution", "beckmann", conv=str)
        return bsdfs.metal(ks=_child_rgb(node, "specularReflectance", (1,) * 3),
                           eta_c=_child_rgb(node, "eta", (0.2, 0.92, 1.1)),
                           k_c=_child_rgb(node, "k", (3.9, 2.45, 2.14)),
                           alpha=alpha or 0.0, dist_ggx=(dist == "ggx"))
    if kind in ("plastic", "roughplastic"):
        alpha = _child_value(node, "alpha", 0.1)
        return bsdfs.substrate(kd=_child_rgb(node, "diffuseReflectance", (0.5,) * 3),
                               ks=_child_rgb(node, "specularReflectance", (0.04,) * 3),
                               alpha=alpha or 0.1)
    if kind == "phong":
        return bsdfs.phong(kd=_child_rgb(node, "diffuseReflectance", (0.5,) * 3),
                           ks=_child_rgb(node, "specularReflectance", (0.2,) * 3),
                           exponent=_child_value(node, "exponent", 30.0))
    return bsdfs.diffuse((0.5, 0.5, 0.5))


def load_mitsuba(path) -> Scene:
    path = Path(path)
    text = path.read_text(errors="ignore")
    root = ET.fromstring(text)

    # $defaults substitution
    defaults = {d.get("name"): d.get("value") for d in root.findall("default")}

    def subst(v):
        if isinstance(v, str) and v.startswith("$"):
            return defaults.get(v[1:], v)
        return v

    scene = Scene()
    ctx = {"dir": path.parent, "atlas": []}
    mat_by_id: Dict[str, int] = {}

    for b in root.findall("bsdf"):
        mid = scene.add_material(_bsdf_desc(b, ctx))
        if b.get("id"):
            mat_by_id[b.get("id")] = mid

    # sensor
    sensor = root.find("sensor")
    fov, fov_axis, to_world = 39.3077, "x", np.eye(4, dtype=np.float32)
    width = height = 512
    if sensor is not None:
        fov = _child_value(sensor, "fov", fov) or fov
        fov_axis = _child_value(sensor, "fovAxis", "x", conv=str) or "x"
        tw = sensor.find("transform")
        to_world = _parse_transform(tw)
        film = sensor.find("film")
        if film is not None:
            width = int(_child_value(film, "width", 512) or 512)
            height = int(_child_value(film, "height", 512) or 512)
    scene.camera = make_camera(width, height, fov=float(subst(fov)),
                               to_world=to_world, fov_axis=fov_axis, flip=True)

    # shapes
    for sh in root.findall("shape"):
        kind = sh.get("type")
        m = _parse_transform(sh.find("transform"))
        # material
        ref = sh.find("ref")
        inline = sh.find("bsdf")
        if ref is not None and ref.get("id") in mat_by_id:
            mat = mat_by_id[ref.get("id")]
        elif inline is not None:
            mat = scene.add_material(_bsdf_desc(inline, ctx))
        else:
            mat = scene.add_material(bsdfs.diffuse((0.5,) * 3))
        emitter = sh.find("emitter")
        emission = np.zeros(3, np.float32)
        if emitter is not None and emitter.get("type") == "area":
            emission = np.asarray(
                _child_rgb(emitter, "radiance", (1, 1, 1)), np.float32)

        meshes = []
        if kind == "obj":
            fname = _child_value(sh, "filename", None, conv=str)
            sub, mats, _tex = load_obj(path.parent / fname)
            for sm in sub:
                sm.material = mat
                sm.emission = emission
                meshes.append(sm)
        elif kind == "ply":
            fname = _child_value(sh, "filename", None, conv=str)
            meshes.append(load_ply(path.parent / fname, material=mat,
                                   emission=emission))
        elif kind == "serialized":
            # Mitsuba binary meshes (reference scene_loader.rs:499-500)
            from .serialized import load_serialized
            fname = _child_value(sh, "filename", None, conv=str)
            sidx = int(_child_value(sh, "shapeIndex", 0) or 0)
            meshes.append(load_serialized(path.parent / fname,
                                          shape_index=sidx, material=mat,
                                          emission=emission))
        elif kind == "rectangle":
            meshes.append(make_quad((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0),
                                    material=mat, emission=tuple(emission)))
        elif kind == "cube":
            meshes.append(make_box((-1, -1, -1), (1, 1, 1), material=mat))
        elif kind == "sphere":
            c = sh.find("point")
            center = ([float(c.get(a, 0)) for a in "xyz"]
                      if c is not None else (0, 0, 0))
            radius = _child_value(sh, "radius", 1.0) or 1.0
            meshes.append(make_sphere(center, radius, material=mat,
                                      emission=tuple(emission)))
        for mesh in meshes:
            v4 = np.concatenate([mesh.vertices,
                                 np.ones((len(mesh.vertices), 1), np.float32)], -1)
            mesh.vertices = (v4 @ m.T)[:, :3]
            if mesh.normals is not None:
                nm = np.linalg.inv(m[:3, :3]).T
                nn = mesh.normals @ nm.T
                mesh.normals = nn / np.maximum(
                    np.linalg.norm(nn, axis=-1, keepdims=True), 1e-20)
            scene.add_mesh(mesh)

    # standalone emitters
    for em in root.findall("emitter"):
        kind = em.get("type")
        if kind == "point":
            p = em.find("point")
            pos = ([float(p.get(a, 0)) for a in "xyz"] if p is not None
                   else (0, 0, 0))
            scene.point_lights.append(
                (np.asarray(pos, np.float32),
                 _child_rgb(em, "intensity", (1, 1, 1))))
        elif kind == "constant":
            scene.env_constant = np.asarray(
                _child_rgb(em, "radiance", (1, 1, 1)), np.float32)
        elif kind == "envmap":
            fname = _child_value(em, "filename", None, conv=str)
            if fname:
                from ...utils import image as rimage
                scene.env_image = rimage.load(str(path.parent / fname))
        elif kind in ("directional", "distant"):
            d = em.find("vector")
            dvec = ([float(d.get(a, 0)) for a in "xyz"] if d is not None
                    else (0, -1, 0))
            scene.directional_lights.append(
                (np.asarray(dvec, np.float32),
                 _child_rgb(em, "irradiance", (1, 1, 1))))

    # homogeneous medium (reference scene_loader.rs:734-781)
    for med in root.iter("medium"):
        if med.get("type") == "homogeneous":
            ss = _child_rgb(med, "sigmaS", None)
            sa = _child_rgb(med, "sigmaA", None)
            if ss is None and sa is None:
                st = _child_rgb(med, "sigmaT", (1, 1, 1))
                alb = _child_rgb(med, "albedo", (0.5, 0.5, 0.5))
                ss = tuple(t * a for t, a in zip(st, alb))
                sa = tuple(t - s for t, s in zip(st, ss))
            g = 0.0
            ph = med.find("phase")
            if ph is not None and ph.get("type") == "hg":
                g = _child_value(ph, "g", 0.0) or 0.0
            scene.volume = make_volume(sigma_s=ss or (0, 0, 0),
                                       sigma_a=sa or (0, 0, 0), g=g)
    if ctx["atlas"]:
        th = max(a.shape[0] for a in ctx["atlas"])
        tw = max(a.shape[1] for a in ctx["atlas"])

        def _pad(a):
            out = np.zeros((th, tw, 3), np.float32)
            out[: a.shape[0], : a.shape[1]] = a
            return out

        scene.textures = np.stack([_pad(a) for a in ctx["atlas"]])
    return scene

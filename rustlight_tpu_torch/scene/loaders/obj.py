"""Wavefront OBJ (+MTL) loader; port of rustlight_tpu/scene/loaders/obj.py.

The reference loads OBJ through the native tobj crate (src/geometry.rs:
13-97); here a C++ parser (csrc/obj_loader.cpp, built with g++ into
build/kernels/ at first use, called through ctypes) feeds numpy-vectorized
corner dedup, and a pure-Python line parser gives the same arrays where g++
is missing, as utils/piz.py chooses for its codec. `PARSES` counts the files
each parser read. Polygon faces triangulate as fans; per-material TriMesh
groups.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List

import numpy as np

from ...bsdfs import diffuse, TEX_BITMAP
from ..geometry import TriMesh

_LIB = None
_LIB_FAILED = False
PARSES = {"native": 0, "python": 0}


def _load_native():
    """The native parser, built with g++ into build/kernels/ at first use;
    None where it cannot be built."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    try:
        from ...ops.native import build_host
        so = build_host(Path(__file__).resolve().parents[2] / "csrc"
                        / "obj_loader.cpp")
        lib = ctypes.CDLL(str(so))
        lib.rl_obj_parse.restype = ctypes.c_void_p
        lib.rl_obj_parse.argtypes = [ctypes.c_char_p]
        lib.rl_obj_counts.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_longlong)]
        lib.rl_obj_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_char_p]
        lib.rl_obj_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    except Exception:
        _LIB_FAILED = True
    return _LIB


def _parse_obj_native(path: Path):
    """C++ parse -> flat numpy arrays, or None if the library is missing."""
    lib = _load_native()
    if lib is None:
        return None
    h = lib.rl_obj_parse(str(path).encode())
    if not h:
        return None
    try:
        c = (ctypes.c_longlong * 6)()
        lib.rl_obj_counts(h, c)
        nv, nn, nt, nf, ml, bl = (int(x) for x in c)
        pos = np.empty((nv, 3), np.float32)
        nrm = np.empty((nn, 3), np.float32)
        uv = np.empty((nt, 2), np.float32)
        fv = np.empty((nf, 3), np.int32)
        fvt = np.empty((nf, 3), np.int32)
        fvn = np.empty((nf, 3), np.int32)
        fmat = np.empty(nf, np.int32)
        mats = ctypes.create_string_buffer(ml + 1)
        mtllib = ctypes.create_string_buffer(bl + 1)
        fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        lib.rl_obj_fill(h, fp(pos), fp(nrm), fp(uv), ip(fv), ip(fvt),
                        ip(fvn), ip(fmat), mats, mtllib)
        names = mats.raw[:ml].decode(errors="ignore").split("\n") if ml else []
        return (pos, nrm, uv, fv, fvt, fvn, fmat, names,
                mtllib.raw[:bl].decode(errors="ignore"))
    finally:
        lib.rl_obj_free(h)


def _parse_mtl(path: Path) -> Dict[str, dict]:
    mats: Dict[str, dict] = {}
    cur = None
    if not path.exists():
        return mats
    for line in path.read_text(errors="ignore").splitlines():
        tok = line.split()
        if not tok or tok[0].startswith("#"):
            continue
        if tok[0] == "newmtl":
            cur = tok[1]
            mats[cur] = {}
        elif cur is not None:
            if tok[0] == "Kd":
                mats[cur]["kd"] = tuple(float(x) for x in tok[1:4])
            elif tok[0] == "Ks":
                mats[cur]["ks"] = tuple(float(x) for x in tok[1:4])
            elif tok[0] == "Ns":
                mats[cur]["ns"] = float(tok[1])
            elif tok[0] == "Ke":
                mats[cur]["ke"] = tuple(float(x) for x in tok[1:4])
            elif tok[0] == "map_Kd":
                mats[cur]["map_kd"] = tok[-1]
    return mats


def _parse_obj_py(path: Path):
    """Pure-Python fallback parser producing the same flat arrays."""
    vs, vns, vts = [], [], []
    fv, fvt, fvn, fmat = [], [], [], []
    names: List[str] = []
    mat_ids: Dict[str, int] = {}
    cur_mat = -1
    mtllib = ""

    for line in path.read_text(errors="ignore").splitlines():
        tok = line.split()
        if not tok or tok[0].startswith("#"):
            continue
        t = tok[0]
        if t == "v":
            vs.append(tuple(float(x) for x in tok[1:4]))
        elif t == "vn":
            vns.append(tuple(float(x) for x in tok[1:4]))
        elif t == "vt":
            vts.append(tuple(float(x) for x in tok[1:3]))
        elif t == "mtllib":
            mtllib = tok[1]
        elif t == "usemtl":
            nm = tok[1]
            if nm not in mat_ids:
                mat_ids[nm] = len(names)
                names.append(nm)
            cur_mat = mat_ids[nm]
        elif t == "f":
            corners = []
            for c in tok[1:]:
                parts = c.split("/")
                vi = int(parts[0])
                vi = vi - 1 if vi > 0 else len(vs) + vi
                ti = ni = -1
                if len(parts) > 1 and parts[1]:
                    ti = int(parts[1])
                    ti = ti - 1 if ti > 0 else len(vts) + ti
                if len(parts) > 2 and parts[2]:
                    ni = int(parts[2])
                    ni = ni - 1 if ni > 0 else len(vns) + ni
                corners.append((vi, ti, ni))
            for i in range(1, len(corners) - 1):  # fan triangulation
                for k in (0, i, i + 1):
                    fv.append(corners[k][0])
                    fvt.append(corners[k][1])
                    fvn.append(corners[k][2])
                fmat.append(cur_mat)

    return (np.asarray(vs, np.float32).reshape(-1, 3),
            np.asarray(vns, np.float32).reshape(-1, 3),
            np.asarray(vts, np.float32).reshape(-1, 2),
            np.asarray(fv, np.int32).reshape(-1, 3),
            np.asarray(fvt, np.int32).reshape(-1, 3),
            np.asarray(fvn, np.int32).reshape(-1, 3),
            np.asarray(fmat, np.int32),
            names, mtllib)


def load_obj(path, default_material: int = 0):
    """Parse an OBJ file (native C++ parser when available).

    Returns (meshes, materials, textures): per-material TriMesh groups, the
    corresponding MaterialDesc list (indices are *local*; the caller offsets
    them), and a list of texture file paths (may be empty).
    """
    path = Path(path)
    flat = _parse_obj_native(path)
    PARSES["python" if flat is None else "native"] += 1
    if flat is None:
        flat = _parse_obj_py(path)
    pos, nrm, uv, fv, fvt, fvn, fmat, names, mtllib = flat
    mtl = _parse_mtl(path.parent / mtllib) if mtllib else {}

    meshes, materials, textures = [], [], []
    for gid in np.unique(fmat):
        mat_name = names[gid] if gid >= 0 else ""
        md = mtl.get(mat_name, {})
        kd = md.get("kd", (0.8, 0.8, 0.8))
        desc = diffuse(kd)
        if "map_kd" in md:
            tex_path = str(path.parent / md["map_kd"])
            desc.tex_kind = TEX_BITMAP
            desc.tex_img = len(textures)
            textures.append(tex_path)
        materials.append(desc)
        emission = np.asarray(md.get("ke", (0, 0, 0)), np.float32)

        # numpy-vectorized (v, t, n) corner dedup
        sel = fmat == gid
        corners = np.stack([fv[sel], fvt[sel], fvn[sel]], -1).reshape(-1, 3)
        uniq, inv = np.unique(corners, axis=0, return_inverse=True)
        idx = inv.reshape(-1, 3).astype(np.int32)
        verts = pos[uniq[:, 0]]
        has_uv = bool((uniq[:, 1] >= 0).any()) and uv.shape[0] > 0
        has_n = bool((uniq[:, 2] >= 0).any()) and nrm.shape[0] > 0
        uvs = np.where((uniq[:, 1] >= 0)[:, None],
                       uv[np.clip(uniq[:, 1], 0, max(uv.shape[0] - 1, 0))],
                       0.0).astype(np.float32) if has_uv else None
        norms = np.where((uniq[:, 2] >= 0)[:, None],
                         nrm[np.clip(uniq[:, 2], 0, max(nrm.shape[0] - 1, 0))],
                         0.0).astype(np.float32) if has_n else None
        meshes.append(TriMesh(
            vertices=verts, indices=idx, normals=norms, uvs=uvs,
            material=len(materials) - 1, emission=emission,
            name=f"{path.stem}:{mat_name}",
        ))
    return meshes, materials, textures

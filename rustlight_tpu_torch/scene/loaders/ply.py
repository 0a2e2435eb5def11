"""Minimal PLY mesh reader (ascii + binary little/big endian); port of
rustlight_tpu/scene/loaders/ply.py.

Supports vertex properties x/y/z (+nx/ny/nz, u/v or s/t) and face
vertex_indices lists — the subset pbrt/mitsuba scenes use.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..geometry import TriMesh

_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path, material: int = 0, emission=(0, 0, 0)) -> TriMesh:
    data = Path(path).read_bytes()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="ignore").splitlines()
    body = data[header_end:]

    fmt = "ascii"
    elements = []  # (name, count, [(type, propname) or ('list', ctype, itype, name)])
    cur = None
    for line in header:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            cur = (tok[1], int(tok[2]), [])
            elements.append(cur)
        elif tok[0] == "property" and cur is not None:
            if tok[1] == "list":
                cur[2].append(("list", tok[2], tok[3], tok[4]))
            else:
                cur[2].append((tok[1], tok[2]))

    endian = "<" if "little" in fmt else ">"
    verts = norms = uvs = None
    faces = []

    if fmt == "ascii":
        lines = body.decode("ascii", errors="ignore").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = [p[-1] for p in props]
                arr = np.array(lines[pos:pos + count * len(props)],
                               dtype=np.float32).reshape(count, len(props))
                pos += count * len(props)
                verts, norms, uvs = _extract(arr, cols)
            elif name == "face":
                for _ in range(count):
                    k = int(lines[pos]); pos += 1
                    idx = [int(x) for x in lines[pos:pos + k]]; pos += k
                    for i in range(1, k - 1):
                        faces.append((idx[0], idx[i], idx[i + 1]))
            else:
                # skip unknown elements (ascii): assume scalar props
                pos += count * len(props)
    else:
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                scalar = all(p[0] != "list" for p in props)
                assert scalar, "list property on vertices unsupported"
                fmt_str = endian + "".join(_TYPES[p[0]][0] for p in props)
                size = struct.calcsize(fmt_str)
                arr = np.frombuffer(body, dtype=np.dtype(
                    [(p[1], endian + _TYPES[p[0]][0]) for p in props]),
                    count=count, offset=off)
                off += size * count
                cols = [p[1] for p in props]
                flat = np.stack([arr[c].astype(np.float32) for c in cols], -1)
                verts, norms, uvs = _extract(flat, cols)
            elif name == "face":
                assert props and props[0][0] == "list"
                _, ctype, itype, _ = props[0]
                cfmt, csz = _TYPES[ctype]
                ifmt, isz = _TYPES[itype]
                for _ in range(count):
                    (k,) = struct.unpack_from(endian + cfmt, body, off)
                    off += csz
                    idx = struct.unpack_from(endian + str(k) + ifmt, body, off)
                    off += isz * k
                    for i in range(1, k - 1):
                        faces.append((idx[0], idx[i], idx[i + 1]))
    return TriMesh(
        vertices=verts, indices=np.asarray(faces, np.int32),
        normals=norms, uvs=uvs, material=material,
        emission=np.asarray(emission, np.float32), name=Path(path).stem)


def _extract(arr, cols):
    def col3(a, b, c):
        if a in cols and b in cols and c in cols:
            return np.stack([arr[:, cols.index(x)] for x in (a, b, c)], -1)
        return None

    def col2(a, b):
        if a in cols and b in cols:
            return np.stack([arr[:, cols.index(x)] for x in (a, b)], -1)
        return None

    verts = col3("x", "y", "z")
    norms = col3("nx", "ny", "nz")
    uvs = col2("u", "v")
    if uvs is None:
        uvs = col2("s", "t")
    return verts, norms, uvs

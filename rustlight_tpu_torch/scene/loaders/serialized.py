"""Mitsuba `.serialized` binary mesh format; port of
rustlight_tpu/scene/loaders/serialized.py.

Reference: the external mitsuba_rs crate the reference delegates to for
`<shape type="serialized">` (src/scene_loader.rs:499-500). Format (Mitsuba
0.5/0.6 docs, fileformat 0x041C):

  file   := chunk*  offsets  count
  chunk  := u16 magic (0x041C), u16 version (3 or 4), zlib stream
  end    := u64 offset per mesh ... u32 mesh_count  (trailing dictionary)

Decompressed chunk payload:
  u32 flags        (0x0001 normals, 0x0002 texcoords, 0x0008 vertex colors,
                    0x0010 face normals, 0x1000 single precision,
                    0x2000 double precision)
  [version >= 4] null-terminated utf-8 name
  u64 vertex_count, u64 triangle_count
  positions [V,3] f32/f64, normals [V,3] if flag, texcoords [V,2] if flag,
  colors [V,3] if flag, indices [T,3] u32
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..geometry import TriMesh

MAGIC = 0x041C
_F_NORMALS = 0x0001
_F_TEXCOORDS = 0x0002
_F_COLORS = 0x0008
_F_FACE_NORMALS = 0x0010
_F_SINGLE = 0x1000
_F_DOUBLE = 0x2000


def _mesh_offsets(data: bytes):
    """Trailing dictionary: u32 count at EOF, preceded by count offsets —
    u64 in current files, u32 in old (pre-0.4) ones. Validate the decoded
    offsets against the chunk magic and fall back across widths, so both
    generations load (the reference delegates this to mitsuba_rs)."""
    (count,) = struct.unpack_from("<I", data, len(data) - 4)

    def try_width(fmt, width):
        if count == 0 or len(data) < 4 + width * count:
            return None
        off = struct.unpack_from(f"<{count}{fmt}",
                                 data, len(data) - 4 - width * count)
        for o in off:
            if o + 4 > len(data) or struct.unpack_from("<H", data, o)[0] != MAGIC:
                return None
        return list(off)

    return try_width("Q", 8) or try_width("I", 4) or [0]


def load_serialized(path, shape_index: int = 0, material: int = 0,
                    emission=(0.0, 0.0, 0.0), name: str = "") -> TriMesh:
    data = Path(path).read_bytes()
    offsets = _mesh_offsets(data)
    if not (0 <= shape_index < len(offsets)):
        raise ValueError(
            f"{path}: shapeIndex {shape_index} out of range "
            f"({len(offsets)} meshes)")
    off = offsets[shape_index]
    magic, version = struct.unpack_from("<HH", data, off)
    if magic != MAGIC:
        raise ValueError(f"{path}: bad serialized magic {magic:#x} at {off}")
    payload = zlib.decompress(data[off + 4:])

    pos = 0
    (flags,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    mesh_name = ""
    if version >= 4:
        end = payload.index(b"\x00", pos)
        mesh_name = payload[pos:end].decode("utf-8", errors="replace")
        pos = end + 1
    n_v, n_t = struct.unpack_from("<QQ", payload, pos)
    pos += 16

    if flags & _F_DOUBLE:
        fdt, fsz = np.float64, 8
    else:   # single precision (0x1000) or legacy default
        fdt, fsz = np.float32, 4

    def take(n, dt, sz):
        nonlocal pos
        a = np.frombuffer(payload, dt, count=n, offset=pos)
        pos += n * sz
        return a

    verts = take(3 * n_v, fdt, fsz).reshape(n_v, 3).astype(np.float32)
    normals = None
    if flags & _F_NORMALS:
        normals = take(3 * n_v, fdt, fsz).reshape(n_v, 3).astype(np.float32)
    uvs = None
    if flags & _F_TEXCOORDS:
        uvs = take(2 * n_v, fdt, fsz).reshape(n_v, 2).astype(np.float32)
    if flags & _F_COLORS:
        take(3 * n_v, fdt, fsz)   # vertex colors unused (as in the reference)
    idt = np.uint64 if n_v > 0xFFFFFFFF else np.uint32
    isz = 8 if n_v > 0xFFFFFFFF else 4
    idx = take(3 * n_t, idt, isz).reshape(n_t, 3).astype(np.int32)

    if flags & _F_FACE_NORMALS:
        normals = None   # per-face shading = geometric normals
    return TriMesh(vertices=verts, indices=idx, normals=normals, uvs=uvs,
                   material=material, emission=np.asarray(emission, np.float32),
                   name=name or mesh_name or Path(path).stem)


def save_serialized(path, meshes):
    """Write TriMesh list as a v4 single/multi-mesh .serialized file
    (used by tests to round-trip the reader)."""
    blobs = []
    for m in meshes:
        flags = _F_SINGLE
        if m.normals is not None:
            flags |= _F_NORMALS
        if m.uvs is not None:
            flags |= _F_TEXCOORDS
        payload = struct.pack("<I", flags)
        payload += (m.name or "mesh").encode() + b"\x00"
        payload += struct.pack("<QQ", len(m.vertices), len(m.indices))
        payload += np.asarray(m.vertices, np.float32).tobytes()
        if m.normals is not None:
            payload += np.asarray(m.normals, np.float32).tobytes()
        if m.uvs is not None:
            payload += np.asarray(m.uvs, np.float32).tobytes()
        payload += np.asarray(m.indices, np.uint32).tobytes()
        blobs.append(struct.pack("<HH", MAGIC, 4) + zlib.compress(payload))
    out = b""
    offsets = []
    for b in blobs:
        offsets.append(len(out))
        out += b
    out += struct.pack(f"<{len(blobs)}Q", *offsets)
    out += struct.pack("<I", len(blobs))
    Path(path).write_bytes(out)

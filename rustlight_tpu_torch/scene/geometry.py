"""Triangle meshes and their flattened tables; port of
rustlight_tpu/scene/geometry.py.

Host side: `TriMesh` (indexed triangles + material/emission). Tables: one
flat SoA over all scene triangles, padded to a multiple of TRI_PAD, with the
precomputed Baldwin-Weber rows the dense intersector tests against
(accel/dense.py). Scenes above CLUSTER_THRESHOLD triangles also carry the
tile walk's tables (accel/walk.py), built from one SAH BVH; the reference's
XLA clustered tables are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from ..accel.walk import build_walk_tables, walk_tables_to

TRI_PAD = 8
CLUSTER_THRESHOLD = 1024

@dataclass
class TriMesh:
    """Host-side indexed triangle mesh."""
    vertices: np.ndarray            # [v, 3] f32
    indices: np.ndarray             # [t, 3] int32
    normals: Optional[np.ndarray] = None   # [v, 3]
    uvs: Optional[np.ndarray] = None       # [v, 2]
    material: int = 0
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    name: str = ""
    # the reference's EmissionType (geometry.rs:99-104): 0 = the constant
    # color `emission`, 1 = HSV ramp over u, 2 = texture atlas slot
    emission_kind: int = 0
    emission_scale: float = 1.0
    emission_tex: int = -1          # index into the scene texture atlas

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32)
        self.indices = np.asarray(self.indices, np.int32)
        self.emission = np.asarray(self.emission, np.float32)
        if self.normals is not None:
            self.normals = np.asarray(self.normals, np.float32)
        if self.uvs is not None:
            self.uvs = np.asarray(self.uvs, np.float32)

    @property
    def n_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def is_light(self) -> bool:
        if self.emission_kind != 0:
            return self.emission_scale > 0.0
        return bool(np.any(self.emission > 0.0))

    def mean_emission(self, textures=None) -> np.ndarray:
        """Representative Le for the flux and the atom weights: the HSV
        ramp's mean over u, or the texture's mean, times the scale; the
        exact uv-dependent value is applied where emission is evaluated."""
        if self.emission_kind == 1:
            return np.asarray([0.5, 0.5, 0.0], np.float32) * self.emission_scale
        if self.emission_kind == 2:
            if textures is not None and 0 <= self.emission_tex < len(textures):
                return (np.asarray(textures[self.emission_tex], np.float32)
                        .mean(axis=(0, 1)) * self.emission_scale)
            return np.full(3, self.emission_scale, np.float32)
        return self.emission

    def triangle_areas(self) -> np.ndarray:
        v, i = self.vertices, self.indices
        e1 = v[i[:, 1]] - v[i[:, 0]]
        e2 = v[i[:, 2]] - v[i[:, 0]]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    def total_area(self) -> float:
        return float(self.triangle_areas().sum())

    def flux(self, textures=None) -> np.ndarray:
        """Emitter flux = area * Le * pi."""
        return self.total_area() * self.mean_emission(textures) * np.pi

    def compute_vertex_normals(self) -> None:
        """Area-weighted vertex normals (for smooth shading when absent)."""
        v, i = self.vertices, self.indices
        fn = np.cross(v[i[:, 1]] - v[i[:, 0]], v[i[:, 2]] - v[i[:, 0]])
        n = np.zeros_like(v)
        for k in range(3):
            np.add.at(n, i[:, k], fn)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        self.normals = n / np.maximum(norm, 1e-20)


class GeometryTables(NamedTuple):
    """Flat per-triangle SoA (padded to TRI_PAD). Pad rows are degenerate."""
    n_tris: int
    n_pad: int
    v0: Any          # [T, 3]
    e1: Any          # [T, 3]
    e2: Any          # [T, 3]
    n_g: Any         # [T, 3] unit geometric normal
    inter_rows: Any  # [T, 3, 4] Baldwin-Weber rows (N4 | U4 | V4)
    vn: Any          # [T, 3, 3] per-corner shading normals
    vuv: Any         # [T, 3, 2] per-corner uvs
    area: Any        # [T]
    mat_id: Any      # [T] int32
    mesh_id: Any     # [T] int32
    emitter_id: Any  # [T] int32, -1 if not emissive
    has_normals: Any  # [T] bool
    walk: Any = None  # accel/walk.py WalkTables above CLUSTER_THRESHOLD


def _baldwin_weber_rows(v0, e1, e2, n):
    """Per-triangle world->(t, u, v) affine rows [t, 3, 4] = [N4, U4, V4],
    X4 = [x, -x.v0]: u = w1.(p - v0) with w1 = (e2 x n)/((e2 x n).e1),
    v likewise with w2 = (e1 x n)/((e1 x n).e2), t = -(n.o + d)/(n.d)."""
    c2 = np.cross(e2, n)
    d1 = np.sum(c2 * e1, axis=-1, keepdims=True)
    w1 = c2 / np.where(np.abs(d1) > 1e-30, d1, 1.0)
    c1 = np.cross(e1, n)
    d2 = np.sum(c1 * e2, axis=-1, keepdims=True)
    w2 = c1 / np.where(np.abs(d2) > 1e-30, d2, 1.0)

    def row4(x):
        return np.concatenate([x, -np.sum(x * v0, axis=-1, keepdims=True)], axis=-1)

    return np.stack([row4(n), row4(w1), row4(w2)], axis=1).astype(
        np.float32, copy=False)


def build_geometry_tables(meshes: List[TriMesh],
                          mesh_emitter_id: List[int]) -> GeometryTables:
    """Flatten meshes into one padded triangle table (numpy).

    mesh_emitter_id[i] = emitter index for mesh i, or -1."""
    n_tris = sum(m.n_triangles for m in meshes)
    cols = {k: [] for k in ("v0", "e1", "e2", "ng", "rows", "vn", "vuv",
                            "area", "mat", "mid", "eid", "hasn")}
    for mi, m in enumerate(meshes):
        v, idx = np.asarray(m.vertices, np.float32), m.indices
        p0, p1, p2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
        e1 = p1 - p0
        e2 = p2 - p0
        nraw = np.cross(e1, e2)
        nlen = np.linalg.norm(nraw, axis=-1, keepdims=True)
        ng = nraw / np.maximum(nlen, 1e-30)
        nt = len(idx)
        cols["v0"].append(p0)
        cols["e1"].append(e1)
        cols["e2"].append(e2)
        cols["ng"].append(ng)
        cols["rows"].append(_baldwin_weber_rows(p0, e1, e2, ng))
        cols["area"].append(0.5 * nlen[:, 0])
        if m.normals is not None:
            cols["vn"].append(np.stack([m.normals[idx[:, k]] for k in range(3)], 1))
            cols["hasn"].append(np.ones(nt, bool))
        else:
            cols["vn"].append(np.repeat(ng[:, None, :], 3, axis=1))
            cols["hasn"].append(np.zeros(nt, bool))
        if m.uvs is not None:
            cols["vuv"].append(np.stack([m.uvs[idx[:, k]] for k in range(3)], 1))
        else:
            cols["vuv"].append(np.zeros((nt, 3, 2), np.float32))
        cols["mat"].append(np.full(nt, m.material, np.int32))
        cols["mid"].append(np.full(nt, mi, np.int32))
        cols["eid"].append(np.full(nt, mesh_emitter_id[mi], np.int32))
    c = {k: np.concatenate(v, axis=0) for k, v in cols.items()}

    t_pad = max(TRI_PAD, ((n_tris + TRI_PAD - 1) // TRI_PAD) * TRI_PAD)
    pad = t_pad - n_tris

    def padz(x, fill=0):
        return np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, x.dtype)], axis=0)

    # degenerate pad triangles: n = 0 rows make Nd == 0, so they never hit
    gt = GeometryTables(
        n_tris=n_tris, n_pad=t_pad,
        v0=padz(c["v0"]), e1=padz(c["e1"]), e2=padz(c["e2"]),
        n_g=padz(c["ng"]), inter_rows=padz(c["rows"]),
        vn=padz(c["vn"]), vuv=padz(c["vuv"]), area=padz(c["area"]),
        mat_id=padz(c["mat"]), mesh_id=padz(c["mid"], -1),
        emitter_id=padz(c["eid"], -1), has_normals=padz(c["hasn"], False),
    )
    if n_tris > CLUSTER_THRESHOLD:
        gt = gt._replace(walk=build_walk_tables(gt))
    return gt


def geometry_to(geom, device, walk_options=None) -> GeometryTables:
    """Upload numpy geometry tables (this module's or the JAX package's,
    read by attribute) to `device`; the JAX package's walk tables are
    converted to this package's layout and its clustered tables ignored.
    `walk_options` (accel/walk.py: WalkOptions) sets the walk's schedule."""
    walk = getattr(geom, "walk", None)
    if walk is None and geom.n_tris > CLUSTER_THRESHOLD:
        raise NotImplementedError(
            f"{geom.n_tris} triangles and no walk tables: only the tile "
            "walk is ported for scenes of this size")
    cols = {f: torch.as_tensor(np.ascontiguousarray(getattr(geom, f)),
                               device=device)
            for f in GeometryTables._fields
            if f not in ("n_tris", "n_pad", "walk")}
    return GeometryTables(
        n_tris=int(geom.n_tris), n_pad=int(geom.n_pad),
        walk=(None if walk is None
              else walk_tables_to(walk, device, walk_options)), **cols)


def scene_bounds(meshes: List[TriMesh]):
    lo = np.min([m.vertices.min(0) for m in meshes], axis=0)
    hi = np.max([m.vertices.max(0) for m in meshes], axis=0)
    center = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - center))
    return lo, hi, center, radius


def make_quad(p0, p1, p2, p3, material=0, emission=(0, 0, 0), name="") -> TriMesh:
    """Quad from 4 corners (ccw), split into 2 triangles."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return TriMesh(verts, idx, uvs=uv, material=material,
                   emission=np.asarray(emission, np.float32), name=name)


def make_box(lo, hi, material=0, name="") -> TriMesh:
    """Axis-aligned box with outward normals."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    quads = [
        ([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]),   # -z
        ([x1, y0, z1], [x0, y0, z1], [x0, y1, z1], [x1, y1, z1]),   # +z
        ([x0, y0, z1], [x0, y0, z0], [x0, y1, z0], [x0, y1, z1]),   # -x
        ([x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0]),   # +x
        ([x0, y0, z1], [x1, y0, z1], [x1, y0, z0], [x0, y0, z0]),   # -y
        ([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]),   # +y
    ]
    verts, idx = [], []
    for q in quads:
        base = len(verts)
        verts.extend(q)
        idx.append([base, base + 1, base + 2])
        idx.append([base, base + 2, base + 3])
    return TriMesh(np.asarray(verts, np.float32), np.asarray(idx, np.int32),
                   material=material, name=name)


def make_sphere(center, radius, material=0, emission=(0, 0, 0),
                n_theta=32, n_phi=32, name="") -> TriMesh:
    """Tessellated UV sphere (the reference tessellates spheres 32x32)."""
    center = np.asarray(center, np.float32)
    thetas = np.linspace(0, np.pi, n_theta + 1)
    phis = np.linspace(0, 2 * np.pi, n_phi + 1)
    verts, norms, uvs = [], [], []
    for it, th in enumerate(thetas):
        for ip, ph in enumerate(phis):
            n = np.array([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                          np.cos(th)], np.float32)
            verts.append(center + radius * n)
            norms.append(n)
            uvs.append([ip / n_phi, it / n_theta])
    idx = []
    stride = n_phi + 1
    for it in range(n_theta):
        for ip in range(n_phi):
            a = it * stride + ip
            b = a + 1
            c = a + stride
            d = c + 1
            if it > 0:
                idx.append([a, c, b])
            if it < n_theta - 1:
                idx.append([b, c, d])
    return TriMesh(np.asarray(verts, np.float32), np.asarray(idx, np.int32),
                   normals=np.asarray(norms, np.float32),
                   uvs=np.asarray(uvs, np.float32), material=material,
                   emission=np.asarray(emission, np.float32), name=name)

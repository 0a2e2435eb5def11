"""The port's scene loaders against the JAX package's, on the same files.

Inputs: the five example scenes of examples/ and the small files that
tests/test_loaders.py writes (OBJ + MTL, PLY ascii and binary, a PBRT scene,
instances, imagemap and checkerboard textures, Mitsuba scenes with a
bitmap, named IORs and `.serialized` shapes, the latter written by the JAX
package's save_serialized, and a pre-0.4 `.serialized` file).

Both packages load each file; every field of the host Scene must be equal
(meshes, materials, texture atlas, camera, lights, environment, medium).
Then both compile it, and every column of the compiled host tables must be
equal: the geometry rows, the walk tables (the JAX package's converted to
the port's layout), the emitter atoms with their CDF and the environment's
2D CDF, the material table. Bound: bit-equal, dtypes included; the loaders
and the table builders are the same numpy code on the same inputs.

Also: the native OBJ parser against the Python parser, and
examples/cbox.pbrt against the port's procedural cornell_box.
"""
import dataclasses
import struct
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from rustlight_tpu.scene.loaders import load_scene as jax_load_scene
from rustlight_tpu.scene.loaders import ply as jply
from rustlight_tpu.scene.loaders import obj as jobj
from rustlight_tpu.scene.loaders import serialized as jser
from rustlight_tpu.scene import geometry as jgeometry
from rustlight_tpu.scene.camera import resize_camera as jax_resize_camera
from rustlight_tpu.bsdfs.fresnel import resolve_ior as jax_resolve_ior
from rustlight_tpu.utils import image as jimage
from rustlight_tpu_torch.accel.walk import WalkTables, walk_tables_from_numpy
from rustlight_tpu_torch.bsdfs.fresnel import NAMED_IOR, resolve_ior
from rustlight_tpu_torch.bsdfs.table import _FIELDS, KIND_GLASS
from rustlight_tpu_torch.integrators import IntegratorPathTracing, render
from rustlight_tpu_torch.models import cornell_box
from rustlight_tpu_torch.scene import geometry as tgeometry
from rustlight_tpu_torch.scene.camera import resize_camera
from rustlight_tpu_torch.scene.emitters import EmitterTables
from rustlight_tpu_torch.scene.geometry import GeometryTables
from rustlight_tpu_torch.scene.loaders import LOADERS, load_scene, register_loader
from rustlight_tpu_torch.scene.loaders import obj as tobj
from rustlight_tpu_torch.scene.loaders import ply as tply
from rustlight_tpu_torch.scene.loaders import serialized as tser

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["cbox.pbrt", "instances.pbrt", "caustic.pbrt", "envglass.xml",
            "fog_box.xml"]

FILES = {
    "box.mtl": """\
        newmtl red
        Kd 0.8 0.1 0.1
        newmtl lamp
        Kd 0 0 0
        Ke 5 5 5
        """,
    "box.obj": """\
        mtllib box.mtl
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        vn 0 0 1
        vt 0 0
        vt 1 0
        vt 1 1
        vt 0 1
        usemtl red
        f 1/1/1 2/2/1 3/3/1 4/4/1
        usemtl lamp
        f 1/1/1 3/3/1 2/2/1
        """,
    "t.ply": """\
        ply
        format ascii 1.0
        element vertex 3
        property float x
        property float y
        property float z
        element face 1
        property list uchar int vertex_indices
        end_header
        0 0 0
        1 0 0
        0 1 0
        3 0 1 2
        """,
    "scene.pbrt": """\
        LookAt 0 1 -4  0 1 0  0 1 0
        Camera "perspective" "float fov" [45]
        Film "image" "integer xresolution" [32] "integer yresolution" [32]
        WorldBegin
        AttributeBegin
          AreaLightSource "diffuse" "rgb L" [10 10 10]
          Shape "trianglemesh"
            "point P" [-0.5 1.9 -0.5  0.5 1.9 -0.5  0.5 1.9 0.5  -0.5 1.9 0.5]
            "integer indices" [0 1 2 0 2 3]
        AttributeEnd
        Material "matte" "rgb Kd" [0.7 0.7 0.7]
        Shape "trianglemesh"
          "point P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]
          "integer indices" [0 1 2 0 2 3]
        LightSource "point" "point from" [0 3 0] "rgb I" [4 4 4]
        LightSource "distant" "point from" [0 0 0] "point to" [0.3 -1 0.2]
          "rgb L" [0.5 0.6 0.7]
        LightSource "infinite" "rgb L" [0.2 0.3 0.4]
        Shape "sphere" "float radius" [0.3]
        WorldEnd
        """,
    "objects.pbrt": """\
        Film "image" "integer xresolution" [16] "integer yresolution" [16]
        WorldBegin
        Material "matte" "rgb Kd" [0.6 0.2 0.2]
        ObjectBegin "post"
          Shape "trianglemesh"
            "point P" [-0.1 0 -0.1  0.1 0 -0.1  0.1 1 -0.1  -0.1 1 -0.1]
            "integer indices" [0 1 2 0 2 3]
        ObjectEnd
        AttributeBegin
          Translate 2 0 0
          ObjectInstance "post"
        AttributeEnd
        AttributeBegin
          Translate -2 0 0
          Scale 1 2 1
          Rotate 30 0 1 0
          ObjectInstance "post"
        AttributeEnd
        ObjectInstance "post"
        WorldEnd
        """,
    "textures.pbrt": """\
        Film "image" "integer xresolution" [16] "integer yresolution" [16]
        WorldBegin
        Texture "wood" "spectrum" "imagemap" "string filename" ["t.pfm"]
        Texture "check" "spectrum" "checkerboard" "rgb tex1" [0.1 0.1 0.1] "rgb tex2" [0.9 0.9 0.9]
        Material "matte" "texture Kd" ["wood"]
        Shape "trianglemesh" "point P" [-2 0 0  2 0 0  2 2 0  -2 2 0] "integer indices" [0 1 2 0 2 3] "float uv" [0 0 1 0 1 1 0 1]
        Material "matte" "texture Kd" ["check"]
        Shape "trianglemesh" "point P" [-2 -2 1  2 -2 1  2 0 1  -2 0 1] "integer indices" [0 1 2 0 2 3] "float uv" [0 0 1 0 1 1 0 1]
        Material "plastic" "rgb Kd" [0.3 0.2 0.1] "float roughness" [0.05]
        Shape "plymesh" "string filename" "q.ply"
        WorldEnd
        """,
    "scene.xml": """\
        <scene version="0.6.0">
          <default name="fov" value="45"/>
          <sensor type="perspective">
            <float name="fov" value="45"/>
            <string name="fovAxis" value="y"/>
            <transform name="toWorld">
              <lookat origin="0, 1, -4" target="0, 1, 0" up="0, 1, 0"/>
            </transform>
            <film type="hdrfilm">
              <integer name="width" value="24"/>
              <integer name="height" value="18"/>
            </film>
          </sensor>
          <bsdf type="diffuse" id="white">
            <rgb name="reflectance" value="0.7, 0.7, 0.7"/>
          </bsdf>
          <bsdf type="plastic" id="plastic"/>
          <bsdf type="phong" id="phong"/>
          <shape type="rectangle">
            <transform name="toWorld">
              <rotate x="1" angle="-90"/>
              <scale value="5"/>
            </transform>
            <ref id="white"/>
          </shape>
          <shape type="cube">
            <transform name="toWorld">
              <scale x="0.3" y="0.5" z="0.3"/>
              <matrix value="1 0 0 0.5  0 1 0 0.5  0 0 1 0  0 0 0 1"/>
            </transform>
            <ref id="plastic"/>
          </shape>
          <shape type="obj">
            <string name="filename" value="box.obj"/>
            <ref id="phong"/>
          </shape>
          <shape type="ply">
            <string name="filename" value="t.ply"/>
            <bsdf type="roughconductor">
              <string name="distribution" value="ggx"/>
              <float name="alpha" value="0.2"/>
            </bsdf>
          </shape>
          <shape type="sphere">
            <point name="center" x="0" y="1.8" z="0"/>
            <float name="radius" value="0.2"/>
            <ref id="white"/>
            <emitter type="area">
              <rgb name="radiance" value="8, 8, 8"/>
            </emitter>
          </shape>
          <emitter type="point">
            <point name="position" x="0" y="2" z="0"/>
            <rgb name="intensity" value="3, 2, 1"/>
          </emitter>
          <emitter type="directional">
            <vector name="direction" x="0.2" y="-1" z="0.1"/>
            <rgb name="irradiance" value="0.4, 0.4, 0.4"/>
          </emitter>
          <emitter type="constant">
            <rgb name="radiance" value="0.1, 0.2, 0.3"/>
          </emitter>
          <medium type="homogeneous">
            <rgb name="sigmaT" value="0.3, 0.2, 0.1"/>
            <rgb name="albedo" value="0.8, 0.7, 0.6"/>
            <phase type="hg"><float name="g" value="-0.3"/></phase>
          </medium>
        </scene>
        """,
    "bitmap.xml": """\
        <scene version="0.6.0">
          <bsdf type="diffuse" id="mat">
            <texture type="bitmap" name="reflectance">
              <string name="filename" value="t.pfm"/>
              <float name="uscale" value="2"/>
            </texture>
          </bsdf>
          <bsdf type="twosided" id="check">
            <bsdf type="diffuse">
              <texture type="checkerboard" name="reflectance">
                <rgb name="color0" value="0.1, 0.2, 0.3"/>
                <rgb name="color1" value="0.8, 0.7, 0.6"/>
              </texture>
            </bsdf>
          </bsdf>
          <shape type="rectangle"><ref id="mat"/></shape>
          <shape type="rectangle">
            <transform name="toWorld"><translate z="1"/></transform>
            <ref id="check"/>
          </shape>
          <emitter type="envmap"><string name="filename" value="env.pfm"/></emitter>
        </scene>
        """,
    "ior.xml": """\
        <scene version="0.6.0">
          <sensor type="perspective">
            <float name="fov" value="45"/>
            <film type="hdrfilm">
              <integer name="width" value="8"/>
              <integer name="height" value="8"/>
            </film>
          </sensor>
          <bsdf type="dielectric" id="wat">
            <string name="intIOR" value="water"/>
            <string name="extIOR" value="air"/>
          </bsdf>
          <bsdf type="thindielectric" id="num">
            <float name="intIOR" value="1.33"/>
          </bsdf>
          <shape type="sphere">
            <point name="center" x="0" y="0" z="2"/>
            <float name="radius" value="0.5"/>
            <ref id="wat"/>
          </shape>
          <shape type="sphere">
            <point name="center" x="1" y="0" z="2"/>
            <float name="radius" value="0.5"/>
            <ref id="num"/>
          </shape>
        </scene>
        """,
    "serialized.xml": """\
        <scene version="0.6.0">
          <shape type="serialized">
            <string name="filename" value="m.serialized"/>
            <integer name="shapeIndex" value="1"/>
            <transform name="toWorld"><translate x="3"/></transform>
            <emitter type="area"><rgb name="radiance" value="5,5,5"/></emitter>
          </shape>
          <shape type="serialized">
            <string name="filename" value="m.serialized"/>
          </shape>
        </scene>
        """,
}
TMP_SCENES = ["box.obj", "scene.pbrt", "objects.pbrt", "textures.pbrt",
              "scene.xml", "bitmap.xml", "ior.xml", "serialized.xml"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tmp inputs, written once."""
    d = tmp_path_factory.mktemp("loaders")
    for name, text in FILES.items():
        (d / name).write_text(textwrap.dedent(text))
    header = (b"ply\nformat binary_little_endian 1.0\n"
              b"element vertex 4\n"
              b"property float x\nproperty float y\nproperty float z\n"
              b"property float u\nproperty float v\n"
              b"element face 1\n"
              b"property list uchar int vertex_indices\nend_header\n")
    verts = struct.pack("<20f", 0, 0, 0, 0, 0, 1, 0, 0, 1, 0,
                        1, 1, 0, 1, 1, 0, 1, 0, 0, 1)
    (d / "q.ply").write_bytes(header + verts + struct.pack("<B4i", 4, 0, 1,
                                                           2, 3))
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:, :4] = (1, 0, 0)
    tex[:, 4:] = (0, 0, 1)
    jimage.save(str(d / "t.pfm"), tex)
    rng = np.random.default_rng(0)
    jimage.save(str(d / "env.pfm"),
                (0.2 + rng.random((6, 12, 3))).astype(np.float32))
    quad = jgeometry.make_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1))
    sph = jgeometry.make_sphere((0, 1, 0), 0.5, n_theta=6, n_phi=6)
    jser.save_serialized(d / "m.serialized", [quad, sph])
    # a pre-0.4 file: version-3 chunks, the offsets as u32
    blobs = []
    for k in (1, 2):
        payload = struct.pack("<I", jser._F_SINGLE) + struct.pack("<QQ", 3, 1)
        payload += np.arange(9, dtype=np.float32).tobytes()
        payload += (np.array([[0, 1, 2]], np.uint32) * k).tobytes()
        blobs.append(struct.pack("<HH", jser.MAGIC, 3)
                     + zlib.compress(payload))
    out, offs = b"", []
    for b in blobs:
        offs.append(len(out))
        out += b
    (d / "old.serialized").write_bytes(out + struct.pack("<2I", *offs)
                                       + struct.pack("<I", 2))
    return d


def _path(files, name):
    return ROOT / "examples" / name if name in EXAMPLES else files / name


def _equal(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_mesh(jm, tm, what):
    for f in ("vertices", "indices", "normals", "uvs", "emission"):
        _equal(getattr(jm, f), getattr(tm, f), f"{what}.{f}")
    for f in ("material", "name", "emission_kind", "emission_scale",
              "emission_tex"):
        assert getattr(jm, f) == getattr(tm, f), f"{what}.{f}"


def _same_camera(jc, tc, what="camera"):
    for f in ("width", "height", "fov", "fov_axis", "flip"):
        assert getattr(jc, f) == getattr(tc, f), f"{what}.{f}"
    for f in ("sample_to_camera", "camera_to_sample", "to_world", "to_local",
              "image_rect_min", "image_rect_max"):
        _equal(getattr(jc, f), getattr(tc, f), f"{what}.{f}")


def _same_host_scene(js, ts):
    assert len(js.meshes) == len(ts.meshes)
    for k, (jm, tm) in enumerate(zip(js.meshes, ts.meshes)):
        _same_mesh(jm, tm, f"mesh {k}")
    assert len(js.materials) == len(ts.materials)
    for k, (jd, td) in enumerate(zip(js.materials, ts.materials)):
        assert dataclasses.asdict(jd) == dataclasses.asdict(td), f"mat {k}"
    _equal(js.textures, ts.textures, "textures")
    _same_camera(js.camera, ts.camera)
    for f in ("point_lights", "directional_lights", "point_normal_lights"):
        jl, tl = getattr(js, f), getattr(ts, f)
        assert len(jl) == len(tl), f
        for k, (a, b) in enumerate(zip(jl, tl)):
            assert len(a) == len(b), f
            for x, y in zip(a, b):
                _equal(x, y, f"{f}[{k}]")
    _equal(js.env_constant, ts.env_constant, "env_constant")
    _equal(js.env_image, ts.env_image, "env_image")
    if js.volume is None:
        assert ts.volume is None
    else:
        for f in ("sigma_a", "sigma_s", "phase_g"):
            _equal(getattr(js.volume, f), getattr(ts.volume, f), f)


@pytest.mark.parametrize("name", EXAMPLES + TMP_SCENES)
def test_host_scene_equals_jax(files, name):
    path = _path(files, name)
    _same_host_scene(jax_load_scene(path), load_scene(path))


def _same_tables(jh, th):
    """Every column of the compiled host tables."""
    jg, tg = jh.geom, th.geom
    assert (jg.n_tris, jg.n_pad) == (tg.n_tris, tg.n_pad)
    for f in GeometryTables._fields:
        if f not in ("n_tris", "n_pad", "walk"):
            _equal(getattr(jg, f), getattr(tg, f), f"geom.{f}")
    if jg.walk is None:
        assert tg.walk is None
    else:
        conv = walk_tables_from_numpy(jg.walk)
        for f in WalkTables._fields:
            a, b = getattr(conv, f), getattr(tg.walk, f)
            if isinstance(b, (int, tuple)):
                assert a == b, f"walk.{f}"
            else:
                _equal(a, b, f"walk.{f}")
    je, te = jh.emitters, th.emitters
    for f in EmitterTables._fields:
        b = getattr(te, f)
        if f == "kinds":
            assert b == set(np.asarray(je.atom_kind).tolist())
        elif f in ("atom_cdf", "env_cdf"):
            for g in type(b)._fields:
                _equal(getattr(getattr(je, f), g), getattr(b, g), f"{f}.{g}")
        elif isinstance(b, (bool, int)):
            assert getattr(je, f) == b, f
        else:
            _equal(getattr(je, f), b, f"emitters.{f}")
    for f in _FIELDS + ("textures",):
        _equal(getattr(jh.materials, f), getattr(th.materials, f),
               f"materials.{f}")
    _same_camera(jh.camera, th.camera)
    assert jh.use_shading_normals == th.use_shading_normals


@pytest.mark.parametrize("name", EXAMPLES + TMP_SCENES)
def test_compiled_tables_equal_jax(files, name):
    path = _path(files, name)
    jh = jax_load_scene(path).compile().host.data
    th = load_scene(path).compile(device="cpu").host
    _same_tables(jh, th)


def test_example_tiers_and_counts():
    """The five example scenes' triangle counts, tiers and light kinds."""
    want = {"cbox.pbrt": (40, False, {0}), "instances.pbrt": (52, False, {0}),
            "caustic.pbrt": (2216, True, {0}),
            "envglass.xml": (5954, True, {3}),
            "fog_box.xml": (2000, True, {0, 1})}
    for name, (n, walk, kinds) in want.items():
        sd = load_scene(ROOT / "examples" / name).compile(device="cpu")
        assert sd.geom.n_tris == n, name
        assert (sd.geom.walk is not None) == walk, name
        assert sd.emitters.kinds == kinds, name
        assert sd.device == torch.device("cpu")
    assert load_scene(ROOT / "examples" / "fog_box.xml").volume is not None


@pytest.mark.parametrize("name, kw", [
    ("t.ply", {}), ("q.ply", dict(material=3, emission=(1, 2, 3)))])
def test_ply_equals_jax(files, name, kw):
    _same_mesh(jply.load_ply(files / name, **kw),
               tply.load_ply(files / name, **kw), name)


@pytest.mark.parametrize("name, index", [("m.serialized", 0),
                                         ("m.serialized", 1),
                                         ("old.serialized", 0),
                                         ("old.serialized", 1)])
def test_serialized_equals_jax(files, name, index):
    _same_mesh(jser.load_serialized(files / name, index),
               tser.load_serialized(files / name, index), name)
    with pytest.raises(ValueError):
        tser.load_serialized(files / name, 2)


def test_save_serialized_round_trips_across_packages(tmp_path):
    quad = tgeometry.make_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1))
    sph = tgeometry.make_sphere((0, 1, 0), 0.5, n_theta=5, n_phi=7)
    tser.save_serialized(tmp_path / "p.serialized", [quad, sph])
    jser.save_serialized(tmp_path / "j.serialized", [quad, sph])
    assert ((tmp_path / "p.serialized").read_bytes()
            == (tmp_path / "j.serialized").read_bytes())
    for k, m in enumerate((quad, sph)):
        got = jser.load_serialized(tmp_path / "p.serialized", k)
        for f in ("vertices", "indices", "normals", "uvs"):
            _equal(getattr(m, f), getattr(got, f), f)


def _obj_lines():
    rng = np.random.RandomState(0)
    verts = rng.uniform(-1, 1, (300, 3))
    lines = ["mtllib m.mtl"]
    lines += [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in verts]
    lines += [f"vn {v[0]:.4f} {v[1]:.4f} {v[2]:.4f}" for v in verts[:150]]
    lines += [f"vt {abs(v[0]):.4f} {abs(v[1]):.4f}" for v in verts[:100]]
    lines.append("usemtl red")
    for i in range(0, 290, 4):   # quads with v/t/n
        lines.append(" ".join(["f"] + [f"{i + k}/{i % 100 + k}/{i % 150 + k}"
                                       for k in range(1, 5)]))
    lines.append("usemtl blue")
    for i in range(1, 60, 3):    # negative position-only indices
        lines.append(f"f {-i} {-(i + 1)} {-(i + 2)}")
    return lines


def test_native_obj_parser_matches_python_and_jax(tmp_path):
    (tmp_path / "t.obj").write_text("\n".join(_obj_lines()))
    (tmp_path / "m.mtl").write_text(
        "newmtl red\nKd 0.8 0.1 0.1\nmap_Kd tex.png\n"
        "newmtl blue\nKd 0.1 0.1 0.8\nKe 1 2 3\n")
    flat_n = tobj._parse_obj_native(tmp_path / "t.obj")
    assert flat_n is not None, "g++ could not build csrc/obj_loader.cpp"
    flat_p = tobj._parse_obj_py(tmp_path / "t.obj")
    flat_j = jobj._parse_obj_py(tmp_path / "t.obj")
    for a, b, c in zip(flat_n, flat_p, flat_j):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        else:
            assert a == b == c
    before = dict(tobj.PARSES)
    meshes, mats, tex = tobj.load_obj(str(tmp_path / "t.obj"))
    assert tobj.PARSES["native"] == before["native"] + 1
    jm, jmats, jtex = jobj.load_obj(str(tmp_path / "t.obj"))
    assert len(meshes) == len(jm) == 2 and tex == jtex
    for k, (a, b) in enumerate(zip(jm, meshes)):
        _same_mesh(a, b, f"mesh {k}")
    assert [dataclasses.asdict(m) for m in mats] == [
        dataclasses.asdict(m) for m in jmats]


def test_cbox_pbrt_renders_as_the_procedural_box():
    """examples/cbox.pbrt reproduces the port's cornell_box (as
    tests/test_loaders.py holds the JAX package's): 24x24, 8 spp, depth 3,
    within 1e-5."""
    sc = load_scene(ROOT / "examples" / "cbox.pbrt")
    sc.camera = sc.camera._replace(width=24, height=24)
    integ = IntegratorPathTracing(max_depth=3, hard_cap=3)
    f1 = render(sc.compile(device="cpu"), integ, spp=8, seed=0)["primal"]
    f2 = render(cornell_box(24, 24).compile(device="cpu"), integ, spp=8,
                seed=0)["primal"]
    assert f1.mean() > 0.05
    np.testing.assert_allclose(f1, f2, atol=1e-5)


def test_registry_and_errors(tmp_path):
    assert set(LOADERS) == {".pbrt", ".xml", ".obj"}
    with pytest.raises(ValueError, match="no scene loader"):
        load_scene(tmp_path / "x.blend")
    register_loader(".TXT", lambda p: "custom")
    try:
        assert load_scene(tmp_path / "a.txt") == "custom"
    finally:
        del LOADERS[".txt"]
    assert resolve_ior("1.25", 0.0) == 1.25 and resolve_ior(None, 1.5) == 1.5
    assert resolve_ior("BK7", 0.0) == jax_resolve_ior("BK7", 0.0) == 1.5046
    assert resolve_ior(-2.0, 1.5) == 1.5
    with pytest.raises(ValueError):
        resolve_ior("unobtainium", 1.0)
    sc = load_scene(ROOT / "examples" / "envglass.xml")
    assert sum(m.kind == KIND_GLASS for m in sc.materials) == 1
    assert NAMED_IOR["water"] == 1.3330


def test_geometry_and_camera_helpers_equal_jax():
    """make_box, compute_vertex_normals, flux / mean_emission of the three
    emission kinds, and resize_camera."""
    jb = jgeometry.make_box((0, 1, 2), (3, 5, 4), material=2, name="b")
    tb = tgeometry.make_box((0, 1, 2), (3, 5, 4), material=2, name="b")
    _same_mesh(jb, tb, "box")
    jb.compute_vertex_normals()
    tb.compute_vertex_normals()
    _equal(jb.normals, tb.normals, "normals")
    tex = np.random.default_rng(1).random((2, 4, 4, 3)).astype(np.float32)
    for kind, tex_id in ((0, -1), (1, -1), (2, 1), (2, 5)):
        for m in (jb, tb):
            m.emission = np.asarray((1, 2, 3), np.float32)
            m.emission_kind, m.emission_scale, m.emission_tex = kind, 2.5, tex_id
        _equal(jb.mean_emission(tex), tb.mean_emission(tex), "mean")
        _equal(jb.flux(tex), tb.flux(tex), "flux")
        assert jb.is_light == tb.is_light
    sc = load_scene(ROOT / "examples" / "envglass.xml")
    jsc = jax_load_scene(ROOT / "examples" / "envglass.xml")
    for w, h in ((32, 24), (40, 40), (7, 13)):
        _same_camera(jax_resize_camera(jsc.camera, w, h),
                     resize_camera(sc.camera, w, h))

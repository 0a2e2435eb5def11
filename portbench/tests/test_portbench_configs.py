"""The configurations' scenes as the renderer compiles them equal the
renderer's own models (models/cbox.py, models/presets.py:sphere_grid), and
BENCHMARK.json names a file for everything the harness finds by name."""
import json
import os

import numpy as np
import pytest

from portbench import port
from portbench.scene import build_arrays, load_config

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GEOM = ("v0", "e1", "e2", "n_g", "inter_rows", "vn", "vuv", "area", "mat_id",
        "mesh_id", "emitter_id", "has_normals")
EMIT = ("tri_emission", "tri_pdf_area", "tri_atom")


def _host(sd):
    return sd.host


def _same_tables(a, b):
    for k in GEOM:
        np.testing.assert_array_equal(getattr(a.geom, k), getattr(b.geom, k),
                                      err_msg=k)
    for k in EMIT:
        np.testing.assert_array_equal(getattr(a.emitters, k),
                                      getattr(b.emitters, k), err_msg=k)
    np.testing.assert_array_equal(a.emitters.atom_cdf.cdf,
                                  b.emitters.atom_cdf.cdf)
    np.testing.assert_array_equal(a.materials.kd, b.materials.kd)
    for k in ("sample_to_camera", "to_world", "image_rect_min",
              "image_rect_max"):
        np.testing.assert_array_equal(getattr(a.camera, k),
                                      getattr(b.camera, k), err_msg=k)


def test_cbox_equals_models_cbox():
    from rustlight_tpu_torch.models.cbox import cornell_box
    ours = port.compile_scene(build_arrays(load_config("cbox")), 64, 36,
                              "cpu").host
    theirs = cornell_box(64, 36).compile("cpu").host
    assert ours.geom.n_tris == theirs.geom.n_tris == 40
    _same_tables(ours, theirs)


def test_grid122k_equals_sphere_grid():
    from rustlight_tpu_torch.models.presets import sphere_grid
    arrays = build_arrays(load_config("grid122k"))
    assert arrays.n_triangles == 131_222
    ours = port.port_scene(arrays, 64, 36)
    theirs = sphere_grid(122_000, 64, 36)
    assert len(ours.meshes) == len(theirs.meshes) == 2
    for a, b in zip(ours.meshes, theirs.meshes):
        for k in ("vertices", "indices", "normals", "uvs", "emission"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                          err_msg=k)
        assert a.material == b.material
    assert [m.kd for m in ours.materials] == [m.kd for m in theirs.materials]
    for k in ("sample_to_camera", "to_world"):
        np.testing.assert_array_equal(getattr(ours.camera, k),
                                      getattr(theirs.camera, k))


def test_benchmark_names_its_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = os.path.join(ROOT, "portbench")
    for c in bench["configs"]:
        cfg = load_config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["source"] == cfg["source"] and c["reduced"] == cfg["reduced"]
    for w in bench["workloads"]:
        for sub, name in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(pb, sub, f"{name}.json"))
        cfg = load_config(w["config"])
        with open(os.path.join(pb, "traffic", f"{w['traffic']}.json")) as f:
            kind = json.load(f)["integrator"]
        assert kind in cfg["integrators"]
        for sub in ("integrators", "reference/integrators"):
            assert os.path.exists(os.path.join(pb, sub, f"{kind}.py"))
        for spec in cfg["materials"].values():
            for sub in ("materials", "reference/materials"):
                assert os.path.exists(
                    os.path.join(pb, sub, f"{spec['kind']}.py"))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(pb, "metrics", f"{m['name']}.py"))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("cfg", ["cbox", "grid122k"])
def test_config_states_source_assumed_reduced(cfg):
    c = load_config(cfg)
    assert c["source"] and isinstance(c["assumed"], dict)
    assert c["reduced"] == []

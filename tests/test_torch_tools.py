"""The port's user tools (rustlight_tpu_torch/tools/) and its PNG writer
against the JAX package's tools/ scripts, on the CPU.

  - the PNG encoder (utils/image.py) with PIL blocked: PIL decodes its
    files to the same uint8 array, odd widths, gray and RGBA too; the
    decoder reads back every filter type; JPG needs PIL and says so;
  - every ported module imports with `jax`, `rustlight_tpu` and `PIL`
    blocked and loads nothing of the repo's tools/ (a subprocess);
  - tonemap: the PNG's pixels, every -m metric and the falsecolor PNG
    equal to tools/tonemap.py's on a seeded 16x16 EXR;
  - regression: build_tests and make_integrator give tools/regression.py's
    table (classes and constructor fields) for every name; a
    --make-refs / --check round trip on cbox_ao at 1 spp (references at
    2) passes, and exits 1 once the reference is scaled by 1.5; the gate's
    rule on planted rows; --out may not be the committed matrix;
  - smoke_scenes on examples/cbox.pbrt at 16 px, 1 spp; run_experiments'
    technique specs, CSV header and one `path` row;
  - every tool's default --device cuda raises without a card.

`slow`: --check -s cbox_ao cbox_direct at the stored settings reproduces
regress/results.json within 1e-4.
"""
import importlib.util
import inspect
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rustlight_tpu_torch.tools import (regression, run_experiments,
                                       smoke_scenes, tonemap)
from rustlight_tpu_torch.utils import image as timage

ROOT = Path(__file__).resolve().parents[1]
MODULES = ["rustlight_tpu_torch.utils.spectrum",
           "rustlight_tpu_torch.utils.image",
           "rustlight_tpu_torch.tools.tonemap",
           "rustlight_tpu_torch.tools.regression",
           "rustlight_tpu_torch.tools.smoke_scenes",
           "rustlight_tpu_torch.tools.run_experiments",
           "rustlight_tpu_torch.tools.viewer"]


def _jax_tool(name):
    """tools/<name>.py of the JAX package, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pil_decode(data: bytes) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)))


# ---- PNG


@pytest.mark.parametrize("shape", [(16, 16, 3), (7, 13, 3), (5, 1, 3),
                                   (9, 11), (6, 5, 4)])
def test_png_encoder_without_pil(monkeypatch, tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    px = rng.integers(0, 256, shape, dtype=np.uint8)
    monkeypatch.setitem(sys.modules, "PIL", None)
    data = timage.encode_png(px)
    np.testing.assert_array_equal(timage.decode_png(data), px)
    if len(shape) == 3 and shape[2] == 3:
        img = rng.uniform(0, 2, shape).astype(np.float32)
        timage.save(tmp_path / "x.png", img)          # write_ldr, no PIL
        got = timage.read_ldr(tmp_path / "x.png")     # decode_png, no PIL
        np.testing.assert_array_equal(
            np.round(got ** (1 / 2.2) * 255).astype(np.uint8),
            timage.tonemap_gamma(img))
        monkeypatch.delitem(sys.modules, "PIL")
        np.testing.assert_array_equal(
            _pil_decode((tmp_path / "x.png").read_bytes()),
            timage.tonemap_gamma(img))
    monkeypatch.delitem(sys.modules, "PIL", raising=False)
    np.testing.assert_array_equal(_pil_decode(data), px)


def _filtered(px: np.ndarray, ft: int) -> bytes:
    """A PNG of RGB `px` with every row under filter `ft` (a plain
    encoder of the five PNG filters)."""
    import struct
    import zlib
    h, w, c = px.shape
    raw = px.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        line, up = raw[y], raw[y - 1] if y else np.zeros(w * c, np.int32)
        a = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        b = up
        cc = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = b
        elif ft == 3:
            pred = (a + b) >> 1
        else:
            pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, cc))
        rows.append(bytes([ft]) + ((line - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4])
def test_png_decoder_reads_every_filter(ft):
    px = np.random.default_rng(ft).integers(0, 256, (6, 7, 3), np.uint8)
    data = _filtered(px, ft)
    np.testing.assert_array_equal(_pil_decode(data), px)
    np.testing.assert_array_equal(timage.decode_png(data), px)


def test_jpg_needs_pil_and_says_so(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        timage.save(tmp_path / "x.jpg", np.zeros((2, 2, 3), np.float32))


def test_modules_import_without_jax_pil_or_tools():
    code = (
        "import sys\n"
        "for m in ('jax', 'rustlight_tpu', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [n for n, m in list(sys.modules.items()) if m is not None and"
        " (n.split('.')[0] in ('jax', 'rustlight_tpu', 'PIL') or"
        f" str(getattr(m, '__file__', '') or '').startswith({str(ROOT / 'tools') + '/'!r}))]\n"
        "assert not bad, bad\n"
        "from rustlight_tpu_torch.utils.image import encode_png\n"
        "import numpy as np\n"
        "assert encode_png(np.zeros((3, 5, 3), np.uint8))[:4] == b'\\x89PNG'\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


# ---- tonemap


@pytest.fixture(scope="module")
def exr_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("tonemap")
    rng = np.random.default_rng(7)
    img = rng.uniform(0.0, 1.5, (16, 16, 3)).astype(np.float32)
    ref = (img * rng.uniform(0.7, 1.3, img.shape)).astype(np.float32)
    timage.write_exr(d / "img.exr", img)
    timage.write_exr(d / "ref.exr", ref)
    return d


def _run_jax_tonemap(argv, capsys, monkeypatch):
    mod = _jax_tool("tonemap")
    monkeypatch.setattr(sys, "argv", ["tonemap.py"] + argv)
    mod.main()
    return capsys.readouterr().out


def test_tonemap_png_matches_jax(exr_pair, tmp_path, capsys, monkeypatch):
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
        shutil.copy(exr_pair / "img.exr", tmp_path / sub / "img.exr")
    _run_jax_tonemap([str(tmp_path / "jax" / "img.exr")], capsys, monkeypatch)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert tonemap.main([str(tmp_path / "port" / "img.exr")]) == 0
    monkeypatch.delitem(sys.modules, "PIL")
    got = _pil_decode((tmp_path / "port" / "img.png").read_bytes())
    want = _pil_decode((tmp_path / "jax" / "img.png").read_bytes())
    assert got.shape == (16, 16, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", ["l1", "l2", "mrse", "mape", "smape",
                                    "rmse", "dssim"])
def test_tonemap_metrics_match_jax(exr_pair, tmp_path, capsys, monkeypatch,
                                   metric):
    img, ref = str(exr_pair / "img.exr"), str(exr_pair / "ref.exr")
    fc = metric in ("l1", "mape")
    extra = ["-fc", str(tmp_path / "jax_fc.png"), "-c", "0", "0.5"] if fc \
        else []
    want = _run_jax_tonemap([img, "-r", ref, "-m", metric, "-p"] + extra,
                            capsys, monkeypatch)
    extra = ["-fc", str(tmp_path / "port_fc.png"), "-c", "0", "0.5"] if fc \
        else []
    assert tonemap.main([img, "-r", ref, "-m", metric, "-p"] + extra) == 0
    got = capsys.readouterr().out
    assert got == want and float(got) > 0.0
    if fc:
        np.testing.assert_array_equal(
            _pil_decode((tmp_path / "port_fc.png").read_bytes()),
            _pil_decode((tmp_path / "jax_fc.png").read_bytes()))


# ---- regression


@pytest.fixture(scope="module")
def jax_regression():
    return _jax_tool("regression")


def _plain(v):
    return v is None or isinstance(v, (int, float, str, bool)) or (
        isinstance(v, tuple) and all(_plain(x) for x in v))


# the JAX path tracer resolves nee_rr="default" to "auto" when it is
# built, the port's when it renders: the same tier-aware choice
_SAME_AS_DEFAULT = {("nee_rr", "auto")}


def _ctor_fields(obj, other) -> dict:
    """The constructor parameters an integrator keeps under their own
    names, of those the class of `other` (its counterpart) takes too: set
    ones by value, ones left at their default as "default", nested
    integrators by class and fields."""
    sig = inspect.signature(type(obj).__init__)
    common = inspect.signature(type(other).__init__).parameters
    out = {"class": type(obj).__name__}
    for name, p in list(sig.parameters.items())[1:]:
        if name not in common or not hasattr(obj, name):
            continue
        v = getattr(obj, name)
        if type(v).__name__.startswith("Integrator"):
            out[name] = _ctor_fields(v, getattr(other, name))
        elif _plain(v):
            out[name] = ("default" if v == p.default
                         or (name, v) in _SAME_AS_DEFAULT else v)
    return out


def _same_fields(port_obj, jax_obj):
    pf, jf = _ctor_fields(port_obj, jax_obj), _ctor_fields(jax_obj, port_obj)
    assert pf == jf and len(pf) > 1, (pf, jf)


def _all_names(tests):
    names = {"ao", "path"}
    for spec in tests.values():
        names |= set(spec["techniques"]) | {spec.get("ref_tech", "path")}
    return sorted(names)


def test_regression_table_matches_jax(jax_regression):
    jt, tt = jax_regression.build_tests(), regression.build_tests()
    assert list(jt) == list(tt)
    for name in jt:
        js, ts = jt[name], tt[name]
        assert {k: v for k, v in js.items() if k != "scene"} == \
            {k: v for k, v in ts.items() if k != "scene"}
        jsc, tsc = js["scene"](), ts["scene"]()
        assert (jsc.camera.width, jsc.camera.height) == \
            (tsc.camera.width, tsc.camera.height)
        np.testing.assert_array_equal(np.asarray(jsc.camera.to_world),
                                      np.asarray(tsc.camera.to_world))
        assert len(jsc.meshes) == len(tsc.meshes)
        assert (jsc.volume is None) == (tsc.volume is None)
        if jsc.volume is not None:
            for f in ("sigma_s", "sigma_a"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(jsc.volume, f)),
                    np.asarray(getattr(tsc.volume, f)))
    assert set(_all_names(tt)) <= set(NAMES)
    assert regression.METRICS == jax_regression.METRICS
    assert regression.GI_ALGO == jax_regression.GI_ALGO


# every name of tools/regression.py:92-139
NAMES = ["ao", "path", "light", "vpl", "pssmlt", "erpt", "smcmc", "direct",
         "gradient-path", "gradient-path-explicit", "point-normal",
         "path-single", "plane-single", "plane-single-unc", "bre", "beams",
         "planes", "vrl"]


@pytest.mark.parametrize("name", NAMES)
def test_regression_integrators_match_jax(jax_regression, name):
    _same_fields(regression.make_integrator(name),
                 jax_regression.make_integrator(name))


def test_regression_unknown_name_raises(jax_regression):
    for mod in (jax_regression, regression):
        with pytest.raises(ValueError):
            mod.make_integrator("no-such")


def test_regression_gate_rule():
    stored = {"s/a": {"l1": 1.0, "l2": 1.0, "mape": 1.0, "dssim": 1.0}}
    floors = {"s": {"l1": 0.2, "l2": 0.0, "mape": 0.0, "dssim": 0.0}}
    at = {"l1": 1.3 + 1.5 * 0.2, "l2": 1.3, "mape": 1.3, "dssim": 1.3}
    assert regression.gate({"s/a": at}, stored, floors) == []
    over = dict(at, l1=at["l1"] * (1 + 1e-6))
    assert len(regression.gate({"s/a": over}, stored, floors)) == 1
    assert "no noise floor" in regression.gate({"s/a": at}, stored, {})[0]
    assert regression.gate({"t/a": at}, stored, floors) == []


def _reg(tmp_path, *argv):
    return regression.main(["--out", str(tmp_path), "--device", "cpu",
                            "-s", "cbox_ao", "--spp", "1", "--ref-spp", "2",
                            *argv])


def test_regression_round_trip_and_planted_reference(tmp_path, capsys):
    assert _reg(tmp_path, "--make-refs") == 0
    ref = tmp_path / "refs" / "cbox_ao.exr"
    assert ref.exists() and (tmp_path / "results.json").exists()
    assert (tmp_path / "index.html").exists()
    assert "cbox_ao/ao" in json.loads((tmp_path / "results.json").read_text())
    assert _reg(tmp_path, "--check") == 0
    assert "regression gate OK (1 rows checked)" in capsys.readouterr().out
    timage.write_exr(ref, timage.read_exr(ref) * 1.5)
    assert _reg(tmp_path, "--check") == 1
    assert "REGRESSION GATE FAILED" in capsys.readouterr().out


def test_regression_never_writes_the_committed_matrix():
    with pytest.raises(SystemExit, match="only reads"):
        regression.main(["--out", str(ROOT / "regress"), "--device", "cpu",
                         "--check", "-s", "cbox_ao"])


@pytest.mark.slow
def test_regression_check_reproduces_stored_rows(tmp_path, capsys):
    assert regression.main(["--out", str(tmp_path), "--device", "cpu",
                            "--check", "-s", "cbox_ao", "cbox_direct"]) == 0
    stored = json.loads((ROOT / "regress" / "results.json").read_text())
    out = capsys.readouterr().out
    for key in ("cbox_ao/ao", "cbox_direct/direct"):
        line = next(s for s in out.splitlines() if s.startswith(f"[{key}]"))
        row = eval(line[line.index("{"):line.index("}") + 1])  # noqa: S307
        for m in regression.METRICS:
            assert row[m] == pytest.approx(stored[key][m], rel=1e-4)


# ---- smoke_scenes, run_experiments


def test_smoke_scenes_cbox(tmp_path, capsys, monkeypatch):
    rec = smoke_scenes.smoke_one(smoke_scenes.EXAMPLES / "cbox.pbrt", 16, 1,
                                 torch.device("cpu"), out=tmp_path)
    assert rec["ok"] and rec["tier"] == "dense" and rec["mean"] > 0
    assert rec["launches"] == {}          # the CPU runs the plain versions
    img = timage.read_pfm(tmp_path / "cbox.pfm")
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    d = tmp_path / "scenes"
    d.mkdir()
    shutil.copy(smoke_scenes.EXAMPLES / "cbox.pbrt", d / "cbox.pbrt")
    monkeypatch.setattr(smoke_scenes, "EXAMPLES", d)
    argv = ["--size", "16", "--spp", "1", "--device", "cpu"]
    assert smoke_scenes.main(argv) == 0
    assert "all 1 scenes smoke-rendered clean" in capsys.readouterr().out
    (d / "broken.pbrt").write_text("WorldBegin\nShape \"nosuch\"\n")
    assert smoke_scenes.main(argv) == 1


@pytest.mark.parametrize("spec", [
    "path", "ao", "direct", "light", "vpl", "vpl:64", "pssmlt", "erpt",
    "smcmc", "smcmc:irls", "gradient-path", "gradient-path:weighted",
    "point-normal", "point-normal:tr", "point-normal:ex_clamp",
    "point-normal:warp_TP_bezier", "plane-single", "plane-single:cmis",
    "vol-primitives", "vol-primitives:vrl"])
def test_run_experiments_specs_match_jax(spec):
    jmod = _jax_tool("run_experiments")
    _same_fields(run_experiments.make_integrator(spec),
                 jmod.make_integrator(spec))


def test_run_experiments_csv(tmp_path, capsys):
    argv = ["--res", "0.0625", "--spp", "1", "--ref-spp", "2", "-t", "path",
            "--device", "cpu", "--out", str(tmp_path)]
    assert run_experiments.main(argv) == 0
    lines = (tmp_path / "results.csv").read_text().splitlines()
    assert lines[0] == "technique,spp,time_s,l1,mape,rmse"
    assert len(lines) == 2 and lines[1].startswith("path,1,")
    vals = [float(x) for x in lines[1].split(",")[2:]]
    assert all(np.isfinite(vals)) and vals[1] > 0
    assert (tmp_path / "cbox_ref.exr").exists() and (
        tmp_path / "path.exr").exists()


def test_tools_raise_without_a_card(monkeypatch, tmp_path):
    from rustlight_tpu_torch.tools import viewer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: regression.main(["--out", str(tmp_path), "--check",
                                     "-s", "cbox_ao"]),
            lambda: smoke_scenes.main(["--size", "8"]),
            lambda: run_experiments.main(["-t", "path", "--out",
                                          str(tmp_path)]),
            lambda: viewer.main(["cbox", "--port", "0", "--host",
                                 "127.0.0.1"], block=False)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()

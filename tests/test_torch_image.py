"""The port's image codecs and metrics against the JAX package's, and the
port's import rule.

- read_exr of both packages on every .exr in the repo, bit for bit.
- Cross round trips: for every compression the JAX package writes (and
  HALF, and a tiled file), each package writes a seeded image; the two
  files are byte-identical and each package reads the other's back to the
  same array.
- The PIZ codec: the port's native build against its Python fallback and
  against the JAX package's codec, bit for bit.
- A recorded difference: a multipart part whose `type` is missing or
  unknown is refused by the port (ValueError); the JAX package decodes it
  as scanline.
- metric_scalar of regress/refs/cbox_direct.exr against regress/
  cbox_direct_direct.exr reproduces regress/results.json's stored row
  exactly, and the metrics equal the JAX package's.
- No .py under rustlight_tpu_torch/, and not chip_smoke.py, imports jax,
  flax or rustlight_tpu (an AST walk).
"""
import ast
import json
import struct
from pathlib import Path

import numpy as np
import pytest

from rustlight_tpu.utils import image as jimage
from rustlight_tpu.utils import metrics as jmetrics
from rustlight_tpu.utils import piz as jpiz
from rustlight_tpu_torch.utils import image as timage
from rustlight_tpu_torch.utils import metrics as tmetrics
from rustlight_tpu_torch.utils import piz as tpiz

ROOT = Path(__file__).resolve().parents[1]
EXRS = sorted(str(p.relative_to(ROOT)) for p in
              [ROOT / "examples" / "sky.exr", *ROOT.glob("regress/*.exr"),
               *ROOT.glob("regress/refs/*.exr")])
COMPRESSIONS = ["none", "rle", "zips", "zip", "piz", "pxr24", "b44", "b44a",
                "dwaa", "dwab"]
METRICS = ["l1", "l2", "mape", "dssim"]


@pytest.mark.parametrize("rel", EXRS)
def test_read_exr_matches_jax(rel):
    a = timage.read_exr(ROOT / rel)
    b = jimage.read_exr(ROOT / rel)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _image(h=37, w=23, seed=5):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 4.0, (h, w, 3)).astype(np.float32)
    img[0, 0] = (0.0, 1e-5, 65000.0)
    return img


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_exr_cross_round_trip(tmp_path, compression, half):
    img = _image()
    jp, tp = tmp_path / "j.exr", tmp_path / "t.exr"
    jimage.write_exr(jp, img, half=half, compression=compression)
    timage.write_exr(tp, img, half=half, compression=compression)
    assert jp.read_bytes() == tp.read_bytes()
    for path in (jp, tp):
        a, b = timage.read_exr(path), jimage.read_exr(path)
        np.testing.assert_array_equal(a, b)
        assert a.shape == img.shape and np.all(np.isfinite(a))


@pytest.mark.parametrize("compression", ["none", "zip", "piz"])
def test_tiled_exr_cross_round_trip(tmp_path, compression):
    img = _image(40, 50)
    jp, tp = tmp_path / "j.exr", tmp_path / "t.exr"
    jimage.write_exr(jp, img, compression=compression, tiled=(16, 16))
    timage.write_exr(tp, img, compression=compression, tiled=(16, 16))
    assert jp.read_bytes() == tp.read_bytes()
    np.testing.assert_array_equal(timage.read_exr(jp), img)
    np.testing.assert_array_equal(jimage.read_exr(tp), img)


def test_piz_native_fallback_and_jax_agree():
    rng = np.random.default_rng(8)
    chans = [(23, 32, 2), (23, 32, 2), (23, 32, 1)]
    planar = rng.integers(0, 2000, tpiz._planar_total(chans)).astype(np.uint16)
    assert tpiz._load_native() is not None   # g++ builds it into build/
    native = tpiz.piz_compress(planar, chans)
    py = tpiz.piz_compress(planar, chans, force_python=True)
    for payload in (native, py, jpiz.piz_compress(planar, chans)):
        np.testing.assert_array_equal(tpiz.piz_uncompress(payload, chans),
                                      planar)
        np.testing.assert_array_equal(
            tpiz.piz_uncompress(payload, chans, force_python=True), planar)
        np.testing.assert_array_equal(jpiz.piz_uncompress(payload, chans),
                                      planar)
    assert native == jpiz.piz_compress(planar, chans)


def _attr(name, typ, val):
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(val)) + val


def _multipart(path, ptype, img):
    """A two-part multipart EXR (uncompressed FLOAT R, G, B scanlines, one
    line a chunk), written from the format specification; the first part's
    `type` attribute is `ptype` (left out when None)."""
    h, w, _ = img.shape
    heads, bodies = b"", []
    for pi, name in enumerate((b"beauty", b"copy")):
        chl = b"".join(c + b"\0" + struct.pack("<iiii", 2, 0, 1, 1)
                       for c in (b"B", b"G", b"R")) + b"\0"
        dw = struct.pack("<iiii", 0, 0, w - 1, h - 1)
        hd = (_attr(b"channels", b"chlist", chl)
              + _attr(b"compression", b"compression", b"\0")
              + _attr(b"dataWindow", b"box2i", dw)
              + _attr(b"displayWindow", b"box2i", dw)
              + _attr(b"name", b"string", name))
        t = ptype if pi == 0 else "scanlineimage"
        if t is not None:
            hd += _attr(b"type", b"string", t.encode())
        hd += (_attr(b"chunkCount", b"int", struct.pack("<i", h))
               + _attr(b"lineOrder", b"lineOrder", b"\0")
               + _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)))
        heads += hd + b"\0"
        bodies.append([img[y, :, ::-1].T.astype("<f4").tobytes()
                       for y in range(h)])
    out = b"\x76\x2f\x31\x01" + struct.pack("<i", 2 | 0x1000) + heads + b"\0"
    base = len(out) + 8 * 2 * h
    tables, body = b"", b""
    for pi, chunks in enumerate(bodies):
        for y, c in enumerate(chunks):
            tables += struct.pack("<Q", base + len(body))
            body += struct.pack("<iii", pi, y, len(c)) + c
    path.write_bytes(out + tables + body)
    return path


def test_multipart_well_formed_reads_alike(tmp_path):
    img = _image(6, 5)
    fp = _multipart(tmp_path / "mp.exr", "scanlineimage", img)
    for part in (None, 0, 1, "copy"):
        np.testing.assert_array_equal(timage.read_exr(fp, part=part), img)
        np.testing.assert_array_equal(jimage.read_exr(fp, part=part), img)


@pytest.mark.parametrize("ptype", [None, "mystery"])
def test_multipart_without_a_known_type_is_refused(tmp_path, ptype):
    """Recorded difference: the JAX package decodes such a part as
    scanline (rustlight_tpu/utils/image.py:1227); the port refuses it."""
    img = _image(6, 5)
    fp = _multipart(tmp_path / "mp.exr", ptype, img)
    np.testing.assert_array_equal(jimage.read_exr(fp), img)
    with pytest.raises(ValueError, match="missing or unknown"):
        timage.read_exr(fp)
    np.testing.assert_array_equal(timage.read_exr(fp, part="copy"), img)


def test_pfm_and_png_write_alike(tmp_path):
    """PFM files byte for byte; PNG files pixel for pixel: the port encodes
    PNG itself (zlib, no PIL), the JAX package through PIL, so the
    compressed bytes differ while every decoded 8-bit value is equal."""
    img = _image()
    for ext in ("pfm", "png"):
        jimage.save(tmp_path / f"j.{ext}", img)
        timage.save(tmp_path / f"t.{ext}", img)
        if ext == "pfm":
            assert (tmp_path / f"j.{ext}").read_bytes() == \
                (tmp_path / f"t.{ext}").read_bytes()
        else:
            from PIL import Image
            t_px = np.asarray(Image.open(tmp_path / "t.png"))
            np.testing.assert_array_equal(
                t_px, np.asarray(Image.open(tmp_path / "j.png")))
            np.testing.assert_array_equal(t_px, timage.tonemap_gamma(img))
        for name in ("j", "t"):
            np.testing.assert_array_equal(
                timage.load(tmp_path / f"{name}.{ext}"),
                jimage.load(tmp_path / f"{name}.{ext}"))


@pytest.mark.parametrize("metric", METRICS)
def test_metric_scalar_reproduces_the_stored_row(metric):
    ref = timage.read_exr(ROOT / "regress" / "refs" / "cbox_direct.exr")
    img = timage.read_exr(ROOT / "regress" / "cbox_direct_direct.exr")
    row = json.loads((ROOT / "regress" / "results.json").read_text())[
        "cbox_direct/direct"]
    assert tmetrics.metric_scalar(ref, img, metric) == row[metric]


@pytest.mark.parametrize("metric", METRICS + ["rmse", "mrse", "smape"])
def test_metrics_match_jax(metric):
    ref = timage.read_exr(ROOT / "regress" / "refs" / "veach_mis.exr")
    img = timage.read_exr(ROOT / "regress" / "veach_mis_path.exr")
    assert tmetrics.metric_scalar(ref, img, metric) == \
        jmetrics.metric_scalar(ref, img, metric)
    if metric not in ("dssim", "rmse"):
        np.testing.assert_array_equal(
            tmetrics.compute_metric(ref, img, metric),
            jmetrics.compute_metric(ref, img, metric))


def _imports(path):
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted((ROOT / "rustlight_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 40
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "flax", "rustlight_tpu")]
    assert not bad, bad

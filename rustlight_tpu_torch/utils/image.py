"""HDR/LDR image I/O: PFM, EXR, PNG (zlib, no PIL), JPG via PIL; the
port's own copy of rustlight_tpu/utils/image.py.

Host-side (numpy) equivalents of the reference's Bitmap I/O
(src/structure.rs:467-683): PFM read/write, EXR via OpenEXR, LDR with gamma 2.2.
The EXR codec here is a self-contained pure-Python implementation of the EXR 2.0
scanline format (FLOAT/HALF; compression NONE, RLE, ZIPS, ZIP and PIZ — ZIP being
what Mitsuba/Blender/pbrt emit by default and PIZ OpenEXR's own wavelet default in
several DCC tools, so external reference images and envmap textures load without
a native OpenEXR dependency). PIZ rides the dual native-C++/pure-Python codec in
piz.py.
"""
from __future__ import annotations

import struct as _struct
import zlib as _zlib
from pathlib import Path

import numpy as np


# ----------------------------------------------------------------------------- PFM

def write_pfm(path, img: np.ndarray) -> None:
    """img [h, w, 3] float32, row 0 = top. PFM stores bottom-up, little-endian."""
    img = np.asarray(img, dtype=np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # negative scale => little endian
        f.write(np.flipud(img).astype("<f4").tobytes())


def read_pfm(path) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {header!r}")
        channels = 3 if header == b"PF" else 1
        line = f.readline().strip()
        while line.startswith(b"#"):
            line = f.readline().strip()
        w, h = map(int, line.split())
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * channels * 4), dtype=dtype)
        img = data.reshape(h, w, channels).astype(np.float32)
        return np.flipud(img).copy()


# ----------------------------------------------------------------------------- EXR

def _exr_attr(name: bytes, typ: bytes, value: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + _struct.pack("<i", len(value)) + value


# compression enum (OpenEXR): 0=NONE, 1=RLE, 2=ZIPS (1 line), 3=ZIP (16 lines),
# 4=PIZ (32 lines), 5=PXR24 (16, decode only), 6=B44 / 7=B44A (32, decode
# only), 8=DWAA (32, decode only) / 9=DWAB (256, decode only)
_EXR_LINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16, 6: 32, 7: 32,
                        8: 32, 9: 256}


def _rle_decode(src: bytes) -> bytes:
    """OpenEXR RLE (ImfRle.cpp): signed count byte c — c < 0 copies -c
    literal bytes, c >= 0 repeats the next byte c+1 times."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        c = src[i] - 256 if src[i] > 127 else src[i]
        i += 1
        if c < 0:
            out += src[i:i - c]
            i += -c
        else:
            out += src[i:i + 1] * (c + 1)
            i += 1
    return bytes(out)


def _rle_encode(src: bytes) -> bytes:
    """Simple valid RLE encoder (runs >= 3 as repeats, else literals)."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        run = 1
        while i + run < n and src[i + run] == src[i] and run < 128:
            run += 1
        if run >= 3:
            out.append(run - 1)
            out.append(src[i])
            i += run
        else:
            j = i + run
            while j < n and j - i < 127:
                nr = 1
                while j + nr < n and src[j + nr] == src[j] and nr < 3:
                    nr += 1
                if nr >= 3:
                    break
                j += nr
            out.append(256 - (j - i))
            out += src[i:j]
            i = j
    return bytes(out)


def _predict_interleave(t: np.ndarray) -> bytes:
    """Shared ZIP/RLE post-transform: undo the byte delta predictor, then
    interleave the two planar halves (ImfZip.cpp / ImfRle.cpp)."""
    p = ((np.cumsum(t.astype(np.int64) - 128) + 128) & 0xFF).astype(np.uint8)
    n = p.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = p[:half]
    out[1::2] = p[half:]
    return out.tobytes()


def _deinterleave_predict(raw: bytes) -> bytes:
    s = np.frombuffer(raw, np.uint8)
    n = s.size
    half = (n + 1) // 2
    planar = np.empty(n, np.uint8)
    planar[:half] = s[0::2]
    planar[half:] = s[1::2]
    d = planar.astype(np.int64)
    pred = np.empty(n, np.int64)
    pred[0] = d[0]
    pred[1:] = d[1:] - d[:-1] + 128
    return (pred & 0xFF).astype(np.uint8).tobytes()


def _zip_undo(payload: bytes) -> bytes:
    return _predict_interleave(
        np.frombuffer(_zlib.decompress(payload), np.uint8))


def _rle_undo(payload: bytes) -> bytes:
    return _predict_interleave(np.frombuffer(_rle_decode(payload), np.uint8))


def _zip_do(raw: bytes) -> bytes:
    """Inverse of _zip_undo: de-interleave halves, apply the delta
    predictor, deflate (ImfZip.cpp::compress)."""
    return _zlib.compress(_deinterleave_predict(raw))


def _rle_do(raw: bytes) -> bytes:
    return _rle_encode(_deinterleave_predict(raw))


def _piz_chans(channels, w: int, ny: int):
    """PIZ channel descriptors: (pixels per row, rows, u16 words per pixel)."""
    return [(w, ny, 1 if pt == 1 else 2) for _, pt in channels]


def _piz_do(raw: bytes, channels, w: int, ny: int) -> bytes:
    """Scanline-interleaved raw block -> PIZ payload (channel-planar inside)."""
    from . import piz as _piz
    chans = _piz_chans(channels, w, ny)
    words = np.frombuffer(raw, "<u2").reshape(ny, -1)
    # per scanline the channels sit side by side (alphabetical); split them
    # out into the per-channel planar order PIZ compresses
    widths = [nx * size for nx, _, size in chans]
    edges = np.cumsum([0] + widths)
    planar = np.concatenate(
        [words[:, edges[i]:edges[i + 1]].reshape(-1) for i in range(len(chans))])
    return _piz.piz_compress(planar, chans)


def _pxr24_undo(payload: bytes, channels, w: int, ny: int) -> bytes:
    """PXR24 decode (ImfPxr24Compressor.cpp::uncompress): inflate, then per
    scanline x channel the values ride as difference-coded MSB-first byte
    planes — 3 planes for FLOAT (the mantissa's low 8 bits were dropped on
    write: lossy), 2 for HALF, 4 for UINT. Returns the scanline-interleaved
    raw block."""
    data = np.frombuffer(_zlib.decompress(payload), np.uint8)
    pos = 0
    rows = []
    for _y in range(ny):
        row = []
        for _name, pt in channels:
            nb = {0: 4, 1: 2, 2: 3}[pt]        # UINT, HALF, FLOAT
            planes = [data[pos + k * w: pos + (k + 1) * w].astype(np.int64)
                      for k in range(nb)]
            pos += nb * w
            diff = np.zeros(w, np.int64)
            for p in planes:
                diff = (diff << 8) | p
            mask = (1 << (8 * nb)) - 1
            pix = np.cumsum(diff) & mask
            if pt == 1:
                row.append(pix.astype("<u2").view(np.uint8))
            elif pt == 2:
                row.append((pix << 8).astype("<u4").view(np.uint8))
            else:
                row.append(pix.astype("<u4").view(np.uint8))
        rows.append(np.concatenate(row))
    return np.concatenate(rows).tobytes()


def _b44_unpack14_batch(tiles: np.ndarray) -> np.ndarray:
    """Batch-decode 14-byte 4x4 HALF tiles [T, 14] u8 -> [T, 16] u16
    (ImfB44Compressor::unpack14): s[0] absolute, the rest 6-bit biased
    deltas at a shared shift, chained along x then y. Fully vectorized —
    a per-tile Python loop costs interpreter work per 16 pixels and takes
    minutes on real 2k x 2k images."""
    b = tiles.astype(np.int64)
    t = b.shape[0]
    shift = b[:, 2] >> 2
    bias = np.int64(0x20) << shift
    d = np.empty((t, 15), np.int64)
    d[:, 0] = ((b[:, 2] << 4) | (b[:, 3] >> 4)) & 0x3F     # s4  <- s0
    d[:, 1] = ((b[:, 3] << 2) | (b[:, 4] >> 6)) & 0x3F     # s8  <- s4
    d[:, 2] = b[:, 4] & 0x3F                               # s12 <- s8
    d[:, 3] = b[:, 5] >> 2                                 # s1  <- s0
    d[:, 4] = ((b[:, 5] << 4) | (b[:, 6] >> 4)) & 0x3F     # s5  <- s4
    d[:, 5] = ((b[:, 6] << 2) | (b[:, 7] >> 6)) & 0x3F     # s9  <- s8
    d[:, 6] = b[:, 7] & 0x3F                               # s13 <- s12
    d[:, 7] = b[:, 8] >> 2                                 # s2  <- s1
    d[:, 8] = ((b[:, 8] << 4) | (b[:, 9] >> 4)) & 0x3F     # s6  <- s5
    d[:, 9] = ((b[:, 9] << 2) | (b[:, 10] >> 6)) & 0x3F    # s10 <- s9
    d[:, 10] = b[:, 10] & 0x3F                             # s14 <- s13
    d[:, 11] = b[:, 11] >> 2                               # s3  <- s2
    d[:, 12] = ((b[:, 11] << 4) | (b[:, 12] >> 4)) & 0x3F  # s7  <- s6
    d[:, 13] = ((b[:, 12] << 2) | (b[:, 13] >> 6)) & 0x3F  # s11 <- s10
    d[:, 14] = b[:, 13] & 0x3F                             # s15 <- s14
    dd = (d << shift[:, None]) - bias[:, None]
    s = np.zeros((t, 16), np.int64)
    s[:, 0] = (b[:, 0] << 8) | b[:, 1]
    for dst, src, k in ((4, 0, 0), (8, 4, 1), (12, 8, 2), (1, 0, 3),
                        (5, 4, 4), (9, 8, 5), (13, 12, 6), (2, 1, 7),
                        (6, 5, 8), (10, 9, 9), (14, 13, 10), (3, 2, 11),
                        (7, 6, 12), (11, 10, 13), (15, 14, 14)):
        s[:, dst] = s[:, src] + dd[:, k]
    return (s & 0xFFFF).astype(np.uint16)


def _b44_from_monotonic(s: np.ndarray) -> np.ndarray:
    """Invert the compressor's bit-pattern-monotonic half transform
    (positive: flag bit set; negative: all bits inverted)."""
    s = s.astype(np.uint16)
    return np.where(s & 0x8000, s & 0x7FFF, ~s).astype(np.uint16)


def _b44_undo(payload: bytes, channels, w: int, ny: int) -> bytes:
    """B44 / B44A decode (ImfB44Compressor.cpp::uncompress): channel-planar;
    HALF channels as 4x4 tiles of 14 bytes (or 3 bytes for B44A's constant
    tiles, marker b[2] == 0xfc — a real shift never reaches 63, so the
    marker test is safe for both variants), FLOAT/UINT channels stored raw.
    Returns the scanline-interleaved raw block. Tile unpack is batched
    (_b44_unpack14_batch); only the variable-stride offset scan walks
    Python, and it skips whole runs of 14-byte tiles per step."""
    data = np.frombuffer(payload, np.uint8)
    pos = 0
    chan_rows = []
    nty, ntx = -(-ny // 4), -(-w // 4)
    ntiles = nty * ntx
    for _name, pt in channels:
        if pt != 1:                       # FLOAT / UINT ride uncompressed
            nb = w * ny * 4
            chan_rows.append(data[pos:pos + nb].reshape(ny, w * 4))
            pos += nb
            continue
        # offset scan: stride depends on the constant-tile marker, so the
        # prefix sum is sequential — but runs of packed tiles vectorize
        offs = np.empty(ntiles, np.int64)
        const = np.zeros(ntiles, bool)
        p = int(pos)
        t = 0
        while t < ntiles:
            rem = ntiles - t
            cand = data[p + 2: p + 2 + 14 * rem: 14]
            hit = np.nonzero(cand[:rem] == 0xFC)[0]
            run = int(hit[0]) if hit.size else min(rem, cand.shape[0])
            if run:
                offs[t:t + run] = p + 14 * np.arange(run)
                t += run
                p += 14 * run
            if t < ntiles and (hit.size or cand.shape[0] < rem):
                # bound-check before the marker read: a payload truncated
                # mid-grid must raise the codec error, not IndexError
                if p + 2 >= data.size or data[p + 2] != 0xFC:
                    raise ValueError("B44: truncated tile data")
                offs[t] = p
                const[t] = True
                t += 1
                p += 3
        vals = np.zeros((ntiles, 16), np.uint16)
        packed = ~const
        if packed.any():
            idx = offs[packed][:, None] + np.arange(14)
            vals[packed] = _b44_unpack14_batch(data[idx])
        if const.any():
            co = offs[const]
            v = (data[co].astype(np.uint16) << 8) | data[co + 1]
            vals[const] = v[:, None]
        vals = _b44_from_monotonic(vals)
        img = vals.reshape(nty, ntx, 4, 4).transpose(0, 2, 1, 3) \
            .reshape(nty * 4, ntx * 4)[:ny, :w]
        chan_rows.append(
            np.ascontiguousarray(img).view(np.uint8).reshape(ny, w * 2))
        pos = p
    return np.concatenate(
        [np.concatenate([cr[y] for cr in chan_rows]) for y in range(ny)]
    ).tobytes()


# --------------------------------------------------------------------- DWA
# DWAA/DWAB decode (ImfDwaCompressor.cpp semantics, written from the format
# spec — no OpenEXR implementation exists in this offline environment, so
# the conformance anchors are the independent in-test spec encoders in
# the JAX package's tests (TestExrDwa), same methodology as PIZ/B44).
#
# Stream layout (version 2): 11 little-endian u64 header words
# (version, unknownUncompressedSize, unknownCompressedSize,
#  acCompressedSize, dcCompressedSize, rleCompressedSize,
#  rleUncompressedSize, rleRawSize, totalAcUncompressedCount,
#  totalDcUncompressedCount, acCompression), then the serialized channel
# classification rules (u16 total size including itself; each rule is a
# NUL-terminated suffix + a flags byte [cscIdx+1 in bits 4-7, scheme in
# bits 2-3, case-insensitive in bit 0] + a pixel-type byte), then the four
# data segments in order: UNKNOWN (deflate), AC (ImfHuf container or
# deflate per acCompression), DC (EXR-Zip: deflate + delta predictor +
# byte interleave), RLE (deflate + EXR-RLE; per channel the sample bytes
# are split into byte planes).
#
# LOSSY_DCT channels: per 8x8 block, the DC half rides in the DC segment
# (component-planar within a channel set) and the AC halfs ride zigzagged
# + zero-run-coded in the shared AC segment (0xff00 = end of block,
# 0xffXX = run of XX zeros, else literal half bits). Decode per block:
# un-zigzag -> inverse orthonormal 8x8 DCT -> (BT.709 inverse CSC for
# R/G/B sets) -> float-to-half -> toLinear LUT (the sign-preserving 2.2
# power curve of dwaLookups). UNKNOWN channels are stored raw planar; RLE
# channels byte-planar.

_DWA_ZIGZAG = np.array([
    0,  1,  8,  16, 9,  2,  3,  10,
    17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_DWA_UNKNOWN, _DWA_LOSSY_DCT, _DWA_RLE = 0, 1, 2

# BT.709 RGB<->YCbCr (ImfDwaCompressorSimd.h csc709Forward64/Inverse64)
_DWA_CSC_INV = np.array([[1.0, 0.0, 1.5747],
                         [1.0, -0.1873, -0.4682],
                         [1.0, 1.8556, 0.0]], np.float32)

_dwa_lut_cache = {}


def _dwa_to_linear_lut() -> np.ndarray:
    """65536-entry half-bits -> half-bits LUT: sign * |x|^2.2 (the inverse
    of the encoder's perceptual 1/2.2 curve, dwaLookups toLinear)."""
    lut = _dwa_lut_cache.get("lin")
    if lut is None:
        v = np.arange(65536, dtype=np.uint16).view(np.float16) \
            .astype(np.float32)
        with np.errstate(invalid="ignore", over="ignore"):
            lin = np.sign(v) * np.abs(v) ** np.float32(2.2)
            lin = np.where(np.isnan(v), v, lin)      # NaN bits pass through
            lut = lin.astype(np.float16).view(np.uint16)
        _dwa_lut_cache["lin"] = lut
    return lut


def _dwa_dct_mat() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix T (rows = frequencies); forward
    2D transform is T @ X @ T.T, inverse is T.T @ C @ T."""
    x = np.arange(8, dtype=np.float64)
    u = x[:, None]
    t = np.cos((2 * x[None, :] + 1) * u * np.pi / 16.0)
    t[0] *= np.sqrt(1.0 / 8.0)
    t[1:] *= 0.5
    return t.astype(np.float32)


def _dwa_parse_rules(buf: bytes):
    """Deserialize v2 channel classification rules."""
    rules = []
    i = 0
    while i < len(buf):
        j = buf.index(b"\0", i)
        suffix = buf[i:j].decode("latin-1")
        i = j + 1
        if i + 2 > len(buf):
            raise ValueError("DWA: truncated channel rule")
        flags, ptype = buf[i], buf[i + 1]
        i += 2
        rules.append((suffix, (flags >> 2) & 3, ptype, (flags >> 4) - 1,
                      bool(flags & 1)))
    return rules


_DWA_DEFAULT_RULES = (
    [("R", _DWA_LOSSY_DCT, pt, 0, False) for pt in (1, 2)]
    + [("G", _DWA_LOSSY_DCT, pt, 1, False) for pt in (1, 2)]
    + [("B", _DWA_LOSSY_DCT, pt, 2, False) for pt in (1, 2)]
    + [(sfx, _DWA_LOSSY_DCT, pt, -1, False)
       for sfx in ("Y", "BY", "RY") for pt in (1, 2)]
    + [("A", _DWA_RLE, pt, -1, False) for pt in (0, 1, 2)]
)


def _dwa_classify(name: str, ptype: int, rules):
    """(scheme, cscIdx) for one channel: first rule whose suffix and pixel
    type match (suffix = name after the last '.')."""
    suffix = name.rsplit(".", 1)[-1]
    for r_sfx, r_scheme, r_type, r_csc, r_ci in rules:
        s = suffix.lower() if r_ci else suffix
        t = r_sfx.lower() if r_ci else r_sfx
        if s == t and ptype == r_type:
            return r_scheme, r_csc
    return _DWA_UNKNOWN, -1


def _dwa_unrle_ac(ac: np.ndarray, cur: int, zig: np.ndarray) -> int:
    """Fill one 64-entry zigzag half-bits block (DC already set at [0])
    from the shared AC token stream; returns the new cursor. (Scalar
    reference semantics; production decode uses _dwa_unrle_ac_batch.)"""
    dct = 1
    n = ac.shape[0]
    while dct < 64:
        if cur >= n:
            raise ValueError("DWA: AC stream underrun")
        val = int(ac[cur])
        cur += 1
        if val == 0xFF00:
            break
        if (val >> 8) == 0xFF:
            dct += val & 0xFF
        else:
            if dct < 64:
                zig[dct] = val
            dct += 1
    return cur


def _dwa_unrle_ac_batch(ac: np.ndarray, cur: int, nb: int):
    """Expand `nb` blocks' AC tokens from the shared stream starting at
    `cur` in one vectorized pass. Returns ([nb, 64] uint16 zigzag planes
    with position 0 left zero for the caller's DC, new cursor).

    Token semantics (mirrors _dwa_unrle_ac): 0xFF00 = end-of-block,
    0xFFnn = skip nn zigzag slots, else a literal half written at the
    current slot. A block also ends once its slot counter (starting at 1)
    reaches 64. Vectorization: each token advances the slot counter by a
    data-independent amount, so a single cumsum S gives every token's slot;
    block ends are searchsorted thresholds on S plus the next-EOB index,
    leaving only an O(nb) scalar walk for the start offsets (the interpreter
    bottleneck was the per-token inner loop, ~200k calls for a 2048² DWAB)."""
    toks = ac[cur:]
    ntoks = toks.shape[0]
    is_eob = toks == 0xFF00
    is_run = (toks >> 8 == 0xFF) & ~is_eob
    adv = np.where(is_run, toks & 0xFF,
                   np.where(is_eob, 0, 1)).astype(np.int64)
    s_cum = np.concatenate(([0], np.cumsum(adv)))      # S[i] = sum adv[:i]
    # first j >= i with slot 1 + (S[j+1]-S[i]) >= 64, for every i at once
    full_end = np.searchsorted(s_cum[1:], s_cum[:-1] + 63, side="left")
    eob_pos = np.nonzero(is_eob)[0]
    starts = np.empty(nb, np.int64)
    s = 0
    ep = 0
    n_eob = eob_pos.shape[0]
    for b in range(nb):
        if s >= ntoks:
            # a block must consume at least one token (EOB or content)
            raise ValueError("DWA: AC stream underrun")
        starts[b] = s
        while ep < n_eob and eob_pos[ep] < s:
            ep += 1
        e_eob = eob_pos[ep] if ep < n_eob else ntoks
        e = min(e_eob, int(full_end[s]))
        if e >= ntoks:
            raise ValueError("DWA: AC stream underrun")
        s = e + 1
    consumed = s
    out = np.zeros((nb, 64), np.uint16)
    lit = np.nonzero(~is_eob[:consumed] & ~is_run[:consumed])[0]
    if lit.size:
        blk = np.searchsorted(starts, lit, side="right") - 1
        pos = 1 + s_cum[lit] - s_cum[starts[blk]]
        # consumed literals always land in 1..63: the scalar loop only reads
        # a token while the slot counter is < 64
        out[blk, pos] = toks[lit]
    return out, cur + consumed


def _dwa_undo(payload: bytes, channels, w: int, ny: int) -> bytes:
    if len(payload) < 88:
        raise ValueError("DWA: truncated header")
    hdr = np.frombuffer(payload[:88], "<u8")
    (version, unk_unc, unk_cmp, ac_cmp, dc_cmp, rle_cmp, rle_unc,
     rle_raw, ac_count, dc_count, ac_scheme) = (int(x) for x in hdr)
    pos = 88
    if version >= 2:
        rule_size = int.from_bytes(payload[pos:pos + 2], "little")
        rules = _dwa_parse_rules(payload[pos + 2:pos + rule_size])
        pos += rule_size
    else:
        rules = _DWA_DEFAULT_RULES

    unk = _zlib.decompress(payload[pos:pos + unk_cmp]) if unk_cmp else b""
    pos += unk_cmp
    if len(unk) != unk_unc:
        raise ValueError("DWA: unknown-segment size mismatch")
    if ac_cmp:
        buf = payload[pos:pos + ac_cmp]
        pos += ac_cmp
        if ac_scheme == 0:                       # STATIC_HUFFMAN
            from .piz import huf_uncompress
            ac = huf_uncompress(buf, ac_count)
        elif ac_scheme == 1:                     # DEFLATE
            ac = np.frombuffer(_zlib.decompress(buf), "<u2")
            if ac.shape[0] != ac_count:
                raise ValueError("DWA: AC count mismatch")
        else:
            raise ValueError(f"DWA: unknown AC compression {ac_scheme}")
    else:
        ac = np.empty(0, np.uint16)
    if dc_cmp:
        dc = np.frombuffer(_zip_undo(payload[pos:pos + dc_cmp]), "<u2")
        pos += dc_cmp
        if dc.shape[0] != dc_count:
            raise ValueError("DWA: DC count mismatch")
    else:
        dc = np.empty(0, np.uint16)
    if rle_cmp:
        rle = _rle_decode(_zlib.decompress(payload[pos:pos + rle_cmp]))
        pos += rle_cmp
        if len(rle) != rle_raw:
            raise ValueError("DWA: RLE size mismatch")
    else:
        rle = b""

    schemes = [_dwa_classify(nm, pt, rules) for nm, pt in channels]
    # CSC sets: channels sharing a prefix whose classifiers carry cscIdx
    # 0, 1 and 2 — all three present, decoded as one YCbCr group
    by_prefix = {}
    for ci, ((nm, pt), (scheme, csc)) in enumerate(zip(channels, schemes)):
        if scheme == _DWA_LOSSY_DCT and csc >= 0:
            pre = nm.rsplit(".", 1)[0] if "." in nm else ""
            by_prefix.setdefault(pre, {})[csc] = ci
    csc_sets = {}          # first-channel index -> [idx R, idx G, idx B]
    in_set = {}
    for pre, m in by_prefix.items():
        if len(m) == 3:
            members = [m[0], m[1], m[2]]
            first = min(members)
            csc_sets[first] = members
            for ci in members:
                in_set[ci] = first

    nbx, nby = -(-w // 8), -(-ny // 8)
    nblocks = nbx * nby
    tmat = _dwa_dct_mat()
    lut = _dwa_to_linear_lut()
    ac_cur, dc_cur, rle_cur, unk_cur = 0, 0, 0, 0
    planes = [None] * len(channels)     # uint8 [ny, w*pixsize] per channel

    def decode_dct_set(members):
        """One LossyDctDecoder(CSC) pass: consumes component-planar DC,
        shared AC; returns per-member half-bit planes [ny, w]."""
        nonlocal ac_cur, dc_cur
        ncomp = len(members)
        # stream order is block-major, component-minor: (b0,c0), (b0,c1), …
        zig, ac_cur = _dwa_unrle_ac_batch(ac, ac_cur, nblocks * ncomp)
        zig = zig.reshape(nblocks, ncomp, 64)
        zig[:, :, 0] = dc[dc_cur:dc_cur + ncomp * nblocks] \
            .reshape(ncomp, nblocks).T
        dc_cur += ncomp * nblocks
        # un-zigzag to raster, batch inverse DCT
        raster = np.zeros((nblocks, ncomp, 64), np.uint16)
        raster[:, :, _DWA_ZIGZAG] = zig
        vals = np.ascontiguousarray(raster).view(np.float16) \
            .astype(np.float32).reshape(nblocks, ncomp, 8, 8)
        idct = np.einsum("ux,bcuv,vy->bcxy", tmat, vals, tmat,
                         optimize=True)
        if ncomp == 3:
            idct = np.einsum("rc,bcxy->brxy", _DWA_CSC_INV, idct)
        half_bits = lut[idct.astype(np.float16).view(np.uint16)]
        # scatter blocks into [ny, w] planes (crop edge blocks)
        out = []
        for c in range(ncomp):
            plane = half_bits[:, c].reshape(nby, nbx, 8, 8) \
                .transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)
            out.append(np.ascontiguousarray(plane[:ny, :w]))
        return out

    order = []
    done = set()
    for ci in range(len(channels)):
        if ci in done:
            continue
        if ci in in_set:
            members = csc_sets[in_set[ci]]
            order.append(members)
            done.update(members)
        else:
            order.append([ci])
            done.add(ci)

    for group in order:
        scheme, _csc = schemes[group[0]]
        if scheme == _DWA_LOSSY_DCT:
            half_planes = decode_dct_set(group)
            for ci, hp in zip(group, half_planes):
                nm, pt = channels[ci]
                if pt == 1:      # HALF
                    planes[ci] = hp.astype("<u2").view(np.uint8) \
                        .reshape(ny, w * 2)
                elif pt == 2:    # FLOAT: encoder went through half
                    planes[ci] = hp.view(np.float16).astype("<f4") \
                        .view(np.uint8).reshape(ny, w * 4)
                else:
                    raise ValueError("DWA: UINT channel cannot be LOSSY_DCT")
            continue
        ci = group[0]
        nm, pt = channels[ci]
        nb = {0: 4, 1: 2, 2: 4}[pt]
        if scheme == _DWA_RLE:
            # per channel: nb byte planes of w*ny bytes each (the sample
            # bytes split by position, little-endian)
            need = nb * w * ny
            seg = np.frombuffer(rle[rle_cur:rle_cur + need], np.uint8)
            rle_cur += need
            if seg.size != need:
                raise ValueError("DWA: RLE channel underrun")
            sam = seg.reshape(nb, ny * w).T.copy()     # [n, nb] LE bytes
            planes[ci] = sam.reshape(ny, w * nb)
        else:                                          # UNKNOWN: raw planar
            need = nb * w * ny
            seg = unk[unk_cur:unk_cur + need]
            unk_cur += need
            if len(seg) != need:
                raise ValueError("DWA: unknown-channel underrun")
            planes[ci] = np.frombuffer(seg, np.uint8).reshape(ny, w * nb)

    return np.concatenate(
        [np.concatenate([p[y] for p in planes]) for y in range(ny)]
    ).tobytes()


def _piz_undo(payload: bytes, channels, w: int, ny: int) -> bytes:
    from . import piz as _piz
    chans = _piz_chans(channels, w, ny)
    planar = _piz.piz_uncompress(payload, chans)
    parts, off = [], 0
    for nx, ny_, size in chans:
        parts.append(planar[off:off + nx * ny_ * size].reshape(ny_, nx * size))
        off += nx * ny_ * size
    return np.concatenate(parts, axis=1).astype("<u2").tobytes()


# ------------------------------------------------------------ write encoders
# Write-side counterparts of the PXR24/B44/B44A/DWA decoders above (VERDICT
# r3 item 9: the reference writes EXR through full OpenEXR,
# src/structure.rs:490-642 — every compression enum 0-9 must round-trip).
# Each encoder is validated by encode->decode round-trips (bit-exact where
# the format is lossless: PXR24 on HALF/UINT, B44A constant tiles) plus the
# randomized fuzz suite of the JAX package's tests.

def _pxr24_do(raw: bytes, channels, w: int, ny: int) -> bytes:
    """Inverse of _pxr24_undo: per scanline x channel, difference-code the
    pixel words (FLOAT truncated to its top 24 bits — lossy by design) and
    split into MSB-first byte planes, then deflate."""
    data = np.frombuffer(raw, np.uint8)
    pos = 0
    planes = []
    for _y in range(ny):
        for _name, pt in channels:
            bpp = 2 if pt == 1 else 4
            row = data[pos:pos + w * bpp]
            pos += w * bpp
            if pt == 1:                       # HALF: 2 planes
                pix = row.view("<u2").astype(np.int64)
                nb = 2
            elif pt == 2:
                # FLOAT -> 24 bits a la OpenEXR floatToFloat24: round the
                # dropped mantissa byte to nearest (not truncate), and keep
                # NaNs NaN (a NaN whose kept mantissa bits are all zero
                # would otherwise collapse to +/-Inf).  ADVICE r4.
                u = row.view("<u4").astype(np.uint32)
                s = u & np.uint32(0x80000000)
                e = u & np.uint32(0x7F800000)
                m = u & np.uint32(0x007FFFFF)
                fin24 = ((e | m) + (m & np.uint32(0x80))) >> np.uint32(8)
                m24 = m >> np.uint32(8)
                nan24 = (e >> np.uint32(8)) | m24 | (m24 == 0)
                spec24 = np.where(m != 0, nan24, e >> np.uint32(8))
                i24 = np.where(e == np.uint32(0x7F800000), spec24, fin24)
                pix = ((s >> np.uint32(8)) | i24).astype(np.int64)
                nb = 3
            else:                             # UINT
                pix = row.view("<u4").astype(np.int64)
                nb = 4
            mask = (1 << (8 * nb)) - 1
            diff = np.empty(w, np.int64)
            diff[0] = pix[0]
            diff[1:] = pix[1:] - pix[:-1]
            diff &= mask
            for k in range(nb):
                planes.append(((diff >> (8 * (nb - 1 - k))) & 0xFF)
                              .astype(np.uint8))
    return _zlib.compress(np.concatenate(planes).tobytes())


# (dst, src) chains of the 15 packed 6-bit deltas, in stream order — the
# exact inverse of _b44_unpack14_batch's reconstruction table
_B44_CHAIN = ((4, 0), (8, 4), (12, 8), (1, 0), (5, 4), (9, 8), (13, 12),
              (2, 1), (6, 5), (10, 9), (14, 13), (3, 2), (7, 6), (11, 10),
              (15, 14))


def _b44_pack14_batch(s: np.ndarray) -> np.ndarray:
    """Batch-encode 4x4 HALF tiles [T, 16] u16 (monotonic-transformed) ->
    [T, 14] u8. Per tile the smallest shift is chosen such that every
    chained delta d (against the RECONSTRUCTED predecessor, so quantization
    error never accumulates) satisfies 0 <= (d + (0x20 << shift)) >> shift
    <= 63; vectorized over tiles by iterating shift 0..13 and freezing
    tiles as they become encodable."""
    s = s.astype(np.int64)
    t = s.shape[0]
    best_shift = np.full(t, -1, np.int64)
    best_dd = np.zeros((t, 15), np.int64)
    todo = np.ones(t, bool)
    for shift in range(14):
        if not todo.any():
            break
        bias = np.int64(0x20) << shift
        recon = np.zeros((t, 16), np.int64)
        recon[:, 0] = s[:, 0]
        dd = np.zeros((t, 15), np.int64)
        ok = todo.copy()
        for k, (dst, src) in enumerate(_B44_CHAIN):
            d = s[:, dst] - recon[:, src]
            q = (d + bias) >> shift
            ok &= (q >= 0) & (q <= 63)
            dd[:, k] = np.clip(q, 0, 63)
            recon[:, dst] = recon[:, src] + (dd[:, k] << shift) - bias
        newly = todo & ok
        best_shift[newly] = shift
        best_dd[newly] = dd[newly]
        todo &= ~ok
    if todo.any():
        raise ValueError("B44: tile not encodable at any shift")
    # bit-pack: bytes 0-1 = s[0] big-endian; bytes 2-13 = MSB-first stream
    # of shift(6) then 15 x dd(6)
    out = np.zeros((t, 14), np.uint8)
    out[:, 0] = (s[:, 0] >> 8) & 0xFF
    out[:, 1] = s[:, 0] & 0xFF
    # accumulate the 96-bit stream into a [T, 12] byte array via a running
    # bit cursor (every value is 6 bits, so each spans at most 2 bytes)
    vals = np.concatenate([best_shift[:, None], best_dd], axis=1)  # [T, 16]
    bitpos = 0
    acc = np.zeros((t, 12), np.uint16)
    for j in range(16):
        v = vals[:, j].astype(np.uint16)
        byte, off = divmod(bitpos, 8)
        # a 6-bit value at bit offset `off` spans at most 2 bytes
        acc[:, byte] |= (v << (10 - off)) >> 8
        if byte + 1 < 12:
            acc[:, byte + 1] |= (v << (10 - off)) & 0xFF
        bitpos += 6
    out[:, 2:] = acc.astype(np.uint8)
    return out


def _b44_to_monotonic(v: np.ndarray) -> np.ndarray:
    """Forward bit-pattern-monotonic half transform (inverse of
    _b44_from_monotonic): negative halfs invert all bits, non-negative set
    the flag bit."""
    v = v.astype(np.uint16)
    return np.where(v & 0x8000, ~v, v | 0x8000).astype(np.uint16)


def _b44_do(raw: bytes, channels, w: int, ny: int, b44a: bool) -> bytes:
    """Inverse of _b44_undo: channel-planar; HALF channels as 4x4 tiles of
    14 bytes (B44A: 3-byte [hi, lo, 0xfc] constant tiles), FLOAT/UINT raw."""
    data = np.frombuffer(raw, np.uint8)
    line_bytes = sum(w * (2 if pt == 1 else 4) for _, pt in channels)
    col_off = 0
    parts = []
    nty, ntx = -(-ny // 4), -(-w // 4)
    for _name, pt in channels:
        bpp = 2 if pt == 1 else 4
        chan = data.reshape(ny, line_bytes)[:, col_off:col_off + w * bpp]
        col_off += w * bpp
        if pt != 1:
            parts.append(np.ascontiguousarray(chan).tobytes())
            continue
        vals = np.ascontiguousarray(chan).view("<u2").reshape(ny, w)
        # edge-replicate to 4x4 tile grid (decoder crops)
        full = np.empty((nty * 4, ntx * 4), np.uint16)
        full[:ny, :w] = vals
        full[ny:, :w] = vals[-1:, :]
        full[:, w:] = full[:, w - 1:w]
        tiles = full.reshape(nty, 4, ntx, 4).transpose(0, 2, 1, 3) \
            .reshape(nty * ntx, 16)
        mono = _b44_to_monotonic(tiles)
        const = (mono == mono[:, :1]).all(axis=1) if b44a \
            else np.zeros(mono.shape[0], bool)
        packed = _b44_pack14_batch(mono[~const]) if (~const).any() \
            else np.zeros((0, 14), np.uint8)
        buf = bytearray()
        pi = 0
        for ti in range(mono.shape[0]):
            if const[ti]:
                v = int(mono[ti, 0])
                buf += bytes([v >> 8, v & 0xFF, 0xFC])
            else:
                buf += packed[pi].tobytes()
                pi += 1
        parts.append(bytes(buf))
    return b"".join(parts)


def _dwa_rle_ac_batch(flat: np.ndarray) -> np.ndarray:
    """Vectorized AC zero-run tokenizer over [B, 64] zigzag blocks.

    Per row, positions 1..63: a literal token per nonzero half, one
    0xFF00|len run token per interior zero run, trailing zero runs
    dropped — the write-side mirror of _dwa_unrle_ac (the scalar spec
    decoder), vectorized for the same reason the decode side was (a
    2048^2 DWAB is ~200k blocks; a Python per-block loop is
    interpreter-bound for minutes).

    End-of-block: the decoder stops as soon as its slot counter reaches
    64, WITHOUT consuming a token — so a full block (nonzero at zigzag
    slot 63) must NOT be followed by 0xFF00; the EOB token is emitted
    only for blocks that end early via a trailing zero run. (A stray EOB
    after a full block desyncs every later block in the stream — the
    high-contrast-render bug this rule fixes.)"""
    v = np.ascontiguousarray(flat[:, 1:], np.uint16)
    # Token-space collision guard (ADVICE r4): any half in 0xFF00-0xFFFF (all
    # negative NaNs) shares the zero-run/EOB token prefix and would desync the
    # decoder's AC stream for every later block.  Canonicalize them to the
    # positive quiet NaN 0x7E00 before tokenizing (NaN-ness preserved).
    v = np.where((v & np.uint16(0xFF00)) == np.uint16(0xFF00),
                 np.uint16(0x7E00), v)
    n_rows, n = v.shape
    nzm = v != 0
    col = np.arange(n)
    # next nonzero position at-or-after each column (suffix minimum);
    # 2n sentinel when the rest of the row is zero
    idx = np.where(nzm, col[None, :], 2 * n)
    nxt = np.minimum.accumulate(idx[:, ::-1], axis=1)[:, ::-1]
    prev_nz = np.concatenate([np.ones((n_rows, 1), bool), nzm[:, :-1]],
                             axis=1)
    run_start = (~nzm) & prev_nz & (nxt < n)    # interior runs only
    runlen = (nxt - col[None, :]).astype(np.uint16)
    toks = np.where(nzm, v, np.uint16(0xFF00) | runlen)
    emit = nzm | run_start
    toks = np.concatenate(
        [toks, np.full((n_rows, 1), 0xFF00, np.uint16)], axis=1)
    # EOB only for blocks with a trailing zero run (last slot zero)
    emit = np.concatenate([emit, ~nzm[:, -1:]], axis=1)
    return toks[emit]                            # row-major ragged concat


def _dwa_from_linear_lut() -> np.ndarray:
    """Inverse of _dwa_to_linear_lut: half-bits -> half-bits, the encoder's
    perceptual sign * |x|^(1/2.2) curve."""
    lut = _dwa_lut_cache.get("nonlin")
    if lut is None:
        v = np.arange(65536, dtype=np.uint16).view(np.float16) \
            .astype(np.float32)
        with np.errstate(invalid="ignore", over="ignore"):
            nl = np.sign(v) * np.abs(v) ** np.float32(1.0 / 2.2)
            nl = np.where(np.isnan(v), v, nl)
            lut = nl.astype(np.float16).view(np.uint16)
        _dwa_lut_cache["nonlin"] = lut
    return lut


_DWA_CSC_FWD = np.linalg.inv(_DWA_CSC_INV.astype(np.float64)) \
    .astype(np.float32)


def _dwa_serialize_rules(rules) -> bytes:
    body = b""
    for sfx, scheme, ptype, csc, ci in rules:
        flags = ((csc + 1) << 4) | (scheme << 2) | (1 if ci else 0)
        body += sfx.encode("latin-1") + b"\0" + bytes([flags, ptype])
    return _struct.pack("<H", len(body) + 2) + body


def _dwa_do(raw: bytes, channels, w: int, ny: int) -> bytes:
    """Inverse of _dwa_undo: classify channels under the default rules,
    LOSSY_DCT channels per 8x8 block through the perceptual curve ->
    (forward BT.709 CSC for complete R/G/B sets) -> orthonormal DCT ->
    half quantization -> zero-run zigzag AC (ImfHuf container) +
    component-planar DC (EXR-Zip); RLE channels byte-planar; others raw
    deflate. Emits a version-2 stream with serialized rules."""
    from .piz import huf_compress
    data = np.frombuffer(raw, np.uint8)
    line_bytes = sum(w * (2 if pt == 1 else 4) for _, pt in channels)
    schemes = [_dwa_classify(nm, pt, _DWA_DEFAULT_RULES)
               for nm, pt in channels]
    # channel planes as [ny, w] value arrays
    col_off = 0
    planes = []
    for (_nm, pt) in channels:
        bpp = 2 if pt == 1 else 4
        chan = np.ascontiguousarray(
            data.reshape(ny, line_bytes)[:, col_off:col_off + w * bpp])
        col_off += w * bpp
        planes.append(chan)

    by_prefix = {}
    for ci, ((nm, pt), (scheme, csc)) in enumerate(zip(channels, schemes)):
        if scheme == _DWA_LOSSY_DCT and csc >= 0:
            pre = nm.rsplit(".", 1)[0] if "." in nm else ""
            by_prefix.setdefault(pre, {})[csc] = ci
    csc_sets, in_set = {}, {}
    for pre, m in by_prefix.items():
        if len(m) == 3:
            members = [m[0], m[1], m[2]]
            csc_sets[min(members)] = members
            for ci in members:
                in_set[ci] = min(members)

    nbx, nby = -(-w // 8), -(-ny // 8)
    nblocks = nbx * nby
    tmat = _dwa_dct_mat()
    nonlin = _dwa_from_linear_lut()

    order, done = [], set()
    for ci in range(len(channels)):
        if ci in done:
            continue
        if ci in in_set:
            members = csc_sets[in_set[ci]]
            order.append(members)
            done.update(members)
        else:
            order.append([ci])
            done.add(ci)

    ac_tokens, dc_words = [], []
    rle_bytes, unk_bytes = [], []
    for group in order:
        scheme, _csc = schemes[group[0]]
        nm, pt = channels[group[0]]
        if scheme == _DWA_LOSSY_DCT:
            ncomp = len(group)
            comp = []
            for ci in group:
                _nm, cpt = channels[ci]
                if cpt == 1:
                    half_bits = planes[ci].view("<u2").reshape(ny, w) \
                        .astype(np.uint16)
                elif cpt == 2:
                    half_bits = planes[ci].view("<f4").reshape(ny, w) \
                        .astype(np.float16).view(np.uint16)
                else:
                    raise ValueError("DWA: UINT channel cannot be LOSSY_DCT")
                nl = nonlin[half_bits].view(np.float16).astype(np.float32)
                full = np.zeros((nby * 8, nbx * 8), np.float32)
                full[:ny, :w] = nl        # zero-pad edge blocks (the
                                          # decoder crops them away)
                comp.append(full.reshape(nby, 8, nbx, 8)
                            .transpose(0, 2, 1, 3).reshape(nblocks, 8, 8))
            vals = np.stack(comp, axis=1)            # [nblocks, ncomp, 8, 8]
            if ncomp == 3:
                vals = np.einsum("rc,bcxy->brxy", _DWA_CSC_FWD, vals)
            coef = np.einsum("xu,bcuv,yv->bcxy", tmat, vals, tmat,
                             optimize=True)
            half_q = coef.astype(np.float16).view(np.uint16) \
                .reshape(nblocks, ncomp, 64)
            # the decoder scatters raster[ZZ] = zig, so zig[i] = raster[ZZ[i]]
            zig = half_q[:, :, _DWA_ZIGZAG]
            # DC: component-planar within the set ([ncomp, nblocks])
            dc_words.append(np.ascontiguousarray(
                zig[:, :, 0].T).reshape(-1))
            # AC zero-run code, block-major component-minor
            ac_tokens.append(
                _dwa_rle_ac_batch(zig.reshape(nblocks * ncomp, 64)))
        elif scheme == _DWA_RLE:
            nb = {0: 4, 1: 2, 2: 4}[pt]
            sam = planes[group[0]].reshape(ny * w, nb)
            rle_bytes.append(np.ascontiguousarray(sam.T).reshape(-1))
        else:
            unk_bytes.append(planes[group[0]].reshape(-1))

    ac = np.concatenate(ac_tokens) if ac_tokens else np.empty(0, np.uint16)
    dc = np.concatenate(dc_words) if dc_words else np.empty(0, np.uint16)
    ac_buf = huf_compress(ac) if ac.size else b""
    dc_buf = _zip_do(dc.astype("<u2").tobytes()) if dc.size else b""
    rle_raw = (np.concatenate(rle_bytes).tobytes() if rle_bytes else b"")
    rle_enc = _rle_encode(rle_raw) if rle_raw else b""
    rle_buf = _zlib.compress(rle_enc) if rle_raw else b""
    unk_raw = (np.concatenate(unk_bytes).tobytes() if unk_bytes else b"")
    unk_buf = _zlib.compress(unk_raw) if unk_raw else b""

    rules_buf = _dwa_serialize_rules(_DWA_DEFAULT_RULES)
    hdr = np.asarray([2, len(unk_raw), len(unk_buf), len(ac_buf),
                      len(dc_buf), len(rle_buf), len(rle_enc),
                      len(rle_raw), ac.size, dc.size, 0], "<u8")
    return (hdr.tobytes() + rules_buf + unk_buf + ac_buf + dc_buf + rle_buf)


def write_exr(path, img: np.ndarray, half: bool = False,
              compression: str = "none", tiled=None) -> None:
    """Write [h, w, 3] float32 as an EXR (compression:
    none|rle|zips|zip|piz|pxr24|b44|b44a|dwaa|dwab — the full OpenEXR
    scanline enum 0-9; pxr24 truncates FLOAT mantissas, b44/b44a/dwa are
    lossy by design and force HALF semantics through their codecs).

    tiled=(tx, ty) writes a single-part TILED file (ONE_LEVEL, rounding
    down): version flag 0x200, a 'tiledesc' attribute, and one chunk per
    tile (each tile compressed whole — lines-per-block does not apply to
    tiles)."""
    img = np.asarray(img, dtype=np.float32)
    h, w = img.shape[:2]
    if tiled is not None:
        tx, ty = int(tiled[0]), int(tiled[1])
        if tx <= 0 or ty <= 0 or tx > 0x7FFFFFFF or ty > 0x7FFFFFFF:
            raise ValueError(
                "write_exr: tiled=(tx, ty) needs positive tile dims, got "
                f"({tiled[0]}, {tiled[1]})")
    if img.ndim == 2:
        img = img[:, :, None]
    c = img.shape[2]
    names = ["Y"] if c == 1 else ["R", "G", "B"]  # names[j] = EXR channel of img column j
    pix_t = 1 if half else 2  # 1 = HALF, 2 = FLOAT
    dtype = np.float16 if half else np.float32
    comp = {"none": 0, "rle": 1, "zips": 2, "zip": 3, "piz": 4, "pxr24": 5,
            "b44": 6, "b44a": 7, "dwaa": 8, "dwab": 9}[compression]
    lpb = _EXR_LINES_PER_BLOCK[comp]

    chlist = b""
    for n in sorted(names):
        chlist += n.encode() + b"\0" + _struct.pack("<iiii", pix_t, 0, 1, 1)
    chlist += b"\0"

    version = 2 | (0x200 if tiled else 0)
    header = b"\x76\x2f\x31\x01" + _struct.pack("<i", version)  # magic + ver
    header += _exr_attr(b"channels", b"chlist", chlist)
    header += _exr_attr(b"compression", b"compression", bytes([comp]))
    box = _struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _exr_attr(b"dataWindow", b"box2i", box)
    header += _exr_attr(b"displayWindow", b"box2i", box)
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\0")  # INCREASING_Y
    header += _exr_attr(b"pixelAspectRatio", b"float", _struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f", _struct.pack("<ff", 0.0, 0.0))
    header += _exr_attr(b"screenWindowWidth", b"float", _struct.pack("<f", 1.0))
    if tiled:
        tx, ty = int(tiled[0]), int(tiled[1])
        # mode byte 0 = ONE_LEVEL + ROUND_DOWN
        header += _exr_attr(b"tiles", b"tiledesc",
                            _struct.pack("<IIB", tx, ty, 0))
    header += b"\0"

    # channel order within each chunk is alphabetical
    order = [names.index(n) for n in sorted(names)]
    chans = [(n, pix_t) for n in sorted(names)]

    def _encode(raw, bw, bny):
        if comp == 4:
            z = _piz_do(raw, chans, bw, bny)
        elif comp == 5:
            z = _pxr24_do(raw, chans, bw, bny)
        elif comp in (6, 7):
            z = _b44_do(raw, chans, bw, bny, b44a=(comp == 7))
        elif comp in (8, 9):
            z = _dwa_do(raw, chans, bw, bny)
        elif comp == 1:
            z = _rle_do(raw)
        elif comp:
            z = _zip_do(raw)
        else:
            z = raw
        return z if len(z) < len(raw) else raw          # OpenEXR raw fallback

    blocks = []
    if tiled:
        for dy in range(0, (h + ty - 1) // ty):
            for dx in range(0, (w + tx - 1) // tx):
                bw = min(tx, w - dx * tx)
                bny = min(ty, h - dy * ty)
                raw = b"".join(
                    img[y][dx * tx:dx * tx + bw, j].astype(dtype).tobytes()
                    for y in range(dy * ty, dy * ty + bny) for j in order)
                payload = _encode(raw, bw, bny)
                blocks.append(_struct.pack("<iiiii", dx, dy, 0, 0,
                                           len(payload)) + payload)
    else:
        for y0 in range(0, h, lpb):
            ny = min(lpb, h - y0)
            raw = b"".join(
                img[y][:, j].astype(dtype).tobytes()
                for y in range(y0, y0 + ny) for j in order)
            payload = _encode(raw, w, ny)
            blocks.append(_struct.pack("<ii", y0, len(payload)) + payload)
    table_off = len(header) + 8 * len(blocks)
    offsets, acc = [], table_off
    for b in blocks:
        offsets.append(acc)
        acc += len(b)
    with open(path, "wb") as f:
        f.write(header + _struct.pack("<%dQ" % len(blocks), *offsets)
                + b"".join(blocks))


def _parse_exr_part_header(data: bytes, pos: int):
    """Parse one header (attribute list up to its null terminator).

    Returns (hdr dict, new pos); hdr is None for an EMPTY header (the
    terminator of a multipart header sequence)."""
    if data[pos] == 0:
        return None, pos + 1
    hdr = {"channels": [], "comp": None, "dw": None, "tiles": None,
           "name": None, "type": None, "chunkCount": None}
    while data[pos] != 0:
        nul = data.index(b"\0", pos)
        name = data[pos:nul]; pos = nul + 1
        nul = data.index(b"\0", pos)
        typ = data[pos:nul]; pos = nul + 1
        (size,) = _struct.unpack_from("<i", data, pos); pos += 4
        val = data[pos:pos + size]; pos += size
        if name == b"channels":
            cp = 0
            while val[cp] != 0:
                cn = val.index(b"\0", cp)
                cname = val[cp:cn].decode(); cp = cn + 1
                pt, _, _, _ = _struct.unpack_from("<iiii", val, cp); cp += 16
                hdr["channels"].append((cname, pt))
        elif name == b"compression":
            hdr["comp"] = val[0]
        elif name == b"dataWindow":
            hdr["dw"] = _struct.unpack("<iiii", val)
        elif name == b"tiles":
            hdr["tiles"] = _struct.unpack("<IIB", val[:9])
        elif name == b"name":
            hdr["name"] = val.rstrip(b"\0").decode()
        elif name == b"type":
            hdr["type"] = val.rstrip(b"\0").decode()
        elif name == b"chunkCount":
            (hdr["chunkCount"],) = _struct.unpack("<i", val)
    return hdr, pos + 1


def read_exr(path, part=None) -> np.ndarray:
    """Read a scanline EXR — every compression enum 0–9 (NONE/RLE/ZIPS/ZIP/
    PIZ/PXR24/B44/B44A/DWAA/DWAB).

    Multipart files (version bit 0x1000, OpenEXR >= 2.0: a header sequence
    terminated by an empty header, one chunk-offset table per part, each
    chunk prefixed with its i32 part number — ImfMultiPartInputFile) load
    ONE part: `part` selects by index or by part name; default is the first
    non-deep part. Deep parts (and deep single-part files, bit 0x800) are
    rejected loudly, never decoded as garbage.

    Caveat (DWAA/DWAB only): the DWA decoder is spec-derived and has never
    been validated against a canonical OpenEXR-written DWA file — no OpenEXR
    implementation exists in this offline environment. Its conformance
    anchors are independent in-test spec encoders (same methodology as PIZ/
    B44); the toLinear curve in particular uses the analytic sign·|x|^2.2
    form rather than OpenEXR's generated dwaLookups table, so real DWA files
    could decode with small value deviations. Cross-validate against an
    OpenEXR-produced file as soon as a toolchain is available."""
    data = Path(path).read_bytes()
    if data[:4] != b"\x76\x2f\x31\x01":
        raise ValueError("not an EXR file")
    # version field: low byte = 2, flag bits select tiled (0x200),
    # long-names (0x400, header layout unchanged), deep (0x800),
    # multipart (0x1000).
    (version,) = _struct.unpack_from("<I", data, 4)
    if version & 0x800:
        raise NotImplementedError(
            "EXR deep files unsupported; flatten with oiiotool first")
    multipart = bool(version & 0x1000)
    chunk_prefix = 0
    part_is_tiled = bool(version & 0x200)

    if multipart:
        headers, pos = [], 8
        while True:
            hdr, pos = _parse_exr_part_header(data, pos)
            if hdr is None:
                break
            headers.append(hdr)
        if not headers:
            raise ValueError("multipart EXR with no headers")
        for h in headers:
            if h["chunkCount"] is None:
                raise ValueError(
                    "multipart EXR part missing required chunkCount")
        # ---- part selection: index, name, or first non-deep part
        if part is None:
            sel = next((i for i, h in enumerate(headers)
                        if not (h["type"] or "").startswith("deep")), None)
            if sel is None:
                raise NotImplementedError(
                    "EXR multipart: every part is deep; flatten first")
        elif isinstance(part, str):
            names = [h["name"] for h in headers]
            if part not in names:
                raise ValueError(
                    f"EXR part {part!r} not found (parts: {names})")
            sel = names.index(part)
        else:
            sel = int(part)
            if not 0 <= sel < len(headers):
                raise ValueError(
                    f"EXR part index {sel} out of range ({len(headers)})")
        hsel = headers[sel]
        if (hsel["type"] or "").startswith("deep"):
            raise NotImplementedError(
                f"EXR part {hsel['name']!r} is deep; flatten first")
        # a multipart header must say what its part is; a missing or unknown
        # type is refused, not decoded as scanline
        if hsel["type"] not in ("scanlineimage", "tiledimage"):
            raise ValueError(
                f"EXR part {hsel['name']!r}: type {hsel['type']!r} is missing "
                "or unknown (scanlineimage, tiledimage)")
        # ---- one offset table per part, in header order
        for i, h in enumerate(headers):
            if i == sel:
                table_pos = pos
            pos += 8 * h["chunkCount"]
        channels, comp = hsel["channels"], hsel["comp"]
        dw, tiles = hsel["dw"], hsel["tiles"]
        n_chunks = hsel["chunkCount"]
        part_is_tiled = hsel["type"] == "tiledimage"
        chunk_prefix = 4                     # i32 part number per chunk
        pos = table_pos
        sel_part = sel
    else:
        hdr, pos = _parse_exr_part_header(data, 8)
        if hdr is None:
            raise ValueError("EXR with empty header")
        if part is not None:
            # single-part: honor explicit selection instead of silently
            # returning the only image under a mismatched name/index
            if isinstance(part, str):
                if part != hdr["name"]:
                    raise ValueError(
                        f"EXR part {part!r} not found "
                        f"(single-part file, name {hdr['name']!r})")
            elif int(part) != 0:
                raise ValueError(
                    f"EXR part index {int(part)} out of range "
                    "(single-part file)")
        channels, comp, dw, tiles = (hdr["channels"], hdr["comp"],
                                     hdr["dw"], hdr["tiles"])
        n_chunks = None
        sel_part = 0
    if comp not in _EXR_LINES_PER_BLOCK:
        raise NotImplementedError(
            f"EXR compression {comp} unsupported (read: NONE/RLE/ZIPS/ZIP/"
            f"PIZ/PXR24/B44/B44A/DWAA/DWAB)")
    x0, y0, x1, y1 = dw
    w, h = x1 - x0 + 1, y1 - y0 + 1
    out = np.zeros((h, w, len(channels)), dtype=np.float32)

    def _decode(payload, bw, bny, raw_len):
        """One chunk through the compression codec (shared by scanline
        blocks and tiles — every codec is (channels, width, lines)
        parameterized, and a tile is simply one chunk of tile dims)."""
        if comp and len(payload) < raw_len:
            if comp == 4:
                return _piz_undo(payload, channels, bw, bny)
            if comp == 1:
                return _rle_undo(payload)
            if comp == 5:
                return _pxr24_undo(payload, channels, bw, bny)
            if comp in (6, 7):
                return _b44_undo(payload, channels, bw, bny)
            if comp in (8, 9):
                return _dwa_undo(payload, channels, bw, bny)
            return _zip_undo(payload)
        return payload

    def _scatter(blk, bx0, by0, bw, bny):
        p = 0
        for yy in range(by0, by0 + bny):
            for ci, (cname, pt) in enumerate(channels):
                bpp = 2 if pt == 1 else 4
                dt = np.float16 if pt == 1 else np.float32
                out[yy, bx0:bx0 + bw, ci] = np.frombuffer(
                    blk[p:p + bw * bpp],
                    dtype="<" + dt().dtype.str[1:]).astype(np.float32)
                p += bw * bpp

    if part_is_tiled:                            # tiled (single- or multipart)
        if tiles is None:
            raise ValueError("tiled EXR without a 'tiles' attribute")
        tx, ty, mode = tiles
        if n_chunks is None:
            n_chunks = _exr_tile_chunk_count(w, h, tx, ty, mode)
        offsets = _struct.unpack_from("<%dQ" % n_chunks, data, pos)
        for off in offsets:
            if chunk_prefix:
                (pn,) = _struct.unpack_from("<i", data, off)
                if pn != sel_part:
                    raise ValueError(
                        f"EXR chunk part number {pn} != selected {sel_part}")
                off += chunk_prefix
            dx, dy, lx, ly, n = _struct.unpack_from("<iiiii", data, off)
            if lx != 0 or ly != 0:
                continue                         # mip/rip levels: level 0 only
            bw = min(tx, w - dx * tx)
            bny = min(ty, h - dy * ty)
            raw_len = bny * sum(bw * (2 if pt == 1 else 4)
                                for _, pt in channels)
            blk = _decode(data[off + 20:off + 20 + n], bw, bny, raw_len)
            _scatter(blk, dx * tx, dy * ty, bw, bny)
    else:                                        # scanline
        lpb = _EXR_LINES_PER_BLOCK[comp]
        if n_chunks is None:
            n_chunks = (h + lpb - 1) // lpb
        offsets = _struct.unpack_from("<%dQ" % n_chunks, data, pos)
        line_bytes = sum(w * (2 if pt == 1 else 4) for _, pt in channels)
        for off in offsets:
            if chunk_prefix:
                (pn,) = _struct.unpack_from("<i", data, off)
                if pn != sel_part:
                    raise ValueError(
                        f"EXR chunk part number {pn} != selected {sel_part}")
                off += chunk_prefix
            y, n = _struct.unpack_from("<ii", data, off)
            ny = min(lpb, y1 - y + 1)
            blk = _decode(data[off + 8:off + 8 + n], w, ny, ny * line_bytes)
            _scatter(blk, 0, y - y0, w, ny)
    names = [c[0] for c in channels]
    if names == ["B", "G", "R"]:
        out = out[:, :, ::-1]
    return out


def _exr_tile_chunk_count(w: int, h: int, tx: int, ty: int,
                          mode: int) -> int:
    """Number of entries in a tiled single-part offset table: level mode
    (low nibble: 0 ONE_LEVEL, 1 MIPMAP, 2 RIPMAP) and rounding mode (high
    nibble: 0 down, 1 up) determine the level dimensions; each level
    contributes ceil(lw/tx) * ceil(lh/ty) tiles."""
    level_mode = mode & 0xF
    round_up = (mode >> 4) & 0xF == 1

    def lev_size(s, lev):
        if lev == 0:
            return s
        d = 1 << lev
        return max(1, (s + d - 1) // d if round_up else s // d)

    def levels_for(s):
        # number of levels until the dimension reaches 1
        n = 1
        while lev_size(s, n) >= 1 and lev_size(s, n - 1) > 1:
            n += 1
        return n

    def tiles_at(lw, lh):
        return ((lw + tx - 1) // tx) * ((lh + ty - 1) // ty)

    if level_mode == 0:
        return tiles_at(w, h)
    if level_mode == 1:
        n = levels_for(max(w, h))
        return sum(tiles_at(lev_size(w, lv), lev_size(h, lv))
                   for lv in range(n))
    if level_mode == 2:
        nx, ny = levels_for(w), levels_for(h)
        return sum(tiles_at(lev_size(w, lx), lev_size(h, ly))
                   for lx in range(nx) for ly in range(ny))
    raise ValueError(f"EXR: unknown tile level mode {level_mode}")


# ----------------------------------------------------------------------------- LDR

def tonemap_gamma(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """HDR -> 8-bit with gamma 2.2, mirrors reference save_ldr_image (structure.rs:160-168)."""
    img = np.clip(np.asarray(img, dtype=np.float32), 0.0, None)
    return (np.clip(img ** (1.0 / gamma), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG color type by channel count: gray, RGB, RGBA
_PNG_COLOR = {1: 0, 3: 2, 4: 6}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (_struct.pack(">I", len(data)) + tag + data
            + _struct.pack(">I", _zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit PNG of a uint8 [h, w] (gray), [h, w, 3] (RGB) or [h, w, 4]
    (RGBA) array: IHDR, one IDAT of rows under filter 0 (none), IEND,
    with zlib's deflate at `level` and CRCs from zlib.crc32. No PIL."""
    px = np.asarray(pixels)
    if px.dtype != np.uint8:
        raise ValueError(f"PNG: uint8 pixels expected, got {px.dtype}")
    if px.ndim == 2:
        px = px[..., None]
    if px.ndim != 3 or px.shape[2] not in _PNG_COLOR:
        raise ValueError(f"PNG: [h, w], [h, w, 3] or [h, w, 4] expected, "
                         f"got {px.shape}")
    h, w, c = px.shape
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 0
    rows[:, 1:] = px.reshape(h, w * c)
    ihdr = _struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR[c], 0, 0, 0)
    return (_PNG_SIG + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", _zlib.compress(rows.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the five PNG filters row by row ([h, 1 + stride] uint8)."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h + 1, stride + bpp), np.int32)   # a zero row and pad
    for y in range(h):
        ft, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        up = out[y, bpp:]
        if ft == 0:
            out[y + 1, bpp:] = line
        elif ft == 2:
            out[y + 1, bpp:] = (line + up) & 0xFF
        elif ft in (1, 3, 4):
            cur = out[y + 1]
            prev = out[y]
            for x in range(stride):
                a, b, c = cur[x], prev[x + bpp], prev[x]
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) >> 1
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x + bpp] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {ft}")
    return out[1:, bpp:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The uint8 pixels of an 8-bit, non-interlaced gray, RGB or RGBA PNG
    ([h, w] or [h, w, c]): the files encode_png writes, and any such PNG
    under any filter. Other PNGs raise ValueError (read them with PIL)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("PNG: bad signature")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, = _struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = _struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != _zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG: bad CRC in {tag!r}")
        if tag == b"IHDR":
            hdr = _struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG: no IHDR")
    w, h, depth, color, _, _, interlace = hdr
    chans = {v: k for k, v in _PNG_COLOR.items()}.get(color)
    if depth != 8 or chans is None or interlace:
        raise ValueError(f"PNG: 8-bit non-interlaced gray/RGB/RGBA only "
                         f"(depth {depth}, color type {color}, interlace "
                         f"{interlace})")
    raw = np.frombuffer(_zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw.reshape(h, 1 + w * chans), chans).reshape(h, w, chans)
    return px[..., 0] if chans == 1 else px


def write_png(path, pixels: np.ndarray, level: int = 6) -> None:
    Path(path).write_bytes(encode_png(pixels, level))


def _pil_image(what: str):
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f"{what} needs PIL (Pillow), which is not "
                          "installed; PNG is written and read without "
                          "it") from None
    return Image


def write_ldr(path, img: np.ndarray, gamma: float = 2.2) -> None:
    """Gamma-tonemapped 8-bit image: PNG by the encoder above; JPG/BMP
    through PIL."""
    px = tonemap_gamma(img, gamma)
    if Path(path).suffix.lower() == ".png":
        write_png(path, px)
    else:
        _pil_image(f"writing {Path(path).suffix} files").fromarray(px).save(
            path)


def read_ldr(path) -> np.ndarray:
    """Read PNG/JPG to linear float32 (inverse gamma 2.2), [h, w, 3]:
    through PIL where it is installed, else a PNG by decode_png."""
    try:
        from PIL import Image
    except ImportError:
        if Path(path).suffix.lower() != ".png":
            _pil_image(f"reading {Path(path).suffix} files")
        px = decode_png(Path(path).read_bytes())
        px = np.repeat(px[..., None], 3, -1) if px.ndim == 2 else px[..., :3]
        arr = px.astype(np.float32) / 255.0
    else:
        arr = np.asarray(Image.open(path).convert("RGB"),
                         dtype=np.float32) / 255.0
    return arr ** 2.2


def save(path, img: np.ndarray) -> None:
    """Save by extension: .pfm/.exr/.png/.jpg (reference Bitmap::save)."""
    ext = Path(path).suffix.lower()
    if ext == ".pfm":
        write_pfm(path, img)
    elif ext == ".exr":
        write_exr(path, img)
    elif ext in (".png", ".jpg", ".jpeg", ".bmp"):
        write_ldr(path, img)
    else:
        raise ValueError(f"unsupported image extension {ext}")


def load(path) -> np.ndarray:
    ext = Path(path).suffix.lower()
    if ext == ".pfm":
        return read_pfm(path)
    if ext == ".exr":
        return read_exr(path)
    return read_ldr(path)

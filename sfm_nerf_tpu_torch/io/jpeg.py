"""A baseline JPEG writer in numpy: ``write_jpeg(path, rgb_u8, quality=95)``.

The port's stand-in for ``cv2.imwrite`` on a ``.jpg`` name (the card's
machine has no cv2), with cv2's defaults for that call: quality 95, 4:2:0
chroma subsampling, the quantisation tables of ITU-T T.81 Annex K scaled
by the IJG quality formula, the standard Huffman tables of Annex K.3, a
JFIF header.  One baseline (SOF0) frame, 8-bit, three components.

Vectorised throughout: the colour conversion and the 8 x 8 DCT are matrix
products over all blocks, the zig-zag, run-length and Huffman coding are
array operations over all coefficients, and the bits are packed with
``np.packbits``; no Python loop runs per block or per coefficient.
"""

from __future__ import annotations

import struct

import numpy as np

# ITU-T T.81 Annex K.1: luminance and chrominance quantisation, row-major
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)

# zig-zag scan: the row-major index of the k-th coefficient
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.3: (code lengths 1..16 counts, symbols) of the four tables
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282"
    "090a161718191a25262728292a3435363738393a434445464748494a535455565758595a63"
    "6465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6"
    "a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6"
    "e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a"
    "162434e125f11718191a262728292a35363738393a434445464748494a535455565758595a"
    "636465666768696a737475767778797a82838485868788898a92939495969798999aa2a3a4"
    "a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5"
    "e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    c[0] /= np.sqrt(2)
    return c


_DCT = _dct_matrix()


def quant_tables(quality: int):
    """The two tables (row-major) at ``quality``, as libjpeg scales them."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return [np.clip((t * scale + 50) // 100, 1, 255) for t in (_Q_LUMA, _Q_CHROMA)]


def _huffman_codes(spec):
    """symbol -> (code, length) arrays of 256 from a (counts, symbols) spec."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _size(v: np.ndarray) -> np.ndarray:
    """The JPEG magnitude category: bits of |v| (0 for 0)."""
    a = np.abs(v)
    return np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1, 0)


def _value_bits(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, v + (1 << s) - 1)


def encode(rgb: np.ndarray, quality: int = 95) -> bytes:
    """The JPEG file of an (H, W, 3) uint8 RGB image, as bytes."""
    rgb = np.asarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"write_jpeg wants (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"JPEG cannot hold {w}x{h}")
    x = rgb.astype(np.float64)
    ycc = x @ np.array([[0.299, -0.168735892, 0.5],
                        [0.587, -0.331264108, -0.418687589],
                        [0.114, 0.5, -0.081312411]])
    ycc[..., 1:] += 128
    # pad to whole 16 x 16 MCUs by repeating the last row and column
    H, W = -(-h // 16) * 16, -(-w // 16) * 16
    ycc = np.pad(ycc, ((0, H - h), (0, W - w), (0, 0)), mode="edge")
    y = ycc[..., 0]
    # 4:2:0: each chroma sample the mean of a 2 x 2 square
    cb, cr = (ycc[..., c].reshape(H // 2, 2, W // 2, 2).mean((1, 3)) for c in (1, 2))
    qy, qc = quant_tables(quality)
    mh, mw = H // 16, W // 16

    def coeffs(plane, q):
        b = _blocks(plane - 128.0)
        f = _DCT @ b @ _DCT.T
        return np.round(f.reshape(*b.shape[:2], 64) / q).astype(np.int64)[..., _ZIGZAG]

    cy = coeffs(y, qy)                             # (2mh, 2mw, 64)
    # MCU order: Y00 Y01 Y10 Y11 Cb Cr
    cy = cy.reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mh * mw, 4, 64)
    blocks = np.concatenate([cy, coeffs(cb, qc).reshape(mh * mw, 1, 64),
                             coeffs(cr, qc).reshape(mh * mw, 1, 64)], 1).reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mh * mw)
    # DC: the difference from the previous block of the same component
    dc = blocks[:, 0].copy()
    for c in range(3):
        sel = comp == c
        dc[sel] = np.diff(blocks[sel, 0], prepend=0)
    chroma = comp > 0
    dcs = _size(dc)
    tables = [_huffman_codes(t) for t in (_DC_LUMA, _DC_CHROMA, _AC_LUMA, _AC_CHROMA)]
    n_blocks = len(blocks)
    # AC: (run, size) symbols of every nonzero coefficient, ZRLs, EOBs
    ac = blocks[:, 1:]
    bi, pos = np.nonzero(ac)
    vals = ac[bi, pos]
    prev = np.full(len(bi), -1)
    same = np.r_[False, bi[1:] == bi[:-1]]
    prev[same] = pos[:-1][same[1:]]
    run = pos - prev - 1
    n_zrl = run // 16
    run = run % 16
    s = _size(vals)
    sym = run * 16 + s
    last = np.full(n_blocks, -1)
    last[bi] = pos                                 # nonzero positions ascend per block
    eob = last < 62
    # one row per emitted symbol: (block, rank within the block, code, length)
    rows_blk = [np.arange(n_blocks)]
    rows_rank = [np.zeros(n_blocks, np.int64)]
    dcc, dcl = np.where(chroma, tables[1][0][dcs], tables[0][0][dcs]), \
        np.where(chroma, tables[1][1][dcs], tables[0][1][dcs])
    rows_code = [(dcc << dcs) | _value_bits(dc, dcs)]
    rows_len = [dcl + dcs]
    ch = chroma[bi]
    acode = np.where(ch, tables[3][0][sym], tables[2][0][sym])
    alen = np.where(ch, tables[3][1][sym], tables[2][1][sym])
    # a ZRL (0xF0) per 16 zeros before the coefficient, then the coefficient
    zrl_code = np.where(ch, tables[3][0][0xF0], tables[2][0][0xF0])
    zrl_len = np.where(ch, tables[3][1][0xF0], tables[2][1][0xF0])
    rank = 1 + pos * 4                              # room for up to 3 ZRLs before
    for z in range(3):
        has = n_zrl > z
        rows_blk.append(bi[has])
        rows_rank.append(rank[has] - 3 + z)
        rows_code.append(zrl_code[has])
        rows_len.append(zrl_len[has])
    rows_blk.append(bi)
    rows_rank.append(rank)
    rows_code.append((acode << s) | _value_bits(vals, s))
    rows_len.append(alen + s)
    eb = np.flatnonzero(eob)
    rows_blk.append(eb)
    rows_rank.append(np.full(len(eb), 1 + 64 * 4))
    rows_code.append(np.where(chroma[eb], tables[3][0][0], tables[2][0][0]))
    rows_len.append(np.where(chroma[eb], tables[3][1][0], tables[2][1][0]))
    blk, rk = np.concatenate(rows_blk), np.concatenate(rows_rank)
    order = np.lexsort((rk, blk))
    code = np.concatenate(rows_code)[order]
    length = np.concatenate(rows_len)[order]
    data = _pack(code, length)
    return _headers(w, h, qy, qc) + data + b"\xff\xd9"


def _pack(code: np.ndarray, length: np.ndarray) -> bytes:
    """Concatenate the codes MSB first, pad with 1 bits, stuff 0x00 after
    every 0xFF."""
    maxlen = int(length.max()) if len(length) else 1
    shift = length[:, None] - 1 - np.arange(maxlen)[None, :]
    valid = shift >= 0
    stream = ((code[:, None] >> np.maximum(shift, 0)) & 1)[valid].astype(np.uint8)
    pad = (-len(stream)) % 8
    stream = np.concatenate([stream, np.ones(pad, np.uint8)])
    out = np.packbits(stream)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _headers(w, h, qy, qc) -> bytes:
    out = b"\xff\xd8"
    out += _segment(0xFFE0, b"JFIF\x00" + bytes([1, 1, 0]) + struct.pack(">HH", 1, 1)
                    + b"\x00\x00")
    out += _segment(0xFFDB, bytes([0]) + bytes(qy[_ZIGZAG].astype(np.uint8))
                    + bytes([1]) + bytes(qc[_ZIGZAG].astype(np.uint8)))
    out += _segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3)
                    + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    dht = b""
    for cls_id, (counts, symbols) in ((0x00, _DC_LUMA), (0x10, _AC_LUMA),
                                      (0x01, _DC_CHROMA), (0x11, _AC_CHROMA)):
        dht += bytes([cls_id]) + bytes(counts) + bytes(symbols)
    out += _segment(0xFFC4, dht)
    out += _segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out


def write_jpeg(path: str, rgb_u8: np.ndarray, quality: int = 95) -> str:
    """Write ``rgb_u8`` (H, W, 3) uint8 RGB to ``path`` as a baseline JPEG."""
    data = encode(rgb_u8, quality)
    with open(path, "wb") as f:
        f.write(data)
    return path


def sof0_size(path: str):
    """(width, height) from a JPEG's SOF0 header; raises if it has none."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG")
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise ValueError(f"{path}: bad marker at {i}")
        marker = data[i + 1]
        seg_len = struct.unpack(">H", data[i + 2:i + 4])[0]
        if marker == 0xC0:
            h, w = struct.unpack(">HH", data[i + 5:i + 9])
            return w, h
        i += 2 + seg_len
    raise ValueError(f"{path}: no SOF0 header")

"""PNG reader and writer on zlib, struct and numpy alone.

The machine that serves the port has no imageio, cv2, PIL or matplotlib, so
the port reads its datasets and writes its artifacts through this module.

Reader: 8-bit grey, grey+alpha, RGB and RGBA, non-interlaced, all five row
filters.  The Average and Paeth filters make every byte depend on its left,
upper and upper-left neighbours, so the rows are reconstructed along
anti-diagonals: every pixel of one diagonal depends only on the two before
it, which turns H*W scalar steps into H+W-1 vector steps.

Writer: 8-bit grey (H, W), RGB (H, W, 3) or RGBA (H, W, 4), filter 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter(ftype: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the per-row filters.  ``filt`` (H, W, C) int32 filtered bytes,
    ``ftype`` (H,) filter type per row.  Returns (H, W, C) uint8."""
    h, w, c = filt.shape
    if np.all(ftype == 0):
        return filt.astype(np.uint8)
    # one zero row above and one zero column to the left: a, b, c lookups
    # need no edge cases
    out = np.zeros((h + 1, w + 1, c), np.int32)
    ft = ftype.astype(np.int32)
    for t in range(h + w - 1):
        ys = np.arange(max(0, t - w + 1), min(h - 1, t) + 1)
        xs = t - ys
        a = out[ys + 1, xs]
        b = out[ys, xs + 1]
        cc = out[ys, xs]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, cc))
        f = ft[ys][:, None]
        pred = np.select(
            [f == 1, f == 2, f == 3, f == 4],
            [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit PNG file to uint8: (H, W) for grey, else (H, W, C)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "PNG") -> np.ndarray:
    """``read_png`` of the file's bytes (``path`` names them in errors)."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); 8-bit grey/RGB/RGBA, "
            "non-interlaced only")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(height, 1 + width * c)
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: bad row filter type {ftype.max()}")
    img = _unfilter(ftype, raw[:, 1:].reshape(height, width, c).astype(np.int32))
    return img[..., 0] if c == 1 else img


def png_size(path: str):
    """(width, height) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def write_png(path: str, img: np.ndarray) -> None:
    """Encode uint8 (H, W), (H, W, 3) or (H, W, 4) as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def encode_png(img: np.ndarray) -> bytes:
    """``write_png``'s file as bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png wants uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(c)
    if ctype is None:
        raise ValueError(f"encode_png: {c} channels not supported")
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(img).reshape(h, w * c)],
        axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return b"".join((_SIGNATURE,
                     chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)),
                     chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
                     chunk(b"IEND", b"")))

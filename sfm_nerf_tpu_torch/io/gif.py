"""GIF89a writer and reader on struct and numpy alone.

The port imports no imageio, cv2 or PIL (see io/png.py), so the
turntable's frames are stitched here.

Writer: every frame (H, W, 3) uint8 of one size is mapped to one global
palette of at most 256 colours, made by median cut over the frames'
colours (exact when they hold 256 or fewer); each pixel takes the palette
entry nearest to it.  A NETSCAPE2.0 block loops the animation, and each
frame carries a delay of 100 / fps centiseconds.  The codes are GIF's
variable-width LZW (8-bit roots, 9 to 12 bits, a clear code when the table
is full), built by a Python loop over the pixels; quantization and bit
packing are numpy.

Reader: what the writer writes and other encoders' plain GIFs (global or
local palettes, any LZW minimum code size, no interlace), for tests and
the smoke run: ``read_gif(path) -> (frames (N, H, W, 3) uint8, delays_cs)``.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

_MAX_CODE = 4096


def _median_cut(colors: np.ndarray, weights: np.ndarray, n: int) -> np.ndarray:
    """At most ``n`` palette colours (uint8) for the unique ``colors``
    (M, 3) of counts ``weights``: split the box of the largest
    population-weighted channel range at the weighted median of that
    channel until there are ``n`` boxes; each box gives its weighted mean."""
    boxes = [(colors.astype(np.int64), weights.astype(np.int64))]
    while len(boxes) < n:
        spans = [(c.max(0) - c.min(0)) if len(c) > 1 else np.zeros(3, np.int64)
                 for c, _ in boxes]
        scores = [s.max() * w.sum() for s, (_, w) in zip(spans, boxes)]
        i = int(np.argmax(scores))
        if scores[i] == 0:
            break
        c, w = boxes.pop(i)
        ch = int(np.argmax(spans[i]))
        order = np.argsort(c[:, ch], kind="stable")
        c, w = c[order], w[order]
        cut = int(np.searchsorted(np.cumsum(w), w.sum() / 2.0))
        cut = min(max(cut, 1), len(c) - 1)
        boxes += [(c[:cut], w[:cut]), (c[cut:], w[cut:])]
    return np.stack([np.round((c * w[:, None]).sum(0) / w.sum()) for c, w in boxes]
                    ).astype(np.uint8)


def _nearest(colors: np.ndarray, palette: np.ndarray, chunk: int = 8192) -> np.ndarray:
    """Index of the palette entry nearest (squared RGB distance, the first
    on ties) to each of ``colors`` (M, 3)."""
    pal = palette.astype(np.int32)
    out = np.empty(len(colors), np.int64)
    for i in range(0, len(colors), chunk):
        d = colors[i:i + chunk, None, :].astype(np.int32) - pal[None]
        out[i:i + chunk] = np.argmin((d * d).sum(-1), axis=1)
    return out


def quantize(frames: Sequence[np.ndarray], max_colors: int = 256,
             ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(palette (P, 3) uint8, per frame (H, W) palette indices): the
    writer's quantization.  ``palette[indices]`` is what a reader of the
    file decodes."""
    flat = np.concatenate([np.asarray(f, np.uint8).reshape(-1, 3) for f in frames])
    packed = (flat[:, 0].astype(np.int64) << 16) | (flat[:, 1].astype(np.int64) << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(packed, return_inverse=True, return_counts=True)
    colors = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], -1).astype(np.uint8)
    if len(colors) <= max_colors:
        palette, index_of = colors, np.arange(len(colors))
    else:
        palette = _median_cut(colors, counts, max_colors)
        index_of = _nearest(colors, palette)
    idx = index_of[inverse]
    out, off = [], 0
    for f in frames:
        h, w = f.shape[:2]
        out.append(idx[off:off + h * w].reshape(h, w))
        off += h * w
    return palette, out


def _lzw_codes(pixels: np.ndarray, min_size: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """GIF LZW of ``pixels`` (1-D palette indices below 2**min_size): the
    codes and the width each is written with.  A reader's table trails the
    writer's by one entry, so a code goes out at the width of the reader's
    next free index (``next - 1``)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    codes, sizes = [clear], [min_size + 1]
    table: dict = {}
    nxt = eoi + 1
    seq = pixels.tolist()
    w = seq[0]
    for k in seq[1:]:
        key = (w << 8) | k
        got = table.get(key)
        if got is not None:
            w = got
            continue
        codes.append(w)
        sizes.append(min(12, max(min_size + 1, (nxt - 1).bit_length())))
        if nxt < _MAX_CODE:
            table[key] = nxt
            nxt += 1
        else:
            codes.append(clear)
            sizes.append(12)
            table.clear()
            nxt = eoi + 1
        w = k
    for code in (w, eoi):
        codes.append(code)
        sizes.append(min(12, max(min_size + 1, (nxt - 1).bit_length())))
        nxt = min(nxt + 1, _MAX_CODE)
    return np.asarray(codes, np.int64), np.asarray(sizes, np.int64)


def _pack_bits(codes: np.ndarray, sizes: np.ndarray) -> bytes:
    """The codes least significant bit first, each ``sizes`` bits wide."""
    start = np.cumsum(sizes) - sizes
    bits = np.zeros(int(sizes.sum()), np.uint8)
    for j in range(int(sizes.max())):
        on = sizes > j
        bits[start[on] + j] = (codes[on] >> j) & 1
    return np.packbits(bits, bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        piece = data[i:i + 255]
        out.append(len(piece))
        out += piece
    out.append(0)
    return bytes(out)


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float = 2.0) -> np.ndarray:
    """Write ``frames`` ((H, W, 3) uint8, one size) as a looping GIF89a at
    ``fps``.  Returns the frames as the file holds them (palette colours),
    (N, H, W, 3) uint8."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    if not frames or any(f.ndim != 3 or f.shape[2] != 3 or f.shape != frames[0].shape
                         for f in frames):
        raise ValueError("write_gif takes one or more (H, W, 3) uint8 frames of one size")
    h, w = frames[0].shape[:2]
    palette, indices = quantize(frames)
    table = np.zeros((256, 3), np.uint8)
    table[:len(palette)] = palette
    delay = int(round(100.0 / fps))
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)     # global table of 256, 8-bit colour
    out += table.tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"
    for idx in indices:
        out += b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        out.append(8)
        out += _sub_blocks(_pack_bits(*_lzw_codes(idx.reshape(-1))))
    out.append(0x3B)
    with open(path, "wb") as f:
        f.write(bytes(out))
    return np.stack([palette[i] for i in indices])


def _lzw_decode(data: bytes, min_size: int, n_pixels: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    weights = 1 << np.arange(12)
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    roots = [bytes([i]) for i in range(1 << min_size)] + [b"", b""]
    table = list(roots)
    size, pos, prev = min_size + 1, 0, None
    out = bytearray()
    while pos + size <= len(bits):
        code = int(bits[pos:pos + size] @ weights[:size])
        pos += size
        if code == clear:
            table, size, prev = list(roots), min_size + 1, None
            continue
        if code == eoi:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None and len(table) < _MAX_CODE:
                table.append(prev + entry[:1])
        elif prev is not None and code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"corrupt LZW stream: code {code} with {len(table)} entries")
        out += entry
        prev = entry
        if len(table) == (1 << size) and size < 12:
            size += 1
        if len(out) >= n_pixels:
            break
    if len(out) < n_pixels:
        raise ValueError(f"LZW stream holds {len(out)} of {n_pixels} pixels")
    return np.frombuffer(bytes(out[:n_pixels]), np.uint8)


def read_gif(path: str) -> Tuple[np.ndarray, List[int]]:
    """(frames (N, H, W, 3) uint8, each frame's delay in centiseconds).
    Each frame is decoded onto the full canvas as given (no disposal or
    transparency compositing, which the writer does not use)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF")
    width, height, flags, _, _ = struct.unpack("<HHBBB", data[6:13])
    pos = 13
    global_table = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        global_table = np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    frames, delays, delay = [], [], 0

    def blocks(p):
        chunks = []
        while data[p]:
            chunks.append(data[p + 1:p + 1 + data[p]])
            p += 1 + data[p]
        return b"".join(chunks), p + 1

    while pos < len(data) and data[pos] != 0x3B:
        kind = data[pos]
        if kind == 0x21:
            label = data[pos + 1]
            body, pos = blocks(pos + 2)
            if label == 0xF9:
                delay = struct.unpack("<H", body[1:3])[0]
        elif kind == 0x2C:
            x, y, w, h, iflags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
            pos += 10
            table = global_table
            if iflags & 0x80:
                n = 2 << (iflags & 7)
                table = np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(n, 3)
                pos += 3 * n
            if iflags & 0x40:
                raise ValueError(f"{path}: interlaced frames are not read")
            min_size = data[pos]
            body, pos = blocks(pos + 1)
            canvas = np.zeros((height, width, 3), np.uint8)
            canvas[y:y + h, x:x + w] = table[_lzw_decode(body, min_size, w * h)].reshape(h, w, 3)
            frames.append(canvas)
            delays.append(delay)
        else:
            raise ValueError(f"{path}: unexpected block 0x{kind:02x} at byte {pos}")
    return np.stack(frames), delays

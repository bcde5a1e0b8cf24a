#!/usr/bin/env python3
"""Write ``sfm_nerf_tpu_torch/io/_glyph_table.py``: the bitmap font the
port's figures draw their text with.

    python3 tools/make_glyph_table.py

Needs matplotlib (for its FreeType wrapper and its copy of DejaVu Sans, the
font matplotlib's figures use); the port itself never imports it.  For each
printable ASCII character and the minus sign U+2212 (matplotlib's tick
labels use it), it stores:

- the glyph rendered unhinted, antialiased, at ``PPEM`` = 64 pixels per em,
  as 8-bit coverage, with the pen-relative position of its top-left pixel;
- its linear advance and its ink's left and right edge, in em;
- for each (size in points, dpi) the figures lay text out at, the glyph's
  hinted ink top and bottom in pixels, as matplotlib's Agg backend measures
  them (force_autohint, hinting factor 8): text heights and descents then
  come out as matplotlib's do.

The table is committed; run this again only to change it.
"""

import base64
import os
import zlib

import numpy as np
from matplotlib import font_manager
from matplotlib.ft2font import FT2Font, LoadFlags

PPEM = 64
CHARS = "".join(chr(c) for c in range(32, 127)) + "−"
# (points, dpi): 10 pt ticks / labels / legend, 12 pt titles, at the figure
# dpi every writer lays out at (100) and the dpis they save at (150, 300)
SIZES = [(10, 100), (12, 100), (10, 150), (12, 150), (10, 300), (12, 300)]
OUT = os.path.join(os.path.dirname(__file__), "..", "sfm_nerf_tpu_torch", "io",
                   "_glyph_table.py")


def main():
    path = font_manager.findfont("DejaVu Sans")
    font = FT2Font(path, hinting_factor=1)
    font.set_size(PPEM, 72)
    advances, inks, origins, shapes, blobs = [], [], [], [], []
    for ch in CHARS:
        glyph = font.load_char(ord(ch), flags=LoadFlags.NO_HINTING)
        advances.append(glyph.linearHoriAdvance / 65536 / PPEM)
        font.set_text(ch, 0.0, flags=LoadFlags.NO_HINTING)
        font.draw_glyphs_to_bitmap(antialiased=True)
        img = np.asarray(font.get_image(), np.uint8)
        xmin, _, xmax, ymax = glyph.bbox
        inks.append((round(xmin / 64 / PPEM, 6), round(xmax / 64 / PPEM, 6)))
        # ft2font draws the string's bbox origin at column 0 and the bbox
        # top one row below the image top (draw_glyphs_to_bitmap)
        origins.append((round(xmin / 64, 3), round(ymax / 64 + 1, 3)))
        shapes.append(img.shape)
        blobs.append(img.tobytes())
    hinted = {}
    for pt, dpi in SIZES:
        f = FT2Font(path, hinting_factor=8)
        f.set_size(pt, dpi)
        tops, bottoms = [], []
        for ch in CHARS:
            g = f.load_char(ord(ch), flags=LoadFlags.FORCE_AUTOHINT)
            tops.append(g.bbox[3] / 64)
            bottoms.append(g.bbox[1] / 64)
        hinted[(pt, dpi)] = (tops, bottoms)
    data = base64.b64encode(zlib.compress(b"".join(blobs), 9)).decode()
    lines = [
        '"""DejaVu Sans as bitmaps for io/figure.py: written by',
        "tools/make_glyph_table.py (see there); do not edit.  The font's",
        "licence (Bitstream Vera / DejaVu) permits redistributing derived",
        "glyphs.\"\"\"",
        "",
        f"PPEM = {PPEM}",
        f"CHARS = {CHARS!r}",
        f"ADVANCES = {[round(a, 6) for a in advances]!r}",
        f"INK_X = {inks!r}",
        f"ORIGINS = {origins!r}",
        f"SHAPES = {[tuple(int(v) for v in s) for s in shapes]!r}",
        f"HINTED = {{{', '.join(f'{k!r}: ({v[0]!r}, {v[1]!r})' for k, v in hinted.items())}}}",
        "BITMAPS = (",
    ]
    for i in range(0, len(data), 76):
        lines.append(f"    {data[i:i + 76]!r}")
    lines.append(")")
    with open(OUT, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"wrote {OUT}: {len(CHARS)} glyphs, {len(data)} base64 bytes")


if __name__ == "__main__":
    main()

"""Figures drawn with numpy alone: the port's stand-in for the matplotlib
calls of the JAX package's figure writers (io/artifacts.py, test mode's
``figure_{i}.png``, Wrapper's ``--plot_rays``).

The card's machine has neither matplotlib nor cv2, so this module lays out
and rasterises the few kinds of figure those writers make, with
matplotlib's defaults as its geometry (``matplotlibrc`` of matplotlib 3.10):

- a figure of ``figsize`` inches, laid out at 100 dpi and drawn at the dpi
  it is saved at (``Figure.savefig``), as matplotlib does;
- 2-D axes in the subplot box (left .125, right .9, bottom .11, top .88,
  wspace .2), data limits with 5 % margins, ``axis_equal`` (aspect equal by
  ``datalim``), ``MaxNLocator`` ticks with ``ScalarFormatter`` labels, grid,
  spines, title, axis labels, ``imshow`` (aspect equal by ``box``, Hanning
  resampling) and ``axis_off``;
- 3-D axes as mplot3d draws them: elevation 30, azimuth -60, roll 0,
  perspective with focal length 1, box aspect (4, 4, 3), camera distance
  10; panes, grid, axis lines, ticks and labels, depth-shaded scatter
  (``get_proj`` and ``proj3d`` of mplot3d, as arithmetic);
- ``legend()`` at matplotlib's "best" location, ``tight_layout``;
- ``tab10`` for ``C{i}`` and the line colour cycle, and the named colours
  the writers use.

Text comes from a bitmap table of DejaVu Sans (io/_glyph_table.py, written
by tools/make_glyph_table.py), resampled to the size drawn.  Everything is
antialiased by coverage: disks, squares and triangles by their signed
distance, segments by their distance to the pixel centre, fills by the
half-planes of their edges; overlapping pieces are composited in drawing
order (``Canvas.composite``).  The figures are close to matplotlib's, not
equal to them: the tests hold each against matplotlib's on the same input.
"""

from __future__ import annotations

import base64
import math
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sfm_nerf_tpu_torch.io import _glyph_table as _gt
from sfm_nerf_tpu_torch.io.png import write_png

LAYOUT_DPI = 100            # matplotlib's figure.dpi: layout happens at it
FONT_PT = 10.0              # font.size: ticks, labels, legend
TITLE_PT = 12.0             # axes.titlesize 'large'
SUBPLOT = dict(left=0.125, right=0.9, bottom=0.11, top=0.88, wspace=0.2, hspace=0.2)

TAB10 = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
         "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]
NAMED = {"blue": "#0000ff", "green": "#008000", "red": "#ff0000",
         "orange": "#ffa500", "purple": "#800080", "black": "#000000",
         "white": "#ffffff"}
GRID_RGB = "#b0b0b0"


def to_rgb(c) -> np.ndarray:
    """A matplotlib colour spec ('C3', '#rrggbb', a named colour, a grey
    level string '0.8', an RGB tuple) as float RGB in [0, 1]."""
    if isinstance(c, str):
        if c[:1] == "C" and c[1:].isdigit():
            c = TAB10[int(c[1:]) % 10]
        c = NAMED.get(c, c)
        if c.startswith("#"):
            return np.array([int(c[i:i + 2], 16) for i in (1, 3, 5)], np.float64) / 255
        return np.full(3, float(c))
    return np.asarray(c, np.float64)[:3]


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

_INDEX = {ch: i for i, ch in enumerate(_gt.CHARS)}
_ADV = np.asarray(_gt.ADVANCES)
_INK_X = np.asarray(_gt.INK_X)
_GLYPHS: List[np.ndarray] = []


def _glyph_bitmaps() -> List[np.ndarray]:
    if not _GLYPHS:
        raw = zlib.decompress(base64.b64decode("".join(_gt.BITMAPS)))
        off = 0
        for h, w in _gt.SHAPES:
            _GLYPHS.append(np.frombuffer(raw, np.uint8, h * w, off).reshape(h, w)
                           .astype(np.float32) / 255)
            off += h * w
    return _GLYPHS


def _codes(s: str) -> np.ndarray:
    return np.array([_INDEX.get(ch, _INDEX["?"]) for ch in s], int)


def text_extent(s: str, pt: float, dpi: float) -> Tuple[float, float, float]:
    """(width, height, descent) in pixels of ``s``'s ink, as matplotlib's
    Agg renderer measures it: heights from the hinted glyph boxes at that
    size where the table has them, widths from the linear advances."""
    idx = _codes(s)
    if not len(idx):
        return 0.0, 0.0, 0.0
    ppem = pt * dpi / 72
    pen = np.concatenate([[0.0], np.cumsum(_ADV[idx])[:-1]]) * ppem
    left = pen + _INK_X[idx, 0] * ppem
    right = pen + _INK_X[idx, 1] * ppem
    hinted = _gt.HINTED.get((pt, dpi))          # (10, 100) == (10.0, 100.0) as keys
    if hinted is not None:
        tops = np.asarray(hinted[0])[idx]
        bottoms = np.asarray(hinted[1])[idx]
    else:
        scale = ppem / _gt.PPEM
        org = np.asarray(_gt.ORIGINS)[idx]
        hs = np.asarray([_gt.SHAPES[i][0] for i in idx])
        tops = np.ceil((org[:, 1] - 1) * scale)
        bottoms = -np.ceil(-(org[:, 1] - 1 - (hs - 2)) * scale)
    ymax, ymin = max(tops.max(), 0.0), min(bottoms.min(), 0.0)
    return float(right.max() - left.min()), float(ymax - ymin), float(-ymin)


def text_layout(s: str, pt: float, dpi: float) -> Tuple[float, float, float]:
    """(width, height, descent) of the text's layout box: the ink box, at
    least as tall and deep as "lp"'s (matplotlib's Text._get_layout)."""
    w, h, d = text_extent(s, pt, dpi)
    _, lp_h, lp_d = text_extent("lp", pt, dpi)
    return w, max(h, lp_h), max(d, lp_d)


def _area_weights(n_in: int, scale: float, off: float, n_out: int) -> np.ndarray:
    """(n_out, n_in): overlap of input pixel i, spanning [off + i·scale,
    off + (i+1)·scale), with output pixel j, spanning [j, j + 1)."""
    a = off + np.arange(n_in) * scale
    j = np.arange(n_out)[:, None]
    return np.clip(np.minimum(a + scale, j + 1) - np.maximum(a, j), 0, None)


def text_mask(s: str, pt: float, dpi: float):
    """The string's coverage at ``pt`` and ``dpi``: (mask, x of the ink's
    left edge relative to the pen start, y of the mask's top edge above
    the baseline), in pixels."""
    idx = _codes(s)
    ppem = pt * dpi / 72
    scale = ppem / _gt.PPEM
    pen = np.concatenate([[0.0], np.cumsum(_ADV[idx])[:-1]]) * ppem
    org = np.asarray(_gt.ORIGINS)[idx] * scale
    glyphs = _glyph_bitmaps()
    lefts = pen + org[:, 0]
    tops = org[:, 1]
    x0, y0 = math.floor(lefts.min()), math.ceil(tops.max())
    rights = [lefts[k] + glyphs[i].shape[1] * scale for k, i in enumerate(idx)]
    bottoms = [tops[k] - glyphs[i].shape[0] * scale for k, i in enumerate(idx)]
    w = math.ceil(max(rights)) - x0 + 1
    h = y0 - math.floor(min(bottoms)) + 1
    mask = np.zeros((h, w), np.float32)
    for k, i in enumerate(idx):
        g = glyphs[i]
        if not g.size or not g.any():
            continue
        wy = _area_weights(g.shape[0], scale, y0 - tops[k], h)
        wx = _area_weights(g.shape[1], scale, lefts[k] - x0, w)
        mask += wy @ g @ wx.T
    ink_left = _INK_X[idx[0], 0] * ppem
    return np.clip(mask, 0, 1), float(x0 - ink_left), float(y0)


# ---------------------------------------------------------------------------
# the canvas: display coordinates (x right, y up, pixel centres at i + .5)
# ---------------------------------------------------------------------------

class Canvas:
    """An RGB float canvas of ``width`` x ``height`` pixels."""

    def __init__(self, width: int, height: int):
        self.w, self.h = int(width), int(height)
        self.rgb = np.ones((self.h, self.w, 3), np.float32)

    def to_uint8(self) -> np.ndarray:
        return (np.clip(self.rgb, 0, 1) * 255 + 0.5).astype(np.uint8)

    # -- compositing ------------------------------------------------------
    def composite(self, rows, cols, alpha, rgb, order=None, clip=None):
        """Composite fragments: pixel (rows, cols) gets colour ``rgb`` (N, 3)
        at opacity ``alpha`` (N,), each over the ones before it in
        ``order`` (default: as given).  ``clip`` = (x0, y0, x1, y1) in
        display coordinates drops fragments whose pixel centre is outside."""
        rows = np.asarray(rows).ravel()
        cols = np.asarray(cols).ravel()
        alpha = np.asarray(alpha, np.float64).ravel()
        rgb = np.broadcast_to(np.asarray(rgb, np.float64), (len(alpha), 3))
        keep = (alpha > 1e-4) & (rows >= 0) & (rows < self.h) & (cols >= 0) & (cols < self.w)
        if clip is not None:
            x0, y0, x1, y1 = clip
            cx, cy = cols + 0.5, self.h - rows - 0.5
            keep &= (cx >= x0) & (cx <= x1) & (cy >= y0) & (cy <= y1)
        if not keep.any():
            return
        pix = rows[keep].astype(np.int64) * self.w + cols[keep]
        a = np.minimum(alpha[keep], 1.0 - 1e-7)
        c = rgb[keep]
        o = np.arange(len(alpha))[keep] if order is None else np.asarray(order).ravel()[keep]
        s = np.lexsort((o, pix))
        pix, a, c = pix[s], a[s], c[s]
        log_keep = np.log1p(-a)
        cs = np.cumsum(log_keep)
        start = np.flatnonzero(np.r_[True, pix[1:] != pix[:-1]])
        counts = np.diff(np.r_[start, len(pix)])
        end_cs = np.repeat(cs[start + counts - 1], counts)
        before = np.repeat(np.r_[0.0, cs][start], counts)
        weight = a * np.exp(end_cs - cs)                  # what the later ones leave
        group = np.repeat(np.arange(len(start)), counts)
        acc = np.stack([np.bincount(group, weight * c[:, k], len(start)) for k in range(3)], 1)
        remain = np.exp(end_cs - before)[start]
        flat = self.rgb.reshape(-1, 3)
        u = pix[start]
        flat[u] = flat[u] * remain[:, None] + acc

    def blend_mask(self, top: int, left: int, mask: np.ndarray, rgb, alpha=1.0, clip=None):
        """Blend ``rgb`` through the coverage ``mask`` whose top-left pixel is
        (row ``top``, column ``left``)."""
        h, w = mask.shape
        r0, c0 = max(top, 0), max(left, 0)
        r1, c1 = min(top + h, self.h), min(left + w, self.w)
        if r0 >= r1 or c0 >= c1:
            return
        m = mask[r0 - top:r1 - top, c0 - left:c1 - left] * alpha
        if clip is not None:
            x0, y0, x1, y1 = clip
            cx = np.arange(c0, c1) + 0.5
            cy = self.h - np.arange(r0, r1) - 0.5
            m = m * (((cy >= y0) & (cy <= y1))[:, None] & ((cx >= x0) & (cx <= x1))[None, :])
        region = self.rgb[r0:r1, c0:c1]
        region += (np.asarray(rgb, np.float32) - region) * m[..., None]

    # -- shapes -----------------------------------------------------------
    def fill_polygon(self, pts, rgb, alpha=1.0, clip=None):
        """A convex polygon (display coordinates), coverage from the
        half-planes of its edges."""
        pts = np.asarray(pts, np.float64)
        if len(pts) < 3:
            return
        x0, x1 = math.floor(pts[:, 0].min()) - 1, math.ceil(pts[:, 0].max()) + 1
        y0, y1 = math.floor(pts[:, 1].min()) - 1, math.ceil(pts[:, 1].max()) + 1
        xs = np.arange(max(x0, 0), min(x1, self.w)) + 0.5
        ys = np.arange(max(y0, 0), min(y1, self.h)) + 0.5
        if not len(xs) or not len(ys):
            return
        area = np.sum(pts[:, 0] * np.roll(pts[:, 1], -1) - np.roll(pts[:, 0], -1) * pts[:, 1])
        if abs(area) < 1e-12:
            return
        sd = np.full((len(ys), len(xs)), np.inf, np.float32)
        for a, b in zip(pts, np.roll(pts, -1, axis=0)):
            e = b - a
            n = np.hypot(*e)
            if n < 1e-12:
                continue
            nx, ny = (-e[1], e[0]) if area > 0 else (e[1], -e[0])   # inward normal
            d = ((xs[None, :] - a[0]) * nx + (ys[:, None] - a[1]) * ny) / n
            np.minimum(sd, d.astype(np.float32), out=sd)
        cov = np.clip(sd + 0.5, 0, 1)
        top = self.h - int(ys[-1] + 0.5)
        self.blend_mask(top, int(xs[0] - 0.5), cov[::-1], rgb, alpha, clip)

    def segments(self, p0, p1, width, rgb, alpha=1.0, clip=None, order0=0, snap=False):
        """Antialiased strokes from ``p0`` (N, 2) to ``p1``, ``width``
        pixels wide, colours ``rgb`` (N, 3) or (3,), drawn in order.
        ``snap``: round the ends to pixel centres (odd widths) or edges
        (even), as Agg snaps horizontal and vertical lines."""
        p0 = np.asarray(p0, np.float64).reshape(-1, 2)
        p1 = np.asarray(p1, np.float64).reshape(-1, 2)
        if not len(p0):
            return
        # to pixel space: u along columns, v along rows (down)
        a = np.stack([p0[:, 0], self.h - p0[:, 1]], 1)
        b = np.stack([p1[:, 0], self.h - p1[:, 1]], 1)
        if snap:
            sv = 0.5 if int(math.floor(width + 0.5)) % 2 else 0.0
            a, b = np.floor(a + 0.5) + sv, np.floor(b + 0.5) + sv
        finite = np.isfinite(a).all(1) & np.isfinite(b).all(1)
        seg = np.flatnonzero(finite)
        a, b = a[finite], b[finite]
        d = b - a
        steep = np.abs(d[:, 1]) > np.abs(d[:, 0])
        ma = np.where(steep, a[:, 1], a[:, 0])
        mb = np.where(steep, b[:, 1], b[:, 0])
        lo, hi = np.minimum(ma, mb), np.maximum(ma, mb)
        half = width / 2.0
        length = np.hypot(d[:, 0], d[:, 1])
        cos = np.where(length > 0, np.maximum(np.abs(d[:, 0]), np.abs(d[:, 1]))
                       / np.maximum(length, 1e-12), 1.0)
        m0 = np.floor(lo - half - 1).astype(np.int64)
        nm = (np.ceil(hi + half + 1).astype(np.int64) - m0)
        reach = np.ceil((half + 0.5) / cos + 0.5).astype(np.int64)
        nn = 2 * reach + 1
        per = nm * nn
        # a few million fragments at a time, in drawing order
        bounds = np.searchsorted(np.cumsum(per), np.arange(1, int(per.sum()) // 4_000_000 + 1)
                                 * 4_000_000)
        rgb = np.asarray(rgb, np.float64)
        al = np.asarray(alpha, np.float64)
        for part in np.split(np.arange(len(a)), np.unique(bounds[bounds < len(a)])):
            if len(part):
                self._segment_run(part, a, d, steep, m0, reach, nn, per, half, width,
                                  rgb[seg] if rgb.ndim == 2 else rgb,
                                  al[seg] if al.ndim else al, clip, order0 + seg)

    def _segment_run(self, part, a, d, steep, m0, reach, nn, per, half, width, rgb, al,
                     clip, order):
        total = int(per[part].sum())
        if total == 0:
            return
        sid = np.repeat(part, per[part])
        k = np.arange(total) - np.repeat(np.cumsum(per[part]) - per[part], per[part])
        im = m0[sid] + k // nn[sid]
        # the minor coordinate of the segment's centre line at this step
        dm = np.where(steep, d[:, 1], d[:, 0])[sid]
        dn = np.where(steep, d[:, 0], d[:, 1])[sid]
        am = np.where(steep, a[:, 1], a[:, 0])[sid]
        an = np.where(steep, a[:, 0], a[:, 1])[sid]
        t = np.where(np.abs(dm) > 1e-12, (im + 0.5 - am) / np.where(np.abs(dm) > 1e-12, dm, 1), 0.0)
        centre = an + np.clip(t, 0, 1) * dn
        iminor = np.floor(centre).astype(np.int64) + (k % nn[sid]) - reach[sid]
        cu = np.where(steep[sid], iminor, im) + 0.5
        cv = np.where(steep[sid], im, iminor) + 0.5
        # distance from the pixel centre to the segment
        ax_, ay_ = a[sid, 0], a[sid, 1]
        dx, dy = d[sid, 0], d[sid, 1]
        l2 = np.maximum(dx * dx + dy * dy, 1e-12)
        tt = np.clip(((cu - ax_) * dx + (cv - ay_) * dy) / l2, 0, 1)
        dist = np.hypot(cu - ax_ - tt * dx, cv - ay_ - tt * dy)
        cov = np.clip(half + 0.5 - dist, 0, 1) if width >= 1 else \
            np.clip(1.0 - dist, 0, 1) * width
        keep = cov > 1e-3
        sk = sid[keep]
        cols = np.where(steep[sid], iminor, im)[keep]
        rows = np.where(steep[sid], im, iminor)[keep]
        self.composite(rows, cols, cov[keep] * (al[sk] if al.ndim else al),
                       rgb[sk] if rgb.ndim == 2 else rgb, order[sk], clip)

    def markers(self, xy, kind: str, size_px: float, rgb, alpha, edge_px: float,
                clip=None, order0=0, fill=True):
        """Markers centred at ``xy`` (N, 2): ``kind`` 'o' (diameter
        ``size_px``), 's' (side), '^' (width and height); each a filled
        face (unless not ``fill``) and an edge stroke ``edge_px`` wide in
        the same colour and opacity, composited one after the other as Agg
        does."""
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        ok = np.isfinite(xy).all(1)
        if not ok.any():
            return
        xy = xy[ok]
        rgb = np.broadcast_to(np.asarray(rgb, np.float64), (len(ok), 3))[ok]
        alpha = np.broadcast_to(np.asarray(alpha, np.float64), (len(ok),))[ok]
        r = size_px / 2.0
        reach = int(math.ceil(r + edge_px / 2 + 1.5))
        off = np.arange(-reach, reach + 1)
        cx = xy[:, 0]
        cy = self.h - xy[:, 1]
        col0 = np.floor(cx).astype(np.int64)
        row0 = np.floor(cy).astype(np.int64)
        cols = col0[:, None, None] + off[None, None, :]
        rows = row0[:, None, None] + off[None, :, None]
        px = cols + 0.5 - cx[:, None, None]
        py = cy[:, None, None] - (rows + 0.5)              # up
        if kind == "o":
            sd = r - np.hypot(px, py)
        elif kind == "s":
            sd = r - np.maximum(np.abs(px), np.abs(py))
        elif kind == "^":
            # the triangle (0, r), (-r, -r), (r, -r)
            n = 1 / math.sqrt(5)
            sd = np.minimum(py + r, np.minimum((r - py - 2 * px) * n, (r - py + 2 * px) * n))
        else:
            raise ValueError(f"marker {kind!r}")
        face = np.clip(sd + 0.5, 0, 1)
        edge = np.clip(edge_px / 2 + 0.5 - np.abs(sd), 0, 1) if edge_px > 0 else None
        n = len(xy)
        shape = (n, 2 * reach + 1, 2 * reach + 1)
        rr = np.broadcast_to(rows, shape)
        cc = np.broadcast_to(cols, shape)
        idx = np.broadcast_to(np.arange(n)[:, None, None], shape)
        parts = ([(face, 0)] if fill else []) + ([(edge, 1)] if edge is not None else [])
        self.composite(
            np.concatenate([rr.ravel()] * len(parts)),
            np.concatenate([cc.ravel()] * len(parts)),
            np.concatenate([(m * alpha[:, None, None]).ravel() for m, _ in parts]),
            np.concatenate([np.repeat(rgb, shape[1] * shape[2], 0)] * len(parts)),
            np.concatenate([(order0 + 2 * idx + k).ravel() for _, k in parts]),
            clip)

    def text(self, s: str, x: float, y: float, pt: float, dpi: float, rgb=(0, 0, 0),
             ha="left", va="baseline", rotation=0, clip=None):
        """Draw ``s`` with its layout box aligned at (x, y) by ``ha`` /
        ``va``; ``rotation`` 90 turns it about that point
        (rotation_mode 'anchor').  Returns its layout box (x0, y0, x1, y1)."""
        if not s:
            return (x, y, x, y)
        box = text_box(s, x, y, pt, dpi, ha, va, rotation)
        mask, dx, top = text_mask(s, pt, dpi)
        w, h, d = text_layout(s, pt, dpi)
        if rotation == 0:
            left_pen = box[0] + dx
            baseline = box[1] + d
            self.blend_mask(int(round(self.h - (baseline + top))), int(round(left_pen)),
                            mask, to_rgb(rgb), 1.0, clip)
        else:
            # 90 degrees counter-clockwise: the baseline runs upwards at
            # x = box[2] - d, the text's left at y = box[1]
            m = np.rot90(mask)
            baseline_x = box[2] - d
            self.blend_mask(int(round(self.h - (box[1] + dx) - m.shape[0])),
                            int(round(baseline_x - top)), m, to_rgb(rgb), 1.0, clip)
        return box

    def image(self, img: np.ndarray, box):
        """Resample ``img`` (H, W, 3) float in [0, 1] onto ``box`` = (x0,
        y0, x1, y1) as matplotlib's Agg backend does: sampled relative to
        the box's lower-left corner, then placed at that corner rounded to
        whole pixels; Hanning interpolation (widened by the ratio when
        shrinking), nearest when the image is enlarged 3 times or more or
        by exactly 1 or 2."""
        x0, y0, x1, y1 = box
        h, w = img.shape[:2]
        out_w, out_h = int(math.ceil(x1 - x0)), int(math.ceil(y1 - y0))
        kx = _resample_matrix(w, (x1 - x0) / w, out_w)
        ky = _resample_matrix(h, (y1 - y0) / h, out_h)
        # rows are resampled bottom up, as the display's y runs
        rows = np.tensordot(ky, img[::-1], axes=(1, 0))              # (out_h, w, 3)
        out = np.matmul(rows.transpose(0, 2, 1), kx.T).transpose(0, 2, 1)[::-1]
        c0 = int(math.floor(x0 + 0.5))
        r0 = self.h - int(math.floor(y0 + 0.5)) - out_h
        rr0, cc0 = max(r0, 0), max(c0, 0)
        rr1, cc1 = min(r0 + out_h, self.h), min(c0 + out_w, self.w)
        self.rgb[rr0:rr1, cc0:cc1] = out[rr0 - r0:rr1 - r0, cc0 - c0:cc1 - c0]


def _resample_matrix(n_in: int, scale: float, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights taking an axis of ``n_in`` samples, stretched
    by ``scale``, to ``n_out``."""
    u = (np.arange(n_out) + 0.5) / scale - 0.5          # input coordinate
    if scale >= 3 or abs(scale - 1) < 1e-9 or abs(scale - 2) < 1e-9:
        idx = np.clip(np.floor(u + 0.5).astype(int), 0, n_in - 1)
        m = np.zeros((n_out, n_in))
        m[np.arange(n_out), idx] = 1
        return m
    radius = max(1.0, 1.0 / scale)
    i = np.arange(n_in)
    t = (i[None, :] - u[:, None]) / radius
    wgt = np.where(np.abs(t) < 1, 0.5 + 0.5 * np.cos(np.pi * t), 0.0)
    s = wgt.sum(1, keepdims=True)
    return wgt / np.where(s > 0, s, 1)


def text_box(s, x, y, pt, dpi, ha="left", va="baseline", rotation=0):
    """The layout box (x0, y0, x1, y1) of ``s`` aligned at (x, y)."""
    w, h, d = text_layout(s, pt, dpi)
    bx = {"left": 0.0, "center": -w / 2, "right": -w}[ha]
    by = {"baseline": -d, "bottom": 0.0, "top": -h, "center": -h / 2,
          "center_baseline": -(h - d) / 2 - d}[va]
    if rotation == 0:
        return (x + bx, y + by, x + bx + w, y + by + h)
    # rotate the box (bx, by)-(bx + w, by + h) by 90 degrees about (x, y)
    return (x - (by + h), y + bx, x - by, y + bx + w)


# ---------------------------------------------------------------------------
# ticks: matplotlib's AutoLocator and ScalarFormatter
# ---------------------------------------------------------------------------

def _scale_range(vmin, vmax, n):
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    offset = 0.0 if abs(meanv) / dv < 100 else math.copysign(
        10 ** (math.log10(abs(meanv)) // 1), meanv)
    return 10 ** (math.log10(dv / n) // 1), offset


def auto_ticks(vmin: float, vmax: float, nbins: int, three_d: bool = False) -> np.ndarray:
    """MaxNLocator(nbins, steps=[1, 2, 2.5, 5, 10]).tick_values."""
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    if vmax - vmin < 1e-300:
        vmin, vmax = vmin - 1, vmax + 1
    nbins = int(np.clip(nbins, 1, 9))
    scale, offset = _scale_range(vmin, vmax, nbins)
    _vmin, _vmax = vmin - offset, vmax - offset
    steps = np.array([0.1, 0.2, 0.25, 0.5, 1, 2, 2.5, 5, 10, 20]) * scale
    raw_step = (_vmax - _vmin) / nbins
    if three_d:
        raw_step *= 23 / 24
    istep = np.nonzero(steps >= raw_step)[0][0]
    tol = 1e-10
    if offset > 0:
        tol = min(0.4999, max(1e-10, 10 ** (math.log10(offset / steps[istep]) - 12)))
    ticks = np.array([])
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        dlo, mlo = divmod(_vmin - best_vmin, step)
        low = dlo + 1 if abs(mlo / step - 1) < tol else dlo
        dhi, mhi = divmod(_vmax - best_vmin, step)
        high = dhi if abs(mhi / step) < tol else dhi + 1
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= 2:
            break
    return ticks + offset


def format_ticks(locs: Sequence[float]) -> List[str]:
    """ScalarFormatter's labels (no offset, no order of magnitude), with
    the Unicode minus."""
    locs = np.asarray(locs, np.float64)
    if not len(locs):
        return []
    rng = np.ptp(locs) or np.max(np.abs(locs)) or 1.0
    oom = int(math.floor(math.log10(rng)))
    sig = max(0, 3 - oom)
    thresh = 1e-3 * 10 ** oom
    while sig >= 0 and np.abs(locs - np.round(locs, sig)).max() < thresh:
        sig -= 1
    sig += 1
    out = []
    for v in locs:
        v = 0.0 if abs(v) < 1e-8 else v
        out.append(f"{v:1.{sig}f}".replace("-", "−"))
    return out


def _in_interval(locs, lo, hi):
    eps = 1e-10 * max(abs(hi - lo), 1e-300)
    return (locs >= min(lo, hi) - eps) & (locs <= max(lo, hi) + eps)


# ---------------------------------------------------------------------------
# legend
# ---------------------------------------------------------------------------

_LOCS = ["upper right", "upper left", "lower left", "lower right", "right",
         "center left", "center right", "lower center", "upper center", "center"]


class _Legend:
    """matplotlib's default legend: 10 pt labels, a handle 2 em wide, a
    round-cornered white frame at 0.8 opacity with a grey edge, placed at
    the first of matplotlib's nine locations (upper right first) that
    covers no data vertex, else at the one covering fewest."""

    def __init__(self, entries):
        self.entries = entries          # [(label, handle dict)]

    def size(self, dpi):
        k = dpi / 72
        rows = []
        for label, _ in self.entries:
            w, h, d = text_layout(label, FONT_PT, dpi)
            rows.append((w, max(0.7 * FONT_PT * k, h - d), d))
        width = (2.0 + 0.8) * FONT_PT * k + max(r[0] for r in rows)
        height = sum(r[1] + r[2] for r in rows) + 0.5 * FONT_PT * k * (len(rows) - 1)
        pad = 0.4 * FONT_PT * k
        return width + 2 * pad, height + 2 * pad, rows

    def place(self, box, dpi, points, segments_):
        """Lower-left corner in display coordinates, by matplotlib's
        'best' rule over ``points`` (N, 2) and the polylines ``segments_``."""
        w, h, _ = self.size(dpi)
        pad = 0.5 * FONT_PT * dpi / 72
        x0, y0, x1, y1 = box[0] + pad, box[1] + pad, box[2] - pad, box[3] - pad
        spots = {"upper right": (x1 - w, y1 - h), "upper left": (x0, y1 - h),
                 "lower left": (x0, y0), "lower right": (x1 - w, y0),
                 "right": (x1 - w, (y0 + y1 - h) / 2),
                 "center left": (x0, (y0 + y1 - h) / 2),
                 "center right": (x1 - w, (y0 + y1 - h) / 2),
                 "lower center": ((x0 + x1 - w) / 2, y0),
                 "upper center": ((x0 + x1 - w) / 2, y1 - h),
                 "center": ((x0 + x1 - w) / 2, (y0 + y1 - h) / 2)}
        best = None
        pts = np.asarray(points, np.float64).reshape(-1, 2)
        for n, name in enumerate(_LOCS):
            lx, ly = spots[name]
            inside = ((pts[:, 0] > lx) & (pts[:, 0] < lx + w)
                      & (pts[:, 1] > ly) & (pts[:, 1] < ly + h))
            bad = int(inside.sum())
            for line in segments_:
                line = np.asarray(line, np.float64).reshape(-1, 2)
                bad += int(((line[:, 0] > lx) & (line[:, 0] < lx + w)
                            & (line[:, 1] > ly) & (line[:, 1] < ly + h)).sum())
                bad += int(_polyline_hits_box(line, (lx, ly, lx + w, ly + h)))
            if best is None or (bad, n) < best[:2]:
                best = (bad, n, (lx, ly))
            if bad == 0:
                break
        return best[2]

    def draw(self, cv: Canvas, box, dpi, points, segments_):
        k = dpi / 72
        lx, ly = self.place(box, dpi, points, segments_)
        w, h, rows = self.size(dpi)
        _rounded_rect(cv, (lx, ly, lx + w, ly + h), 0.2 * FONT_PT * k, to_rgb("white"),
                      to_rgb("0.8"), 1.0 * k, 0.8)
        pad = 0.4 * FONT_PT * k
        y = ly + h - pad
        for (label, handle), (tw, above, d) in zip(self.entries, rows):
            baseline = y - above
            hx = lx + pad + FONT_PT * k              # the handle's centre
            if handle["kind"] == "scatter":
                hy = baseline + 0.4375 * 0.7 * FONT_PT * k
                size = math.sqrt(handle["s"]) * k * handle.get("shrink", 1.0)
                cv.markers([[hx, hy]], handle["marker"], size, handle["rgb"],
                           handle["alpha"], handle["lw"] * k)
            else:
                hy = baseline + 0.35 * FONT_PT * k
                cv.markers([[hx, hy]], handle["marker"], handle["ms"] * k, handle["rgb"],
                           1.0, handle["mew"] * k)
            cv.text(label, lx + pad + 2.8 * FONT_PT * k, baseline, FONT_PT, dpi)
            y = baseline - d - 0.5 * FONT_PT * k


def _polyline_hits_box(line, box):
    """Whether any segment of ``line`` crosses an edge of ``box``."""
    if len(line) < 2:
        return False
    x0, y0, x1, y1 = box
    edges = [((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)), ((x1, y1), (x0, y1)),
             ((x0, y1), (x0, y0))]
    p, q = line[:-1], line[1:]
    for a, b in edges:
        a, b = np.asarray(a), np.asarray(b)

        def orient(u, v, w):
            return np.sign((v[..., 0] - u[..., 0]) * (w[..., 1] - u[..., 1])
                           - (v[..., 1] - u[..., 1]) * (w[..., 0] - u[..., 0]))
        hit = ((orient(p, q, a) != orient(p, q, b)) & (orient(a, b, p) != orient(a, b, q)))
        if hit.any():
            return True
    return False


def _rounded_rect(cv: Canvas, box, radius, face, edge, lw, alpha):
    """A round-cornered rectangle: face, then its edge stroke."""
    x0, y0, x1, y1 = box
    c0, c1 = max(int(math.floor(x0 - lw)), 0), min(int(math.ceil(x1 + lw)) + 1, cv.w)
    r0, r1 = max(int(math.floor(cv.h - y1 - lw)), 0), min(int(math.ceil(cv.h - y0 + lw)) + 1, cv.h)
    xs = np.arange(c0, c1) + 0.5
    ys = cv.h - (np.arange(r0, r1) + 0.5)
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    hx, hy = (x1 - x0) / 2 - radius, (y1 - y0) / 2 - radius
    qx = np.abs(xs[None, :] - cx) - hx
    qy = np.abs(ys[:, None] - cy) - hy
    out = np.hypot(np.maximum(qx, 0), np.maximum(qy, 0)) + np.minimum(np.maximum(qx, qy), 0)
    sd = radius - out
    cv.blend_mask(r0, c0, np.clip(sd + 0.5, 0, 1).astype(np.float32), face, alpha)
    cv.blend_mask(r0, c0, np.clip(lw / 2 + 0.5 - np.abs(sd), 0, 1).astype(np.float32),
                  edge, alpha)


# ---------------------------------------------------------------------------
# axes
# ---------------------------------------------------------------------------

class _AxesBase:
    def __init__(self, fig: "Figure", pos):
        self.fig = fig
        self.pos = list(pos)            # original position, figure fractions
        self.title = ""
        self.xlabel = self.ylabel = ""
        self.artists: list = []         # in the order added
        self.legend_on = False
        self.lims = {}
        self._cycle = 0

    def set_title(self, s):
        self.title = s

    def set_xlabel(self, s):
        self.xlabel = s

    def set_ylabel(self, s):
        self.ylabel = s

    def set_xlim(self, lo, hi):
        self.lims["x"] = (float(lo), float(hi))

    def set_ylim(self, lo, hi):
        self.lims["y"] = (float(lo), float(hi))

    def legend(self):
        self.legend_on = True

    def _next_color(self):
        c = TAB10[self._cycle % 10]
        self._cycle += 1
        return c

    def _legend_entries(self):
        out = []
        for a in self.artists:
            if a.get("label"):
                if a["kind"] == "scatter":
                    out.append((a["label"], dict(kind="scatter", marker=a["marker"],
                                                 s=a["s"], rgb=a["rgb"], alpha=a["alpha"],
                                                 lw=a["lw"], shrink=a["shrink"])))
                else:
                    out.append((a["label"], dict(kind="line", marker=a["marker"] or "o",
                                                 ms=a["ms"], rgb=a["rgb"], mew=1.0)))
        return _Legend(out) if out else None

    def active_box(self, fw, fh):
        x0, y0, w, h = self.pos
        return (x0 * fw, y0 * fh, (x0 + w) * fw, (y0 + h) * fh)

    def title_box(self, box, dpi):
        return text_box(self.title, (box[0] + box[2]) / 2, box[3] + 6.0 * dpi / 72,
                        TITLE_PT, dpi, "center", "baseline")

    def tight_box(self, fw, fh, dpi):
        """The axes' extent for tight_layout: its active box and its title.
        That is all of it for the figures laid out tightly here: 2-D axes
        turned off, and 3-D axes, whose tick labels matplotlib has not yet
        placed when tight_layout measures them."""
        box = self.active_box(fw, fh)
        if not self.title:
            return box
        t = self.title_box(box, dpi)
        return (min(box[0], t[0]), min(box[1], t[1]), max(box[2], t[2]), max(box[3], t[3]))

    def _scatter_common(self, s, color, marker, alpha, label, linewidths):
        shrink = 0.5 if marker == "." else 1.0
        return dict(kind="scatter", s=float(s), rgb=to_rgb(color),
                    marker="o" if marker == "." else marker, shrink=shrink,
                    alpha=1.0 if alpha is None else float(alpha), alpha_set=alpha,
                    label=label,
                    lw=1.5 if linewidths is None else float(linewidths))


class Axes(_AxesBase):
    """2-D axes."""

    def __init__(self, fig, pos):
        super().__init__(fig, pos)
        self.grid_on = False
        self.equal = False
        self.axis_on = True
        self.image = None

    def scatter(self, x, y, s=36.0, color="C0", marker="o", alpha=None, label=None,
                linewidths=None):
        a = self._scatter_common(s, color, marker, alpha, label, linewidths)
        a["xy"] = np.column_stack([np.asarray(x, np.float64).ravel(),
                                   np.asarray(y, np.float64).ravel()])
        self.artists.append(a)

    def plot(self, x, y, marker=None, markersize=6.0, linestyle="-", label=None):
        """A line in the next colour of the cycle, lines.linewidth wide."""
        self.artists.append(dict(
            kind="line", xy=np.column_stack([np.atleast_1d(np.asarray(x, np.float64)),
                                             np.atleast_1d(np.asarray(y, np.float64))]),
            rgb=to_rgb(self._next_color()), marker=marker, ms=float(markersize),
            ls=linestyle, label=label))

    def grid(self, on=True):
        self.grid_on = bool(on)

    def axis_equal(self):
        self.equal = True

    def axis_off(self):
        self.axis_on = False

    def imshow(self, img):
        """Show an (H, W, 3) uint8 or float image, aspect equal (box)."""
        img = np.asarray(img)
        self.image = img.astype(np.float64) / 255 if img.dtype == np.uint8 else \
            img.astype(np.float64)
        h, w = self.image.shape[:2]
        self.lims = {"x": (-0.5, w - 0.5), "y": (h - 0.5, -0.5)}

    # -- layout -----------------------------------------------------------
    def active_box(self, fw, fh):
        box = super().active_box(fw, fh)
        if self.image is None:
            return box
        # an image: aspect equal, adjustable box, anchored at the centre
        h, w = self.image.shape[:2]
        bw, bh = box[2] - box[0], box[3] - box[1]
        if bh / bw > h / w:
            nh = bw * h / w
            return (box[0], box[1] + (bh - nh) / 2, box[2], box[1] + (bh + nh) / 2)
        nw = bh * w / h
        return (box[0] + (bw - nw) / 2, box[1], box[0] + (bw + nw) / 2, box[3])

    def _data_lims(self):
        pts = [a["xy"] for a in self.artists if len(a["xy"])]
        if pts:
            p = np.concatenate(pts)
            p = p[np.isfinite(p).all(1)]
        if not pts or not len(p):
            return (0.0, 1.0), (0.0, 1.0)
        return (p[:, 0].min(), p[:, 0].max()), (p[:, 1].min(), p[:, 1].max())

    def view(self, fw, fh):
        """(x limits, y limits, active box) as matplotlib draws them."""
        (dx0, dx1), (dy0, dy1) = self._data_lims()

        def auto(lo, hi):
            if hi - lo < 1e-300:         # a single value: the locator's widening
                return (lo - 1, hi + 1) if lo == 0 else (lo - 0.05 * abs(lo), hi + 0.05 * abs(hi))
            m = 0.05 * (hi - lo)
            return lo - m, hi + m
        xl = self.lims.get("x") or auto(dx0, dx1)
        yl = self.lims.get("y") or auto(dy0, dy1)
        box = self.active_box(fw, fh)
        if self.equal and self.image is None:
            xl, yl = _datalim_equal(xl, yl, (dx0, dx1), (dy0, dy1), box)
        return xl, yl, box

    def _ticks(self, xl, yl, box, dpi):
        k = dpi / 72
        nx = math.floor((box[2] - box[0]) / k / (FONT_PT * 3))
        ny = math.floor((box[3] - box[1]) / k / (FONT_PT * 2))
        out = []
        for lo, hi, n in ((xl[0], xl[1], nx), (yl[0], yl[1], ny)):
            locs = auto_ticks(lo, hi, max(n, 1))
            labels = format_ticks(locs)
            keep = _in_interval(locs, lo, hi)
            out.append((locs[keep], [lab for lab, kk in zip(labels, keep) if kk]))
        return out

    def _decorations(self, xl, yl, box, dpi):
        """[(text item, its box)] of the tick labels and axis labels."""
        k = dpi / 72
        (xt, xlab), (yt, ylab) = self._ticks(xl, yl, box, dpi)
        tx = box[0] + (xt - xl[0]) / (xl[1] - xl[0]) * (box[2] - box[0])
        ty = box[1] + (yt - yl[0]) / (yl[1] - yl[0]) * (box[3] - box[1])
        pad = (3.5 + 3.5) * k
        items = []
        for x, s in zip(tx, xlab):
            items.append(((s, x, box[1] - pad, "center", "top", 0),
                          text_box(s, x, box[1] - pad, FONT_PT, dpi, "center", "top")))
        for y, s in zip(ty, ylab):
            items.append(((s, box[0] - pad, y, "right", "center_baseline", 0),
                          text_box(s, box[0] - pad, y, FONT_PT, dpi, "right",
                                   "center_baseline")))
        if self.xlabel:
            bottom = min([b[1] for (it, b) in items if it[4] == "top"] + [box[1]])
            xy = ((box[0] + box[2]) / 2, bottom - 4.0 * k)
            items.append(((self.xlabel, *xy, "center", "top", 0),
                          text_box(self.xlabel, *xy, FONT_PT, dpi, "center", "top")))
        if self.ylabel:
            left = min([b[0] for (it, b) in items if it[3] == "right"] + [box[0]])
            xy = (left - 4.0 * k, (box[1] + box[3]) / 2)
            items.append(((self.ylabel, *xy, "center", "bottom", 90),
                          text_box(self.ylabel, *xy, FONT_PT, dpi, "center", "bottom", 90)))
        return items

    # -- drawing ----------------------------------------------------------
    def draw(self, cv: Canvas, dpi: float):
        k = dpi / 72
        xl, yl, box = self.view(cv.w, cv.h)

        def to_px(xy):
            xy = np.asarray(xy, np.float64).reshape(-1, 2)
            return np.column_stack([
                box[0] + (xy[:, 0] - xl[0]) / (xl[1] - xl[0]) * (box[2] - box[0]),
                box[1] + (xy[:, 1] - yl[0]) / (yl[1] - yl[0]) * (box[3] - box[1])])

        if self.image is not None:
            cv.image(self.image, box)
        clip = box
        # zorder 1: collections
        for a in self.artists:
            if a["kind"] == "scatter":
                cv.markers(to_px(a["xy"]), a["marker"], math.sqrt(a["s"]) * k * a["shrink"],
                           a["rgb"], a["alpha"], a["lw"] * k, clip)
        # zorder 1.5: grid, ticks, tick labels, axis labels
        if self.axis_on:
            (xt, _), (yt, _) = self._ticks(xl, yl, box, dpi)
            tx = box[0] + (xt - xl[0]) / (xl[1] - xl[0]) * (box[2] - box[0])
            ty = box[1] + (yt - yl[0]) / (yl[1] - yl[0]) * (box[3] - box[1])
            if self.grid_on:
                cv.segments(np.column_stack([tx, np.full_like(tx, box[1])]),
                            np.column_stack([tx, np.full_like(tx, box[3])]), 0.8 * k,
                            to_rgb(GRID_RGB), 1.0, clip, snap=True)
                cv.segments(np.column_stack([np.full_like(ty, box[0]), ty]),
                            np.column_stack([np.full_like(ty, box[2]), ty]), 0.8 * k,
                            to_rgb(GRID_RGB), 1.0, clip, snap=True)
            tl = 3.5 * k
            cv.segments(np.column_stack([tx, np.full_like(tx, box[1])]),
                        np.column_stack([tx, np.full_like(tx, box[1] - tl)]), 0.8 * k,
                        np.zeros(3), snap=True)
            cv.segments(np.column_stack([np.full_like(ty, box[0]), ty]),
                        np.column_stack([np.full_like(ty, box[0] - tl), ty]), 0.8 * k,
                        np.zeros(3), snap=True)
            for (s, x, y, ha, va, rot), _ in self._decorations(xl, yl, box, dpi):
                cv.text(s, x, y, FONT_PT, dpi, (0, 0, 0), ha, va, rot)
        # zorder 2: lines
        lines_px = []
        for a in self.artists:
            if a["kind"] == "line":
                p = to_px(a["xy"])
                lines_px.append(p)
                if a["ls"] not in ("None", "none", "", " ") and len(p) > 1:
                    cv.segments(p[:-1], p[1:], 1.5 * k, a["rgb"], 1.0, clip)
                if a["marker"]:
                    cv.markers(p, a["marker"], a["ms"] * k, a["rgb"], 1.0, 1.0 * k, clip)
        # zorder 2.5: spines
        if self.axis_on:
            x0, y0, x1, y1 = box
            cv.segments([[x0, y0], [x1, y0], [x1, y1], [x0, y1]],
                        [[x1, y0], [x1, y1], [x0, y1], [x0, y0]], 0.8 * k, np.zeros(3),
                        snap=True)
        if self.title:
            cv.text(self.title, (box[0] + box[2]) / 2, box[3] + 6.0 * k, TITLE_PT, dpi,
                    (0, 0, 0), "center", "baseline")
        leg = self._legend_entries() if self.legend_on else None
        if leg is not None:
            pts = [to_px(a["xy"]) for a in self.artists if a["kind"] == "scatter"]
            leg.draw(cv, box, dpi, np.concatenate(pts) if pts else np.zeros((0, 2)), lines_px)


def _datalim_equal(xl, yl, dx, dy, box):
    """apply_aspect(aspect 'equal', adjustable 'datalim') of matplotlib:
    widen one of the two limits about its centre."""
    xsize = max(abs(xl[1] - xl[0]), 1e-30)
    ysize = max(abs(yl[1] - yl[0]), 1e-30)
    data_ratio = (box[3] - box[1]) / (box[2] - box[0])
    y_expander = data_ratio * xsize / ysize - 1
    if abs(y_expander) < 0.005:
        return xl, yl
    xr = 1.05 * (dx[1] - dx[0])
    yr = 1.05 * (dy[1] - dy[0])
    xmarg, ymarg = xsize - xr, ysize - yr
    Ysize, Xsize = data_ratio * xsize, ysize / data_ratio
    Xmarg, Ymarg = Xsize - xr, Ysize - yr
    if xmarg > 0 and ymarg > 0:
        adjust_y = (Ymarg > 0 and y_expander < 0) or (Xmarg < 0 and y_expander > 0)
    else:
        adjust_y = y_expander > 0
    if adjust_y:
        yc = 0.5 * (yl[0] + yl[1])
        return xl, (yc - Ysize / 2, yc + Ysize / 2)
    xc = 0.5 * (xl[0] + xl[1])
    return (xc - Xsize / 2, xc + Xsize / 2), yl


# ---------------------------------------------------------------------------
# 3-D axes (mplot3d)
# ---------------------------------------------------------------------------

_PLANES = ((0, 3, 7, 4), (1, 2, 6, 5), (0, 1, 5, 4), (3, 2, 6, 7), (0, 1, 2, 3), (4, 5, 6, 7))
_JUGGLED = ((1, 0, 2), (0, 1, 2), (0, 2, 1))
_TICKDIR = (1, 0, 0)
_PANE_RGBA = ((0.95, 0.95, 0.95, 0.5), (0.9, 0.9, 0.9, 0.5), (0.925, 0.925, 0.925, 0.5))
_VIEW_LIM = (-0.95 / 10, 0.9 / 10)          # set_top_view: both 2-D axes
ELEV, AZIM, DIST, FOCAL = 30.0, -60.0, 10.0, 1.0


class Axes3D(_AxesBase):
    """mplot3d's Axes3D at its default view."""

    def __init__(self, fig, pos):
        super().__init__(fig, pos)
        self.zlabel = ""
        aspect = np.array([4.0, 4.0, 3.0])
        self.box_aspect = aspect * 1.8294640721620434 * 25 / 24 / np.linalg.norm(aspect)

    def set_zlabel(self, s):
        self.zlabel = s

    def _check_label(self, s):
        # mplot3d turns labels longer than 4 characters along their axis
        if len(s) > 4:
            raise ValueError(f"3-D axis label {s!r}: only labels of up to 4 "
                             "characters, which mplot3d draws unrotated")

    def set_zlim(self, lo, hi):
        self.lims["z"] = (float(lo), float(hi))

    def scatter(self, x, y, z, s=20.0, color="C0", marker="o", alpha=None, label=None,
                linewidths=None):
        a = self._scatter_common(s, color, marker, alpha, label, linewidths)
        a["xyz"] = np.column_stack([np.atleast_1d(np.asarray(v, np.float64)).ravel()
                                    for v in (x, y, z)])
        self.artists.append(a)

    def plot(self, x, y, z):
        """A line in the next colour of the cycle, lines.linewidth wide."""
        self.artists.append(dict(
            kind="line", xyz=np.column_stack([np.asarray(v, np.float64) for v in (x, y, z)]),
            rgb=to_rgb(self._next_color()), label=None))

    def active_box(self, fw, fh):
        x0, y0, x1, y1 = super().active_box(fw, fh)
        side = min(x1 - x0, y1 - y0)
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        return (cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2)

    def limits(self):
        """x, y, z limits: the set ones, else the data's with 5 % margins
        (x and y; none on z) and mplot3d's 1/48 view margin."""
        pts = [a["xyz"] for a in self.artists if len(a["xyz"])]
        p = np.concatenate(pts) if pts else np.zeros((0, 3))
        p = p[np.isfinite(p).all(1)]
        out = []
        for i, name in enumerate("xyz"):
            if name in self.lims:
                out.append(self.lims[name])
                continue
            lo, hi = (p[:, i].min(), p[:, i].max()) if len(p) else (0.0, 1.0)
            if hi - lo < 1e-300:
                lo, hi = lo - 1, hi + 1
            m = (0.05 if name != "z" else 0.0) * (hi - lo)   # axes.xmargin; zmargin 0
            lo, hi = lo - m, hi + m
            m = (hi - lo) / 48
            out.append((lo - m, hi + m))
        return out

    def proj_matrix(self, lims):
        """mplot3d's get_proj: world box -> view -> perspective."""
        (x0, x1), (y0, y1), (z0, z1) = lims
        ax, ay, az = self.box_aspect
        dx, dy, dz = (x1 - x0) / ax, (y1 - y0) / ay, (z1 - z0) / az
        world = np.array([[1 / dx, 0, 0, -x0 / dx], [0, 1 / dy, 0, -y0 / dy],
                          [0, 0, 1 / dz, -z0 / dz], [0, 0, 0, 1]])
        R = 0.5 * self.box_aspect
        e, a = np.deg2rad(ELEV), np.deg2rad(AZIM)
        ps = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
        eye = R + DIST * ps
        w = (eye - R) / np.linalg.norm(eye - R)
        u = np.cross([0.0, 0.0, 1.0], w)
        u /= np.linalg.norm(u)
        v = np.cross(w, u)
        eye_f = R + DIST * ps * FOCAL
        Mr, Mt = np.eye(4), np.eye(4)
        Mr[:3, :3] = [u, v, w]
        Mt[:3, 3] = -eye_f
        zf, zb = -DIST, DIST
        proj = np.array([[FOCAL, 0, 0, 0], [0, FOCAL, 0, 0],
                         [0, 0, (zf + zb) / (zf - zb), -2 * zf * zb / (zf - zb)],
                         [0, 0, -1, 0]])
        return proj @ (Mr @ Mt) @ world

    @staticmethod
    def project(M, xyz):
        xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
        v = M @ np.vstack([xyz.T, np.ones(len(xyz))])
        return (v[:3] / v[3]).T

    def _to_px(self, box):
        lo, hi = _VIEW_LIM

        def f(p):
            p = np.asarray(p, np.float64).reshape(-1, 2)
            return np.column_stack([box[0] + (p[:, 0] - lo) / (hi - lo) * (box[2] - box[0]),
                                    box[1] + (p[:, 1] - lo) / (hi - lo) * (box[3] - box[1])])
        return f

    def draw(self, cv: Canvas, dpi: float):
        k = dpi / 72
        box = self.active_box(cv.w, cv.h)
        lims = self.limits()
        M = self.proj_matrix(lims)
        to_px = self._to_px(box)
        mins = np.array([l[0] for l in lims])
        maxs = np.array([l[1] for l in lims])
        corners = np.array([(mins[0], mins[1], mins[2]), (maxs[0], mins[1], mins[2]),
                            (maxs[0], maxs[1], mins[2]), (mins[0], maxs[1], mins[2]),
                            (mins[0], mins[1], maxs[2]), (maxs[0], mins[1], maxs[2]),
                            (maxs[0], maxs[1], maxs[2]), (mins[0], maxs[1], maxs[2])])
        tc = self.project(M, corners)
        highs = np.array([tc[list(_PLANES[2 * i]), 2].mean() < tc[list(_PLANES[2 * i + 1]), 2].mean()
                          for i in range(3)])
        centers = 0.5 * (maxs + mins)
        deltas = (maxs - mins) * 0.08
        minmax = np.where(highs, maxs, mins)
        maxmin = np.where(~highs, maxs, mins)
        ax_points = (box[2] - box[0] + box[3] - box[1]) / k
        dpp = 48 / ax_points
        nbins = math.floor((box[2] - box[0]) / k / (FONT_PT * 3))
        ticks = []
        for i in range(3):
            locs = auto_ticks(lims[i][0], lims[i][1], nbins, three_d=True)
            labels = format_ticks(locs)
            keep = _in_interval(locs, *lims[i])
            ticks.append((locs[keep], [s for s, kk in zip(labels, keep) if kk]))
        # panes
        for i in range(3):
            plane = _PLANES[2 * i + 1] if highs[i] else _PLANES[2 * i]
            quad = to_px(tc[list(plane), :2])
            rgba = _PANE_RGBA[i]
            cv.fill_polygon(quad, rgba[:3], rgba[3])
            cv.segments(quad, np.roll(quad, -1, 0), 1.0 * k, np.array(rgba[:3]), rgba[3])
        # grid lines
        for i in range(3):
            locs = ticks[i][0]
            if not len(locs):
                continue
            xyz0 = np.tile(minmax, (len(locs), 1))
            xyz0[:, i] = locs
            lines = np.stack([xyz0, xyz0, xyz0], 1)
            lines[:, 0, i - 2] = maxmin[i - 2]
            lines[:, 2, i - 1] = maxmin[i - 1]
            p = to_px(self.project(M, lines.reshape(-1, 3))[:, :2]).reshape(-1, 3, 2)
            cv.segments(np.concatenate([p[:, 0], p[:, 1]]), np.concatenate([p[:, 1], p[:, 2]]),
                        0.8 * k, to_rgb(GRID_RGB))
        # axis lines, ticks, tick labels, axis labels
        labels = (self.xlabel, self.ylabel, self.zlabel)
        for label in labels:
            self._check_label(label)
        for i in range(3):
            jug = _JUGGLED[i]
            e0 = minmax.copy()
            e0[jug[0]] = maxmin[jug[0]]
            e1 = e0.copy()
            e1[jug[1]] = maxmin[jug[1]]
            pep = to_px(self.project(M, np.stack([e0, e1]))[:, :2])
            cv.segments(pep[:1], pep[1:], 0.8 * k, np.zeros(3))
            td = _TICKDIR[i]
            tickdelta = deltas[td] if highs[td] else -deltas[td]
            axmask = np.ones(3, bool)
            axmask[i] = False
            for loc, s in zip(*ticks[i]):
                pos = e0.copy()
                pos[i] = loc
                p_out, p_in = pos.copy(), pos.copy()
                p_out[td] = e0[td] + 0.1 * tickdelta
                p_in[td] = e0[td] - 0.2 * tickdelta
                tp = to_px(self.project(M, np.stack([p_out, p_in]))[:, :2])
                cv.segments(tp[:1], tp[1:], 0.8 * k, np.zeros(3))
                pos[td] = e0[td]
                lab = pos + axmask * np.copysign(1, pos - centers) * (3.5 + 8.0) * dpp * deltas
                lx, ly = to_px(self.project(M, lab)[:, :2])[0]
                cv.text(s, lx, ly, FONT_PT, dpi, (0, 0, 0), "center", "top")
            if labels[i]:
                mid = 0.5 * (e0 + e1)
                lab = mid + axmask * np.copysign(1, mid - centers) * (4.0 + 21.0) * dpp * deltas
                lx, ly = to_px(self.project(M, lab)[:, :2])[0]
                cv.text(labels[i], lx, ly, FONT_PT, dpi, (0, 0, 0), "center", "center")
        # lines (zorder 2), then the collections above the axes, far first
        clip = box
        lines = [a for a in self.artists if a["kind"] == "line"]
        lines_px = [to_px(self.project(M, a["xyz"])[:, :2]) for a in lines]
        if lines_px:                 # one call: every line is lines.linewidth wide
            cv.segments(np.concatenate([p[:-1] for p in lines_px]),
                        np.concatenate([p[1:] for p in lines_px]), 1.5 * k,
                        np.concatenate([np.repeat(a["rgb"][None], len(p) - 1, 0)
                                        for a, p in zip(lines, lines_px)]), 1.0, clip)
        colls = []
        for a in self.artists:
            if a["kind"] == "scatter":
                v = self.project(M, a["xyz"])
                inside = ((v[:, 0] >= -1) & (v[:, 0] <= 1) & (v[:, 1] >= -1) & (v[:, 1] <= 1)
                          & (v[:, 2] <= 0))
                colls.append((a, v, inside))
        order = sorted(range(len(colls)), key=lambda n: -(
            colls[n][1][:, 2][colls[n][2]].min() if colls[n][2].any() else np.inf))
        points_px = []
        for n in order:
            a, v, inside = colls[n]
            vz = v[:, 2]
            alpha = np.full(len(v), a["alpha"])
            if a["alpha_set"] is None and inside.any():
                # depth shading; an explicit alpha replaces it (mplot3d
                # passes the collection's alpha to to_rgba_array last)
                lo, hi = vz[inside].min(), vz[inside].max()
                if hi > lo:
                    alpha = alpha * (1 - np.clip((vz - lo) / (hi - lo), 0, 1) * 0.7)
            sel = np.flatnonzero(inside)
            sel = sel[np.argsort(-vz[sel], kind="stable")]
            p = to_px(v[sel, :2])
            points_px.append(p)
            cv.markers(p, a["marker"], math.sqrt(a["s"]) * k * a["shrink"], a["rgb"],
                       alpha[sel], a["lw"] * k, clip)
        if self.title:
            cv.text(self.title, (box[0] + box[2]) / 2, box[3] + 6.0 * k, TITLE_PT, dpi,
                    (0, 0, 0), "center", "baseline")
        leg = self._legend_entries() if self.legend_on else None
        if leg is not None:
            leg.draw(cv, box, dpi, np.concatenate(points_px) if points_px else np.zeros((0, 2)),
                     lines_px)


# ---------------------------------------------------------------------------
# the figure
# ---------------------------------------------------------------------------

class Figure:
    """A figure of ``figsize`` inches: ``add_subplot`` / ``subplots`` give
    its axes, ``savefig`` draws and writes it as a PNG."""

    def __init__(self, figsize):
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.axes: List[_AxesBase] = []
        self.grid = (1, 1)
        self.params = dict(SUBPLOT)

    def size_px(self, dpi):
        return int(round(self.figsize[0] * dpi)), int(round(self.figsize[1] * dpi))

    def _cell(self, nrows, ncols, index):
        p = self.params
        cell_w = (p["right"] - p["left"]) / (ncols + p["wspace"] * (ncols - 1))
        cell_h = (p["top"] - p["bottom"]) / (nrows + p["hspace"] * (nrows - 1))
        r, c = divmod(index, ncols)
        x0 = p["left"] + c * cell_w * (1 + p["wspace"])
        y0 = p["top"] - (r + 1) * cell_h - r * cell_h * p["hspace"]
        return [x0, y0, cell_w, cell_h]

    def add_subplot(self, projection: Optional[str] = None):
        ax = (Axes3D if projection == "3d" else Axes)(self, self._cell(1, 1, 0))
        self.axes.append(ax)
        return ax

    def subplots(self, nrows: int, ncols: int):
        self.grid = (nrows, ncols)
        for i in range(nrows * ncols):
            self.axes.append(Axes(self, self._cell(nrows, ncols, i)))
        return list(self.axes)

    def tight_layout(self, pad: float = 1.08):
        """matplotlib's tight_layout: subplot parameters that fit every
        axes' tight box inside the figure with ``pad`` font sizes to spare,
        computed at the figure's layout dpi."""
        nrows, ncols = self.grid
        dpi = LAYOUT_DPI
        fw, fh = self.size_px(dpi)
        W, H = self.figsize
        hsp = np.zeros((nrows, ncols + 1))
        vsp = np.zeros((nrows + 1, ncols))
        for i, ax in enumerate(self.axes):
            r, c = divmod(i, ncols)
            # the cell against the tight box of what is drawn in it
            x0, y0, w, h = ax.pos
            a = (x0 * fw, y0 * fh, (x0 + w) * fw, (y0 + h) * fh)
            t = ax.tight_box(fw, fh, dpi)
            hsp[r, c] += (a[0] - t[0]) / fw
            hsp[r, c + 1] += (t[2] - a[2]) / fw
            vsp[r, c] += (t[3] - a[3]) / fh
            vsp[r + 1, c] += (a[1] - t[1]) / fh
        pad_in = pad * FONT_PT / 72
        left = max(hsp[:, 0].max(), 0) + pad_in / W
        right = max(hsp[:, -1].max(), 0) + pad_in / W
        top = max(vsp[0, :].max(), 0) + pad_in / H
        bottom = max(vsp[-1, :].max(), 0) + pad_in / H
        p = dict(left=left, right=1 - right, bottom=bottom, top=1 - top,
                 wspace=self.params["wspace"], hspace=self.params["hspace"])
        if ncols > 1:
            hspace = hsp[:, 1:-1].max() + pad_in / W
            h_axes = (1 - right - left - hspace * (ncols - 1)) / ncols
            p["wspace"] = hspace / h_axes
        if nrows > 1:
            vspace = vsp[1:-1, :].max() + pad_in / H
            v_axes = (1 - top - bottom - vspace * (nrows - 1)) / nrows
            p["hspace"] = vspace / v_axes
        self.params = p
        for i, ax in enumerate(self.axes):
            ax.pos = self._cell(nrows, ncols, i)

    def render(self, dpi: float) -> np.ndarray:
        """The figure drawn at ``dpi``: (H, W, 3) uint8."""
        w, h = self.size_px(dpi)
        cv = Canvas(w, h)
        for ax in self.axes:
            ax.draw(cv, dpi)
        return cv.to_uint8()

    def savefig(self, path: str, dpi: float = LAYOUT_DPI) -> np.ndarray:
        img = self.render(dpi)
        write_png(path, img)
        return img

"""Image grids and charts of the analyses (``causalvae_tpu/analysis/plots.py``).

Each writes one PNG with the standard library (zlib, struct), no
matplotlib, which the card's machine lacks. Titles, labels, ticks, legends
and colour bars are not drawn: only the data marks.

The grids are 8-bit greyscale: the images of the JAX figure's panels on a
white grid, ``GAP`` pixels apart, each scaled to its own min..max in grey
(as matplotlib's ``imshow`` shows it; ``mip_quality_grid`` up to its
percentile).

- ``recon_triptych``: one row per sample, original | reconstruction
  [| uncertainty] (the vessel trainer's samples, ``counterfactual recon`` and
  ``z-permute``);
- ``intervention_grid``: one row per source, its original, then one decode
  per target condition (``counterfactual do-t``);
- ``sweep_strip``: one row of a do(M_f) sweep (``counterfactual do-m``);
- ``mip_quality_grid``: one row per group of ``per_group`` images
  (``analyze gradcam``'s per-class maps).

The charts are 8-bit RGB (``write_png_rgb``), each panel a light grey frame
(``FRAME``) around its plot area, values mapped linearly onto its pixels
(``Axis``):

- ``heatmap``: one ``CELL`` x ``CELL`` square per entry, coloured by the
  fixed colour map (``COLORMAPS``: viridis, the JAX chart's default) from
  the matrix's min to its max; NaN white;
- ``ranked_bar``: one bar per entry from 0, in the dict's order (the JAX
  chart does not sort, whatever its docstring says);
- ``phase_comparison_bars``: the ``phase1_norm`` and ``phase2_norm`` bars
  of each of ``features`` side by side (``TAB10`` colours 0 and 1);
- ``scatter_diag``: one point per sample; ``hline``, which the JAX chart
  draws as a vertical dashed red line at x = hline, likewise;
- ``embedding_scatter``: one point per sample in ``TAB10[label % 10]``, the
  highlighted samples ringed in red;
- ``predictions_broken_axis``: per group its samples' points and its mean
  with a +-std error bar; two panels (1:3) split at the ``break_quantile``
  quantile when max > quantile * 1.5 and the quantile is finite, else one;
- ``per_feature_prediction_grid``: a grid of ``min(4, F)`` columns and
  ceil(F / columns) rows of panels, each the groups' mean bars with +-std
  error bars; the spare panels blank;
- ``overlap_distributions``: per group a box of the real values and one of
  the predicted (``BOX_REAL``, ``BOX_PRED``): quartiles at numpy's
  25/50/75 percentiles, whiskers to the furthest value within 1.5 IQR, as
  matplotlib's ``boxplot`` draws them, and the values as points.
"""

from __future__ import annotations

import os
import struct
import zlib

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

GAP = 4  # pixels of white between the images of a grid


def _write_png(path: str, img: np.ndarray, color_type: int) -> None:
    h, w = img.shape[:2]

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)  # filter 0 per row
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def write_png_gray(path: str, img: np.ndarray) -> None:
    """(H, W) uint8 -> an 8-bit greyscale PNG at ``path``."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"a greyscale image is (H, W), got {img.shape}")
    _write_png(path, img, 0)


def write_png_rgb(path: str, img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG (colour type 2) at ``path``."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"an RGB image is (H, W, 3), got {img.shape}")
    _write_png(path, img, 2)


def _gray(a: np.ndarray, vmax: Optional[float] = None) -> np.ndarray:
    """An (H, W) or (H, W, 1) image scaled from its min to its max (or to
    ``vmax``, clipped) onto 0..255."""
    a = np.asarray(a, np.float64)
    a = a[..., 0] if a.ndim == 3 else a
    lo = a.min()
    hi = a.max() if vmax is None else vmax
    scaled = np.clip((a - lo) / (hi - lo), 0.0, 1.0) if hi > lo else np.zeros_like(a)
    return np.round(scaled * 255.0).astype(np.uint8)


def grid_png(cells: Sequence[Sequence[Optional[np.ndarray]]], path: str) -> None:
    """Rows of uint8 (h, w) cells, ``GAP`` pixels apart on white, as one PNG;
    a None cell stays white."""
    h, w = next(c for row in cells for c in row if c is not None).shape
    n_rows, n_cols = len(cells), max(len(row) for row in cells)
    grid = np.full((n_rows * h + (n_rows - 1) * GAP, n_cols * w + (n_cols - 1) * GAP),
                   255, np.uint8)
    for i, row in enumerate(cells):
        for j, cell in enumerate(row):
            if cell is not None:
                grid[i * (h + GAP):i * (h + GAP) + h, j * (w + GAP):j * (w + GAP) + w] = cell
    write_png_gray(path, grid)


def recon_triptych(x, recon, path: str, *, uncertainty=None, n: int = 4) -> None:
    """original | reconstruction [| uncertainty] rows for the first ``n``
    samples of NHWC ``x``, ``recon`` (and ``uncertainty``), as one PNG."""
    cols = [np.asarray(x), np.asarray(recon)]
    if uncertainty is not None:
        cols.append(np.asarray(uncertainty))
    n = min(n, len(cols[0]))
    grid_png([[_gray(c[i]) for c in cols] for i in range(n)], path)


def intervention_grid(originals, grid, path: str) -> None:
    """One row per source: its original, then its decode under each target
    of the (sources, targets, H, W[, 1]) ``grid``."""
    grid = np.asarray(grid)
    grid_png([[_gray(originals[i])] + [_gray(g) for g in grid[i]]
              for i in range(grid.shape[0])], path)


def sweep_strip(images, values, path: str, *, feature_name: str = "") -> None:
    """One row of the (n, H, W[, 1]) ``images`` of a do(M_f := value) sweep
    (``values`` and ``feature_name`` are the JAX figure's titles)."""
    grid_png([[_gray(im) for im in np.asarray(images)]], path)


def mip_quality_grid(images, group_labels, path: str, *, per_group: int = 4,
                     percentile: float = 99.0) -> None:
    """One row per group (sorted, as ``np.unique``) of its first
    ``per_group`` images, each scaled from its min to its ``percentile``
    (at least 1e-6), as the JAX figure's ``vmax``; missing cells white."""
    images = np.asarray(images)
    labels = np.asarray(group_labels)
    rows = []
    for g in np.unique(labels):
        sel = np.nonzero(labels == g)[0][:per_group]
        row = [_gray(images[k], vmax=max(np.percentile(images[k], percentile), 1e-6))
               for k in sel]
        rows.append(row + [None] * (per_group - len(row)))
    grid_png(rows, path)


# --------------------------------------------------------------------------
# Charts (RGB)
# --------------------------------------------------------------------------

Color = Tuple[int, int, int]
WHITE: Color = (255, 255, 255)
BLACK: Color = (0, 0, 0)
FRAME: Color = (176, 176, 176)   # a panel's frame
RED: Color = (214, 39, 40)
BAR: Color = (52, 138, 189)      # ranked_bar's "#348ABD"
BOX_REAL: Color = (158, 202, 225)   # "#9ecae1"
BOX_PRED: Color = (253, 174, 107)   # "#fdae6b"
DOT_REAL: Color = (49, 130, 189)    # "#3182bd"
DOT_PRED: Color = (230, 85, 13)     # "#e6550d"
# matplotlib's tab10, its default colour cycle
TAB10: Tuple[Color, ...] = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
                            (148, 103, 189), (140, 86, 75), (227, 119, 194),
                            (127, 127, 127), (188, 189, 34), (23, 190, 207))
# nine evenly spaced anchors of matplotlib's viridis, interpolated linearly
COLORMAPS: Dict[str, np.ndarray] = {
    "viridis": np.array([(68, 1, 84), (71, 45, 123), (59, 82, 139), (44, 114, 142),
                         (33, 145, 140), (40, 174, 128), (94, 201, 98), (173, 220, 48),
                         (253, 231, 37)], np.float64),
}

MARGIN = 8      # pixels of white around the panels
PLOT_H = 200    # plot-area height of a one-panel chart
CELL = 16       # a heatmap entry's square
BAR_W = 12      # a bar's width
SLOT = 24       # pixels per bar (or per group) along x
DOT = 1         # a point mark is a (2 DOT + 1)-pixel square
RING = 5        # the radius of a highlight ring


def colormap(name: str, values: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 colours of ``values`` in [0, 1] on map ``name`` (NaN
    takes the first colour)."""
    if name not in COLORMAPS:
        raise ValueError(f"colour map {name!r} not in {sorted(COLORMAPS)}")
    table = COLORMAPS[name]
    pos = np.clip(np.nan_to_num(np.asarray(values, np.float64)), 0.0, 1.0) * (len(table) - 1)
    i = np.minimum(np.floor(pos).astype(int), len(table) - 2)
    frac = (pos - i)[..., None]
    return np.round(table[i] * (1 - frac) + table[i + 1] * frac).astype(np.uint8)


def span(values, pad: float = 0.05, zero: bool = False) -> Tuple[float, float]:
    """An axis' (lo, hi): the finite values' min and max, widened by
    ``pad`` of their span on each side; with ``zero``, from 0 (bars), not
    widened. A single value spans +-0.5 around it."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    lo, hi = (float(v.min()), float(v.max())) if v.size else (0.0, 1.0)
    if zero:
        lo, hi = min(lo, 0.0), max(hi, 0.0)
        return (lo, hi) if hi > lo else (lo, lo + 1.0)
    if hi <= lo:
        return lo - 0.5, hi + 0.5
    d = (hi - lo) * pad
    return lo - d, hi + d


class Axis:
    """Linear map of [lo, hi] onto ``n`` pixels from ``first`` (rows:
    ``flip``, hi at the top)."""

    def __init__(self, lo: float, hi: float, first: int, n: int, flip: bool = False):
        self.lo, self.hi, self.first, self.n, self.flip = lo, hi, first, n, flip

    def __call__(self, v) -> np.ndarray:
        frac = (np.asarray(v, np.float64) - self.lo) / (self.hi - self.lo)
        if self.flip:
            frac = 1.0 - frac
        return self.first + np.round(frac * (self.n - 1)).astype(int)


class Canvas:
    """A white (h, w) RGB image to draw marks on; out-of-range pixels are
    clipped."""

    def __init__(self, h: int, w: int):
        self.img = np.full((h, w, 3), 255, np.uint8)

    def rect(self, y0: int, y1: int, x0: int, x1: int, color: Color) -> None:
        """Fill rows y0..y1 and columns x0..x1, inclusive, in any order."""
        h, w = self.img.shape[:2]
        ya, yb = sorted((int(y0), int(y1)))
        xa, xb = sorted((int(x0), int(x1)))
        ya, yb, xa, xb = max(ya, 0), min(yb, h - 1), max(xa, 0), min(xb, w - 1)
        if ya <= yb and xa <= xb:
            self.img[ya:yb + 1, xa:xb + 1] = color

    def frame(self, top: int, left: int, h: int, w: int) -> None:
        """A panel's 1-pixel frame just outside its h x w plot area."""
        self.rect(top - 1, top - 1, left - 1, left + w, FRAME)
        self.rect(top + h, top + h, left - 1, left + w, FRAME)
        self.rect(top - 1, top + h, left - 1, left - 1, FRAME)
        self.rect(top - 1, top + h, left + w, left + w, FRAME)

    def dot(self, y: int, x: int, color: Color, r: int = DOT) -> None:
        self.rect(y - r, y + r, x - r, x + r, color)

    def ring(self, y: int, x: int, color: Color, r: int = RING) -> None:
        t = np.linspace(0.0, 2 * np.pi, 8 * r, endpoint=False)
        for yy, xx in zip(np.round(y + r * np.sin(t)), np.round(x + r * np.cos(t))):
            self.rect(yy, yy, xx, xx, color)

    def vdash(self, x: int, y0: int, y1: int, color: Color) -> None:
        """A dashed vertical line (4 on, 3 off)."""
        for y in range(min(y0, y1), max(y0, y1) + 1):
            if (y - min(y0, y1)) % 7 < 4:
                self.rect(y, y, x, x, color)

    def errorbar(self, x: int, y_lo: int, y_mid: int, y_hi: int) -> None:
        """matplotlib's errorbar(fmt="_", capsize): a black vertical line
        from y_lo to y_hi with caps, and the mean's short horizontal mark."""
        self.rect(y_lo, y_hi, x, x, BLACK)
        for y in (y_lo, y_hi):
            self.rect(y, y, x - 2, x + 2, BLACK)
        self.rect(y_mid, y_mid, x - 4, x + 4, BLACK)

    def save(self, path: str) -> None:
        write_png_rgb(path, self.img)


def heatmap(matrix, path: str, *, row_names=None, col_names=None, title: str = "",
            cmap: str = "viridis", annotate: bool = False, fmt: str = "{:.2f}") -> None:
    """The (R, C) matrix as R x C squares of ``CELL`` pixels coloured from
    its finite min (the map's first colour) to its max (the last); a
    constant matrix takes the first colour, NaN stays white (names, title
    and annotations are the JAX figure's text)."""
    m = np.asarray(matrix, np.float64)
    r, c = m.shape
    finite = m[np.isfinite(m)]
    lo, hi = (float(finite.min()), float(finite.max())) if finite.size else (0.0, 1.0)
    hi = hi if hi > lo else lo + 1.0
    colors = colormap(cmap, (m - lo) / (hi - lo))
    canvas = Canvas(2 * MARGIN + r * CELL, 2 * MARGIN + c * CELL)
    for i in range(r):
        for j in range(c):
            if np.isfinite(m[i, j]):
                y, x = MARGIN + i * CELL, MARGIN + j * CELL
                canvas.rect(y, y + CELL - 1, x, x + CELL - 1, tuple(colors[i, j]))
    canvas.frame(MARGIN, MARGIN, r * CELL, c * CELL)
    canvas.save(path)


def _bars(canvas: Canvas, y: Axis, left: int, values: Sequence[float],
          colors: Sequence[Color], offsets: Sequence[int], errs=None) -> None:
    """Bars from 0 to each value, the k-th of slot i at
    left + i * SLOT + offsets[k]; optional +-err error bars at their centres."""
    zero = int(y(0.0))
    for i, vals in enumerate(values):
        for k, v in enumerate(np.atleast_1d(vals)):
            x0 = left + i * SLOT + offsets[k]
            if np.isfinite(v):
                canvas.rect(zero, int(y(v)), x0, x0 + BAR_W - 1, colors[k])
            if errs is not None and np.isfinite(v):
                e = float(np.atleast_1d(errs[i])[k])
                xc = x0 + BAR_W // 2
                canvas.errorbar(xc, int(y(v - e)), int(y(v)), int(y(v + e)))


def ranked_bar(scores: Dict[str, float], path: str, *, title: str = "",
               ylabel: str = "") -> None:
    """One bar per entry of ``scores`` from 0, in the dict's order (the
    JAX chart draws them unsorted too)."""
    vals = [float(v) for v in scores.values()]
    n = len(vals)
    canvas = Canvas(2 * MARGIN + PLOT_H, 2 * MARGIN + n * SLOT)
    y = Axis(*span(vals, zero=True), MARGIN, PLOT_H, flip=True)
    _bars(canvas, y, MARGIN, vals, [BAR], [(SLOT - BAR_W) // 2])
    canvas.frame(MARGIN, MARGIN, PLOT_H, n * SLOT)
    canvas.save(path)


def phase_comparison_bars(comparison: Dict, path: str) -> None:
    """``phase1_norm`` (TAB10[0]) and ``phase2_norm`` (TAB10[1]) of each of
    ``features``, side by side from 0."""
    names = comparison["features"]
    pairs = [(comparison["phase1_norm"][n], comparison["phase2_norm"][n]) for n in names]
    canvas = Canvas(2 * MARGIN + PLOT_H, 2 * MARGIN + len(names) * SLOT)
    y = Axis(*span(pairs, zero=True), MARGIN, PLOT_H, flip=True)
    _bars(canvas, y, MARGIN, pairs, TAB10[:2], [0, BAR_W])
    canvas.frame(MARGIN, MARGIN, PLOT_H, len(names) * SLOT)
    canvas.save(path)


SCATTER_W = 240  # plot-area width of the scatter charts


def _scatter_axes(xs, ys, h: int = PLOT_H, w: int = SCATTER_W) -> Tuple[Axis, Axis]:
    return (Axis(*span(xs), MARGIN, w), Axis(*span(ys), MARGIN, h, flip=True))


def scatter_diag(x_vals, y_vals, path: str, *, xlabel: str = "", ylabel: str = "",
                 title: str = "", hline: Optional[float] = None, labels=None) -> None:
    """One TAB10[0] point per (x, y); ``hline`` a dashed red vertical line
    at x = hline (the JAX chart's ``axvline``), inside the x range (labels
    are the JAX figure's annotations)."""
    xs = np.asarray(x_vals, np.float64).ravel()
    ys = np.asarray(y_vals, np.float64).ravel()
    ax, ay = _scatter_axes(xs if hline is None else np.append(xs, hline), ys)
    canvas = Canvas(2 * MARGIN + PLOT_H, 2 * MARGIN + SCATTER_W)
    if hline is not None:
        canvas.vdash(int(ax(hline)), MARGIN, MARGIN + PLOT_H - 1, RED)
    for px, py in zip(ax(xs), ay(ys)):
        canvas.dot(py, px, TAB10[0])
    canvas.frame(MARGIN, MARGIN, PLOT_H, SCATTER_W)
    canvas.save(path)


def embedding_scatter(emb, labels, path: str, *, title: str = "t-SNE",
                      highlight_idx=None) -> None:
    """A 2-D embedding, one point per sample in TAB10[label % 10]; the
    samples of ``highlight_idx`` ringed in red."""
    emb = np.asarray(emb, np.float64)
    labels = np.asarray(labels).astype(int).ravel()
    ax, ay = _scatter_axes(emb[:, 0], emb[:, 1], SCATTER_W, SCATTER_W)
    canvas = Canvas(2 * MARGIN + SCATTER_W, 2 * MARGIN + SCATTER_W)
    px, py = ax(emb[:, 0]), ay(emb[:, 1])
    for i in range(len(emb)):
        canvas.dot(py[i], px[i], TAB10[labels[i] % 10])
    if highlight_idx is not None:
        for i in np.atleast_1d(highlight_idx):
            canvas.ring(py[i], px[i], RED)
    canvas.frame(MARGIN, MARGIN, SCATTER_W, SCATTER_W)
    canvas.save(path)


def broken_axis_split(values, break_quantile: float = 0.9) -> Optional[float]:
    """The JAX chart's rule: the cut (the ``break_quantile`` quantile) when
    max > cut * 1.5 and the cut is finite, else None (one panel)."""
    allv = np.asarray(values, np.float64).ravel()
    cut = float(np.quantile(allv, break_quantile))
    return cut if (allv.max() > cut * 1.5 and np.isfinite(cut)) else None


BROKEN_TOP_H = 60  # the upper panel of a broken axis (1 : 3 of PLOT_H + 20)


def predictions_broken_axis(mu_by_group: Dict[str, np.ndarray], path: str, *,
                            feature_name: str = "", break_quantile: float = 0.9) -> None:
    """Per group (in the dict's order, TAB10 cycling) its values as points
    and its mean with a +-std error bar; split into an upper panel
    (cut .. max * 1.05) and a lower one three times as tall (min .. cut)
    where ``broken_axis_split`` says so, else one panel over the data."""
    vals = [np.asarray(v, np.float64).ravel() for v in mu_by_group.values()]
    allv = np.concatenate(vals)
    cut = broken_axis_split(allv, break_quantile)
    width = len(vals) * SLOT
    if cut is None:
        panels = [(MARGIN, PLOT_H, span(allv))]
        h = 2 * MARGIN + PLOT_H
    else:
        low_h = 3 * BROKEN_TOP_H
        panels = [(MARGIN, BROKEN_TOP_H, (cut, float(allv.max()) * 1.05)),
                  (2 * MARGIN + BROKEN_TOP_H, low_h, (float(allv.min()), cut))]
        h = 3 * MARGIN + BROKEN_TOP_H + low_h
    canvas = Canvas(h, 2 * MARGIN + width)
    for top, ph, (lo, hi) in panels:
        y = Axis(lo, hi, top, ph, flip=True)
        sub = Canvas(h, 2 * MARGIN + width)  # drawn whole, kept inside the panel
        for i, v in enumerate(vals):
            xc = MARGIN + i * SLOT + SLOT // 2
            for py in y(v):
                sub.dot(py, xc, TAB10[i % 10])
            sub.errorbar(xc, int(y(v.mean() - v.std())), int(y(v.mean())),
                         int(y(v.mean() + v.std())))
        canvas.img[top:top + ph, MARGIN:MARGIN + width] = \
            sub.img[top:top + ph, MARGIN:MARGIN + width]
        canvas.frame(top, MARGIN, ph, width)
    canvas.save(path)


GRID_PANEL_H = 100  # a panel of per_feature_prediction_grid


def per_feature_prediction_grid(mu_by_group: Dict[str, np.ndarray],
                                feature_names: Sequence[str], path: str) -> None:
    """One panel per feature in a grid of min(4, F) columns: the groups'
    means of that feature as TAB10[0] bars from 0 with +-std error bars;
    the spare panels of the last row blank."""
    arrs = [np.asarray(v, np.float64) for v in mu_by_group.values()]
    n_feat = len(feature_names)
    ncols = min(4, n_feat)
    nrows = (n_feat + ncols - 1) // ncols
    pw = len(arrs) * SLOT
    canvas = Canvas(MARGIN + nrows * (GRID_PANEL_H + MARGIN), MARGIN + ncols * (pw + MARGIN))
    for f in range(n_feat):
        top = MARGIN + (f // ncols) * (GRID_PANEL_H + MARGIN)
        left = MARGIN + (f % ncols) * (pw + MARGIN)
        means = [a[:, f].mean() for a in arrs]
        stds = [a[:, f].std() for a in arrs]
        y = Axis(*span(np.concatenate([np.subtract(means, stds), np.add(means, stds)]),
                       zero=True), top, GRID_PANEL_H, flip=True)
        _bars(canvas, y, left, means, [TAB10[0]], [(SLOT - BAR_W) // 2], errs=stds)
        canvas.frame(top, left, GRID_PANEL_H, pw)
    canvas.save(path)


def box_stats(v) -> Tuple[float, float, float, float, float]:
    """matplotlib ``boxplot``'s (whisker low, Q1, median, Q3, whisker high):
    numpy's 25/50/75 percentiles and the furthest values within 1.5 IQR."""
    v = np.asarray(v, np.float64).ravel()
    q1, med, q3 = np.percentile(v, [25, 50, 75])
    iqr = q3 - q1
    lo = v[v >= q1 - 1.5 * iqr].min()
    hi = v[v <= q3 + 1.5 * iqr].max()
    return float(lo), float(q1), float(med), float(q3), float(hi)


def overlap_distributions(real_by_group: Dict[str, np.ndarray],
                          pred_by_group: Dict[str, np.ndarray], path: str, *,
                          feature_name: str = "") -> None:
    """Per group (the order of ``real_by_group``) a box of its real values
    (``BOX_REAL``, left) and of its predicted ones (``BOX_PRED``, right):
    Q1..Q3 filled, the median a black line, whiskers with caps
    (``box_stats``), and each value a point (``DOT_REAL``, ``DOT_PRED``)."""
    names = list(real_by_group)
    series = [(np.asarray(real_by_group[n], np.float64).ravel(),
               np.asarray(pred_by_group[n], np.float64).ravel()) for n in names]
    y = Axis(*span(np.concatenate([np.concatenate(p) for p in series])), MARGIN, PLOT_H,
             flip=True)
    canvas = Canvas(2 * MARGIN + PLOT_H, 2 * MARGIN + len(names) * SLOT)
    for i, pair in enumerate(series):
        for k, (v, box, dot) in enumerate(zip(pair, (BOX_REAL, BOX_PRED),
                                              (DOT_REAL, DOT_PRED))):
            x0 = MARGIN + i * SLOT + k * (BAR_W - 2) + 1
            xc = x0 + (BAR_W - 2) // 2
            lo, q1, med, q3, hi = (int(p) for p in y(box_stats(v)))
            canvas.rect(lo, q1, xc, xc, BLACK)
            canvas.rect(q3, hi, xc, xc, BLACK)
            for w in (lo, hi):
                canvas.rect(w, w, x0 + 2, x0 + BAR_W - 5, BLACK)
            canvas.rect(q1, q3, x0, x0 + BAR_W - 3, box)
            canvas.rect(med, med, x0, x0 + BAR_W - 3, BLACK)
            for py in y(v):
                canvas.rect(py, py, xc, xc, dot)
    canvas.frame(MARGIN, MARGIN, PLOT_H, len(names) * SLOT)
    canvas.save(path)

"""Image grids of the analyses (``causalvae_tpu/analysis/plots.py``).

Each writes one 8-bit greyscale PNG with the standard library (zlib,
struct), no matplotlib: the images of the JAX figure's panels on a white
grid, ``GAP`` pixels apart, each scaled to its own min..max in grey (as
matplotlib's ``imshow`` shows it; ``mip_quality_grid`` up to its
percentile). Titles, labels and colour bars are not drawn.

- ``recon_triptych``: one row per sample, original | reconstruction
  [| uncertainty] (the vessel trainer's samples, ``counterfactual recon`` and
  ``z-permute``);
- ``intervention_grid``: one row per source, its original, then one decode
  per target condition (``counterfactual do-t``);
- ``sweep_strip``: one row of a do(M_f) sweep (``counterfactual do-m``);
- ``mip_quality_grid``: one row per group of ``per_group`` images
  (``analyze gradcam``'s per-class maps).

The JAX package's charts (heatmap, bars, scatter, embedding, broken axis,
overlap) are not ported.
"""

from __future__ import annotations

import os
import struct
import zlib

from typing import Optional, Sequence

import numpy as np

GAP = 4  # pixels of white between the images of a grid


def write_png_gray(path: str, img: np.ndarray) -> None:
    """(H, W) uint8 -> an 8-bit greyscale PNG at ``path``."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)  # filter 0 per row
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


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

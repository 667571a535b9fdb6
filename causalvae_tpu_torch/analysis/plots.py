"""Training artifacts as images (``causalvae_tpu/analysis/plots.py``).

``recon_triptych`` writes the sample-reconstruction grid of the vessel
trainer: one row per sample, original | reconstruction, each image scaled
to its own min..max in grey (as matplotlib's ``imshow`` with the gray map
shows it). It writes an 8-bit greyscale PNG with the standard library
(zlib, struct): no matplotlib. The JAX version's titles and its third,
uncertainty column are not drawn; the other plots are not ported.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_GAP = 4  # pixels of white between the images of the grid


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


def _gray(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float64)
    a = a[..., 0] if a.ndim == 3 else a
    lo, hi = a.min(), a.max()
    scaled = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    return np.round(scaled * 255.0).astype(np.uint8)


def recon_triptych(x, recon, path: str, *, n: int = 4) -> None:
    """original | reconstruction rows for the first ``n`` samples of NHWC
    ``x`` and ``recon``, as one PNG."""
    x, recon = np.asarray(x), np.asarray(recon)
    n = min(n, len(x))
    h, w = x.shape[1:3]
    grid = np.full((n * h + (n - 1) * _GAP, 2 * w + _GAP), 255, np.uint8)
    for i in range(n):
        r = i * (h + _GAP)
        grid[r:r + h, :w] = _gray(x[i])
        grid[r:r + h, w + _GAP:] = _gray(recon[i])
    write_png_gray(path, grid)

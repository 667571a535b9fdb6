"""MNIST input pipeline (``causalvae_tpu/data/mnist.py``): the morphology M
is measured once for the whole corpus and cached, and the trainer keeps the
corpus on the device and indexes it per batch (``train/workloads.py``).

``load_idx`` / ``load_mnist_dir`` read the IDX files a user supplies; without
them, ``synthetic_mnist`` renders a deterministic digit corpus with PIL (its
glyphs depend on the PIL build: ``ImageFont.load_default()`` is a FreeType
font on PIL >= 10.1 built with FreeType, a bitmap font otherwise). PIL is
imported inside that function only.

``MorphDataset.batches`` shuffles with the numpy generator it is given,
exactly as the JAX dataset does, so both packages see one batch order.
``build_morph_mnist`` keeps the JAX cache file and its digest, whose key
names the extractor flavour; the device extractor is not ported yet.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import struct
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from causalvae_tpu_torch.ops import morphology_host


def load_idx(path: str) -> np.ndarray:
    """Parse an (optionally gzipped) IDX file (MNIST distribution format)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"bad IDX magic in {path}")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32, 13: np.float32,
                 14: np.float64}[dtype_code]
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
        return data.reshape(dims)


def load_mnist_dir(root: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Load images/labels from a directory holding the 4 standard IDX files."""
    prefix = "train" if train else "t10k"
    for ext in ("", ".gz"):
        ipath = os.path.join(root, f"{prefix}-images-idx3-ubyte{ext}")
        lpath = os.path.join(root, f"{prefix}-labels-idx1-ubyte{ext}")
        if os.path.exists(ipath) and os.path.exists(lpath):
            images = load_idx(ipath).astype(np.float32) / 255.0
            labels = load_idx(lpath).astype(np.int32)
            return images, labels
    raise FileNotFoundError(f"no MNIST IDX files under {root}")


def synthetic_mnist(n: int, seed: int = 0, n_classes: int = 10
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic digit corpus: PIL-rendered glyphs with random
    placement/scale jitter. Morphology depends on the digit class, so the
    T -> M mechanism is learnable like on real MNIST."""
    from PIL import Image, ImageDraw, ImageFont

    rng = np.random.default_rng(seed)
    font = ImageFont.load_default()
    images = np.zeros((n, 28, 28), dtype=np.float32)
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    for i in range(n):
        d = int(labels[i])
        canvas = Image.new("L", (16, 16), 0)
        draw = ImageDraw.Draw(canvas)
        draw.text((3, 2), str(d), fill=255, font=font)
        scale = rng.uniform(1.6, 2.2)
        size = max(8, int(16 * scale))
        glyph = canvas.resize((size, size), Image.BILINEAR)
        big = Image.new("L", (28, 28), 0)
        ox = int(rng.integers(-2, 3)) + (28 - size) // 2
        oy = int(rng.integers(-2, 3)) + (28 - size) // 2
        big.paste(glyph, (ox, oy))
        if rng.random() < 0.5:
            big = big.rotate(float(rng.uniform(-12, 12)), resample=Image.BILINEAR)
        images[i] = np.asarray(big, dtype=np.float32) / 255.0
    return images, labels


@dataclass
class MorphDataset:
    """Images (N, 28, 28, 1), morphology m (N, F), one-hot t (N, T) and the
    labels, as float32 (labels int32) numpy; trainers move them to the
    device once."""

    x: np.ndarray
    m: np.ndarray
    t: np.ndarray
    labels: np.ndarray

    def __len__(self):
        return self.x.shape[0]

    def batch_indices(self, batch_size: int, rng: Optional[np.random.Generator] = None,
                      drop_remainder: bool = True) -> Iterator[np.ndarray]:
        """The row indices of each batch of ``batches``, in its order."""
        n = len(self)
        idx = np.arange(n)
        if rng is not None:
            rng.shuffle(idx)
        batch_size = min(batch_size, n)  # corpora smaller than one batch
        stop = n - (n % batch_size) if drop_remainder else n
        for s in range(0, stop, batch_size):
            yield idx[s : s + batch_size]

    def batches(self, batch_size: int, rng: Optional[np.random.Generator] = None,
                drop_remainder: bool = True) -> Iterator[dict]:
        for sel in self.batch_indices(batch_size, rng, drop_remainder):
            yield {"x": self.x[sel], "m": self.m[sel], "t": self.t[sel],
                   "labels": self.labels[sel]}


def build_morph_mnist(
    images: np.ndarray,
    labels: np.ndarray,
    n_features: int = 12,
    t_dim: int = 10,
    limit_count: Optional[int] = None,
    cache_path: Optional[str] = None,
    use_device_extractor: bool = False,
) -> MorphDataset:
    """Pair images with precomputed morphology + one-hot condition
    (ref dataset.py:101-132 cache semantics, minus the per-item host loop).

    ``use_device_extractor`` (the JAX package's vmapped on-device
    morphology) raises ``NotImplementedError``: the port's device morphology
    is not written yet."""
    if use_device_extractor:
        raise NotImplementedError(
            "build_morph_mnist(use_device_extractor=True) needs the device "
            "morphology (ops/morphology.py), which the port does not have yet; "
            "the host extractor is the default")
    if limit_count is not None:
        images, labels = images[:limit_count], labels[:limit_count]
    # content digest ties the cache to THIS corpus AND extractor flavor —
    # swapping --data between equal-sized datasets, or toggling the device
    # extractor, must not reuse stale M
    digest = hashlib.sha1(
        np.ascontiguousarray(images[:: max(1, len(images) // 64)]).tobytes()
        + f"|{n_features}|host".encode()
    ).hexdigest()
    m = None
    if cache_path and os.path.exists(cache_path):
        blob = np.load(cache_path, allow_pickle=False)
        if (blob["m"].shape == (len(images), n_features)
                and "digest" in blob and str(blob["digest"]) == digest):
            m = blob["m"]
    if m is None:
        m = morphology_host.extract_features_batch(images, n_features)
        if cache_path:
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            np.savez(cache_path, m=m, digest=digest)
    t = np.eye(t_dim, dtype=np.float32)[labels]
    return MorphDataset(
        x=images[..., None].astype(np.float32), m=m.astype(np.float32),
        t=t, labels=labels.astype(np.int32),
    )

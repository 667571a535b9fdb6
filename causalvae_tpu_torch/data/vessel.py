"""Vessel-MIP input pipeline (``causalvae_tpu/data/vessel.py``): host decode
and metadata, the image transform on the device, batches for the trainer.

The data contract of the JAX package, kept as it is:

  * CSV rows matched to ``*.vessel.mip.tiff`` files by the trailing integer
    image ID of the file name ("H11-503938.vessel.mip.tiff" -> 503938);
  * the 12 morphology feature columns; rows with a missing feature or
    group dropped; StandardScaler (population std, 0 -> 1) fit on every
    matched row;
  * T = the index of ``group_name`` among the sorted group names, one-hot;
  * the stratified split seeded 42: per group 1 val, 1 test, the rest
    train (fewer than 3 members: the degraded split), and ``"all"``;
  * train mode enumerates the 4x (sample, aug) pair space (aug 0 none,
    1 horizontal, 2 vertical, 3 both flips);
  * resize (antialiased bilinear), flip, per-image min-max, mean binarize,
    in that order, on the device (``make_preprocess``).

``scan_corpus`` reads the CSV with the standard library, not pandas, with
pandas' reading of it: an empty cell or one of pandas' NA strings is
missing, a feature cell that is not a number is missing, ``Image ID`` is
matched as an integer, and ``group_name`` is typed as pandas types a column
(``_group_key``): ints if every present cell is an integer, else floats if
every one is a number, else text; the groups sort by that type, so groups
"1", "2", "10" come in that order.

``load_raw`` decodes a file with the port's own native decoder
(``causalvae_tpu_torch/native``: TIFF 8/16-bit unsigned or 32-bit float
grayscale, uncompressed, LZW, Deflate or PackBits, predictor 2; NPY), on the
CPU and on the card alike; only a file that decoder refuses goes to tifffile,
else PIL, each imported only then. File-backed corpora are batched by the
native thread pool (``iterate_batches(use_native=...)``) where it builds.
This module imports neither pandas, PIL nor tifffile at import.
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import math
import os
import re
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from causalvae_tpu_torch.device import DeviceLike, resolve_device

FEATURE_COLUMNS = (
    "Node count", "Extremity Count", "Junction Count", "Edge count",
    "Segment Count", "Branch Count", "Isolated Edge Count",
    "Subnetwork Count(edge count >= 3)", "Total Vessel Length (μm)",
    "Mean Tortuosity", "Total Vessel Volume (μm^3)", "Average Vessel Radius (μm)",
)

# the strings pandas.read_csv reads as missing by default
_NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


# ---------------------------------------------------------------------------
# Device-side preprocessing
# ---------------------------------------------------------------------------

def make_preprocess(img_hw: Tuple[int, int], device: DeviceLike = None):
    """``pre(raw (B, h, w), aug (B,)) -> (B, H, W, 1)`` float32 on ``device``.

    Resize (antialiased bilinear, half-pixel centres, as
    ``jax.image.resize(..., "bilinear", antialias=True)``) -> flip by aug
    mode (1 horizontal, 2 vertical, 3 both) -> per-image min-max (0 where
    the image is constant) -> binarize at the image's mean."""
    dev = resolve_device(device)
    H, W = img_hw

    def pre(raw: torch.Tensor, aug: torch.Tensor) -> torch.Tensor:
        img = raw.to(dev, torch.float32)
        aug = aug.to(dev)
        img = F.interpolate(img[:, None], size=(H, W), mode="bilinear",
                            align_corners=False, antialias=True)[:, 0]
        h_flip = ((aug == 1) | (aug == 3))[:, None, None]
        v_flip = ((aug == 2) | (aug == 3))[:, None, None]
        img = torch.where(h_flip, img.flip(-1), img)
        img = torch.where(v_flip, img.flip(-2), img)
        lo = img.amin(dim=(1, 2), keepdim=True)
        hi = img.amax(dim=(1, 2), keepdim=True)
        img = torch.where(hi > lo, (img - lo) / (hi - lo), torch.zeros_like(img))
        img = (img > img.mean(dim=(1, 2), keepdim=True)).to(torch.float32)
        return img[..., None]

    return pre


# ---------------------------------------------------------------------------
# Corpus scan (host)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VesselCorpus:
    paths: List[str]                 # len N (empty strings for in-memory corpora)
    raw_images: Optional[np.ndarray]  # (N, h, w) float32 if preloaded, else None
    m_raw: np.ndarray                # (N, 12) unscaled
    m: np.ndarray                    # (N, 12) standardized
    t_idx: np.ndarray                # (N,) int32
    group_names: List            # str, or int/float as pandas types the column
    scaler_mean: np.ndarray
    scaler_scale: np.ndarray
    splits: Dict[str, np.ndarray]    # 'train'/'val'/'test'/'all' -> indices

    @property
    def t_dim(self) -> int:
        return len(self.group_names)

    def one_hot_t(self, idx: np.ndarray) -> np.ndarray:
        return np.eye(self.t_dim, dtype=np.float32)[self.t_idx[idx]]

    def inverse_scale_m(self, m_norm: np.ndarray) -> np.ndarray:
        """Back to real units."""
        return m_norm * self.scaler_scale + self.scaler_mean


def _id_from_filename(basename: str) -> Optional[int]:
    try:
        return int(basename.split("-")[-1].split(".")[0])
    except (ValueError, IndexError):
        return None


def _stratified_split(t_idx: np.ndarray, seed: int = 42) -> Dict[str, np.ndarray]:
    """Per-group 1 val / 1 test / rest train."""
    rng = np.random.RandomState(seed)
    train, val, test = [], [], []
    for g in np.unique(t_idx):
        members = np.nonzero(t_idx == g)[0]
        rng.shuffle(members)
        if len(members) >= 3:
            val.append(members[0])
            test.append(members[1])
            train.extend(members[2:])
        elif len(members) == 2:
            val.append(members[0])
            train.append(members[1])
        elif len(members) == 1:
            train.append(members[0])
    for part in (train, val, test):
        rng.shuffle(part)
    return {
        "train": np.asarray(train, np.int32),
        "val": np.asarray(val, np.int32),
        "test": np.asarray(test, np.int32),
        "all": np.arange(len(t_idx), dtype=np.int32),
    }


def _missing(cell: Optional[str]) -> bool:
    return cell is None or cell in _NA_STRINGS


def _number(cell: Optional[str]) -> float:
    """A feature cell as pandas reads it: NaN if missing or not a number."""
    if _missing(cell):
        return math.nan
    try:
        return float(cell)
    except ValueError:
        return math.nan


def _image_id(cell: Optional[str]) -> Optional[int]:
    """``Image ID`` as an integer ("503938" and "503938.0" alike), else None."""
    value = _number(cell)
    return int(value) if math.isfinite(value) and value.is_integer() else None


_INT = re.compile(r"\s*[+-]?\d+\s*")


def _group_key(cells: List[Optional[str]]) -> Callable[[str], object]:
    """The type pandas gives a ``group_name`` column of these cells: int if
    every present cell is an integer and none is missing (a missing cell
    makes pandas read an int column as float), float if every present cell
    is a number, else str."""
    present = [c for c in cells if not _missing(c)]
    if all(_INT.fullmatch(c) for c in present):
        return float if len(present) < len(cells) else int
    if all("_" not in c and not math.isnan(_number(c)) for c in present):
        return float
    return str


def scan_corpus(csv_path: str, data_root: str, seed: int = 42) -> VesselCorpus:
    """CSV x file-tree matching + scaling + splits (host metadata only)."""
    with open(csv_path, newline="", encoding="utf-8-sig") as f:
        rows = list(csv.DictReader(f))
    files = glob.glob(
        os.path.join(data_root, "**", "*.vessel.mip.tiff"), recursive=True
    )
    id_to_path = {}
    for fpath in files:
        img_id = _id_from_filename(os.path.basename(fpath))
        if img_id is not None:
            id_to_path[img_id] = fpath

    # every named group of the CSV counts, matched or not (pandas' dropna().unique())
    cells = [r.get("group_name") for r in rows]
    key = _group_key(cells)
    group_names = sorted({key(c) for c in cells if not _missing(c)})
    group_to_idx = {n: i for i, n in enumerate(group_names)}

    paths, m_rows, t_rows = [], [], []
    for row in rows:
        img_id = _image_id(row.get("Image ID"))
        if img_id not in id_to_path or _missing(row.get("group_name")):
            continue
        m_vals = np.asarray([_number(row.get(c)) for c in FEATURE_COLUMNS], np.float64)
        if np.isnan(m_vals).any():
            continue
        paths.append(id_to_path[img_id])
        m_rows.append(m_vals)
        t_rows.append(group_to_idx[key(row["group_name"])])

    m_raw = np.asarray(m_rows, np.float64)
    mean = m_raw.mean(axis=0)
    scale = m_raw.std(axis=0)
    scale = np.where(scale == 0.0, 1.0, scale)  # StandardScaler semantics
    m = ((m_raw - mean) / scale).astype(np.float32)
    t_idx = np.asarray(t_rows, np.int32)
    return VesselCorpus(
        paths=paths, raw_images=None, m_raw=m_raw.astype(np.float32), m=m,
        t_idx=t_idx, group_names=list(group_names),
        scaler_mean=mean.astype(np.float32), scaler_scale=scale.astype(np.float32),
        splits=_stratified_split(t_idx, seed),
    )


def load_raw(path: str) -> np.ndarray:
    """Host decode of one image file at its own size, float32: the native
    decoder; for a file it refuses, tifffile, else PIL, each imported only
    then. Raises ValueError naming the file and the TIFF tags the native
    loader could not read when neither is installed."""
    from causalvae_tpu_torch import native

    try:
        return native.decode_raw(path)
    except ValueError as e:
        refused = e
    try:
        import tifffile
    except ImportError:
        pass
    else:
        return np.asarray(tifffile.imread(path), np.float32)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"the native loader cannot decode {refused}, and neither "
                         "tifffile nor PIL is installed") from refused
    with Image.open(path) as im:
        return np.asarray(im, np.float32)


# ---------------------------------------------------------------------------
# Synthetic corpus (stands in where no TIFF tree is at hand)
# ---------------------------------------------------------------------------

def synthetic_corpus(
    n: int = 60, n_groups: int = 19, hw: Tuple[int, int] = (96, 160), seed: int = 0
) -> VesselCorpus:
    """Random vessel-like branching masks + group-dependent morphology rows,
    the same arrays as the JAX package's for the same arguments.

    Feature values are derived from the generated geometry (counts/lengths),
    so mechanism learning (T -> M) behaves like the real corpus."""
    rng = np.random.default_rng(seed)
    h, w = hw
    images = np.zeros((n, h, w), np.float32)
    m_raw = np.zeros((n, 12), np.float64)
    t_idx = rng.integers(0, n_groups, n).astype(np.int32)
    for i in range(n):
        g = int(t_idx[i])
        n_branches = 3 + g % 7 + int(rng.integers(0, 3))
        total_len = 0.0
        img = np.zeros((h, w), np.float32)
        for _ in range(n_branches):
            r = float(rng.uniform(0.2, 0.8) * h)
            c = float(rng.uniform(0.1, 0.3) * w)
            ang = float(rng.uniform(-0.6, 0.6))
            L = int(rng.integers(w // 4, int(w * 0.7)))
            thickness = 1 + g % 3
            for s in range(L):
                ang += float(rng.normal(0, 0.08))
                r += np.sin(ang)
                c += np.cos(ang)
                ri, ci = int(r), int(c)
                if 1 <= ri < h - 1 and 1 <= ci < w - 1:
                    img[ri - thickness + 1 : ri + thickness, ci - thickness + 1 : ci + thickness] = 1.0
                    total_len += 1.0
        images[i] = img
        area = float(img.sum())
        m_raw[i] = [
            n_branches * 2.0, n_branches * 1.1, n_branches * 0.9, n_branches * 2.2,
            n_branches * 2.0, n_branches, rng.uniform(0, 2), max(1.0, n_branches / 3),
            total_len, 1.0 + 0.02 * (g % 5), area * 2.0, 1.0 + (g % 3),
        ]
    mean = m_raw.mean(axis=0)
    scale = np.where(m_raw.std(axis=0) == 0, 1.0, m_raw.std(axis=0))
    m = ((m_raw - mean) / scale).astype(np.float32)
    group_names = [f"group_{i:02d}" for i in range(n_groups)]
    return VesselCorpus(
        paths=[""] * n, raw_images=images, m_raw=m_raw.astype(np.float32), m=m,
        t_idx=t_idx, group_names=group_names,
        scaler_mean=mean.astype(np.float32), scaler_scale=scale.astype(np.float32),
        splits=_stratified_split(t_idx),
    )


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def iterate_batches(
    corpus: VesselCorpus,
    mode: str,
    batch_size: int,
    img_hw: Tuple[int, int],
    *,
    shuffle_seed: Optional[int] = None,
    augment: Optional[bool] = None,
    drop_remainder: bool = True,
    use_native: Optional[bool] = None,
    device: DeviceLike = None,
) -> Iterator[Dict]:
    """Yields {'x': (B, H, W, 1), 'm': (B, 12), 't': (B, T)} tensors on
    ``device`` and 'labels' (B,) int32 on the host.

    Train mode enumerates the 4x (sample, aug) pair space; ``augment``
    defaults to ``mode == "train"``. In-memory corpora index their raw
    images, and ``make_preprocess`` makes ``x`` on the device. File-backed
    corpora go through the native thread pool (``NativeBatchLoader``: decode,
    resize, flip, min-max, binarize on the host) when ``use_native`` is
    True, or None and the library builds; its batches come in the shuffled
    order with ``m``, ``t`` and ``labels`` taken by the sample indices it
    returns, and ``x`` reaches a CUDA device from pinned memory,
    non-blocking. The loader drops a remainder under ``batch_size``; with
    ``drop_remainder=False`` that tail is decoded by ``load_raw`` and
    transformed by ``make_preprocess``, as is every batch without the native
    route."""
    augment = (mode == "train") if augment is None else augment
    idx = corpus.splits[mode]
    pairs = (
        np.stack(np.meshgrid(idx, np.arange(4), indexing="ij"), -1).reshape(-1, 2)
        if augment
        else np.stack([idx, np.zeros_like(idx)], -1)
    )
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(pairs)
    dev = resolve_device(device)
    pinned = dev.type == "cuda"
    file_backed = corpus.raw_images is None
    if use_native is None:
        if file_backed:
            from causalvae_tpu_torch import native

            use_native = native.available()
        else:
            use_native = False

    def to_dev(a) -> torch.Tensor:
        # pinned host copies, so the host queues the next batch without
        # waiting for the device to drain
        t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        if not pinned:
            return t
        return (t if t.is_pinned() else t.pin_memory()).to(dev, non_blocking=True)

    def labelled(x: torch.Tensor, samples: np.ndarray) -> Dict:
        return {"x": x, "m": to_dev(corpus.m[samples]),
                "t": to_dev(corpus.one_hot_t(samples)), "labels": corpus.t_idx[samples]}

    def host_batch(chunk: np.ndarray, pre) -> Dict:
        samples, augs = chunk[:, 0], chunk[:, 1]
        if not file_backed:
            raw = corpus.raw_images[samples]
        else:
            raw = np.stack([load_raw(corpus.paths[j]) for j in samples])
        return labelled(pre(to_dev(raw.astype(np.float32, copy=False)), to_dev(augs)),
                        samples)

    if file_backed and use_native:
        from causalvae_tpu_torch import native

        tail = len(pairs) % batch_size
        main = pairs[: len(pairs) - tail]
        loader = native.NativeBatchLoader(corpus.paths, main[:, 0], img_hw, batch_size,
                                          augs=main[:, 1], binarize=True)
        try:
            while True:
                # the loader writes each batch straight into (pinned) memory
                x = torch.empty((batch_size, *img_hw, 1), dtype=torch.float32, pin_memory=pinned)
                samples = np.empty(batch_size, np.int32)
                if not loader.next_into(x, samples):
                    break
                yield labelled(to_dev(x), samples)
        finally:
            loader.close()
        if tail and not drop_remainder:
            yield host_batch(pairs[len(pairs) - tail :], make_preprocess(img_hw, dev))
        return

    pre = make_preprocess(img_hw, dev)
    stop = len(pairs) - (len(pairs) % batch_size) if drop_remainder else len(pairs)
    for s in range(0, stop, batch_size):
        yield host_batch(pairs[s : s + batch_size], pre)

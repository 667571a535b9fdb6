"""The causal cascade's input pipeline (``causalvae_tpu/data/cascade.py``):
page-by-page MIPs of 3-D TIFF stacks, augmentation and standardisation on
the device.

The data contract of the JAX package, kept as it is: a stack reduced by its
maximum over pages without holding the stack (``load_mip_paged``, here the
native page walk ``native.decode_mip``: no tifffile); intensities clipped to
3000 and 100-px top and bottom margins cropped when the image is taller than
200 (``crop_and_clip``); an antialiased bilinear resize to (512, 960); in
training, horizontal and vertical flips (p = 0.5 each), a shift / scale /
rotation (±5% / ±5% / ±15°, p = 0.5) with a reflect-101 border, brightness
(-0.01, 0.1) and contrast (-0.01, 0.05) (p = 0.5 together); then per-image
standardisation (biased std, + 1e-5). M is min-max scaled over the corpus,
T an integer label.

The JAX package draws the augmentation inside its jitted function from a
``jax.random`` key. The port draws the same parameters from an explicit
``torch.Generator`` (``draw_augment``, on the host) and applies them in a
deterministic function (``apply_augment``) that tests can call with given
parameters, JAX's own draws among them. The warp is JAX's
``map_coordinates(order=1, mode="nearest")``, written as a gather of the four
neighbours with clamped indices, weights and sum in JAX's order.

``scan_cascade_corpus`` reads the CSV with the standard library, with
pandas' reading of it: a feature cell that is missing or not a number
becomes 0 (``to_numeric(errors="coerce").fillna(0)``); ``Image ID`` is
typed as pandas types the column (``data/translator.py`` ``id_strings``);
the groups are the sorted distinct ``group_name`` values of the matched rows,
typed as pandas types the whole column (``data/vessel.py`` ``_group_key``).
This module imports neither pandas, PIL nor tifffile.
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from causalvae_tpu_torch.data.vessel import FEATURE_COLUMNS
from causalvae_tpu_torch.device import DeviceLike, resolve_device

# the augmentation's parameters, one entry per image (shift: (B, 2))
AUGMENT_KEYS = ("hflip", "vflip", "shift", "scale", "angle", "warp",
                "brightness", "contrast", "bc")


def load_mip_paged(path: str) -> np.ndarray:
    """The maximum over a TIFF stack's pages, float32 (h, w), computed page
    by page (never the 3-D stack)."""
    from causalvae_tpu_torch import native

    return native.decode_mip(path)


def crop_and_clip(image: np.ndarray) -> np.ndarray:
    """Clip to 3000, crop 100-px top and bottom margins when taller than 200."""
    image = np.clip(image, image.min(), 3000.0)
    if image.shape[0] > 200:
        image = image[100:-100, :]
    return image


def _resize(img: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, h, w) -> (B, H, W) float32: antialiased bilinear, half-pixel centres."""
    return F.interpolate(img.float()[:, None], size=hw, mode="bilinear",
                         align_corners=False, antialias=True)[:, 0]


def _standardize(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H, W, 1): per image (x - mean) / (std + 1e-5), biased std."""
    mean = img.mean(dim=(1, 2), keepdim=True)
    std = img.std(dim=(1, 2), keepdim=True, correction=0)
    return ((img - mean) / (std + 1e-5))[..., None]


def draw_augment(n: int, generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
    """The augmentation's parameters for ``n`` images, drawn on the host from
    ``generator``: the two flip coins, shift (n, 2) in (-0.05, 0.05), scale in
    (0.95, 1.05), angle in degrees in (-15, 15), the warp's coin, brightness
    in (-0.01, 0.1), contrast in (0.99, 1.05) and the coin of those two."""
    u = torch.rand((n, 10), generator=generator)
    return {"hflip": u[:, 0] < 0.5, "vflip": u[:, 1] < 0.5,
            "shift": u[:, 2:4] * 0.1 - 0.05, "scale": 1.0 + (u[:, 4] * 0.1 - 0.05),
            "angle": u[:, 5] * 30.0 - 15.0, "warp": u[:, 6] < 0.5,
            "brightness": u[:, 7] * 0.11 - 0.01, "contrast": 1.0 + (u[:, 8] * 0.06 - 0.01),
            "bc": u[:, 9] < 0.5}


def _warp(img: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
          angle: torch.Tensor) -> torch.Tensor:
    """Shift / scale / rotation about the centre, reflect-101 border, bilinear
    with the neighbours' indices clamped (JAX's ``map_coordinates(order=1,
    mode="nearest")``): (B, H, W) -> (B, H, W)."""
    B, H, W = img.shape
    dev = img.device
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, None, :]
    y = (yy - cy - (shift[:, 0] * H)[:, None, None]) / scale[:, None, None]
    x = (xx - cx - (shift[:, 1] * W)[:, None, None]) / scale[:, None, None]
    ang = (angle * math.pi / 180.0)[:, None, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    ys = y * cos - x * sin + cy
    xs = y * sin + x * cos + cx
    ys = ys.abs()
    ys = torch.where(ys > H - 1, 2 * (H - 1) - ys, ys)
    xs = xs.abs()
    xs = torch.where(xs > W - 1, 2 * (W - 1) - xs, xs)

    def nodes(c, size):
        lower = torch.floor(c)
        upper_w = c - lower
        i0 = lower.to(torch.int64)
        return [(i0.clamp(0, size - 1), 1 - upper_w), ((i0 + 1).clamp(0, size - 1), upper_w)]

    flat = img.reshape(B, H * W)
    out = None
    for iy, wy in nodes(ys, H):
        for ix, wx in nodes(xs, W):
            v = torch.gather(flat, 1, (iy * W + ix).reshape(B, -1)).reshape(B, H, W)
            term = wy * wx * v
            out = term if out is None else out + term
    return out


def apply_augment(imgs: torch.Tensor, params: Dict[str, torch.Tensor],
                  img_hw: Tuple[int, int]) -> torch.Tensor:
    """The training transform with given parameters (``draw_augment``'s
    keys): (B, h, w) -> (B, H, W, 1) float32 on ``imgs``' device. Resize,
    flips, the warp where its coin says, brightness and contrast where
    theirs does, standardisation."""
    p = {k: params[k].to(imgs.device) for k in AUGMENT_KEYS}
    img = _resize(imgs, img_hw)
    img = torch.where(p["hflip"][:, None, None], img.flip(-1), img)
    img = torch.where(p["vflip"][:, None, None], img.flip(-2), img)
    warped = _warp(img, p["shift"].float(), p["scale"].float(), p["angle"].float())
    img = torch.where(p["warp"][:, None, None], warped, img)
    bc = img * p["contrast"].float()[:, None, None] + p["brightness"].float()[:, None, None]
    img = torch.where(p["bc"][:, None, None], bc, img)
    return _standardize(img)


def make_augment(img_hw: Tuple[int, int], device: DeviceLike = None):
    """``aug(imgs (B, h, w), generator=None, params=None) -> (B, H, W, 1)``
    on ``device``: the parameters drawn from ``generator`` (``draw_augment``)
    unless given."""
    dev = resolve_device(device)

    def aug(imgs, generator: Optional[torch.Generator] = None,
            params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        imgs = torch.as_tensor(imgs).to(dev, torch.float32)
        if params is None:
            params = draw_augment(imgs.shape[0], generator)
        return apply_augment(imgs, params, img_hw)

    return aug


def make_eval_preprocess(img_hw: Tuple[int, int], device: DeviceLike = None):
    """``pre(imgs (B, h, w)) -> (B, H, W, 1)`` on ``device``: resize and
    standardisation."""
    dev = resolve_device(device)

    def pre(imgs) -> torch.Tensor:
        return _standardize(_resize(torch.as_tensor(imgs).to(dev, torch.float32), img_hw))

    return pre


@dataclasses.dataclass
class CascadeCorpus:
    paths: List[str]
    raw_images: Optional[np.ndarray]
    m_raw: np.ndarray
    m: np.ndarray                 # min-max scaled over the corpus
    t_idx: np.ndarray
    group_names: List
    m_min: np.ndarray
    m_denom: np.ndarray


def _min_max(m_raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    m_min = m_raw.min(axis=0)
    m_denom = m_raw.max(axis=0) - m_min
    m_denom[m_denom == 0] = 1.0
    return (m_raw - m_min) / m_denom, m_min, m_denom


def scan_cascade_corpus(csv_path: str, img_root_dirs: Sequence[str]) -> CascadeCorpus:
    """CSV rows matched to ``*.vessel.tiff`` files by the trailing '-' token
    of the name; the matched rows' features (missing or text cells 0) and
    groups (sorted, typed as pandas types the column)."""
    from causalvae_tpu_torch.data.translator import id_strings
    from causalvae_tpu_torch.data.vessel import _group_key, _missing, _number

    if isinstance(img_root_dirs, str):
        img_root_dirs = [img_root_dirs]
    with open(csv_path, newline="", encoding="utf-8-sig") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        header = reader.fieldnames or []
    absent = [c for c in ("Image ID", "group_name", *FEATURE_COLUMNS) if c not in header]
    if absent:
        raise KeyError(f"{csv_path}: no column {absent}")
    path_map: Dict[str, str] = {}
    for root in img_root_dirs:
        for p in glob.glob(os.path.join(root, "**", "*.vessel.tiff"), recursive=True):
            name = os.path.basename(p).replace(".tiff", "").replace(".vessel", "")
            path_map[name.split("-")[-1]] = p
    ids = id_strings([r["Image ID"] for r in rows])
    matched = [(i, r) for i, r in zip(ids, rows) if i in path_map]
    key = _group_key([r["group_name"] for r in rows])
    for i, r in matched:
        if _missing(r["group_name"]):
            raise ValueError(f"{csv_path}: the row of Image ID {i} has no group_name")
    groups = sorted({key(r["group_name"]) for _, r in matched})
    group_to_idx = {g: k for k, g in enumerate(groups)}
    m_raw = np.asarray([[_number(r[c]) for c in FEATURE_COLUMNS] for _, r in matched],
                       np.float64).reshape(len(matched), len(FEATURE_COLUMNS))
    m_raw = np.where(np.isnan(m_raw), 0.0, m_raw).astype(np.float32)  # fillna(0)
    m, m_min, m_denom = _min_max(m_raw)
    return CascadeCorpus(
        paths=[path_map[i] for i, _ in matched], raw_images=None, m_raw=m_raw, m=m,
        t_idx=np.asarray([group_to_idx[key(r["group_name"])] for _, r in matched], np.int32),
        group_names=groups, m_min=m_min, m_denom=m_denom)


def synthetic_cascade_corpus(n: int = 40, n_groups: int = 19, seed: int = 0) -> CascadeCorpus:
    """The vessel synthetic corpus at 128x192 with min-max scaled M."""
    from causalvae_tpu_torch.data.vessel import synthetic_corpus

    vc = synthetic_corpus(n=n, n_groups=n_groups, hw=(128, 192), seed=seed)
    m, m_min, m_denom = _min_max(vc.m_raw)
    return CascadeCorpus(
        paths=vc.paths, raw_images=vc.raw_images, m_raw=vc.m_raw, m=m, t_idx=vc.t_idx,
        group_names=vc.group_names, m_min=m_min, m_denom=m_denom)


def iterate_batches(
    corpus: CascadeCorpus,
    batch_size: int,
    img_hw: Tuple[int, int] = (512, 960),
    *,
    train: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    device: DeviceLike = None,
    aug_params: Optional[Iterator[Dict[str, torch.Tensor]]] = None,
) -> Iterator[Dict]:
    """Yields {'x': (B, H, W, 1), 'm': (B, m) float32, 't': (B,) int64} on
    ``device``. The order is numpy's ``default_rng(seed)`` shuffle in
    training (the JAX order), the corpus order otherwise; a remainder under
    ``batch_size`` is dropped unless ``drop_remainder=False``. Training
    augments each batch with parameters drawn from a CPU generator seeded
    ``seed`` (``aug_params`` hands in each batch's instead; tests pass
    JAX's draws); evaluation resizes and standardises. A file-backed corpus
    is decoded on the host (``load_mip_paged``, ``crop_and_clip``), a batch's
    files in threads (the native decoder releases the GIL)."""
    dev = resolve_device(device)
    fn = make_augment(img_hw, dev) if train else make_eval_preprocess(img_hw, dev)
    idx = np.arange(len(corpus.t_idx))
    if train:
        np.random.default_rng(seed).shuffle(idx)
    gen = torch.Generator().manual_seed(seed)
    stop = len(idx) - (len(idx) % batch_size) if drop_remainder else len(idx)
    for s in range(0, stop, batch_size):
        sel = idx[s:s + batch_size]
        if corpus.raw_images is not None:
            raw = corpus.raw_images[sel]
        else:
            with ThreadPoolExecutor(min(len(sel), os.cpu_count() or 1)) as pool:
                raw = np.stack(list(pool.map(
                    lambda j: crop_and_clip(load_mip_paged(corpus.paths[j])), sel)))
        raw = torch.from_numpy(np.ascontiguousarray(raw, np.float32))
        if train:
            x = fn(raw, gen, None if aug_params is None else next(aug_params))
        else:
            x = fn(raw)
        yield {"x": x,
               "m": torch.from_numpy(np.ascontiguousarray(corpus.m[sel], np.float32)).to(dev),
               "t": torch.from_numpy(corpus.t_idx[sel].astype(np.int64)).to(dev)}

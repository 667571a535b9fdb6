"""The latent translator's input pipeline (``causalvae_tpu/data/translator.py``):
3-D TIFF stacks reduced to their max-intensity projection, a robust
normalisation and a resize on the device.

The data contract of the JAX package, kept as it is: a recursive scan of
several roots for ``*.tif``/``*.tiff`` files matched by the trailing image ID
of the name; a stack reduced by its maximum over pages (``mip``); per image,
a clip to the (100 - p, p) percentiles (p = 99.5, linear interpolation, as
``jnp.percentile``), a min-max scale to [0, 1] and an antialiased bilinear
resize (``jax.image.resize(..., "bilinear")``, whose ``antialias`` is on by
default), to (384, 640) unless told otherwise; a file that cannot be loaded
stands in as a (100, 100) zero image.

The port reads the CSV with the standard library (``match_table`` takes its
rows, ``csv.DictReader``'s dicts) and types its ``Image ID`` column as pandas
would before ``astype(str)`` (``data/vessel.py`` ``_group_key``): an
all-integer column is read as int ("007" -> "7"), one with a missing cell as
float ("7" -> "7.0"), else as text; a missing ID matches no file. TIFF stacks are decoded by the port's
native page walk (``native.decode_pages``), so no tifffile is needed; NPY
files by numpy, anything else by PIL (imported only then). Each file that
falls back to the zero image is logged on stderr and counted in
``LOAD_FAILURES``. This module imports neither pandas, PIL nor tifffile.
"""

from __future__ import annotations

import glob
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from causalvae_tpu_torch.device import DeviceLike, resolve_device

# files ``load_stack`` could not read (each stood in as a zero image)
LOAD_FAILURES = 0
_failures_lock = threading.Lock()


def scan_image_roots(image_roots: Sequence[str]) -> Dict[str, str]:
    """{image_id: path} over every *.tif/*.tiff under the roots; the ID is the
    trailing '-'-separated token of the name with ".tiff", ".tif" and
    ".vessel" removed (a later file of the same ID wins)."""
    if isinstance(image_roots, str):
        image_roots = [image_roots]
    path_map: Dict[str, str] = {}
    for root in image_roots:
        for f in glob.glob(os.path.join(root, "**", "*"), recursive=True):
            if f.lower().endswith((".tiff", ".tif")):
                name = os.path.basename(f)
                for ext in (".tiff", ".tif", ".vessel"):
                    name = name.replace(ext, "")
                path_map[name.split("-")[-1]] = f
    return path_map


def id_strings(cells: Sequence[Optional[str]]) -> List[Optional[str]]:
    """A CSV column's cells as pandas' ``read_csv(...)[col].astype(str)``
    gives them: int column "007" -> "7", float column (a missing cell) "7"
    -> "7.0", text as written; a missing cell stays missing (None; pandas 3
    keeps it NaN), so it matches no file."""
    from causalvae_tpu_torch.data.vessel import _group_key, _missing

    key = _group_key(list(cells))
    return [None if _missing(c) else str(key(c)) for c in cells]


def match_table(rows: Sequence[Dict[str, str]], path_map: Dict[str, str]
                ) -> List[Dict[str, str]]:
    """The CSV rows whose ``Image ID`` (typed by ``id_strings``) has a file,
    in order, each with that ID string as its ``Image ID``."""
    ids = id_strings([r.get("Image ID") for r in rows])
    return [dict(r, **{"Image ID": i}) for r, i in zip(rows, ids) if i in path_map]


def load_stack(path: str) -> np.ndarray:
    """Host decode of a (possibly 3-D) TIFF, NPY or other image file,
    float32: (P, h, w) for a TIFF of P > 1 pages, else (h, w), as
    ``tifffile.imread`` gives it. A file that cannot be read gives a (100, 100)
    zero image, logged on stderr and counted in ``LOAD_FAILURES``."""
    global LOAD_FAILURES
    try:
        if path.lower().endswith((".tif", ".tiff")):
            from causalvae_tpu_torch import native

            stack = native.decode_pages(path)
            return stack[0] if len(stack) == 1 else stack
        if path.lower().endswith(".npy"):
            return np.load(path).astype(np.float32)
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im, np.float32)
    except Exception as e:  # the reference's data semantics: a zero image
        with _failures_lock:
            LOAD_FAILURES += 1
        print(f"load_stack: {path} could not be read ({type(e).__name__}: {e}); "
              "a (100, 100) zero image stands in", file=sys.stderr, flush=True)
        return np.zeros((100, 100), np.float32)


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` over the last axis (linear interpolation,
    the position and weights in float32 as JAX computes them; NaN if a value
    is NaN), from the two order statistics by ``kthvalue``:
    ``torch.quantile`` refuses inputs above 2^24 values."""
    n = x.shape[-1]
    pos = np.float32(np.float32(q) / np.float32(100.0)) * (np.float32(n) - np.float32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = np.float32(pos - lo)
    w_lo = np.float32(1) - w_hi
    lo, hi = int(min(max(lo, 0), n - 1)), int(min(max(hi, 0), n - 1))
    s_lo = x.kthvalue(lo + 1, dim=-1).values
    s_hi = s_lo if hi == lo else x.kthvalue(hi + 1, dim=-1).values
    out = s_lo * float(w_lo) + s_hi * float(w_hi)
    return torch.where(torch.isnan(x).any(dim=-1), torch.nan, out)


def make_preprocess(resize_hw: Tuple[int, int], clip_percentile: float = 99.5,
                    batched: bool = True, device: DeviceLike = None):
    """``pre(raw)`` -> float32 on ``device``: (B, h, w) -> (B, H, W, 1), or
    with ``batched=False`` (h, w) -> (H, W, 1), each image at its own shape
    (for ragged corpora). Per image: clip to the (100 - p, p) percentiles,
    scale to [0, 1] (a constant image's span taken as 1e-5), resize
    (antialiased bilinear, half-pixel centres). The MIP comes before it."""
    dev = resolve_device(device)
    H, W = resize_hw
    lo_q, hi_q = 100.0 - clip_percentile, clip_percentile

    def pre(raw) -> torch.Tensor:
        img = torch.as_tensor(raw).to(dev, torch.float32)
        one = img.dim() == 2
        if one == batched:
            raise ValueError(f"preprocess(batched={batched}) takes "
                             f"{'(B, h, w)' if batched else '(h, w)'}, got {tuple(img.shape)}")
        img = img[None] if one else img
        flat = img.reshape(img.shape[0], -1)
        vmin = percentile(flat, lo_q)[:, None, None]
        vmax = percentile(flat, hi_q)[:, None, None]
        img = torch.minimum(torch.maximum(img, vmin), vmax)
        span = vmax - vmin
        img = (img - vmin) / torch.where(span == 0, 1e-5, span)
        img = F.interpolate(img[:, None], size=(H, W), mode="bilinear",
                            align_corners=False, antialias=True)[:, 0, ..., None]
        return img[0] if one else img

    return pre


def mip(stack: np.ndarray) -> np.ndarray:
    """3-D -> 2-D max-intensity projection (host; ragged shapes)."""
    return stack.max(axis=0) if stack.ndim == 3 else stack


def iterate_images(
    rows: Sequence[Dict[str, str]],
    path_map: Dict[str, str],
    batch_size: int,
    resize_hw: Tuple[int, int] = (384, 640),
    clip_percentile: float = 99.5,
    raw_images: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> Iterator[Dict]:
    """Yields {'x': (B, H, W, 1) on ``device``, 'id': list[str]} over
    ``match_table``'s rows in order; the last batch is short when
    ``batch_size`` does not divide them (nothing is padded). ``raw_images``
    (one per row) replaces the files, which are decoded on the host, a
    batch's in threads (the native page walk releases the GIL). A batch of
    one shape is transformed
    at once, a ragged batch image by image (zero padding to a common canvas
    would skew the percentiles)."""
    pre = make_preprocess(resize_hw, clip_percentile, device=device)
    pre1 = make_preprocess(resize_hw, clip_percentile, batched=False, device=device)
    ids = [str(r["Image ID"]) for r in rows]
    for s in range(0, len(ids), batch_size):
        chunk = ids[s:s + batch_size]
        if raw_images is not None:
            raws = [raw_images[i] for i in range(s, s + len(chunk))]
        else:
            with ThreadPoolExecutor(min(len(chunk), os.cpu_count() or 1)) as pool:
                raws = list(pool.map(lambda i: mip(load_stack(path_map[i])), chunk))
        if len({r.shape for r in raws}) == 1:
            x = pre(torch.from_numpy(np.stack(raws).astype(np.float32, copy=False)))
        else:
            x = torch.stack([pre1(torch.from_numpy(np.asarray(r, np.float32))) for r in raws])
        yield {"x": x, "id": chunk}

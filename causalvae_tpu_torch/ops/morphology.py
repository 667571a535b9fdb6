"""Device morphology (``causalvae_tpu/ops/morphology.py``), batched, in plain
PyTorch on the device of its input.

Every measure takes a batch of images (B, H, W) and computes what the JAX
function computes per image under ``vmap``, with the same arithmetic:

  * connected components  -> iterative min-label propagation over the 8
                             neighbours (a 3x3 max-pool of the negated
                             labels) with pointer jumping
  * Euclidean distance    -> exact min over background pixels, in two
    transform max            separable passes (columns, then rows)
  * perimeter             -> 4-neighbour border + weighted 3x3 scoring
  * ellipse fit           -> closed-form moments of the mask in int32
  * solidity              -> exact convex-hull membership over the integer
                             half-plane directions, chunked by directions
  * Euler number          -> bit-quad counting (8-connectivity)
  * skeleton              -> Zhang-Suen thinning, endpoint / junction scoring
                             with REFLECT_101 borders
  * Hu moments            -> closed-form normalized central moments

JAX's ``lax.while_loop`` under ``vmap`` stops each image at its own fixed
point. Here the batch loops while any image still changes: a converged image
is a fixed point of the loop's body, so further passes leave it as it is,
and the loop tests for convergence every few passes to spare host syncs.
``skeletonize``'s ``max_iter`` still bounds every image's passes, as JAX's
per-image count does. Integer arithmetic stays integer (int32, floor
division as ``//`` floors in JAX); the ``-0.0 -> +0.0`` normalisation of the
ellipse's ``b`` and the first-maximum tie-break over component areas are
kept.

Memory: ``edt_max`` reduces two (B, H, H, W) float32 tensors, 88 KB an
image at 28x28; ``convex_area`` builds (B, d, H) int32 tensors over
``HULL_ELEMENTS`` / (B·H) directions at a time (of the 4,111 with b > 0, and
as many with b < 0, at 28x28). Chunking changes no result.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

from causalvae_tpu_torch.device import DeviceLike, resolve_device

_F32 = torch.float32
HULL_ELEMENTS = 2**24  # elements of each (B, directions, H) tensor of convex_area
CHECK_EVERY = 4  # passes of a fixed-point loop between convergence tests


def _pad(x: torch.Tensor, fill=0) -> torch.Tensor:
    """x (B, H, W) with a border of one ``fill`` cell on every side."""
    return F.pad(x, (1, 1, 1, 1), value=fill)


def _window(p: torch.Tensor, dr: int, dc: int, h: int, w: int) -> torch.Tensor:
    """Of a padded ``p``: the value at (r + dr, c + dc) for every (r, c)."""
    return p[:, 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]


_NEIGH4 = [(-1, 0), (1, 0), (0, -1), (0, 1)]


def largest_component(binary: torch.Tensor) -> torch.Tensor:
    """Mask of the largest 8-connected component (skimage label + argmax-area
    semantics). All-False for an empty image.

    Every pixel's label starts as its row-major index and falls to the least
    label over its 3x3 neighbourhood each pass, then jumps to the label of
    the pixel its label names (a pixel of its own component, whose label is
    no larger). Labels stay indices of the component's pixels and never rise,
    so the one fixed point is JAX's: each component labelled by its least
    index. The jump only shortens the way there."""
    b, h, w = binary.shape
    big = h * w  # background sentinel; labels are exact integers in float32
    idx = torch.arange(h * w, dtype=_F32, device=binary.device).reshape(h, w)
    labels = torch.where(binary, idx, torch.tensor(float(big), device=binary.device))
    sentinel = torch.full((b, 1), float(big), device=binary.device)
    while True:
        for _ in range(CHECK_EVERY):
            prev = labels
            # min over the pixel and its 8 neighbours; the pool's -inf
            # padding is a +inf label, never below the pixel's own
            neigh = -F.max_pool2d(-labels[:, None], 3, stride=1, padding=1)[:, 0]
            labels = torch.where(binary, neigh, torch.full_like(neigh, float(big)))
            flat = torch.cat([labels.reshape(b, -1), sentinel], dim=1)
            labels = flat.gather(1, flat[:, :-1].long()).reshape(b, h, w)
        if torch.equal(labels, prev):
            break
    # the first maximum of the per-key areas is the first-discovered
    # component on area ties, as JAX's argmax
    keys = labels.reshape(b, -1).long()
    counts = torch.zeros(b, h * w + 1, dtype=torch.int32, device=binary.device)
    counts.scatter_add_(1, keys, torch.ones_like(keys, dtype=torch.int32))
    counts[:, big] = 0
    best = counts.argmax(dim=1)
    return (keys == best[:, None]).reshape(b, h, w) & binary


def edt_max(binary: torch.Tensor) -> torch.Tensor:
    """Max Euclidean distance to background (thickness). Every pixel's exact
    min squared distance to a background pixel, in two exact passes: down
    the columns, G²(r, c) = min over background rows r' of column c of
    (r - r')², then along the rows, min over c' of G²(r, c') + (c - c')²,
    which is the min over every background pixel that JAX's (HW, HW)
    brute force takes (integers, exact in float32). With no background,
    scipy's ``distance_transform_edt`` gives max hypot(h, w - 1), kept."""
    _, h, w = binary.shape
    dev = binary.device
    inf = torch.tensor(float("inf"), device=dev)
    r = torch.arange(h, dtype=_F32, device=dev)
    c = torch.arange(w, dtype=_F32, device=dev)
    dr2 = ((r[:, None] - r[None, :]) ** 2)[None, :, :, None]  # (1, r, r', 1)
    dc2 = ((c[:, None] - c[None, :]) ** 2)[None, None]  # (1, 1, c, c')
    g2 = torch.where(~binary[:, None], dr2, inf).amin(dim=2)  # (B, r, c)
    d2 = (g2[:, :, None, :] + dc2).amin(dim=3)  # (B, r, c)
    d2max = torch.where(binary, d2, torch.zeros_like(d2)).amax(dim=(1, 2))
    any_bg = (~binary).any(dim=2).any(dim=1)
    no_bg_max = torch.tensor(math.hypot(h, w - 1), dtype=_F32, device=dev)
    return torch.where(any_bg, torch.sqrt(d2max), no_bg_max)


_PERIM_OFFSETS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]
_PERIM_KVALS = [10, 2, 10, 2, 1, 2, 10, 2, 10]
_PERIM_WEIGHTS = np.zeros(50, dtype=np.float32)
_PERIM_WEIGHTS[[5, 7, 15, 17, 25, 27]] = 1.0
_PERIM_WEIGHTS[[21, 33]] = math.sqrt(2.0)
_PERIM_WEIGHTS[[13, 23]] = (1.0 + math.sqrt(2.0)) / 2.0


def perimeter(mask: torch.Tensor) -> torch.Tensor:
    """skimage perimeter(neighborhood=4): weighted border-pixel scoring."""
    _, h, w = mask.shape
    m = mask.to(torch.int32)
    pm = _pad(m)
    eroded = m
    for dr, dc in _NEIGH4:
        eroded = eroded * _window(pm, -dr, -dc, h, w)
    border = m - eroded
    pb = _pad(border)
    score = torch.zeros_like(border)
    for (dr, dc), k in zip(_PERIM_OFFSETS, _PERIM_KVALS):
        # correlation: score[p] += k * border[p - offset]
        score = score + k * _window(pb, -dr, -dc, h, w)
    score = score * border  # only border-centred scores carry weight
    weights = torch.from_numpy(_PERIM_WEIGHTS).to(mask.device)
    return weights[score.long()].sum(dim=(1, 2))


def euler_number(mask: torch.Tensor) -> torch.Tensor:
    """Euler characteristic with 8-connected foreground via bit-quads (int32)."""
    m = _pad(mask.to(torch.int32))
    a, b, c, d = m[:, :-1, :-1], m[:, :-1, 1:], m[:, 1:, :-1], m[:, 1:, 1:]
    s = a + b + c + d
    c1 = (s == 1).sum(dim=(1, 2), dtype=torch.int32)
    c3 = (s == 3).sum(dim=(1, 2), dtype=torch.int32)
    cd = ((s == 2) & (a == d)).sum(dim=(1, 2), dtype=torch.int32)
    return torch.div(c1 - c3 - 2 * cd, 4, rounding_mode="floor")


def central_moments(img: torch.Tensor, order: int = 3):
    """(mu, m00): central moments mu[b, p, q] (p over rows) about the
    intensity centroid, and the image sums."""
    img = img.to(_F32)
    _, h, w = img.shape
    r = torch.arange(h, dtype=_F32, device=img.device)
    c = torch.arange(w, dtype=_F32, device=img.device)
    m00 = img.sum(dim=(1, 2))
    m10 = (img * r[:, None]).sum(dim=(1, 2))
    m01 = (img * c[None, :]).sum(dim=(1, 2))
    safe = torch.where(m00 == 0, torch.ones_like(m00), m00)
    rc, cc = m10 / safe, m01 / safe
    rp = torch.stack([(r[None] - rc[:, None]) ** p for p in range(order + 1)], dim=1)
    cq = torch.stack([(c[None] - cc[:, None]) ** q for q in range(order + 1)], dim=1)
    return torch.einsum("bph,bqw,bhw->bpq", rp, cq, img), m00


def ellipse_params(mask: torch.Tensor):
    """(major_axis_length, eccentricity, orientation), regionprops semantics.
    The second-order moments are exact int32 (mu_pq * m00^2 = m_pq*m00 -
    m_p0*m_0q stays inside int32 at 28x28)."""
    m = mask.to(torch.int32)
    _, h, w = mask.shape
    r = torch.arange(h, dtype=torch.int32, device=mask.device)[:, None]
    c_ = torch.arange(w, dtype=torch.int32, device=mask.device)[None, :]

    def total(x):
        return x.sum(dim=(1, 2), dtype=torch.int32)

    m00, m10, m01 = total(m), total(m * r), total(m * c_)
    m20, m02, m11 = total(m * r * r), total(m * c_ * c_), total(m * r * c_)
    n20 = m20 * m00 - m10 * m10
    n02 = m02 * m00 - m01 * m01
    n11 = m11 * m00 - m10 * m01
    safe2 = torch.where(m00 == 0, torch.ones_like(m00, dtype=_F32), (m00 * m00).to(_F32))
    a = n02.to(_F32) / safe2  # mu02 / mu00
    b = -n11.to(_F32) / safe2
    # -0.0 -> +0.0, as the host's integer zero: a mirror-symmetric wide mask
    # then gets atan2(-0.0, negative) = -pi and f6 = 0.0, as on the host
    # (b = -0.0 would give +pi and f6 = 1.0)
    b = torch.where(b == 0.0, torch.zeros_like(b), b)
    c = n20.to(_F32) / safe2
    tr2 = (a + c) / 2.0
    det = a * c - b * b
    sq = torch.sqrt(torch.clamp(tr2 * tr2 - det, min=0.0))
    l1 = tr2 + sq
    l2 = torch.clamp(tr2 - sq, min=0.0)
    major = 4.0 * torch.sqrt(torch.clamp(l1, min=0.0))
    safe_l1 = torch.where(l1 > 0, l1, torch.ones_like(l1))
    ecc = torch.where(l1 > 0, torch.sqrt(1.0 - l2 / safe_l1), torch.zeros_like(l1))
    quarter = torch.where(b < 0, torch.full_like(b, -math.pi / 4.0),
                          torch.full_like(b, math.pi / 4.0))
    orient = torch.where(a - c == 0.0, quarter, 0.5 * torch.atan2(-2.0 * b, c - a))
    orient = torch.where(m00 == 0, torch.zeros_like(orient), orient)  # empty: 0.0
    return major, ecc, orient


@functools.lru_cache(maxsize=None)
def _hull_directions(max_comp: int) -> np.ndarray:
    """All coprime integer directions (a, b), |a|, |b| <= max_comp, in JAX's
    order. In doubled coordinates every candidate hull-edge normal is one."""
    dirs = [(a, b) for a in range(-max_comp, max_comp + 1)
            for b in range(-max_comp, max_comp + 1)
            if (a, b) != (0, 0) and math.gcd(abs(a), abs(b)) == 1]
    return np.array(dirs, dtype=np.int32)  # (D, 2)


def convex_area(mask: torch.Tensor) -> torch.Tensor:
    """Pixel count of the convex hull image (offset_coordinates semantics),
    in doubled integer coordinates, exact int32 throughout: per direction
    (a, b) the support value over the rows' extreme foreground columns plus
    max(|a|, |b|), then every half-plane folded into per-row column bounds:
    b > 0 caps the columns from above (floor division), b < 0 from below
    (ceil), b = 0 keeps or drops the row. The directions are taken by the
    sign of b, so each bound reads only its own. An empty row's extreme
    column is a sentinel that puts its support value below every other
    row's; with no foreground at all every row is dropped (JAX's support
    values differ there, its count too is 0)."""
    bsz, h, w = mask.shape
    dev = mask.device
    dirs = torch.from_numpy(_hull_directions(2 * max(h, w) + 2)).to(dev)
    big = 2**30
    far = 2**24  # |2 b far| < 2^31 for |b| <= 58
    rows_any = mask.any(dim=2)  # (B, h)
    cidx = torch.arange(w, dtype=torch.int32, device=dev)
    cmin = torch.where(mask, cidx, torch.full_like(cidx, w)).amin(dim=2)  # (B, h)
    cmax = torch.where(mask, cidx, torch.full_like(cidx, -1)).amax(dim=2)
    ridx = torch.arange(h, dtype=torch.int32, device=dev)
    step = max(1, HULL_ELEMENTS // (bsz * h))

    def bounds(sel, c_ext):
        """min over the directions ``sel`` (b != 0, of one sign) of
        floor(K / 2|b|), K = maxdot - 2 a r, per row: the column cap
        c <= floor(K / 2b) for b > 0, and minus the column floor
        c >= ceil(K / 2b) = -floor(K / -2b) for b < 0."""
        out = None
        for s in range(0, sel.shape[0], step):
            a = sel[s:s + step, 0][None, :, None]  # (1, d, 1)
            b = sel[s:s + step, 1][None, :, None]
            two_ar = 2 * a * ridx  # (1, d, h)
            maxdot = (two_ar + 2 * b * c_ext[:, None, :]).amax(dim=2, keepdim=True) \
                + torch.maximum(a.abs(), b.abs())
            q = torch.div(maxdot - two_ar, 2 * b.abs(), rounding_mode="floor").amin(dim=1)
            out = q if out is None else torch.minimum(out, q)
        return out

    far_t = torch.full_like(cmax, far)
    hi = bounds(dirs[dirs[:, 1] > 0], torch.where(rows_any, cmax, -far_t))
    lo = -bounds(dirs[dirs[:, 1] < 0], torch.where(rows_any, cmin, far_t))
    # b == 0 (a = +-1): the row is feasible iff 2*a*r <= maxdot
    a0 = dirs[dirs[:, 1] == 0, 0][None, :, None]  # (1, 2, 1)
    row_dot = torch.where(rows_any[:, None, :], 2 * a0 * ridx,
                          torch.full((bsz, 1, h), -big, dtype=torch.int32, device=dev))
    maxdot0 = row_dot.amax(dim=2, keepdim=True) + 1
    row_ok = (maxdot0 - 2 * a0 * ridx >= 0).all(dim=1)
    lo = torch.clamp(lo, min=0)
    hi = torch.clamp(hi, max=w - 1)
    count = torch.where(row_ok & (hi >= lo), hi - lo + 1, torch.zeros_like(hi))
    return count.sum(dim=1, dtype=torch.int32).to(_F32)


def _zhang_suen_pass(img: torch.Tensor, step: int) -> torch.Tensor:
    """One Zhang-Suen sub-iteration (step 0 or 1) of uint8 0/1 images."""
    _, h, w = img.shape
    p = _pad(img)
    # neighbours P2..P9 clockwise from north
    n = [_window(p, dr, dc, h, w) for dr, dc in
         ((-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1))]
    bsum = sum(n)
    ring = n + [n[0]]
    a = sum(((ring[k] == 0) & (ring[k + 1] == 1)).to(torch.uint8) for k in range(8))
    if step == 0:
        cond3 = (n[0] * n[2] * n[4]) == 0
        cond4 = (n[2] * n[4] * n[6]) == 0
    else:
        cond3 = (n[0] * n[2] * n[6]) == 0
        cond4 = (n[0] * n[4] * n[6]) == 0
    remove = (img == 1) & (bsum >= 2) & (bsum <= 6) & (a == 1) & cond3 & cond4
    return torch.where(remove, torch.zeros_like(img), img)


def skeletonize(binary: torch.Tensor, max_iter: int = 100) -> torch.Tensor:
    """Zhang-Suen thinning, at most ``max_iter`` iterations an image."""
    img = binary.to(torch.uint8)
    for it in range(max_iter):
        prev = img
        img = _zhang_suen_pass(_zhang_suen_pass(img, 0), 1)
        if (it + 1) % CHECK_EVERY == 0 and torch.equal(img, prev):
            break
    return img.bool()


def skeleton_endpoints_junctions(skel: torch.Tensor):
    """(endpoints, junctions) counts; REFLECT_101 border like cv2.filter2D."""
    _, h, w = skel.shape
    s = F.pad(skel.to(_F32)[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    score = torch.zeros_like(skel, dtype=_F32)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            k = 10.0 if (dr, dc) == (0, 0) else 1.0
            score = score + k * _window(s, dr, dc, h, w)
    endpoints = (score == 11).sum(dim=(1, 2), dtype=torch.int32)
    junctions = (score >= 13).sum(dim=(1, 2), dtype=torch.int32)
    return endpoints, junctions


def hu_moments_log(img: torch.Tensor) -> torch.Tensor:
    """(B, 7) log-scaled Hu moments, cv2 convention (x over columns):
    -sign(h) * log10(|h| + 1e-10) / 10, invariants below 1e-6 clamped to 0."""
    mu, m00 = central_moments(img, 3)
    safe = torch.where(m00 == 0, torch.ones_like(m00), m00)

    def eta(px, qy):  # cv2 nu_pq: p over x (columns) -> mu[row_exp=qy, col_exp=px]
        return mu[:, qy, px] / safe ** (1.0 + (px + qy) / 2.0)

    n20, n02, n11 = eta(2, 0), eta(0, 2), eta(1, 1)
    n30, n03, n21, n12 = eta(3, 0), eta(0, 3), eta(2, 1), eta(1, 2)
    h1 = n20 + n02
    h2 = (n20 - n02) ** 2 + 4 * n11 ** 2
    h3 = (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2
    h4 = (n30 + n12) ** 2 + (n21 + n03) ** 2
    h5 = (n30 - 3 * n12) * (n30 + n12) * ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2) + (
        3 * n21 - n03) * (n21 + n03) * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2)
    h6 = (n20 - n02) * ((n30 + n12) ** 2 - (n21 + n03) ** 2) + 4 * n11 * (n30 + n12) * (
        n21 + n03)
    h7 = (3 * n21 - n03) * (n30 + n12) * ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2) - (
        n30 - 3 * n12) * (n21 + n03) * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2)
    hu = torch.stack([h1, h2, h3, h4, h5, h6, h7], dim=1)
    # the numerical floor of f32 cancellation noise, as the host oracle's
    hu = torch.where(hu.abs() < 1e-6, torch.zeros_like(hu), hu)
    return -torch.sign(hu) * torch.log10(hu.abs() + 1e-10) / 10.0


def _bbox(mask: torch.Tensor):
    _, h, w = mask.shape
    rows, cols = mask.any(dim=2), mask.any(dim=1)
    ridx = torch.arange(h, dtype=torch.int32, device=mask.device)
    cidx = torch.arange(w, dtype=torch.int32, device=mask.device)
    minr = torch.where(rows, ridx, torch.full_like(ridx, h)).amin(dim=1)
    maxr = torch.where(rows, ridx + 1, torch.zeros_like(ridx)).amax(dim=1)
    minc = torch.where(cols, cidx, torch.full_like(cidx, w)).amin(dim=1)
    maxc = torch.where(cols, cidx + 1, torch.zeros_like(cidx)).amax(dim=1)
    return minr, minc, maxr, maxc


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den > 0, else 0."""
    return torch.where(den > 0, num / torch.where(den > 0, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _symmetry(img: torch.Tensor, dim: int) -> torch.Tensor:
    return 1.0 - (img - img.flip(dim)).abs().mean(dim=(1, 2))


def _shape_terms(img: torch.Tensor, threshold: float):
    """The measures both feature sets share: (binary, mask, area, edt,
    solidity, bbox height, bbox width, Euler number)."""
    binary = img > threshold
    mask = largest_component(binary)
    area = mask.to(_F32).sum(dim=(1, 2))
    minr, minc, maxr, maxc = _bbox(mask)
    return (binary, mask, area, edt_max(binary), _ratio(area, convex_area(mask)),
            (maxr - minr).to(_F32), (maxc - minc).to(_F32), euler_number(mask).to(_F32))


def features12(img: torch.Tensor, threshold: float = 0.2) -> torch.Tensor:
    """(B, 12) morphology vectors (see ``morphology_host.extract_features_12``)."""
    img = img.to(_F32)
    binary, mask, area, edt, solidity, height, width, euler = _shape_terms(img, threshold)
    major, ecc, orient = ellipse_params(mask)
    feats = torch.stack([
        area / 784.0, perimeter(mask) / 100.0, edt / 5.0, major / 28.0, ecc,
        (orient + math.pi / 2.0) / math.pi, solidity, _ratio(area, height * width),
        _ratio(width, height) / 3.0, (euler + 2.0) / 4.0,
        _symmetry(img, 2), _symmetry(img, 1)], dim=1)
    return torch.where(binary.any(dim=(1, 2))[:, None], feats, torch.zeros_like(feats))


def features16(img: torch.Tensor, threshold: float = 0.2) -> torch.Tensor:
    """(B, 16) morphology vectors (see ``morphology_host.extract_features_16``)."""
    img = img.to(_F32)
    binary, mask, area, edt, solidity, height, width, euler = _shape_terms(img, threshold)
    endpoints, junctions = skeleton_endpoints_junctions(skeletonize(binary))
    feats = torch.cat([torch.stack([
        area / 784.0, edt / 5.0, solidity,
        torch.clamp(_ratio(width, height), 0.0, 3.0) / 3.0, (euler + 2.0) / 4.0,
        _symmetry(img, 2), _symmetry(img, 1),
        endpoints.to(_F32) / 5.0, junctions.to(_F32) / 5.0], dim=1),
        hu_moments_log(img)], dim=1)
    return torch.where(binary.any(dim=(1, 2))[:, None], feats, torch.zeros_like(feats))


def _on_device(imgs, device: DeviceLike) -> torch.Tensor:
    if isinstance(imgs, torch.Tensor):
        return imgs if device is None else imgs.to(resolve_device(device))
    return torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).to(resolve_device(device))


@torch.no_grad()
def features12_batch(imgs, threshold: float = 0.2,
                     device: Optional[DeviceLike] = None) -> torch.Tensor:
    """``features12`` of (B, H, W) images: a tensor stays on its device
    unless ``device`` is given; numpy goes to ``device`` (``cuda`` unless
    "cpu")."""
    return features12(_on_device(imgs, device), threshold)


@torch.no_grad()
def features16_batch(imgs, threshold: float = 0.2,
                     device: Optional[DeviceLike] = None) -> torch.Tensor:
    """``features16`` of (B, H, W) images; devices as ``features12_batch``."""
    return features16(_on_device(imgs, device), threshold)

"""Host (numpy/scipy/cv2) morphological feature measurement: the port's own
copy of ``causalvae_tpu/ops/morphology_host.py``, arithmetic line for line.

Re-implements, measure by measure, the exact recipe the reference builds from
skimage/scipy/cv2 (ref: mnist_test/01_baseline_causal_vae/dataset.py:11-99 for
the 12-feature set, mnist_test/03_measurement_approach/dataset.py:11-96 for the
16-feature set). skimage is not a dependency here: each regionprops measure is
implemented from its published algorithm (moments-based ellipse fit, weighted
border-pixel perimeter, bit-quad Euler number, convex-hull solidity,
Zhang-Suen skeletonization). scipy supplies connected-component labelling and
the Euclidean distance transform; cv2 supplies Hu moments, exactly as in the
reference (a closed-form fallback stands in without cv2).

This is the one-time host path of ``data/mnist.py build_morph_mnist``: the
dataset's M is measured once and cached. A device extractor is not ported
yet.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage as ndi

try:  # cv2 is used for Hu moments (as the reference does); optional fallback
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

# 8-connectivity structure — skimage.measure.label's default connectivity=2
# (ref: mnist_test/01_baseline_causal_vae/dataset.py:32 uses sk_label defaults)
_STRUCT8 = np.ones((3, 3), dtype=bool)
# 4-connectivity structure used by the perimeter border erosion
_STRUCT4 = ndi.generate_binary_structure(2, 1)


def label_components(binary: np.ndarray):
    """8-connected component labelling (skimage label connectivity=2 semantics)."""
    labels, n = ndi.label(binary, structure=_STRUCT8)
    return labels, n


def largest_component(binary: np.ndarray) -> np.ndarray:
    """Boolean mask of the largest 8-connected component.

    Ties break to the lowest label id, matching ``np.argmax`` over regionprops
    areas in the reference (dataset.py:38).
    """
    labels, n = label_components(binary)
    if n == 0:
        return np.zeros_like(binary, dtype=bool)
    counts = np.bincount(labels.ravel())
    counts[0] = 0
    return labels == int(np.argmax(counts))


def raw_moments(img: np.ndarray, order: int = 3) -> np.ndarray:
    """Raw image moments m[p, q] = sum_r sum_c img[r, c] * r**p * c**q."""
    img = np.asarray(img, dtype=np.float64)
    h, w = img.shape
    r = np.arange(h, dtype=np.float64)
    c = np.arange(w, dtype=np.float64)
    rp = np.stack([r**p for p in range(order + 1)])  # (order+1, h)
    cq = np.stack([c**q for q in range(order + 1)])  # (order+1, w)
    return np.einsum("ph,qw,hw->pq", rp, cq, img)


def central_moments(img: np.ndarray, order: int = 3) -> np.ndarray:
    """Central moments mu[p, q] about the intensity centroid."""
    img = np.asarray(img, dtype=np.float64)
    m = raw_moments(img, 1)
    m00 = m[0, 0]
    if m00 == 0:
        return np.zeros((order + 1, order + 1))
    rc, cc = m[1, 0] / m00, m[0, 1] / m00
    h, w = img.shape
    r = np.arange(h, dtype=np.float64) - rc
    c = np.arange(w, dtype=np.float64) - cc
    rp = np.stack([r**p for p in range(order + 1)])
    cq = np.stack([c**q for q in range(order + 1)])
    return np.einsum("ph,qw,hw->pq", rp, cq, img)


def ellipse_params(mask: np.ndarray):
    """(major_axis_length, eccentricity, orientation) of a binary region.

    Follows the skimage regionprops definitions: the inertia tensor
    [[mu02, -mu11], [-mu11, mu20]] / mu00 of the binary mask; axis lengths are
    4*sqrt(eigenvalue); orientation is the angle (-pi/2, pi/2] between the row
    axis and the major axis (ref consumes these at dataset.py:51-58).
    """
    m = mask.astype(np.int64)
    h, w = m.shape
    r = np.arange(h, dtype=np.int64)[:, None]
    c_ = np.arange(w, dtype=np.int64)[None, :]
    m00 = int(m.sum())
    if m00 == 0:
        return 0.0, 0.0, 0.0
    m10 = int((m * r).sum())
    m01 = int((m * c_).sum())
    m20 = int((m * r * r).sum())
    m02 = int((m * c_ * c_).sum())
    m11 = int((m * r * c_).sum())
    # exact integers: mu_pq * m00 (same formulation as the device path, and
    # what skimage's float64 arithmetic resolves to for integer masks)
    denom = float(m00 * m00)
    a = (m02 * m00 - m01 * m01) / denom  # mu02 / mu00
    b = -(m11 * m00 - m10 * m01) / denom
    c = (m20 * m00 - m10 * m10) / denom
    # eigenvalues of [[a, b], [b, c]]
    tr2 = (a + c) / 2.0
    det = a * c - b * b
    disc = max(tr2 * tr2 - det, 0.0)
    sq = math.sqrt(disc)
    l1, l2 = tr2 + sq, max(tr2 - sq, 0.0)
    major = 4.0 * math.sqrt(l1)
    ecc = math.sqrt(1.0 - l2 / l1) if l1 > 0 else 0.0
    if a - c == 0.0:
        orient = -math.pi / 4.0 if b < 0 else math.pi / 4.0
    else:
        orient = 0.5 * math.atan2(-2.0 * b, c - a)
    return major, ecc, orient


# skimage perimeter weights: border pixels scored by their 4-/8-neighbour
# border configuration via the kernel [[10,2,10],[2,1,2],[10,2,10]].
_PERIM_KERNEL = np.array([[10, 2, 10], [2, 1, 2], [10, 2, 10]], dtype=np.int32)
_PERIM_WEIGHTS = np.zeros(50, dtype=np.float64)
_PERIM_WEIGHTS[[5, 7, 15, 17, 25, 27]] = 1.0
_PERIM_WEIGHTS[[21, 33]] = math.sqrt(2.0)
_PERIM_WEIGHTS[[13, 23]] = (1.0 + math.sqrt(2.0)) / 2.0


def perimeter(mask: np.ndarray) -> float:
    """skimage.measure.perimeter(neighborhood=4) of a binary mask."""
    m = mask.astype(np.uint8)
    eroded = ndi.binary_erosion(m, _STRUCT4, border_value=0)
    border = m - eroded.astype(np.uint8)
    scored = ndi.convolve(border.astype(np.int32), _PERIM_KERNEL, mode="constant", cval=0)
    hist = np.bincount((scored * border).ravel(), minlength=50)[:50]
    return float(hist @ _PERIM_WEIGHTS)


def convex_area(mask: np.ndarray) -> float:
    """Pixel count of the convex hull image of a binary region.

    skimage convex_hull_image semantics with offset_coordinates=True: hull of
    the pixel-center points offset by +-0.5 along each axis; a pixel belongs to
    the hull image if its center lies inside (tolerance 1e-9). Used by
    regionprops ``solidity`` (ref dataset.py:61).
    """
    pts = np.argwhere(mask)
    if len(pts) == 0:
        return 0.0
    if len(pts) == 1:
        return 1.0
    offs = np.array([[0.5, 0.0], [-0.5, 0.0], [0.0, 0.5], [0.0, -0.5]])
    cloud = (pts[:, None, :] + offs[None, :, :]).reshape(-1, 2)
    from scipy.spatial import ConvexHull, QhullError

    try:
        hull = ConvexHull(cloud)
    except QhullError:
        # Degenerate (collinear) region: hull has zero area -> every region
        # pixel is on the hull segment.
        return float(mask.sum())
    # half-plane test: inside iff A @ x + b <= tol for all facets
    eq = hull.equations  # (nfacet, 3): normal_r, normal_c, offset
    centers = np.argwhere(mask | ~mask).astype(np.float64)  # all pixel centers
    inside = np.all(centers @ eq[:, :2].T + eq[:, 2][None, :] <= 1e-9, axis=1)
    return float(inside.sum())


def euler_number(mask: np.ndarray) -> int:
    """Euler characteristic, 8-connected foreground (regionprops default).

    Bit-quad counting: chi = (C1 - C3 - 2*CD) / 4 where C1/C3 are 2x2 windows
    with exactly one/three foreground pixels and CD the two-pixel diagonal
    configurations.
    """
    m = np.pad(mask.astype(np.int32), 1)
    a = m[:-1, :-1]
    b = m[:-1, 1:]
    c = m[1:, :-1]
    d = m[1:, 1:]
    s = a + b + c + d
    c1 = int(np.sum(s == 1))
    c3 = int(np.sum(s == 3))
    cd = int(np.sum((s == 2) & (a == d)))  # diagonal pairs: a&d or b&c set
    return (c1 - c3 - 2 * cd) // 4


def edt_max(binary: np.ndarray) -> float:
    """Max of the Euclidean distance transform (thickness; ref dataset.py:47-48)."""
    return float(ndi.distance_transform_edt(binary).max())


# Zhang-Suen lookup is computed per-pass below.
def skeletonize_zs(binary: np.ndarray, max_iter: int = 100) -> np.ndarray:
    """Zhang-Suen thinning (the algorithm behind skimage 2D skeletonize).

    Iterates two sub-passes removing border pixels until stable. Used for the
    16-feature endpoint/junction counts (ref mnist_test/03 dataset.py:51-75).
    """
    img = binary.astype(np.uint8).copy()

    def neighbours(p):
        # clockwise neighbours P2..P9 starting north
        return [
            p[:-2, 1:-1], p[:-2, 2:], p[1:-1, 2:], p[2:, 2:],
            p[2:, 1:-1], p[2:, :-2], p[1:-1, :-2], p[:-2, :-2],
        ]

    for _ in range(max_iter):
        changed = False
        for step in (0, 1):
            p = np.pad(img, 1)
            n = neighbours(p)
            center = p[1:-1, 1:-1]
            bsum = sum(n)  # number of foreground neighbours
            ring = n + [n[0]]
            a = sum(((ring[k] == 0) & (ring[k + 1] == 1)).astype(np.uint8) for k in range(8))
            if step == 0:
                cond3 = (n[0] * n[2] * n[4]) == 0
                cond4 = (n[2] * n[4] * n[6]) == 0
            else:
                cond3 = (n[0] * n[2] * n[6]) == 0
                cond4 = (n[0] * n[4] * n[6]) == 0
            remove = (
                (center == 1)
                & (bsum >= 2) & (bsum <= 6)
                & (a == 1)
                & cond3 & cond4
            )
            if remove.any():
                img[remove] = 0
                changed = True
        if not changed:
            break
    return img.astype(bool)


_SKEL_KERNEL = np.array([[1, 1, 1], [1, 10, 1], [1, 1, 1]], dtype=np.uint8)


def skeleton_endpoints_junctions(skel: np.ndarray):
    """Endpoint/junction counts via the reference's 3x3 neighbour-sum kernel.

    Matches cv2.filter2D with BORDER_REFLECT_101 (its default) on the uint8
    skeleton: score = 10*center + #neighbours; endpoint score == 11, junction
    score >= 13 (ref mnist_test/03 dataset.py:63-72).
    """
    s = skel.astype(np.uint8)
    if _HAS_CV2:
        scored = cv2.filter2D(s, -1, _SKEL_KERNEL)
    else:  # pragma: no cover
        scored = ndi.correlate(s.astype(np.int32), _SKEL_KERNEL.astype(np.int32), mode="mirror")
    endpoints = int(np.sum(scored == 11))
    junctions = int(np.sum(scored >= 13))
    return endpoints, junctions


def hu_moments_log(img: np.ndarray) -> np.ndarray:
    """Seven log-scaled Hu moments of the raw (non-binarized) image.

    val = -sign(h) * log10(|h| + 1e-10) / 10, matching ref mnist_test/03
    dataset.py:77-91 (which uses cv2.moments + cv2.HuMoments).
    """
    if _HAS_CV2:
        hu = cv2.HuMoments(cv2.moments(np.asarray(img, dtype=np.float64))).ravel()
    else:  # pragma: no cover
        hu = _hu_from_moments(central_moments(img, 3), raw_moments(img, 1)[0, 0])
    # numerical floor shared with the device path: invariants below 1e-6 are
    # below f32 resolution on device, so both paths clamp them to exactly 0
    # (the raw log transform would turn their noise-sign into +/-1.0)
    hu = np.where(np.abs(hu) < 1e-6, 0.0, hu)
    return np.array(
        [-1.0 * np.sign(h) * np.log10(np.abs(h) + 1e-10) / 10.0 for h in hu],
        dtype=np.float64,
    )


def _hu_from_moments(mu: np.ndarray, m00: float) -> np.ndarray:
    """Hu invariants from central moments (cv2 convention: x=col, y=row)."""
    if m00 == 0:
        return np.zeros(7)
    # normalized central moments eta[p_x, q_y]; cv2 nu_pq has p over x (cols)
    def eta(px, qy):
        return mu[qy, px] / (m00 ** (1 + (px + qy) / 2.0))

    n20, n02, n11 = eta(2, 0), eta(0, 2), eta(1, 1)
    n30, n03, n21, n12 = eta(3, 0), eta(0, 3), eta(2, 1), eta(1, 2)
    h1 = n20 + n02
    h2 = (n20 - n02) ** 2 + 4 * n11**2
    h3 = (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2
    h4 = (n30 + n12) ** 2 + (n21 + n03) ** 2
    h5 = (n30 - 3 * n12) * (n30 + n12) * ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2) + (
        3 * n21 - n03
    ) * (n21 + n03) * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2)
    h6 = (n20 - n02) * ((n30 + n12) ** 2 - (n21 + n03) ** 2) + 4 * n11 * (n30 + n12) * (
        n21 + n03
    )
    h7 = (3 * n21 - n03) * (n30 + n12) * ((n30 + n12) ** 2 - 3 * (n21 + n03) ** 2) - (
        n30 - 3 * n12
    ) * (n21 + n03) * (3 * (n30 + n12) ** 2 - (n21 + n03) ** 2)
    return np.array([h1, h2, h3, h4, h5, h6, h7])


def extract_features_12(img: np.ndarray) -> np.ndarray:
    """12-feature morphology vector of a 28x28 grayscale image in [0, 1].

    Exact recipe of ref mnist_test/01_baseline_causal_vae/dataset.py:11-99:
    binarize at 0.2, keep the largest 8-connected blob, then
    [area/784, perimeter/100, edt_max/5, major_axis/28, eccentricity,
     (orientation + pi/2)/pi, solidity, extent, (width/height)/3,
     (euler+2)/4, H-symmetry, V-symmetry].
    """
    img = np.asarray(img, dtype=np.float64)
    if img.ndim == 3:
        img = img.squeeze()
    binary = img > 0.2
    if binary.sum() == 0:
        return np.zeros(12, dtype=np.float32)
    mask = largest_component(binary)

    area = float(mask.sum())
    f1 = area / 784.0
    f2 = perimeter(mask) / 100.0
    f3 = edt_max(binary) / 5.0
    major, ecc, orient = ellipse_params(mask)
    f4 = major / 28.0
    f5 = ecc
    f6 = (orient + math.pi / 2.0) / math.pi
    ca = convex_area(mask)
    f7 = area / ca if ca > 0 else 0.0
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    minr, maxr = int(np.argmax(rows)), int(len(rows) - np.argmax(rows[::-1]))
    minc, maxc = int(np.argmax(cols)), int(len(cols) - np.argmax(cols[::-1]))
    height, width = maxr - minr, maxc - minc
    bbox_area = height * width
    f8 = area / bbox_area if bbox_area > 0 else 0.0  # extent
    f9 = (width / height) / 3.0 if height > 0 else 0.0
    f10 = (euler_number(mask) + 2) / 4.0
    f11 = 1.0 - float(np.mean(np.abs(img - img[:, ::-1])))
    f12 = 1.0 - float(np.mean(np.abs(img - img[::-1, :])))
    return np.array(
        [f1, f2, f3, f4, f5, f6, f7, f8, f9, f10, f11, f12], dtype=np.float32
    )


def extract_features_16(img: np.ndarray) -> np.ndarray:
    """16-feature morphology vector (measurement-approach set).

    Exact recipe of ref mnist_test/03_measurement_approach/dataset.py:11-96:
    [area/784, edt_max/5, solidity, clip(w/h, 0, 3)/3, (euler+2)/4,
     H-symmetry, V-symmetry, endpoints/5, junctions/5, 7 log-Hu moments].
    """
    img = np.asarray(img, dtype=np.float64)
    if img.ndim == 3:
        img = img.squeeze()
    binary = img > 0.2
    if binary.sum() == 0:
        return np.zeros(16, dtype=np.float32)
    mask = largest_component(binary)

    area = float(mask.sum())
    f1 = area / 784.0
    f2 = edt_max(binary) / 5.0
    ca = convex_area(mask)
    f3 = area / ca if ca > 0 else 0.0
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    minr, maxr = int(np.argmax(rows)), int(len(rows) - np.argmax(rows[::-1]))
    minc, maxc = int(np.argmax(cols)), int(len(cols) - np.argmax(cols[::-1]))
    height, width = maxr - minr, maxc - minc
    f4 = float(np.clip(width / height if height > 0 else 0.0, 0, 3.0)) / 3.0
    f5 = (euler_number(mask) + 2) / 4.0
    f6 = 1.0 - float(np.mean(np.abs(img - img[:, ::-1])))
    f7 = 1.0 - float(np.mean(np.abs(img - img[::-1, :])))
    skel = skeletonize_zs(binary)
    endpoints, junctions = skeleton_endpoints_junctions(skel)
    f8 = endpoints / 5.0
    f9 = junctions / 5.0
    hu = hu_moments_log(img)
    return np.array(
        [f1, f2, f3, f4, f5, f6, f7, f8, f9, *hu], dtype=np.float32
    )


def extract_features_batch(imgs: np.ndarray, n_features: int = 12) -> np.ndarray:
    """Vector of features for a batch of images (host loop)."""
    fn = extract_features_12 if n_features == 12 else extract_features_16
    return np.stack([fn(im) for im in imgs])

"""The port's device morphology (``causalvae_tpu_torch/ops/morphology.py``)
against the JAX package's on the CPU, and against the host oracle.

Inputs: ``synthetic_digits(24, seed=3)`` (``tests/conftest.py``), plus an
empty image, a saturated one (no background) and a mirror-symmetric wide
bar. Each JAX function runs as ``jit(vmap(fn))`` over the images, the port's
over the batch. Tolerances:
- equal: the largest component, Euler number, convex area, the skeleton,
  endpoint and junction counts, the EDT maximum (the square root of an
  exact integer), the bounding-box and Euler-derived features;
- perimeter (a float32 sum of ~100 weights in another order) within 1e-6 of
  max|ref| (worst here 1.5e-7); ellipse parameters within 1e-5 (worst
  2.0e-6, the eccentricity); central moments within 1e-5 of max|ref| of the
  host's float64 ones (worst 9.3e-6, the saturated image) and 5e-4 of
  JAX's (whose float32 einsum is 3.2e-4 off the float64 ones there);
- ``features12`` / ``features16`` within 1e-5 outside the Hu entries (worst
  2.0e-6); the Hu entries whose value is at most 0.6 within 1e-4 (worst
  1.0e-5), those above 0.6 skipped, as ``tests/test_morphology.py`` skips
  invariants near the 1e-6 floor;
- against ``morphology_host``: ``tests/test_morphology.py``'s own bounds
  (5e-3 for 12 features; 1e-2 for 16 with its Hu rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.ops import morphology as J

from causalvae_tpu_torch.analysis.importance import measure_generated, phase2_importance
from causalvae_tpu_torch.ops import morphology as P
from causalvae_tpu_torch.ops import morphology_host as H

from conftest import synthetic_digits
from torch_port_helpers import close, two_threads  # noqa: F401

FEAT_TOL = 1e-5
HU_TOL = 1e-4
MOMENTS_TOL = 5e-4  # JAX's float32 einsum is 3.2e-4 of max|ref| off the float64 moments
HU_SKIP = 0.6  # tests/test_morphology.py:120


def _edge_images():
    """Empty; saturated (no background pixel); a mirror-symmetric wide bar
    (its b moment is -0.0, which would flip f6 from 0.0 to 1.0)."""
    imgs = np.zeros((3, 28, 28), np.float32)
    imgs[1] = 0.8
    imgs[2, 12:16, 4:24] = 1.0
    return imgs


@pytest.fixture(scope="module")
def images():
    return np.concatenate([synthetic_digits(24, seed=3), _edge_images()])


def _jax(fn, *args):
    return np.asarray(jax.jit(jax.vmap(fn))(*(jnp.asarray(a) for a in args)))


def _port(fn, *args):
    out = fn(*(torch.from_numpy(np.array(a)) for a in args))
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


@pytest.mark.parametrize("name", ["largest_component", "euler_number", "convex_area",
                                  "skeletonize", "edt_max"])
def test_integer_measures_equal_jax(images, name):
    src = images > 0.2
    if name in ("euler_number", "convex_area"):
        src = _jax(J.largest_component, src)
    got, want = _port(getattr(P, name), src), _jax(getattr(J, name), src)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_skeleton_endpoints_junctions_equal_jax(images):
    skel = np.array(_jax(J.skeletonize, images > 0.2))
    jax_fn = jax.jit(jax.vmap(J.skeleton_endpoints_junctions))
    for g, w in zip(P.skeleton_endpoints_junctions(torch.from_numpy(skel)),
                    jax_fn(jnp.asarray(skel))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("max_iter", [1, 2, 5])
def test_skeletonize_counts_iterations_per_image(images, max_iter):
    """``max_iter`` bounds every image's passes as JAX's per-image count
    does, though the batch loops together."""
    got = _port(lambda b: P.skeletonize(b, max_iter), images > 0.2)
    want = _jax(lambda b: J.skeletonize(b, max_iter), images > 0.2)
    np.testing.assert_array_equal(got, want)


def test_perimeter_ellipse_and_moments_match_jax(images):
    masks = _jax(J.largest_component, images > 0.2)
    close(_port(P.perimeter, masks), _jax(J.perimeter, masks), rel=1e-6, abs_=0.0)
    jax_ellipse = jax.jit(jax.vmap(J.ellipse_params))(jnp.asarray(masks))
    for g, w in zip(_port(P.ellipse_params, masks), jax_ellipse):
        close(g, w, rel=0.0, abs_=FEAT_TOL)
    mu, m00 = _port(P.central_moments, images)
    jmu, jm00 = jax.jit(jax.vmap(J.central_moments))(jnp.asarray(images))
    close(mu, jmu, rel=MOMENTS_TOL, abs_=0.0)
    close(m00, jm00, rel=FEAT_TOL, abs_=0.0)
    for got, img in zip(mu, images):  # and the float64 moments of the host oracle
        close(got, H.central_moments(img), rel=FEAT_TOL, abs_=0.0)


def _hu_close(got, want):
    sel = np.abs(want) <= HU_SKIP
    np.testing.assert_allclose(got[sel], want[sel], rtol=0, atol=HU_TOL)


def test_hu_moments_match_jax(images):
    _hu_close(_port(P.hu_moments_log, images), _jax(J.hu_moments_log, images))


@pytest.mark.parametrize("n_features", [12, 16])
def test_features_match_jax(images, n_features):
    fn = P.features12_batch if n_features == 12 else P.features16_batch
    got = fn(images, device="cpu").numpy()
    want = np.asarray((J.features12_batch if n_features == 12 else J.features16_batch)(
        jnp.asarray(images)))
    assert got.shape == want.shape == (27, n_features) and got.dtype == np.float32
    plain = slice(0, 9) if n_features == 16 else slice(0, 12)
    np.testing.assert_allclose(got[:, plain], want[:, plain], rtol=0, atol=FEAT_TOL)
    if n_features == 16:
        _hu_close(got[:, 9:], want[:, 9:])
    empty, saturated, bar = got[-3:]
    assert not empty.any()
    if n_features == 12:
        # f6 of the symmetric bar: the host's 0.0, not the 1.0 that b = -0.0 gives
        assert bar[5] == want[-1, 5] == H.extract_features_12(images[-1])[5] == 0.0
        assert saturated[2] == pytest.approx(np.hypot(28, 27) / 5, abs=1e-6)  # no background


@pytest.mark.parametrize("n_features", [12, 16])
def test_features_match_the_host_oracle(images, n_features):
    """tests/test_morphology.py's bounds against ``morphology_host``."""
    got = (P.features12_batch if n_features == 12 else P.features16_batch)(
        images, device="cpu").numpy()
    want = H.extract_features_batch(images, n_features)
    if n_features == 12:
        np.testing.assert_allclose(got, want, atol=5e-3)
        return
    noise = np.zeros_like(want, dtype=bool)
    noise[:, 9:] = np.abs(want[:, 9:]) > HU_SKIP
    np.testing.assert_allclose(np.where(noise, want, got), want, atol=1e-2)


def test_chunking_changes_no_result(images, monkeypatch):
    """The hull over a few directions at a time and another convergence
    test period give the default's bits; one image gives its row of the
    batch."""
    want12 = P.features12_batch(images, device="cpu")
    want16 = P.features16_batch(images, device="cpu")
    monkeypatch.setattr(P, "HULL_ELEMENTS", 27 * 28 * 100)
    monkeypatch.setattr(P, "CHECK_EVERY", 3)
    assert torch.equal(P.features12_batch(images, device="cpu"), want12)
    assert torch.equal(P.features16_batch(images, device="cpu"), want16)
    assert torch.equal(P.features16(torch.from_numpy(images[4:5]))[0], want16[4])


def test_measure_generated_matches_jax(images):
    from causalvae_tpu.analysis.importance import measure_generated as jax_measure

    gen = images.reshape(3, 9, 28, 28, 1)  # the features' batch: JAX's compile is cached
    for n in (12, 16):
        got = measure_generated(torch.from_numpy(gen), n).numpy()
        want = np.asarray(jax_measure(jnp.asarray(gen), n))
        assert got.shape == (3, 9, n)
        np.testing.assert_allclose(got[..., :9], want[..., :9], rtol=0, atol=FEAT_TOL)
        _hu_close(got[..., 9:], want[..., 9:])


@pytest.mark.parametrize("n_features", [12, 16])
def test_phase2_importance_on_a_fixed_decode(images, n_features):
    """One fixed set of generated images (3 conditions x 9 samples) measured
    by both packages' device morphology: sensitivities within 1e-4 (the Hu
    entries' bound; worst 2.4e-6), the ranking ordered by JAX's values
    within that."""
    from causalvae_tpu.analysis.importance import phase2_importance as jax_phase2

    imgs = images.reshape(3, 9, 28, 28, 1)
    z = np.zeros((9, 6), np.float32)
    got = phase2_importance(lambda t, zz: torch.from_numpy(imgs), torch.from_numpy(z), 3,
                               n_features=n_features)
    want = jax_phase2(lambda t, zz: jnp.asarray(imgs), jnp.asarray(z), 3,
                                n_features=n_features)
    assert sorted(got["sensitivity"]) == sorted(want["sensitivity"])
    for k, w in want["sensitivity"].items():
        assert abs(got["sensitivity"][k] - w) <= 1e-4, k
    ranked = [want["sensitivity"][k] for k in got["ranking"]]
    assert all(a >= b - 1e-4 for a, b in zip(ranked, ranked[1:]))
    assert got["features"].shape == (3, 9, n_features)


def test_device_extractor_needs_a_device_or_the_cpu():
    """Numpy input goes to ``device``: cuda unless "cpu", which raises
    without a GPU and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.features12_batch(np.zeros((1, 28, 28), np.float32))
    from causalvae_tpu_torch.data.mnist import build_morph_mnist

    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_morph_mnist(np.zeros((2, 28, 28), np.float32), np.zeros(2, np.int64),
                          use_device_extractor=True)

"""The port's latent diagnostics (``analysis/latent_viz.py``) against the
JAX package's and against sklearn, which the JAX functions call, on the CPU.

Tolerances:
- ``encode_corpus`` and ``real_vs_fake_embedding`` against JAX, with the
  weights carried across by ``from_jax_variables`` (C1, the tiny C9 on the
  attention's plain version, the SimpleClassifier): within 1e-5 of max|ref|;
- PCA against sklearn's (``pca_embedding`` of the JAX package): the embedding
  within 1e-5 of max|ref|, signs included; the explained-variance ratios
  within 1e-6;
- t-SNE, N = 60, perplexity 15 (the JAX call's min(30, N // 4)): the joint
  P equal to sklearn's ``_joint_probabilities`` (1e-12) and the objective's
  KL and gradient at the initialisation equal to sklearn's ``_kl_divergence``
  (1e-9 relative; the gradient within one float32 ulp of its max); the
  final KL within 2% of the range of sklearn's exact ``TSNE`` started from
  the port's initialisation moved by 1e-6 relative (four runs: the descent is
  chaotic, and sklearn's own final KL moves by 5-10% under such a move, so
  no single run of either is a fixed target); trustworthiness (k = 5) within
  0.02 of the JAX function's Barnes-Hut embedding's;
- the probe: each fold's accuracy equal to ``cross_val_score``'s on
  separable data; on random z (three and two classes) each fold within one
  test sample of it;
- ``centroid_outliers`` equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sklearn.linear_model import LogisticRegression
from sklearn.manifold import TSNE, _t_sne, trustworthiness
from sklearn.metrics import pairwise_distances
from sklearn.model_selection import cross_val_score
from scipy.spatial.distance import squareform

from causalvae_tpu.analysis import latent_viz as jlv
from causalvae_tpu.models import heads as jheads
from causalvae_tpu.models import vae as jvae

from causalvae_tpu_torch.analysis import latent_viz as lv
from causalvae_tpu_torch.models import heads as pheads
from causalvae_tpu_torch.models.vae import CausalConvVAE

from torch_port_helpers import (close, init_jax, inputs, load_port, small_causal_pair,  # noqa: F401
                                two_threads)

N = 60


def _mnist(b, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.random((b, 28, 28, 1), dtype=np.float32),
            rng.standard_normal((b, 12), dtype=np.float32),
            np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)])


def _clustered(n=N, f=8, k=3, seed=0, sep=3.0):
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(k), n // k)
    z = rng.standard_normal((n, f)) + sep * np.eye(f)[labels]
    return z.astype(np.float32), labels


def test_encode_corpus_matches_jax_c1_and_c9():
    kw = dict(m_dim=12, t_dim=10, z_dim=10)
    jm = jvae.CausalConvVAE(**kw)
    x, m, t = _mnist(10)
    v = init_jax(jm, jnp.asarray(x[:1]), jnp.asarray(m[:1]), jnp.asarray(t[:1]),
                 rng=jax.random.PRNGKey(0), seed=0, jit=True)
    pm = load_port(CausalConvVAE(**kw, device="cpu"), v)
    want = jlv.encode_corpus(jm, v, x, m, t, batch_size=4)
    got = lv.encode_corpus(pm, x, m, t, batch_size=4)
    assert got.dtype == np.float32
    close(got, want, rel=1e-5, abs_=0.0)

    jm9, v9, pm9 = small_causal_pair(seed=1, jit=True)
    x, m, t = inputs(5)
    close(lv.encode_corpus(pm9, x, m, t, batch_size=2),
          jlv.encode_corpus(jm9, v9, x, m, t, batch_size=2), rel=1e-5, abs_=0.0)


def test_real_vs_fake_embedding_matches_jax():
    jm = jheads.SimpleClassifier()
    real, fake = _mnist(6, seed=4)[0], _mnist(5, seed=5)[0]
    v = init_jax(jm, jnp.asarray(real[:1]), seed=6, jit=True)
    pm = load_port(pheads.SimpleClassifier(device="cpu"), v)
    want = jlv.real_vs_fake_embedding(jm, v, real, fake, batch_size=4)
    got = lv.real_vs_fake_embedding(pm, real, fake, batch_size=4)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (len(g), 50)
        close(g, w, rel=1e-5, abs_=0.0)


def test_pca_matches_sklearn_with_its_signs():
    for z in (_clustered()[0], np.random.default_rng(2).standard_normal((700, 6)).astype(
            np.float32)):
        want, want_ratio = jlv.pca_embedding(z)
        got, ratio = lv.pca_embedding(z, device="cpu")
        assert got.dtype == want.dtype
        close(got, want, rel=1e-5, abs_=0.0)
        np.testing.assert_allclose(ratio, want_ratio, rtol=0, atol=1e-6)


def test_tsne_steps_are_sklearn_s():
    z, _ = _clustered()
    z64 = torch.as_tensor(z, dtype=torch.float64)
    p = lv.joint_probabilities(z64, 15.0)
    want_p = squareform(_t_sne._joint_probabilities(
        pairwise_distances(z, squared=True), 15.0, 0))
    np.testing.assert_allclose(p.numpy(), want_p, rtol=0, atol=1e-12)
    y = lv.tsne_init(z)
    kl, grad = lv.kl_objective(torch.as_tensor(y), p)
    want_kl, want_grad = _t_sne._kl_divergence(y.ravel(), squareform(want_p), 1, N, 2)
    assert abs(float(kl) - want_kl) <= 1e-9 * want_kl
    ulp = np.spacing(np.float32(np.abs(want_grad).max()))
    assert np.abs(grad.numpy().ravel() - want_grad).max() <= ulp


def test_tsne_final_kl_and_neighbourhoods_as_sklearn():
    z, _ = _clustered()
    got = lv.exact_tsne(z, 15.0, device="cpu")
    assert got.embedding.shape == (N, 2) and got.embedding.dtype == np.float32
    init = lv.tsne_init(z)
    kls = []
    for k in range(4):
        moved = init * (1 + 1e-6 * np.random.default_rng(k).standard_normal(init.shape))
        kls.append(TSNE(2, perplexity=15.0, init=moved.astype(np.float32),
                        method="exact").fit(z).kl_divergence_)
    assert 0.98 * min(kls) <= got.kl_divergence <= 1.02 * max(kls), (got.kl_divergence, kls)
    jax_emb = jlv.tsne_embedding(z, perplexity=30.0)
    port_emb = lv.tsne_embedding(z, perplexity=30.0, device="cpu")
    np.testing.assert_array_equal(port_emb, got.embedding)  # min(30, N // 4) = 15
    t_port = trustworthiness(z, port_emb, n_neighbors=5)
    t_jax = trustworthiness(z, jax_emb, n_neighbors=5)
    assert abs(t_port - t_jax) <= 0.02, (t_port, t_jax)


def test_multi_perplexity_tsne_runs_each_perplexity():
    z, _ = _clustered(n=24, f=4, k=2)
    got = lv.multi_perplexity_tsne(z, perplexities=(2, 5), device="cpu")
    assert list(got) == [2, 5]
    for p, emb in got.items():
        np.testing.assert_array_equal(emb, lv.tsne_embedding(z, perplexity=p, device="cpu"))


@pytest.mark.parametrize("case", ["separable", "random3", "random2"])
def test_probe_folds_match_cross_val_score(case):
    rng = np.random.default_rng(9)
    if case == "separable":
        z, labels = _clustered(seed=9, sep=10.0)
    else:
        k = 3 if case == "random3" else 2
        z = rng.standard_normal((61, 5)).astype(np.float32)
        labels = rng.integers(0, k, 61)
    want = cross_val_score(LogisticRegression(max_iter=500, random_state=42), z, labels, cv=3)
    got = lv.probe_fold_accuracies(z, labels, device="cpu")
    from causalvae_tpu_torch.train.kfold import stratified_kfold_unshuffled

    sizes = [len(v) for v in stratified_kfold_unshuffled(labels, 3).val_idx]
    if case == "separable":
        assert got == list(want) and min(got) == 1.0
    for g, w, n in zip(got, want, sizes):
        assert abs(g - w) <= 1.0 / n + 1e-12, (got, list(want))
    assert lv.disentanglement_score(z, labels, device="cpu") == pytest.approx(np.mean(got))
    if case != "random3":
        assert jlv.disentanglement_score(z, labels) == pytest.approx(np.mean(want))


def test_unshuffled_folds_are_sklearn_s():
    from sklearn.model_selection import StratifiedKFold

    from causalvae_tpu_torch.train.kfold import stratified_kfold_unshuffled

    labels = np.random.default_rng(4).integers(0, 4, 50)
    plan = stratified_kfold_unshuffled(labels, 3)
    for f, (tr, te) in enumerate(StratifiedKFold(3).split(np.zeros(50), labels)):
        np.testing.assert_array_equal(plan.train_idx[f], tr)
        np.testing.assert_array_equal(plan.val_idx[f], te)


def test_centroid_outliers_match_jax():
    feats = np.random.default_rng(3).standard_normal((40, 50)).astype(np.float32)
    labels = np.random.default_rng(4).integers(0, 4, 40)
    want = jlv.centroid_outliers(feats, labels, top_k=5)
    got = lv.centroid_outliers(feats, labels, top_k=5)
    assert list(got) == list(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])

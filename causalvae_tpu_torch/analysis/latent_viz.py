"""Latent diagnostics (``causalvae_tpu/analysis/latent_viz.py``): t-SNE and
PCA of the abducted latents, the linear probe's disentanglement score, the
classifier's real-vs-fake embedding and the per-class outliers.

Encoding runs on the model's device, a chunk at a time. Where the JAX
package calls sklearn on the host (PCA, Barnes-Hut t-SNE, logistic
regression), the port computes the same thing in torch on ``device`` (CUDA
unless the caller passes ``device="cpu"``), since the card's machine has no
sklearn:

- ``pca_embedding``: centring and an SVD in float64, with sklearn's sign
  rule (``svd_flip`` on the components: each component's entry of largest
  magnitude is positive), so the embedding is sklearn's, signs included;
- ``tsne_embedding``: an exact t-SNE (O(N²) in memory and time per
  iteration) that follows sklearn's ``TSNE`` step by step: the conditional
  P by binary search to the perplexity, symmetrised and normalised; the PCA
  initialisation scaled to std 1e-4 on its first axis; 250 iterations of
  early exaggeration 12 at momentum 0.5, then momentum 0.8 up to 1000 in
  all; ``learning_rate="auto"`` (max(N / 12 / 4, 50)); the gains rule
  (+0.2 where the update and the gradient disagree in sign, x0.8 elsewhere,
  at least 0.01); the convergence checks every 50 iterations; sklearn's
  types (float32 distances, embedding, gains and gradient, a float64
  update; P, Q and the KL in float64). It is exact where the JAX call runs
  Barnes-Hut. The random state enters sklearn only through the PCA
  initialisation, so this is deterministic on a device. The descent is
  chaotic: sklearn's own final KL moves by 5-10% when its initialisation
  moves by 1e-6 relative, so two devices, or sklearn and this, agree on
  the final KL and the neighbourhoods kept, not on the points;
- ``disentanglement_score``: sklearn's ``cross_val_score`` of
  ``LogisticRegression(max_iter=500)`` with ``cv=3``: the unshuffled
  stratified folds (``train/kfold.py stratified_kfold_unshuffled``) and the
  L2-penalised (C = 1, intercept unpenalised) multinomial objective, or the
  binomial one for two classes, minimised by Newton's method in float64.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from causalvae_tpu_torch.device import DeviceLike, module_device, resolve_device

MACHINE_EPSILON = float(np.finfo(np.double).eps)  # sklearn's floor on P and Q


@torch.no_grad()
def encode_corpus(model, x, m, t, batch_size: int = 512,
                  device: DeviceLike = None) -> np.ndarray:
    """Batched mean-abduction of the whole corpus (the model in eval mode,
    one pass per ``batch_size`` chunk on ``device``, the model's own unless
    given) -> (N, z) numpy."""
    from causalvae_tpu_torch.scm.intervene import abduct

    model.eval()
    dev = module_device(model) if device is None else resolve_device(device)
    zs = []
    for s in range(0, len(x), batch_size):
        chunk = (torch.as_tensor(np.asarray(a[s: s + batch_size])).to(dev)
                 for a in (x, m, t))
        zs.append(abduct(model, *chunk).float().cpu().numpy())
    return np.concatenate(zs)


def _pca(z64: torch.Tensor, n_components: int = 2
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(embedding, explained variance ratio) of float64 (N, F) data, with
    sklearn's component signs."""
    zc = z64 - z64.mean(dim=0)
    u, s, vt = torch.linalg.svd(zc, full_matrices=False)
    # svd_flip(u, vt, u_based_decision=False): the largest |entry| of each
    # component row of vt positive
    rows = torch.arange(vt.shape[0], device=vt.device)
    signs = torch.sign(vt[rows, vt.abs().argmax(dim=1)])
    vt = vt * signs[:, None]
    var = s * s / (z64.shape[0] - 1)
    ratio = var / var.sum()
    return zc @ vt[:n_components].T, ratio[:n_components]


def pca_embedding(z: np.ndarray, device: DeviceLike = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn ``PCA(n_components=2).fit_transform(z)`` and its
    ``explained_variance_ratio_``, in z's float type."""
    z = np.asarray(z)
    z64 = torch.as_tensor(z, dtype=torch.float64, device=resolve_device(device))
    emb, ratio = _pca(z64)
    dtype = z.dtype if z.dtype in (np.float32, np.float64) else np.float64
    return emb.cpu().numpy().astype(dtype), ratio.cpu().numpy().astype(dtype)


def _conditional_p(d2: torch.Tensor, perplexity: float, n_steps: int = 100,
                   tol: float = 1e-5) -> torch.Tensor:
    """sklearn's ``_binary_search_perplexity`` over all rows at once: each
    row's Gaussian precision beta searched until the row's entropy is
    log(perplexity) within ``tol``; a row keeps the P of its last beta."""
    n = d2.shape[0]
    dev = d2.device
    beta = torch.ones(n, dtype=torch.float64, device=dev)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    off = ~torch.eye(n, dtype=torch.bool, device=dev)
    p = torch.zeros_like(d2)
    target = math.log(perplexity)
    for _ in range(n_steps):
        pi = torch.exp(-d2 * beta[:, None]) * off
        total = pi.sum(dim=1)
        total = torch.where(total == 0.0, torch.full_like(total, 1e-8), total)
        pi = pi / total[:, None]
        entropy = torch.log(total) + beta * (d2 * pi).sum(dim=1)
        diff = entropy - target
        p = torch.where(done[:, None], p, pi)
        done = done | (diff.abs() <= tol)
        if bool(done.all()):
            break
        up = (diff > 0) & ~done
        down = (diff <= 0) & ~done
        new_up = torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0)
        new_down = torch.where(torch.isinf(lo), beta / 2.0, (beta + lo) / 2.0)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(up, new_up, torch.where(down, new_down, beta))
    return p


class TSNEResult(NamedTuple):
    embedding: np.ndarray  # (N, 2) float32, as sklearn's fit_transform
    kl_divergence: float   # sklearn's kl_divergence_: the last iteration's KL
    n_iter: int            # sklearn's n_iter_: the last iteration's index


def tsne_init(z: np.ndarray) -> np.ndarray:
    """sklearn's ``init="pca"``: the PCA embedding in float32, scaled to
    standard deviation 1e-4 on its first axis."""
    emb = pca_embedding(np.asarray(z, np.float32), device="cpu")[0]
    return emb / np.std(emb[:, 0]) * np.float32(1e-4)


def joint_probabilities(z64: torch.Tensor, perplexity: float) -> torch.Tensor:
    """sklearn's ``_joint_probabilities`` as a full (N, N) matrix with a zero
    diagonal: the conditional P of float32 squared distances, symmetrised,
    normalised and floored at MACHINE_EPSILON."""
    off = ~torch.eye(z64.shape[0], dtype=torch.bool, device=z64.device)
    d2 = (z64[:, None, :] - z64[None, :, :]).square().sum(-1).float().double()
    cond = _conditional_p(d2, perplexity)
    p = cond + cond.T
    return torch.clamp(p / max(float(p.sum()), MACHINE_EPSILON), min=MACHINE_EPSILON) * off


def kl_objective(y: torch.Tensor, p: torch.Tensor, compute_error: bool = True):
    """sklearn's exact ``_kl_divergence`` (1 degree of freedom) at the
    float32 embedding y: (KL or None, the float32 gradient). Q, P - Q and
    the KL in float64."""
    off = ~torch.eye(y.shape[0], dtype=torch.bool, device=y.device)
    y64 = y.double()
    num = 1.0 / (1.0 + torch.cdist(y64, y64).square()) * off
    q = torch.clamp(num / num.sum(), min=MACHINE_EPSILON)
    pqd = (p - q) * num
    grad = (4.0 * (pqd.sum(dim=1, keepdim=True) * y64 - pqd @ y64)).float()
    kl = None
    if compute_error:
        kl = (p * torch.log(torch.clamp(p, min=MACHINE_EPSILON) / q))[off].sum()
    return kl, grad


def exact_tsne(z: np.ndarray, perplexity: float = 30.0,
               device: DeviceLike = None, init: Optional[np.ndarray] = None
               ) -> TSNEResult:
    """sklearn ``TSNE(n_components=2, perplexity=perplexity, init=init or
    "pca", method="exact")`` with its defaults, in torch on ``device``."""
    dev = resolve_device(device)
    z64 = torch.as_tensor(np.asarray(z), dtype=torch.float64, device=dev)
    n = z64.shape[0]
    if not 0 < perplexity < n:
        raise ValueError(f"perplexity ({perplexity}) must be less than n_samples ({n})")
    p = joint_probabilities(z64, perplexity)
    y = torch.as_tensor(tsne_init(z) if init is None else init, dtype=torch.float32,
                        device=dev)
    lr = max(n / 12.0 / 4.0, 50.0)

    def descend(y, p, it, stop, momentum, without_progress):
        update = torch.zeros_like(y, dtype=torch.float64)
        gains = torch.ones_like(y)
        error = best_error = float(np.finfo(float).max)
        best_iter = i = it
        for i in range(it, stop):
            check = (i + 1) % 50 == 0
            kl, grad = kl_objective(y, p, check or i == stop - 1)
            inc = update * grad < 0.0
            gains = torch.clamp(torch.where(inc, gains + 0.2, gains * 0.8), min=0.01)
            grad = grad * gains
            update = momentum * update - lr * grad.double()
            y = (y.double() + update).float()
            if kl is not None:
                error = float(kl)
            if check:
                if error < best_error:
                    best_error, best_iter = error, i
                elif i - best_iter > without_progress:
                    break
                if float(torch.linalg.vector_norm(grad)) <= 1e-7:
                    break
        return y, error, i

    y, error, it = descend(y, p * 12.0, 0, 250, 0.5, 250)
    y, error, it = descend(y, p, it + 1, 1000, 0.8, 300)
    return TSNEResult(y.float().cpu().numpy(), error, it)


def tsne_embedding(z: np.ndarray, *, perplexity: float = 30.0, seed: int = 42,
                   device: DeviceLike = None) -> np.ndarray:
    """2-D t-SNE of z at perplexity min(perplexity, max(2, N // 4)), as the
    JAX call's (``seed`` was sklearn's random state, which reached only its
    PCA initialisation; the port's initialisation is the exact PCA)."""
    return exact_tsne(z, min(perplexity, max(2, len(z) // 4)), device).embedding


def multi_perplexity_tsne(z: np.ndarray, perplexities=(10, 30, 50), seed: int = 42,
                          device: DeviceLike = None) -> Dict:
    """The embedding at several perplexities (ref visualize.py:139-188)."""
    return {p: tsne_embedding(z, perplexity=p, seed=seed, device=device)
            for p in perplexities}


def _fit_logistic(x: torch.Tensor, y: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Weights (F + 1, K') minimising Σ log-loss + ||W||² / 2 (sklearn's C
    = 1; the last row, the intercept, unpenalised) by damped Newton steps
    in float64, to a relative change of the loss of 1e-10: the multinomial
    loss over K' = K columns, or for two classes the binomial one over one
    column (sklearn's formulations)."""
    n, f = x.shape
    xt = torch.cat([x, torch.ones(n, 1, dtype=x.dtype, device=x.device)], dim=1)
    k = 1 if n_classes == 2 else n_classes
    pen = torch.ones(f + 1, dtype=x.dtype, device=x.device)
    pen[-1] = 0.0
    onehot = (y.float() if k == 1 else
              torch.nn.functional.one_hot(y, k)).to(x.dtype).reshape(n, k)

    def loss(w):
        s = xt @ w
        data = (torch.nn.functional.softplus(s) - onehot * s).sum() if k == 1 else \
            (torch.logsumexp(s, dim=1) - (onehot * s).sum(dim=1)).sum()
        return data + 0.5 * (pen[:, None] * w * w).sum()

    w = torch.zeros(f + 1, k, dtype=x.dtype, device=x.device)
    value = loss(w)
    for _ in range(100):
        s = xt @ w
        prob = torch.sigmoid(s) if k == 1 else torch.softmax(s, dim=1)
        grad = xt.T @ (prob - onehot) + pen[:, None] * w
        if k == 1:
            hess = (xt * (prob * (1 - prob))).T @ xt
        else:
            # Σ_i (diag(p_i) - p_i p_iᵀ) ⊗ x̃_i x̃_iᵀ, indexed (a, k, b, l)
            eye = torch.eye(k, dtype=x.dtype, device=x.device)
            hess = (torch.einsum("akb,kl->akbl",
                                 torch.einsum("ik,ia,ib->akb", prob, xt, xt), eye)
                    - torch.einsum("ik,il,ia,ib->akbl", prob, prob, xt, xt))
        hess = hess.reshape((f + 1) * k, (f + 1) * k)
        hess = hess + torch.diag(pen[:, None].expand(f + 1, k).reshape(-1))
        # the multinomial loss is flat along equal shifts of the intercepts:
        # the least-norm step leaves them summing to 0, as sklearn's do
        step = (torch.linalg.pinv(hess, hermitian=True) @ grad.reshape(-1)).reshape(f + 1, k)
        t = 1.0
        while True:
            new = loss(w - t * step)
            if new <= value or t < 1e-8:
                break
            t *= 0.5
        w = w - t * step
        done = float(value - new) <= 1e-10 * max(1.0, abs(float(value)))
        value = new
        if done:
            break
    return w


def probe_fold_accuracies(z: np.ndarray, labels: np.ndarray,
                          device: DeviceLike = None) -> list:
    """sklearn ``cross_val_score(LogisticRegression(max_iter=500), z,
    labels, cv=3)``: each unshuffled stratified fold's test accuracy."""
    from causalvae_tpu_torch.train.kfold import stratified_kfold_unshuffled

    dev = resolve_device(device)
    labels = np.asarray(labels)
    classes, y_all = np.unique(labels, return_inverse=True)
    x = torch.as_tensor(np.asarray(z), dtype=torch.float64, device=dev)
    y = torch.as_tensor(y_all.reshape(-1), device=dev)
    plan = stratified_kfold_unshuffled(labels, 3)
    scores = []
    for tr, te in zip(plan.train_idx, plan.val_idx):
        tr_t = torch.as_tensor(tr, device=dev, dtype=torch.long)
        te_t = torch.as_tensor(te, device=dev, dtype=torch.long)
        # sklearn fits on the classes present in the training fold
        present, y_tr = torch.unique(y[tr_t], return_inverse=True)
        w = _fit_logistic(x[tr_t], y_tr, len(present))
        s = x[te_t] @ w[:-1] + w[-1]
        pred = (s[:, 0] > 0).long() if s.shape[1] == 1 else s.argmax(dim=1)
        scores.append(int((present[pred] == y[te_t]).sum()) / len(te))
    return scores


def disentanglement_score(z: np.ndarray, labels: np.ndarray,
                          device: DeviceLike = None) -> float:
    """How well a linear probe predicts T from Z (lower = better
    disentangled): the mean of ``probe_fold_accuracies``."""
    return float(np.mean(probe_fold_accuracies(z, labels, device)))


@torch.no_grad()
def real_vs_fake_embedding(classifier, real_x: np.ndarray, fake_x: np.ndarray,
                           batch_size: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """The classifier's 50-d features of real and generated images (ref
    visualize.py:190-246), ``batch_size`` at a time on its device; returns
    (real_feats, fake_feats)."""
    classifier.eval()
    dev = module_device(classifier)

    def run(x):
        out = []
        for s in range(0, len(x), batch_size):
            feats, _ = classifier(torch.as_tensor(np.asarray(x[s: s + batch_size])).to(dev))
            out.append(feats.float().cpu().numpy())
        return np.concatenate(out)

    return run(real_x), run(fake_x)


def centroid_outliers(feats: np.ndarray, labels: np.ndarray, top_k: int = 8
                      ) -> Dict[int, np.ndarray]:
    """Per-class farthest-from-centroid samples (ref visualize.py:247-319
    outlier grids). Returns {class: indices (into feats)}."""
    out = {}
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        centroid = feats[idx].mean(axis=0)
        d = np.linalg.norm(feats[idx] - centroid, axis=1)
        out[int(c)] = idx[np.argsort(-d)[:top_k]]
    return out

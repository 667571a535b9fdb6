"""Latent-to-morphology Ridge translation (A17)
(``causalvae_tpu/analysis/translate.py``, numpy, copied as it is).

LOOCV Ridge of Z -> M per feature with R²/correlation ranking, a final
full-data translator W, group-mean contrasts, and bootstrap top-k stability
(ref latent_translator/analysis.py:11-165).

Design: LOOCV for ridge regression has a closed form via the hat matrix —
instead of n_samples separate fits (the reference's sklearn loop), one SVD of
Z gives every leave-one-out prediction at once; the whole analysis is a few
matmuls. Bootstrap ranking is vectorized over resamples.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def ridge_fit(z: np.ndarray, m: np.ndarray, alpha: float = 1.0):
    """Closed-form ridge: W = (Z'Z + aI)^-1 Z'M, with intercept."""
    zc = z - z.mean(axis=0)
    mc = m - m.mean(axis=0)
    d = z.shape[1]
    W = np.linalg.solve(zc.T @ zc + alpha * np.eye(d), zc.T @ mc)
    b = m.mean(axis=0) - z.mean(axis=0) @ W
    return W, b


def ridge_loocv_predictions(z: np.ndarray, m: np.ndarray, alpha: float = 1.0) -> np.ndarray:
    """All leave-one-out predictions in one shot via the hat-matrix identity
    e_loo = e / (1 - h_ii) — no per-sample refits."""
    n = z.shape[0]
    zc = z - z.mean(axis=0)
    mc = m - m.mean(axis=0)
    A = np.linalg.solve(zc.T @ zc + alpha * np.eye(z.shape[1]), zc.T)
    H = zc @ A  # hat matrix (n, n)
    pred = H @ mc
    resid = mc - pred
    h = np.clip(np.diag(H), 0.0, 1.0 - 1e-8)
    loo_resid = resid / (1.0 - h)[:, None]
    return (mc - loo_resid) + m.mean(axis=0)


def fit_translator(
    z: np.ndarray, m: np.ndarray, feature_names: Sequence[str],
    alpha: float = 1.0,
) -> Dict:
    """LOOCV R² + Pearson r per feature, ranking, and the final full-data W
    (ref analysis.py:11-82 fit_translator_ridge)."""
    loo = ridge_loocv_predictions(z, m, alpha)
    ss_res = ((m - loo) ** 2).sum(axis=0)
    ss_tot = ((m - m.mean(axis=0)) ** 2).sum(axis=0)
    r2 = 1.0 - ss_res / np.where(ss_tot == 0, 1.0, ss_tot)
    corr = np.array([
        np.corrcoef(m[:, f], loo[:, f])[0, 1] if m[:, f].std() > 0 else 0.0
        for f in range(m.shape[1])
    ])
    W, b = ridge_fit(z, m, alpha)
    order = np.argsort(-r2)
    return {
        "r2": {feature_names[i]: float(r2[i]) for i in order},
        "corr": {feature_names[i]: float(corr[i]) for i in order},
        "ranking": [feature_names[i] for i in order],
        "W": W, "intercept": b, "loo_predictions": loo,
    }


def group_contrasts(
    z: np.ndarray, groups: np.ndarray, group_names: Sequence[str]
) -> Dict:
    """Group-mean latent contrasts vs the grand mean (ref analysis.py:84-120)."""
    grand = z.mean(axis=0)
    out = {}
    for g in np.unique(groups):
        delta = z[groups == g].mean(axis=0) - grand
        out[group_names[int(g)]] = {
            "norm": float(np.linalg.norm(delta)),
            "top_dims": np.argsort(-np.abs(delta))[:10].tolist(),
        }
    return out


def bootstrap_topk_stability(
    z: np.ndarray, m: np.ndarray, feature_names: Sequence[str],
    *, k: int = 5, n_boot: int = 100, alpha: float = 1.0, seed: int = 0,
) -> Dict:
    """Frequency each feature lands in the LOOCV-R² top-k across bootstrap
    resamples (ref analysis.py:122-165)."""
    rng = np.random.default_rng(seed)
    n = len(z)
    counts = np.zeros(m.shape[1])
    for _ in range(n_boot):
        idx = rng.integers(0, n, n)
        zb, mb = z[idx], m[idx]
        loo = ridge_loocv_predictions(zb, mb, alpha)
        ss_res = ((mb - loo) ** 2).sum(axis=0)
        ss_tot = ((mb - mb.mean(axis=0)) ** 2).sum(axis=0)
        r2 = 1.0 - ss_res / np.where(ss_tot == 0, 1.0, ss_tot)
        counts[np.argsort(-r2)[:k]] += 1
    freq = counts / n_boot
    order = np.argsort(-freq)
    return {feature_names[i]: float(freq[i]) for i in order}

"""Mechanism validity and sensitivity analyses (A1, A4, A18, A8)
(``causalvae_tpu/analysis/mechanism.py``).

Each takes a model with ``predict_m`` (and, for ``uncertainty_table``, a
Gaussian ``morph`` head); the weights live in the module, so JAX's
``variables`` argument has no counterpart. The conditions go to the model's
device; the verdicts keep the reference's thresholds.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from causalvae_tpu_torch.device import module_device


def r2_per_feature(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """sklearn-style R² per feature column (a constant column's denominator
    taken as 1)."""
    ss_res = ((target - pred) ** 2).sum(axis=0)
    ss_tot = ((target - target.mean(axis=0)) ** 2).sum(axis=0)
    return 1.0 - ss_res / np.where(ss_tot == 0, 1.0, ss_tot)


@torch.no_grad()
def _predict_m(model, t) -> np.ndarray:
    from causalvae_tpu_torch.scm.intervene import predict_m

    t = torch.as_tensor(np.asarray(t, np.float32)).to(module_device(model))
    return predict_m(model, t).cpu().numpy()


def mechanism_validity(model, m: np.ndarray, t: np.ndarray, feature_names: Sequence[str],
                       pass_threshold: float = 0.5) -> Dict:
    """R² and MSE of M̂ = f(T) against the measured M per feature; PASS if
    the average R² exceeds ``pass_threshold`` (A1)."""
    m_hat = _predict_m(model, t)
    r2 = r2_per_feature(m_hat, m)
    mse = ((m_hat - m) ** 2).mean(axis=0)
    avg_r2 = float(r2.mean())
    return {
        "r2": {n: float(v) for n, v in zip(feature_names, r2)},
        "mse": {n: float(v) for n, v in zip(feature_names, mse)},
        "avg_r2": avg_r2,
        "verdict": "PASS" if avg_r2 > pass_threshold else "FAIL",
    }


def phase1_importance(model, t_dim: int, feature_names: Sequence[str]) -> Dict:
    """Phase-1 sensitivity: the std across conditions of f(eye(T)) per
    feature, ranked (A4)."""
    preds = _predict_m(model, np.eye(t_dim, dtype=np.float32))  # (T, m)
    sens = preds.std(axis=0)
    order = np.argsort(-sens)
    return {
        "sensitivity": {feature_names[i]: float(sens[i]) for i in order},
        "ranking": [feature_names[i] for i in order],
        "predictions": preds,
    }


def cascade_sensitivity(model, t_dim: int, control_idx: int,
                        feature_names: Sequence[str]) -> Dict:
    """f(T_i) - f(control) per condition, ranked by mean |difference| (A18)."""
    preds = _predict_m(model, np.eye(t_dim, dtype=np.float32))
    delta = preds - preds[control_idx:control_idx + 1]
    importance = np.abs(delta).mean(axis=0)
    order = np.argsort(-importance)
    return {
        "delta": delta,
        "importance": {feature_names[i]: float(importance[i]) for i in order},
        "ranking": [feature_names[i] for i in order],
    }


@torch.no_grad()
def uncertainty_table(model, t_dim: int, feature_names: Sequence[str]) -> Dict:
    """sigma of P(M|T) per condition x feature, and the most and least
    certain feature per condition (A8)."""
    from causalvae_tpu_torch.scm.uncertainty import all_conditions_sigma

    mu, sigma = (v.cpu().numpy() for v in all_conditions_sigma(model, t_dim))
    rows = [{
        "condition": t,
        "most_certain": feature_names[int(sigma[t].argmin())],
        "least_certain": feature_names[int(sigma[t].argmax())],
        "sigma_min": float(sigma[t].min()),
        "sigma_max": float(sigma[t].max()),
    } for t in range(t_dim)]
    return {"mu": mu, "sigma": sigma, "per_condition": rows}

"""K-fold evaluation and the ensemble pairwise report
(``causalvae_tpu/analysis/kfold_eval.py``).

Per-fold per-feature R² and mean aleatoric sigma on each fold's val split,
their aggregation over folds (mean, std, CV), and the all-pairs ensemble
treatment report with its filtered views. The fold models are an
``nn.ModuleList`` (``scm/ensemble.py``); where JAX slices fold f out of the
stacked parameters, the port takes member f.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

import numpy as np
import torch

from causalvae_tpu_torch.analysis.mechanism import r2_per_feature
from causalvae_tpu_torch.device import module_device


@torch.no_grad()
def per_fold_validation_r2(models, plan, m: np.ndarray, t: np.ndarray,
                           feature_names: Sequence[str]) -> Dict:
    """R²(m_mu vs m) per feature on each fold's val split, plus each fold's
    mean sigma; the aggregate over folds per feature."""
    from causalvae_tpu_torch.scm.uncertainty import morph_sigma

    r2s, sigmas = [], []
    for f in range(plan.n_folds):
        idx = plan.val_idx[f]
        mu, sigma = morph_sigma(models[f], torch.as_tensor(
            np.asarray(t)[idx], device=module_device(models[f])))
        r2s.append(r2_per_feature(mu.float().cpu().numpy(), np.asarray(m)[idx]))
        sigmas.append(sigma.float().cpu().numpy().mean(axis=0))
    r2s = np.stack(r2s)      # (K, F)
    sigmas = np.stack(sigmas)
    mean, std = r2s.mean(axis=0), r2s.std(axis=0)
    cv = std / np.where(np.abs(mean) > 1e-9, np.abs(mean), 1.0)
    return {
        "per_fold_r2": r2s,
        "per_fold_sigma": sigmas,
        "aggregate": {
            feature_names[i]: {
                "r2_mean": float(mean[i]), "r2_std": float(std[i]),
                "cv": float(cv[i]), "sigma_mean": float(sigmas.mean(0)[i]),
            }
            for i in range(len(feature_names))
        },
    }


@torch.no_grad()
def ensemble_pairwise_report(models, t_dim: int, group_names: Sequence,
                             feature_names: Sequence[str]) -> List[Dict]:
    """All ordered treatment pairs x features: the ensemble-mean M'
    difference (the all_pairwise_report.csv rows)."""
    from causalvae_tpu_torch.scm.ensemble import ensemble_predict_m

    t_eye = torch.eye(t_dim, device=module_device(models))
    mu_mean, _ = ensemble_predict_m(models, t_eye)
    mu_mean = mu_mean.float().cpu().numpy()  # (T, F)
    rows = []
    for i in range(t_dim):
        for j in range(t_dim):
            if i == j:
                continue
            diff = mu_mean[i] - mu_mean[j]
            for f, name in enumerate(feature_names):
                rows.append({
                    "treatment_a": group_names[i], "treatment_b": group_names[j],
                    "feature": name, "diff": float(diff[f]),
                    "abs_diff": float(abs(diff[f])),
                })
    return rows


_CONC_RE = re.compile(r"(\d+(?:\.\d+)?)\s*(nM|uM|ug|mg|µM|µg)", re.IGNORECASE)


def parse_treatment_name(name: str) -> Dict:
    """Split 'Drug 10nM'-style group names into drug, concentration and unit."""
    m = _CONC_RE.search(name)
    conc = float(m.group(1)) if m else None
    unit = m.group(2) if m else None
    drug = _CONC_RE.sub("", name).strip(" -_")
    return {"drug": drug, "concentration": conc, "unit": unit}


def filter_pairwise(rows: List[Dict], *, mode: str,
                    baseline_names: Sequence[str] = ("PBS", "isotype")) -> List[Dict]:
    """Filtered pairwise views:
    'efficacy'       — drug vs named baselines
    'dose_response'  — same drug, different concentration
    'vs_baseline'    — any treatment vs each baseline name."""
    out = []
    for r in rows:
        a = parse_treatment_name(r["treatment_a"])
        b = parse_treatment_name(r["treatment_b"])
        is_baseline_b = any(bn.lower() in r["treatment_b"].lower() for bn in baseline_names)
        if mode == "efficacy" and is_baseline_b:
            out.append(r)
        elif (mode == "dose_response" and a["drug"] == b["drug"]
              and a["concentration"] != b["concentration"]):
            out.append(r)
        elif mode == "vs_baseline" and is_baseline_b:
            out.append(r)
    return out


def top_k_per_pair(rows: List[Dict], k: int = 3) -> Dict:
    """The k features of largest |diff| per treatment pair."""
    by_pair: Dict = {}
    for r in rows:
        by_pair.setdefault((r["treatment_a"], r["treatment_b"]), []).append(r)
    return {pair: sorted(rs, key=lambda r: -r["abs_diff"])[:k]
            for pair, rs in by_pair.items()}

"""Vessel model reports (``causalvae_tpu/analysis/vessel_report.py``): the
two row functions of the CLI's ``vessel-report``, ``predictions_by_treatment``
and ``uncertainty_by_treatment_rows``, in the JAX package's CSV contracts.
The module's other reports (``discriminative_feature_ensemble``, which
needs sklearn's RandomForest, ``full_report_vs_baseline``,
``reliability_gate``, ``m_influence_check``, ``fix_csv_names``) are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from causalvae_tpu_torch.device import module_device


@torch.no_grad()
def predictions_by_treatment(model, x, m, t, t_idx: np.ndarray,
                             group_names: Sequence, feature_names: Sequence[str],
                             batch_size: int = 16) -> Dict:
    """Every sample through the model's eval forward (``batch_size`` rows at
    a time, noise from a CPU generator seeded 0), its m_mu gathered per
    treatment: one row per (treatment, feature) with mean, std and count,
    for every treatment present."""
    model.eval()
    dev = module_device(model)
    gen = torch.Generator().manual_seed(0)
    mus = []
    for s in range(0, len(x), batch_size):
        out = model(*(torch.as_tensor(a[s: s + batch_size]).to(dev) for a in (x, m, t)),
                    generator=gen)
        mus.append(out.m_mu.float().cpu().numpy())
    mus = np.concatenate(mus)  # (N, F)

    rows, table = [], {}
    t_idx = np.asarray(t_idx)
    for g in range(len(group_names)):
        sel = t_idx == g
        if not sel.any():
            continue
        mean, std = mus[sel].mean(axis=0), mus[sel].std(axis=0)
        table[g] = {"mean": mean, "std": std, "n": int(sel.sum())}
        for f, name in enumerate(feature_names):
            rows.append({
                "treatment": group_names[g], "feature": name,
                "mean": float(mean[f]), "std": float(std[f]), "n": int(sel.sum()),
            })
    return {"rows": rows, "by_treatment": table, "per_sample_mu": mus}


@torch.no_grad()
def uncertainty_by_treatment_rows(models, group_names: Sequence,
                                  feature_names: Sequence[str]) -> List[Dict]:
    """uncertainty_by_treatment.csv rows: the fold-mean prediction and
    aleatoric sigma per (treatment, feature)."""
    from causalvae_tpu_torch.scm.uncertainty import ensemble_sigma_by_treatment

    mu, sigma = ensemble_sigma_by_treatment(models, len(group_names))
    mu, sigma = mu.float().cpu().numpy(), sigma.float().cpu().numpy()
    return [
        {"treatment": group_names[g], "feature": feature_names[f],
         "pred_mean": float(mu[g, f]), "aleatoric_sigma": float(sigma[g, f])}
        for g in range(len(group_names))
        for f in range(len(feature_names))
    ]

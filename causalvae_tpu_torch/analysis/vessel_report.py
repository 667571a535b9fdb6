"""Vessel model reports (``causalvae_tpu/analysis/vessel_report.py``), in
the JAX package's CSV contracts: the two row functions of the CLI's
``vessel-report`` (``predictions_by_treatment``,
``uncertainty_by_treatment_rows``), the discriminative feature ensemble,
the report against a baseline group, the reliability gate, the decoder's
M-influence check and the pairwise CSV's name fix.

``discriminative_feature_ensemble`` ranks features by three scores, as the
JAX one: a random forest's impurity importances, the variance and the
one-way ANOVA F. The card's machine has no sklearn, so the forest is
written here in numpy with sklearn's ``RandomForestClassifier`` defaults
(100 trees, gini, bootstrap samples, sqrt(F) candidate features per node,
grown until pure, one sample a leaf at least; a tree's importances are its
weighted impurity decreases, normalised; the forest's, their mean over the
trees that split). It is seeded by ``seed`` through numpy's generator, so
its trees are not sklearn's: the importances agree with sklearn's as two
forests of 100 trees do. The F statistic is sklearn's ``f_classif``
arithmetic in the data's type.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Sequence

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


def _gini(weights: np.ndarray) -> np.ndarray:
    """Gini impurity of rows of per-class weights."""
    total = weights.sum(axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = weights / total[..., None]
    return 1.0 - np.nansum(frac * frac, axis=-1)


def _tree_importances(x: np.ndarray, y: np.ndarray, w: np.ndarray, n_classes: int,
                      max_features: int, rng: np.random.Generator) -> np.ndarray:
    """One fully grown gini tree on the samples of weight w > 0 (weights the
    bootstrap counts): each feature's summed weighted impurity decrease,
    normalised to 1 (zeros for a tree that never splits)."""
    n_features = x.shape[1]
    imp = np.zeros(n_features)
    onehot = np.eye(n_classes)[y] * w[:, None]
    stack = [np.nonzero(w > 0)[0]]
    while stack:
        idx = stack.pop()
        node = onehot[idx].sum(axis=0)
        node_imp = _gini(node)
        if len(idx) < 2 or node_imp <= 1e-7:
            continue
        best = None  # (proxy, feature, left indices, right indices)
        evaluated = 0
        for f in rng.permutation(n_features):
            if evaluated >= max_features:
                break
            vals = x[idx, f]
            order = np.argsort(vals, kind="stable")
            sv = vals[order]
            if sv[-1] <= sv[0] + 1e-7:
                continue  # constant here: sklearn draws another feature
            evaluated += 1
            left = np.cumsum(onehot[idx[order]], axis=0)[:-1]
            right = node - left
            valid = sv[1:] > sv[:-1] + 1e-7
            wl, wr = left.sum(axis=1), right.sum(axis=1)
            with np.errstate(invalid="ignore", divide="ignore"):
                proxy = (np.where(wl > 0, (left * left).sum(axis=1) / wl, 0.0)
                         + np.where(wr > 0, (right * right).sum(axis=1) / wr, 0.0))
            proxy = np.where(valid, proxy, -np.inf)
            pos = int(np.argmax(proxy))
            if np.isfinite(proxy[pos]) and (best is None or proxy[pos] > best[0]):
                best = (proxy[pos], f, idx[order[:pos + 1]], idx[order[pos + 1:]])
        if best is None:
            continue
        _, f, li, ri = best
        wl, wr = onehot[li].sum(axis=0), onehot[ri].sum(axis=0)
        imp[f] += (node.sum() * node_imp - wl.sum() * _gini(wl) - wr.sum() * _gini(wr))
        stack += [ri, li]
    total = imp.sum()
    return imp / total if total > 0 else imp


def random_forest_importances(x: np.ndarray, labels: np.ndarray, n_estimators: int = 100,
                              seed: int = 42) -> np.ndarray:
    """The impurity importances of a random forest with sklearn's
    ``RandomForestClassifier`` defaults, seeded by ``seed``."""
    x = np.asarray(x, np.float64)
    _, y = np.unique(np.asarray(labels), return_inverse=True)
    y = y.reshape(-1)
    n, n_features = x.shape
    n_classes = int(y.max()) + 1
    max_features = max(1, int(np.sqrt(n_features)))
    rng = np.random.default_rng(seed)
    trees = []
    for _ in range(n_estimators):
        w = np.bincount(rng.integers(0, n, n), minlength=n).astype(np.float64)
        imp = _tree_importances(x, y, w, n_classes, max_features, rng)
        if imp.any():
            trees.append(imp)
    if not trees:
        return np.zeros(n_features)
    mean = np.mean(trees, axis=0)
    return mean / mean.sum()


def anova_f(x: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """sklearn ``f_classif(x, labels)[0]``: the one-way ANOVA F per feature,
    in sklearn's arithmetic and x's float type (inf or nan where a feature
    is constant within every class)."""
    x = np.asarray(x)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    labels = np.asarray(labels)
    args = [x[labels == k] for k in np.unique(labels)]
    n_per = np.array([a.shape[0] for a in args])
    n = np.sum(n_per)
    ss_all = sum((a * a).sum(axis=0) for a in args)
    sums = [np.asarray(a.sum(axis=0)) for a in args]
    sq_all = sum(sums) ** 2
    sstot = ss_all - sq_all / float(n)
    ssbn = 0.0
    for k in range(len(args)):
        ssbn += sums[k] ** 2 / n_per[k]
    ssbn -= sq_all / float(n)
    sswn = sstot - ssbn
    with np.errstate(divide="ignore", invalid="ignore"):
        f = (ssbn / float(len(args) - 1)) / (sswn / float(n - len(args)))
    return np.asarray(f).ravel()


def discriminative_feature_ensemble(mus: np.ndarray, t_idx: np.ndarray,
                                    feature_names: Sequence[str], seed: int = 42) -> Dict:
    """Random-forest importance + variance + ANOVA-F over per-sample
    predicted morphology, and the features ordered by their averaged rank
    (A13, ref analyze_discriminative_features.py:14-179)."""
    mus = np.asarray(mus)
    rf_imp = random_forest_importances(mus, t_idx, seed=seed)
    variance = mus.var(axis=0)
    f_stat = np.nan_to_num(anova_f(mus, t_idx))

    def rank(v):
        order = np.argsort(-v)
        r = np.empty_like(order)
        r[order] = np.arange(len(v))
        return r

    avg_rank = (rank(rf_imp) + rank(variance) + rank(f_stat)) / 3.0
    order = np.argsort(avg_rank)
    return {
        "rf_importance": {feature_names[i]: float(rf_imp[i]) for i in range(len(feature_names))},
        "variance": {feature_names[i]: float(variance[i]) for i in range(len(feature_names))},
        "anova_f": {feature_names[i]: float(f_stat[i]) for i in range(len(feature_names))},
        "consensus_ranking": [feature_names[i] for i in order],
    }


def full_report_vs_baseline(mu: np.ndarray, sigma: np.ndarray, baseline_idx: int,
                            group_names: Sequence, feature_names: Sequence[str]
                            ) -> List[Dict]:
    """Every treatment vs the baseline group: per-feature delta mu and
    discriminative score (A12, ref analyze_vessel.py:192-313)."""
    rows = []
    for g in range(len(group_names)):
        if g == baseline_idx:
            continue
        d = mu[g] - mu[baseline_idx]
        score = np.abs(d) / np.sqrt(sigma[g] ** 2 + sigma[baseline_idx] ** 2 + 1e-12)
        for f, name in enumerate(feature_names):
            rows.append({
                "treatment": group_names[g], "baseline": group_names[baseline_idx],
                "feature": name, "delta": float(d[f]), "score": float(score[f]),
            })
    return rows


def reliability_gate(r2_by_treatment_feature: np.ndarray,
                     sigma_by_treatment_feature: np.ndarray, group_names: Sequence,
                     feature_names: Sequence[str], *, reliable_sigma: float = 0.6,
                     unreliable_sigma: float = 0.8) -> List[Dict]:
    """sigma-gated reliability class per (treatment, feature): sigma <= 0.6
    reliable, > 0.8 unreliable, else marginal (A16, ref
    plot_detailed_reliability.py:116-205)."""
    rows = []
    for g in range(len(group_names)):
        for f in range(len(feature_names)):
            s = float(sigma_by_treatment_feature[g, f])
            cat = ("reliable" if s <= reliable_sigma
                   else "unreliable" if s > unreliable_sigma else "marginal")
            rows.append({
                "treatment": group_names[g], "feature": feature_names[f],
                "r2": float(r2_by_treatment_feature[g, f]),
                "sigma": s, "category": cat,
            })
    return rows


_FIRST_DECODER_LAYERS = ("dec_fc", "dec_fc1", "dec_adapter_fc1")


@torch.no_grad()
def m_influence_check(model, x, m, t, *, shift: float = 10.0,
                      generator: Optional[torch.Generator] = None) -> Dict:
    """Decoder-uses-M diagnostic (I5, ref check_m_influence.py:14-86): the
    mean |pixel change| between decode(m, z) and decode(m + shift, z) for
    the abducted mean z (below 1e-4: "CRITICAL: decoder ignoring M"), and
    the first decoder layer's mean |weight| on the M inputs over that on
    the rest (the model's ``dec_fc``, ``dec_fc1`` or ``dec_adapter_fc1``;
    None for a model with none). As in the JAX check, the layer's first
    ``m_dim`` inputs are taken for M's, which holds for the vessel and MNIST
    models; C5's ``dec_fc`` reads [z, t], and its ratio is JAX's number
    all the same. ``generator`` is the JAX check's ``rng``, which reaches
    nothing (the abduction is the mean)."""
    from causalvae_tpu_torch.scm.intervene import abduct, decode

    model.eval()
    dev = module_device(model)
    x, m, t = (torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
               .to(dev) for a in (x, m, t))
    z = abduct(model, x, m, t)
    base = decode(model, m, z)
    shifted = decode(model, m + shift, z)
    diff = float((shifted.float() - base.float()).abs().mean())

    ratio = None
    for name in _FIRST_DECODER_LAYERS:
        layer = getattr(model, name, None)
        if layer is not None:
            # nn.Linear keeps (out, in); JAX's kernel is (in, out): its rows
            # [:m_dim] are the weight's columns [:, :m_dim]
            w = np.ascontiguousarray(layer.weight.detach().float().cpu().numpy().T)
            m_dim = m.shape[-1]
            m_mass = np.abs(w[:m_dim]).mean()
            z_mass = np.abs(w[m_dim:]).mean()
            ratio = float(m_mass / (z_mass + 1e-12))
            break
    verdict = "CRITICAL: decoder ignoring M" if diff < 1e-4 else "OK"
    return {"mean_pixel_diff": diff, "m_to_z_weight_ratio": ratio, "verdict": verdict}


def fix_csv_names(csv_path: str, group_names: Sequence) -> int:
    """Rewrite numeric Treatment_From/Treatment_To indices in a pairwise
    report CSV into group names, in place (ref vessel_analysis/
    02_evaluate_kfold/fix_csv_names.py:11-68). Returns the number of cells
    rewritten; non-numeric columns are left untouched."""
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return 0
    fixed = 0
    for col in ("Treatment_From", "Treatment_To"):
        if col not in rows[0]:
            continue
        try:
            vals = [int(float(r[col])) for r in rows]
        except ValueError:
            continue  # already names
        for r, v in zip(rows, vals):
            if 0 <= v < len(group_names):
                r[col] = group_names[v]
                fixed += 1
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    return fixed

"""Measurement-based feature importance (A5) and the phase comparison (A6)
(``causalvae_tpu/analysis/importance.py``).

Phase 2 re-measures morphology on *generated* counterfactual images and
ranks features by how much they move across conditions. The sweep is the
model's decode and the measurement the device morphology
(``ops/morphology.py``), both on the device of the generated images. Where
JAX ``vmap``s over perturbed features, the port loops.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


@torch.no_grad()
def measure_generated(images: torch.Tensor, n_features: int = 16) -> torch.Tensor:
    """The device morphology of generated images (..., H, W, 1) in [0, 1],
    on their device -> (..., n_features)."""
    from causalvae_tpu_torch.ops import morphology

    flat = images.reshape((-1,) + tuple(images.shape[-3:]))[..., 0]
    fn = morphology.features16_batch if n_features == 16 else morphology.features12_batch
    return fn(flat).reshape(tuple(images.shape[:-3]) + (n_features,))


@torch.no_grad()
def phase2_importance(
    decode_fn,
    z_samples: torch.Tensor,
    t_dim: int,
    *,
    n_features: int = 16,
    feature_names: Optional[Sequence[str]] = None,
) -> Dict:
    """Fixed z pool, sweep all conditions, re-measure, rank by the mean over
    samples of the std across conditions (A5).

    decode_fn(t_onehot (T, t_dim), z (S, z_dim)) -> (T, S, H, W, 1): the
    model's batched counterfactual generator; the one-hot conditions are made
    on ``z_samples``' device."""
    t_eye = torch.eye(t_dim, dtype=torch.float32, device=z_samples.device)
    feats = measure_generated(decode_fn(t_eye, z_samples), n_features)  # (T, S, F)
    sens = feats.std(dim=0, correction=0).mean(dim=0).cpu().numpy()
    order = np.argsort(-sens)
    names = list(feature_names) if feature_names else [f"f{i}" for i in range(len(sens))]
    return {
        "sensitivity": {names[i]: float(sens[i]) for i in order},
        "ranking": [names[i] for i in order],
        "features": feats.cpu().numpy(),
    }


def pairwise_cohens_d(
    feats_a: np.ndarray, feats_b: np.ndarray, feature_names: Sequence[str]
) -> Dict:
    """Cohen's d per feature between two conditions' generated measurements."""
    mean_a, mean_b = feats_a.mean(axis=0), feats_b.mean(axis=0)
    var_a, var_b = feats_a.var(axis=0), feats_b.var(axis=0)
    pooled = np.sqrt((var_a + var_b) / 2.0 + 1e-12)
    d = (mean_b - mean_a) / pooled
    order = np.argsort(-np.abs(d))
    return {
        "cohens_d": {feature_names[i]: float(d[i]) for i in order},
        "ranking": [feature_names[i] for i in order],
    }


def minmax_normalize(values: np.ndarray) -> np.ndarray:
    lo, hi = values.min(), values.max()
    return (values - lo) / (hi - lo) if hi > lo else np.zeros_like(values)


def compare_phases(phase1: Dict, phase2: Dict, feature_names: Sequence[str]) -> Dict:
    """Min-max-normalized side-by-side comparison of the phase-1 (mechanism)
    and phase-2 (measured) sensitivities, and their correlation (A6)."""
    common = [n for n in feature_names
              if n in phase1["sensitivity"] and n in phase2["sensitivity"]]
    v1 = minmax_normalize(np.asarray([phase1["sensitivity"][n] for n in common]))
    v2 = minmax_normalize(np.asarray([phase2["sensitivity"][n] for n in common]))
    agreement = float(np.corrcoef(v1, v2)[0, 1]) if len(common) > 1 else float("nan")
    return {
        "features": common,
        "phase1_norm": {n: float(v) for n, v in zip(common, v1)},
        "phase2_norm": {n: float(v) for n, v in zip(common, v2)},
        "rank_correlation": agreement,
    }


@torch.no_grad()
def perturbation_importance(
    decode_fn, m_base: torch.Tensor, z_base: torch.Tensor, *,
    delta: float = 1.0, n_random: int = 8, generator: Optional[torch.Generator] = None,
    feature_names: Optional[Sequence[str]] = None,
) -> Dict:
    """Visual-perturbation importance: the mean L2 image change from adding
    ``delta`` to each feature over ``n_random`` (m, z) rows (A12): rows drawn
    with ``generator`` (JAX: ``rng``), else the first ``n_random``.

    decode_fn(m (B, F), z (B, Z)) -> (B, H, W, 1)."""
    m_dim = m_base.shape[-1]
    if generator is not None:
        idx = torch.randint(0, m_base.shape[0], (n_random,), generator=generator,
                            device=generator.device).to(m_base.device)
        ms, zs = m_base[idx], z_base[idx]
    else:
        ms, zs = m_base[:n_random], z_base[:n_random]
    base = decode_fn(ms, zs)
    changes = []
    for f in range(m_dim):
        m_p = ms.clone()
        m_p[:, f] += delta
        out = decode_fn(m_p, zs)
        changes.append(torch.sqrt(((out - base) ** 2).sum(dim=(1, 2, 3))).mean())
    changes = torch.stack(changes).cpu().numpy()
    order = np.argsort(-changes)
    names = list(feature_names) if feature_names else [f"f{i}" for i in range(m_dim)]
    return {
        "image_change": {names[i]: float(changes[i]) for i in order},
        "ranking": [names[i] for i in order],
    }

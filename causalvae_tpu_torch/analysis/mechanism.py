"""Mechanism analyses (``causalvae_tpu/analysis/mechanism.py``): so far
``r2_per_feature``, which the k-fold evaluation reads. The validity,
sensitivity and residual analyses come with the rest of ``analysis/``."""

from __future__ import annotations

import numpy as np


def r2_per_feature(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """sklearn-style R² per feature column (a constant column's denominator
    taken as 1)."""
    ss_res = ((target - pred) ** 2).sum(axis=0)
    ss_tot = ((target - target.mean(axis=0)) ** 2).sum(axis=0)
    return 1.0 - ss_res / np.where(ss_tot == 0, 1.0, ss_tot)

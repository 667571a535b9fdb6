"""Causal-effect estimation and refutation suite (A7), self-contained numpy
(``causalvae_tpu/analysis/causal_checks.py``).

Per feature, a backdoor linear-regression estimate of T -> M_f (two
conditions, Gaussian noise of std 0.5 injected), then three refuters
(random common cause, placebo treatment by permuting T, an unobserved common
cause) and a tipping-point sweep over confounder strength 0.1..1.0 for a
sign flip of the effect. The estimator is OLS on the treatment indicator;
the refuters' p-values are those of the JAX package's built-in path. The
DoWhy path of the JAX package is not ported: ``use_dowhy="auto"`` and
``"never"`` take the built-in path, ``"require"`` raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _ols_effect(treat: np.ndarray, outcome: np.ndarray,
                extra: Optional[np.ndarray] = None) -> float:
    """OLS coefficient of the binary treatment on the outcome
    (backdoor.linear_regression with no measured confounders)."""
    cols = [np.ones_like(treat, dtype=np.float64), treat.astype(np.float64)]
    if extra is not None:
        cols.append(extra.astype(np.float64))
    X = np.stack(cols, axis=1)
    beta, *_ = np.linalg.lstsq(X, outcome.astype(np.float64), rcond=None)
    return float(beta[1])


def estimate_effect(
    m_a: np.ndarray, m_b: np.ndarray, *, noise_std: float = 0.5, seed: int = 0
) -> Dict:
    """Effect of condition B vs A on one feature with injected Gaussian noise
    (ref analyze_dowhy.py:75-96 builds exactly this two-group frame)."""
    rng = np.random.default_rng(seed)
    outcome = np.concatenate([m_a, m_b]) + rng.normal(
        0.0, noise_std, len(m_a) + len(m_b)
    )
    treat = np.concatenate([np.zeros(len(m_a)), np.ones(len(m_b))])
    return {"effect": _ols_effect(treat, outcome), "treat": treat, "outcome": outcome}


def refute_random_common_cause(
    treat: np.ndarray, outcome: np.ndarray, base_effect: float,
    n_sims: int = 100, seed: int = 1,
) -> Dict:
    """Add an independent random covariate; the estimate should not move.
    p = fraction of sims whose |effect - base| exceeds the observed spread
    (DoWhy's RandomCommonCause semantics: high p = robust)."""
    rng = np.random.default_rng(seed)
    effects = np.array([
        _ols_effect(treat, outcome, rng.normal(size=len(treat)))
        for _ in range(n_sims)
    ])
    # robust if the distribution of new effects stays centered on base_effect
    z = abs(effects.mean() - base_effect) / (effects.std() + 1e-12)
    from math import erf, sqrt

    p = 1.0 - erf(z / sqrt(2.0))
    return {"new_effect": float(effects.mean()), "p_value": float(p)}


def refute_placebo(
    treat: np.ndarray, outcome: np.ndarray, base_effect: float,
    n_sims: int = 100, seed: int = 2,
) -> Dict:
    """Permute the treatment; the effect should collapse to ~0. p = fraction
    of permuted |effects| >= |base| would be ~0 for a real effect; DoWhy
    reports p as the placebo effect's consistency with zero (high = good)."""
    rng = np.random.default_rng(seed)
    effects = np.array([
        _ols_effect(rng.permutation(treat), outcome) for _ in range(n_sims)
    ])
    z = abs(effects.mean()) / (effects.std() + 1e-12)
    from math import erf, sqrt

    p = 1.0 - erf(z / sqrt(2.0))
    return {"placebo_effect": float(effects.mean()), "p_value": float(p)}


def refute_unobserved_common_cause(
    treat: np.ndarray, outcome: np.ndarray, *,
    effect_strength_on_outcome: float = 0.5, seed: int = 3,
) -> Dict:
    """Simulate an unobserved confounder correlated with T at the given
    strength; report the shifted estimate."""
    rng = np.random.default_rng(seed)
    confounder = treat + rng.normal(0, 1.0, len(treat))
    shifted_outcome = outcome + effect_strength_on_outcome * confounder
    return {"new_effect": _ols_effect(treat, shifted_outcome)}


def tipping_point(
    treat: np.ndarray, outcome: np.ndarray, base_effect: float,
    strengths: Sequence[float] = tuple(np.arange(0.1, 1.01, 0.1)),
    seed: int = 4,
) -> Optional[float]:
    """Smallest confounder strength that flips the effect's sign
    (ref analyze_dowhy.py:127-160 sweep 0.1..1.0). None = never flips."""
    sign = np.sign(base_effect)
    for s in strengths:
        eff = refute_unobserved_common_cause(
            treat, outcome, effect_strength_on_outcome=-sign * s, seed=seed
        )["new_effect"]
        if np.sign(eff) != sign:
            return float(s)
    return None


def causal_validation_report(
    m_by_condition: Dict[int, np.ndarray],
    cond_a: int,
    cond_b: int,
    feature_names: Sequence[str],
    *, noise_std: float = 0.5, seed: int = 0, use_dowhy: str = "auto",
) -> Dict:
    """Full A7 table for one condition pair across all features: effect,
    RCC p, placebo p, tipping point, robust.

    use_dowhy: "auto" and "never" take the built-in refuters; "require"
    raises ``ImportError`` (the DoWhy path is not ported)."""
    if use_dowhy not in ("auto", "never", "require"):
        raise ValueError(f"use_dowhy must be auto/never/require, got {use_dowhy!r}")
    if use_dowhy == "require":
        raise ImportError("use_dowhy='require': the DoWhy path (dowhy) is not ported; "
                          "'auto' or 'never' take the built-in refuters")
    rows = {}
    for f, name in enumerate(feature_names):
        a = m_by_condition[cond_a][:, f]
        b = m_by_condition[cond_b][:, f]
        est = estimate_effect(a, b, noise_std=noise_std, seed=seed + f)
        rcc = refute_random_common_cause(est["treat"], est["outcome"], est["effect"])
        plc = refute_placebo(est["treat"], est["outcome"], est["effect"])
        tip = tipping_point(est["treat"], est["outcome"], est["effect"])
        rows[name] = {
            "effect": est["effect"],
            "rcc_p": rcc["p_value"],
            "placebo_p": plc["p_value"],
            "tipping_point": tip,
            "robust": rcc["p_value"] > 0.05 and plc["p_value"] > 0.05,
        }
    return rows

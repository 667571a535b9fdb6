"""Uncertainty extraction, SNR and Monte-Carlo sampling
(``causalvae_tpu/scm/uncertainty.py``).

sigma(T) from the Gaussian mechanism head, the fold-mean aleatoric sigma
per treatment, pairwise discriminative scores and SNR in real units, and
Monte-Carlo decode statistics. Where JAX ``vmap``s over fold members or MC
samples, the port loops and stacks; the weights live in the modules, so
JAX's ``variables`` argument has no counterpart. Every spread is a
population standard deviation (divided by N, as ``jnp.std`` and numpy's).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from causalvae_tpu_torch.device import module_device


def morph_sigma(model, t: torch.Tensor, logvar_clip: float = 10.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m_mu, m_sigma) of P(M|T) for a batch of conditions:
    sigma = exp(0.5 * clamp(logvar, -clip, clip))."""
    m_mu, m_logvar = model.morph(t)
    return m_mu, torch.exp(0.5 * m_logvar.clamp(-logvar_clip, logvar_clip))


def all_conditions_sigma(model, t_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mechanism (mu, sigma) for every one-hot condition at once."""
    return morph_sigma(model, torch.eye(t_dim, device=module_device(model)))


def ensemble_sigma_by_treatment(models, t_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold-mean (mu, sigma) per (treatment, feature), each (t_dim, m_dim):
    the uncertainty_by_treatment.csv quantity."""
    t = torch.eye(t_dim, device=module_device(models))
    outs = [morph_sigma(member, t) for member in models]
    mus = torch.stack([mu for mu, _ in outs])  # (K, T, m)
    sigmas = torch.stack([s for _, s in outs])
    return mus.mean(dim=0), sigmas.mean(dim=0)


def pairwise_snr(mu: torch.Tensor, sigma: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SNR[i, j, f] = |mu_i - mu_j| / sqrt(sigma_i^2 + sigma_j^2) per feature
    for all treatment pairs. ``scale`` (the per-feature std of the
    standardisation) converts mu and sigma to real units first."""
    if scale is not None:
        mu = mu * scale
        sigma = sigma * scale
    d = (mu[:, None, :] - mu[None, :, :]).abs()
    s = torch.sqrt(sigma[:, None, :] ** 2 + sigma[None, :, :] ** 2 + 1e-12)
    return d / s


def discriminative_score(mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Pairwise |mu_A - mu_B| / sqrt(sigma_A^2 + sigma_B^2), the vessel
    'discriminative power' matrix: ``pairwise_snr`` under its own name."""
    return pairwise_snr(mu, sigma)


def significant_changes(snr: np.ndarray, mu_real: np.ndarray, group_names,
                        feature_names, baseline: Optional[int] = None,
                        top_k: int = 10) -> list:
    """Top-k |SNR| (treatment pair, feature) records, dicts ready for CSV."""
    n_t = snr.shape[0]
    rows = []
    for i in range(n_t):
        js = range(n_t) if baseline is None else [baseline]
        for j in js:
            if i == j:
                continue
            for f in range(snr.shape[-1]):
                rows.append({
                    "treatment": group_names[i],
                    "vs": group_names[j],
                    "feature": feature_names[f],
                    "snr": float(snr[i, j, f]),
                    "delta": float(mu_real[i, f] - mu_real[j, f]),
                })
    rows.sort(key=lambda r: -abs(r["snr"]))
    return rows[:top_k]


def mc_decode_stats(model, m: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor,
                    generator: Optional[torch.Generator] = None, n_mc: int = 100,
                    eps: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo decode over z ~ N(mu, sigma^2): (pixel mean, pixel std)
    over ``n_mc`` samples. The noise is drawn from ``generator`` unless
    ``eps`` (n_mc, B, z) is given (tests pass the JAX side's draws); one
    decode per sample."""
    from causalvae_tpu_torch.models.vae import reparameterize
    from causalvae_tpu_torch.scm.intervene import decode

    if eps is not None and eps.shape[0] != n_mc:
        raise ValueError(f"eps holds {eps.shape[0]} samples, n_mc is {n_mc}")
    recons = torch.stack([
        decode(model, m, reparameterize(mu, logvar, generator=generator,
                                        eps=None if eps is None else eps[i]))
        for i in range(n_mc)])  # (MC, B, H, W, C)
    return recons.mean(dim=0), recons.std(dim=0, correction=0)


def feature_stats_real_units(m_norm_by_treatment: Dict[int, np.ndarray],
                             scaler_mean: np.ndarray, scaler_scale: np.ndarray
                             ) -> Dict[int, Dict[str, np.ndarray]]:
    """Per-treatment per-feature mean and std in raw measurement units."""
    out = {}
    for t, m_norm in m_norm_by_treatment.items():
        real = np.asarray(m_norm) * scaler_scale + scaler_mean
        out[t] = {"mean": real.mean(axis=0), "std": real.std(axis=0)}
    return out

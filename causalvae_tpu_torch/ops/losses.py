"""Loss functions of every workload (``causalvae_tpu/ops/losses.py``).

Each mirrors the JAX function of the same name: float32 math, the same sums,
the same ``w`` sample masks. ``vessel_loss`` routes the unmasked image terms
through the ELBO kernel (``ops/kernels/elbo.py``), as the JAX package routes
them through its Pallas kernel; a sample mask takes the plain formulation.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.nn import functional as F

Tensor = torch.Tensor


def _wsum(per_elem: Tensor, w: Optional[Tensor]) -> Tensor:
    """Full sum, or per-sample sums weighted by ``w`` (shape (B,)): weight 0
    removes a padded sample from every reduction exactly."""
    if w is None:
        return per_elem.sum()
    per_sample = per_elem.sum(dim=tuple(range(1, per_elem.dim())))
    return (per_sample * w.float()).sum()


def bce_sum(recon: Tensor, x: Tensor, w: Optional[Tensor] = None) -> Tensor:
    """Summed binary cross-entropy, torch F.binary_cross_entropy semantics
    (log clamped at -100)."""
    r, x = recon.float(), x.float()
    logr = torch.log(r).clamp_min(-100.0)
    log1mr = torch.log1p(-r).clamp_min(-100.0)
    return _wsum(-(x * logr + (1.0 - x) * log1mr), w)


def kld_sum(mu: Tensor, logvar: Tensor, w: Optional[Tensor] = None) -> Tensor:
    """-0.5 * sum(1 + logvar - mu^2 - exp(logvar))."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * _wsum(1.0 + logvar - mu * mu - torch.exp(logvar), w)


def mse_sum(a: Tensor, b: Tensor, w: Optional[Tensor] = None) -> Tensor:
    d = a.float() - b.float()
    return _wsum(d * d, w)


def gaussian_nll_sum(m: Tensor, m_mu: Tensor, m_logvar: Tensor,
                     w: Optional[Tensor] = None) -> Tensor:
    """0.5 * sum(logvar + (m - mu)^2 / var), the probabilistic morph loss."""
    m, m_mu, m_logvar = m.float(), m_mu.float(), m_logvar.float()
    return 0.5 * _wsum(m_logvar + (m - m_mu) ** 2 / torch.exp(m_logvar), w)


def discriminator_ce(logits: Tensor, t_idx: Tensor) -> Tensor:
    """Mean cross-entropy of the discriminator step."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, t_idx.long()[:, None]).mean()


def confusion_kl(logits: Tensor, t_dim: int) -> Tensor:
    """KL(uniform || softmax(logits)), batchmean."""
    logp = F.log_softmax(logits.float(), dim=-1)
    u = 1.0 / t_dim
    log_u = float(torch.tensor(u, dtype=torch.float32).log())
    return (u * (log_u - logp)).sum() / logits.shape[0]


def mnist_vae_loss(out, x: Tensor, m: Tensor, d_logits_fake: Tensor, *,
                   beta: float = 1.0, lambda_adv: float = 10.0,
                   lambda_morph: float = 100.0, t_dim: int = 10,
                   w: Optional[Tensor] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """BCE_sum + beta*KLD + lambda_morph*MSE(m_hat, m) + 100*lambda_adv*confusion."""
    loss_recon = bce_sum(out.recon_x, x, w)
    loss_kld = kld_sum(out.mu, out.logvar, w) * beta
    loss_morph = mse_sum(out.m_hat, m, w) * lambda_morph
    loss_adv = confusion_kl(d_logits_fake, t_dim) * lambda_adv * 100.0
    total = loss_recon + loss_kld + loss_morph + loss_adv
    return total, {"loss": total, "recon": loss_recon, "kld": loss_kld,
                   "morph": loss_morph, "adv": loss_adv}


def mnist_bayes_vae_loss(out, x: Tensor, m: Tensor, d_logits_fake: Tensor, *,
                         beta: float = 1.0, lambda_adv: float = 10.0,
                         t_dim: int = 10) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Bayesian variant: the morph MSE becomes a Gaussian NLL."""
    loss_recon = bce_sum(out.recon_x, x)
    loss_kld = kld_sum(out.mu, out.logvar) * beta
    loss_morph = gaussian_nll_sum(m, out.m_mu, out.m_logvar)
    loss_adv = confusion_kl(d_logits_fake, t_dim) * lambda_adv * 100.0
    total = loss_recon + loss_kld + loss_morph + loss_adv
    return total, {"loss": total, "recon": loss_recon, "kld": loss_kld,
                   "morph": loss_morph, "adv": loss_adv}


def vessel_recon_terms(recon: Tensor, x: Tensor, w: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor]:
    """Weighted MSE + background sparsity of vessel images (plain form).

    pos_weight = clamp((1 - pos_frac) / pos_frac, 1, 50) from the batch's own
    foreground fraction, without gradient; weight map 1 + (pos_weight - 1) x;
    sparsity = sum |recon| where x < 0.1. With a sample mask ``w`` the
    foreground fraction counts valid samples only and masked samples drop
    out of both sums."""
    recon, x = recon.float(), x.float()
    with torch.no_grad():
        if w is None:
            n_pos = x.sum()
            size = float(x.numel())
        else:
            wb = w.float().reshape((-1,) + (1,) * (x.dim() - 1))
            n_pos = (x * wb).sum()
            size = w.float().sum() * (x.numel() / x.shape[0])
        pos_fraction = n_pos / (size + 1e-6)
        pos_weight = ((1.0 - pos_fraction) / (pos_fraction + 1e-6)).clamp(1.0, 50.0)
    weight = 1.0 + (pos_weight - 1.0) * x
    recon_loss = _wsum((recon - x) ** 2 * weight, w)
    sparsity = _wsum(recon.abs() * (x < 0.1), w)
    return recon_loss, sparsity


def vessel_loss(out, x: Tensor, m: Tensor, *, beta: float = 0.5,
                lambda_morph: float = 10000.0, lambda_sparsity: float = 0.3,
                w: Optional[Tensor] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """recon + beta*KLD + lambda_morph*NLL + lambda_sparsity*sparsity.

    The unmasked image terms run through the ELBO kernel
    (``ops/kernels/elbo.py``: the CUDA kernel for CUDA tensors, its plain
    version on the CPU); a sample mask ``w`` takes the plain formulation."""
    if w is None:
        from causalvae_tpu_torch.ops.kernels.elbo import vessel_recon_terms_fused

        recon_loss, sparsity = vessel_recon_terms_fused(out.recon_x, x)
    else:
        recon_loss, sparsity = vessel_recon_terms(out.recon_x, x, w)
    loss_kld = kld_sum(out.mu, out.logvar, w)
    loss_morph = gaussian_nll_sum(m, out.m_mu, out.m_logvar, w)
    total = (recon_loss + beta * loss_kld + lambda_morph * loss_morph
             + lambda_sparsity * sparsity)
    return total, {"loss": total, "recon": recon_loss, "kld": loss_kld,
                   "morph": loss_morph, "sparsity": sparsity}


def cvae_loss(recon: Tensor, x: Tensor, mu: Tensor, logvar: Tensor, *,
              beta: float = 1.0):
    """Standard CVAE: BCE_sum + beta*KLD."""
    loss_recon = bce_sum(recon, x)
    loss_kld = kld_sum(mu, logvar) * beta
    total = loss_recon + loss_kld
    return total, {"loss": total, "recon": loss_recon, "kld": loss_kld}


def cascade_loss(out, x: Tensor, m: Tensor, *, gamma: float = 2000.0):
    """MSE_sum + gamma*MSE(m_hat, m)_sum + KLD."""
    loss_recon = mse_sum(out.recon_x, x)
    loss_m = mse_sum(out.m_hat, m)
    loss_kld = kld_sum(out.mu, out.logvar)
    total = loss_recon + gamma * loss_m + loss_kld
    return total, {"loss": total, "recon": loss_recon, "morph": loss_m,
                   "kld": loss_kld}


def vit_vae_loss(recon: Tensor, x: Tensor, mu: Tensor, logvar: Tensor, *,
                 beta: float = 1.0):
    """Mean MSE + beta * mean KLD."""
    recon_loss = ((recon.float() - x.float()) ** 2).mean()
    lv, mu = logvar.float(), mu.float()
    kld = -0.5 * (1.0 + lv - mu ** 2 - torch.exp(lv)).mean()
    total = recon_loss + beta * kld
    return total, {"loss": total, "recon": recon_loss, "kld": kld}

"""The latent causal-mechanism layer T -> M (``causalvae_tpu/models/mechanism.py``).

Ported: the Gaussian ``MorphPredictor`` the vessel models use. The
deterministic head and ``DAGMechanism`` come with the models that need them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from causalvae_tpu_torch.models.vae import Dense


class MorphPredictor(nn.Module):
    """MLP T -> M with a Gaussian (mu, logvar) head; LeakyReLU(0.2) trunk.

    ``logvar_clip`` clamps m_logvar to [-clip, clip] (the vessel models use 10).
    Computes in ``dtype`` (float32 parameters, ``models.vae.Dense``).
    """

    def __init__(self, t_dim: int, m_dim: int, hidden: Sequence[int] = (64, 64),
                 logvar_clip: Optional[float] = 10.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = (t_dim, *hidden)
        self.dtype = dtype
        self.shared = nn.ModuleList(
            Dense(a, b, dtype) for a, b in zip(widths[:-1], widths[1:]))
        self.mu = Dense(widths[-1], m_dim, dtype)
        self.logvar = Dense(widths[-1], m_dim, dtype)
        self.logvar_clip = logvar_clip

    def forward(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = t.to(self.dtype)
        for layer in self.shared:
            h = F.leaky_relu(layer(h), 0.2)
        m_logvar = self.logvar(h)
        if self.logvar_clip is not None:
            m_logvar = m_logvar.clamp(-self.logvar_clip, self.logvar_clip)
        return self.mu(h), m_logvar

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean prediction only."""
        return self(t)[0]

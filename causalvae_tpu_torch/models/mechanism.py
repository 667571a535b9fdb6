"""The latent causal-mechanism layer T -> M (``causalvae_tpu/models/mechanism.py``).

``MorphPredictor`` is the MLP mechanism M' = f(T), deterministic (the MNIST
C1 model) or a Gaussian head P(M|T) (C4 and the vessel models).
``DAGMechanism`` generalises it to a masked-adjacency structural equation
over named factor groups, one batched matmul for every factor; it reduces to
``MorphPredictor`` for the T -> M graph. The cascade's ``bn_layers`` option
is not ported yet and raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from causalvae_tpu_torch.models.vae import Dense


class MorphPredictor(nn.Module):
    """MLP mechanism T -> M with an optional Gaussian (mu, logvar) head.

    hidden:       widths of the shared trunk (``shared.{i}``)
    gaussian:     False -> one head ``out`` (M'); True -> heads ``mu`` and
                  ``logvar`` (m_mu, m_logvar)
    activation:   "relu" (MNIST) or "leaky_relu" (vessel, slope 0.2)
    logvar_clip:  clamps m_logvar to [-clip, clip] (vessel: 10; None: no clamp)
    bn_layers:    the cascade's BatchNorm after hidden layers; not ported yet,
                  so anything but () raises
    Computes in ``dtype`` (float32 parameters, ``models.vae.Dense``).
    """

    def __init__(self, t_dim: int, m_dim: int, hidden: Sequence[int] = (128,),
                 gaussian: bool = False, activation: str = "relu",
                 bn_layers: Sequence[int] = (), logvar_clip: Optional[float] = 10.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if tuple(bn_layers):
            raise NotImplementedError("MorphPredictor(bn_layers=...) is the cascade "
                                      "model's option, not ported yet")
        if activation not in ("relu", "leaky_relu"):
            raise ValueError(f"activation {activation!r}: 'relu' or 'leaky_relu'")
        widths = (t_dim, *hidden)
        self.dtype = dtype
        self.gaussian = gaussian
        self.activation = activation
        self.logvar_clip = logvar_clip
        self.shared = nn.ModuleList(
            Dense(a, b, dtype) for a, b in zip(widths[:-1], widths[1:]))
        if gaussian:
            self.mu = Dense(widths[-1], m_dim, dtype)
            self.logvar = Dense(widths[-1], m_dim, dtype)
        else:
            self.out = Dense(widths[-1], m_dim, dtype)

    def _act(self, h: torch.Tensor) -> torch.Tensor:
        if self.activation == "leaky_relu":
            return F.leaky_relu(h, 0.2)
        return F.relu(h)

    def forward(self, t: torch.Tensor):
        """M' (deterministic) or (m_mu, m_logvar) (Gaussian)."""
        h = t.to(self.dtype)
        for layer in self.shared:
            h = self._act(layer(h))
        if not self.gaussian:
            return self.out(h)
        m_logvar = self.logvar(h)
        if self.logvar_clip is not None:
            m_logvar = m_logvar.clamp(-self.logvar_clip, self.logvar_clip)
        return self.mu(h), m_logvar

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean prediction only."""
        out = self(t)
        return out[0] if self.gaussian else out


class DAGMechanism(nn.Module):
    """Masked-adjacency structural-equation layer over named factor groups.

    Factors are concatenated blocks of one vector; ``adjacency[i, j] = 1``
    lets factor i influence factor j. Each factor j is an MLP over the masked
    concatenation of its parents, computed for all factors in one pass: the
    mask applied to the input projection ``w1`` (total, n·hidden), then a
    per-factor second layer ``w2`` (n, hidden, heads·max(dims)). Factors
    without parents (roots) reproduce their input; with ``gaussian`` the
    logvar is clipped to [-10, 10] (0 for roots). The parameters keep the
    JAX names and layouts (``w1``, ``b1``, ``w2``, ``b2``).
    """

    def __init__(self, factors: Sequence[Tuple[str, int]], adjacency, hidden: int = 64,
                 gaussian: bool = False):
        super().__init__()
        self.factors = tuple((str(n), int(d)) for n, d in factors)
        self.hidden = hidden
        self.gaussian = gaussian
        dims = [d for _, d in self.factors]
        n, total, width = len(dims), sum(dims), max(dims)
        adj = np.asarray(adjacency)
        col_factor = np.concatenate([np.full((d,), i) for i, d in enumerate(dims)])
        # per-child input mask over the concatenated vector, repeated per hidden unit
        self.register_buffer("mask1", torch.from_numpy(np.repeat(
            adj[col_factor, :].astype(np.float32), hidden, axis=1)), persistent=False)
        has_parents = adj.sum(axis=0) > 0
        self.register_buffer("keep", torch.from_numpy(np.concatenate(
            [np.full((d,), bool(has_parents[i])) for i, d in enumerate(dims)])),
            persistent=False)
        heads = 2 if gaussian else 1
        self.w1 = nn.Parameter(torch.randn(total, n * hidden) * total ** -0.5)
        self.b1 = nn.Parameter(torch.zeros(n * hidden))
        self.w2 = nn.Parameter(torch.randn(n, hidden, heads * width) * hidden ** -0.5)
        self.b2 = nn.Parameter(torch.zeros(n, heads * width))

    def forward(self, values: torch.Tensor):
        """values: (..., sum(dims)), the factor values concatenated. Returns
        every factor's prediction in that layout; with ``gaussian``, (mu,
        logvar)."""
        dims = [d for _, d in self.factors]
        n, width = len(dims), max(dims)
        x = values.float()
        h = F.relu(x @ (self.w1 * self.mask1) + self.b1)
        h = h.reshape(*x.shape[:-1], n, self.hidden)
        out = torch.einsum("...nh,nhd->...nd", h, self.w2) + self.b2

        def gather(which: int) -> torch.Tensor:
            return torch.cat([out[..., i, which * width: which * width + d]
                              for i, d in enumerate(dims)], dim=-1)

        mu = torch.where(self.keep, gather(0), x)
        if not self.gaussian:
            return mu
        logvar = torch.where(self.keep, gather(1).clamp(-10.0, 10.0), 0.0)
        return mu, logvar

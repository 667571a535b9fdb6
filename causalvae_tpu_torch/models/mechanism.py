"""The latent causal-mechanism layer T -> M (``causalvae_tpu/models/mechanism.py``).

``MorphPredictor`` is the MLP mechanism M' = f(T), deterministic (the MNIST
C1 model) or a Gaussian head P(M|T) (C4 and the vessel models).
``DAGMechanism`` generalises it to a masked-adjacency structural equation
over named factor groups, one batched matmul for every factor; it reduces to
``MorphPredictor`` for the T -> M graph. The cascade's mechanism (C10) puts
a BatchNorm after its first hidden layer (``bn_layers``): flax's plain
``nn.BatchNorm``, here ``PlainBatchNorm`` (plain PyTorch, no kernel).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from causalvae_tpu_torch.models.vae import Dense
from causalvae_tpu_torch.ops.kernels.batchnorm import BatchNorm
from causalvae_tpu_torch.parallel.mesh import current_global_batch, sum_over_ranks


class PlainBatchNorm(BatchNorm):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over dim 0 of (B, C)
    in plain PyTorch (no kernel launches; the JAX side runs no Pallas kernel
    there): in training the batch mean and flax's fast biased variance
    E[x²] - E[x]² (at least 0) in float32, through autograd, and the running
    statistics updated; in eval the running ones. ``train`` overrides the
    module's mode for one call (flax's ``use_running_average``). Parameters,
    buffers and names as ``BatchNorm``'s (``scale``, ``bias``, ``mean``,
    ``var``); the result in ``dtype``. Inside a ``parallel.mesh.global_batch``
    block Σx and Σx² are summed over the ranks (``sum_over_ranks``, whose
    backward sums their gradients too), so the statistics, the backward and
    the running statistics are the whole batch's on every rank."""

    def forward(self, x: torch.Tensor, train: Optional[bool] = None) -> torch.Tensor:
        if not (self.training if train is None else train):
            mul = torch.rsqrt(self.var.float() + self.epsilon) * self.scale.float()
            return ((x.float() - self.mean.float()) * mul + self.bias.float()).to(self.dtype)
        xf = x.float()
        gb = current_global_batch()
        if gb is None:
            mean = xf.mean(dim=0)
            ex2 = xf.square().mean(dim=0)
        else:
            sums = sum_over_ranks(torch.stack([xf.sum(dim=0), xf.square().sum(dim=0)]),
                                  gb.mesh)
            mean, ex2 = sums[0] / gb.total, sums[1] / gb.total
        var = torch.clamp_min(ex2 - mean.square(), 0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.float()
        self._update(mean, var)
        return ((xf - mean) * mul + self.bias.float()).to(self.dtype)


class MorphPredictor(nn.Module):
    """MLP mechanism T -> M with an optional Gaussian (mu, logvar) head.

    hidden:       widths of the shared trunk (``shared.{i}``)
    gaussian:     False -> one head ``out`` (M'); True -> heads ``mu`` and
                  ``logvar`` (m_mu, m_logvar)
    activation:   "relu" (MNIST) or "leaky_relu" (vessel, slope 0.2)
    logvar_clip:  clamps m_logvar to [-clip, clip] (vessel: 10; None: no clamp)
    bn_layers:    indices of the hidden layers followed by a ``PlainBatchNorm``
                  (before the activation), ``shared_bn.{i}`` as JAX's
                  ``shared_bn_{i}``; the cascade norms its first (``(0,)``)
    Computes in ``dtype`` (float32 parameters, ``models.vae.Dense``). The
    BatchNorms follow the module's mode unless ``forward`` is given ``train``
    (``mean`` runs them on the running statistics, as JAX's ``train=False``
    default does).
    """

    def __init__(self, t_dim: int, m_dim: int, hidden: Sequence[int] = (128,),
                 gaussian: bool = False, activation: str = "relu",
                 bn_layers: Sequence[int] = (), logvar_clip: Optional[float] = 10.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        bad = [i for i in bn_layers if not 0 <= i < len(hidden)]
        if bad:
            raise ValueError(f"bn_layers {tuple(bn_layers)}: no hidden layer {bad} "
                             f"among the {len(hidden)}")
        if activation not in ("relu", "leaky_relu"):
            raise ValueError(f"activation {activation!r}: 'relu' or 'leaky_relu'")
        widths = (t_dim, *hidden)
        self.dtype = dtype
        self.gaussian = gaussian
        self.activation = activation
        self.logvar_clip = logvar_clip
        self.shared = nn.ModuleList(
            Dense(a, b, dtype) for a, b in zip(widths[:-1], widths[1:]))
        self.shared_bn = nn.ModuleDict(
            {str(i): PlainBatchNorm(hidden[i], dtype=dtype) for i in sorted(set(bn_layers))})
        if gaussian:
            self.mu = Dense(widths[-1], m_dim, dtype)
            self.logvar = Dense(widths[-1], m_dim, dtype)
        else:
            self.out = Dense(widths[-1], m_dim, dtype)

    def _act(self, h: torch.Tensor) -> torch.Tensor:
        if self.activation == "leaky_relu":
            return F.leaky_relu(h, 0.2)
        return F.relu(h)

    def forward(self, t: torch.Tensor, train: Optional[bool] = None):
        """M' (deterministic) or (m_mu, m_logvar) (Gaussian); ``train``
        sets the BatchNorms' mode for this call (None: the module's)."""
        h = t.to(self.dtype)
        for i, layer in enumerate(self.shared):
            h = layer(h)
            if str(i) in self.shared_bn:
                h = self.shared_bn[str(i)](h, train)
            h = self._act(h)
        if not self.gaussian:
            return self.out(h)
        m_logvar = self.logvar(h)
        if self.logvar_clip is not None:
            m_logvar = m_logvar.clamp(-self.logvar_clip, self.logvar_clip)
        return self.mu(h), m_logvar

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean prediction only (BatchNorms on their running statistics)."""
        out = self(t, train=False)
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

    ``dtype`` is the JAX module's ``dtype``, which here is also the
    parameters' (JAX creates them in it, unlike the Dense layers): below
    float32 the four leaves are ``dtype`` tensors, the mask and the values
    are cast to it, and every product and sum rounds to it. The weights
    start as flax's ``init`` draws them (``models.vae.flax_init_``:
    ``lecun_normal``, fan_in ``total`` for ``w1`` and n·hidden for ``w2``;
    zero biases), seeded from torch's default generator.
    """

    def __init__(self, factors: Sequence[Tuple[str, int]], adjacency, hidden: int = 64,
                 gaussian: bool = False, dtype: torch.dtype = torch.float32):
        from causalvae_tpu_torch.models.vae import flax_init_

        super().__init__()
        self.factors = tuple((str(n), int(d)) for n, d in factors)
        self.hidden = hidden
        self.gaussian = gaussian
        self.dtype = dtype
        dims = [d for _, d in self.factors]
        n, total, width = len(dims), sum(dims), max(dims)
        adj = np.asarray(adjacency)
        col_factor = np.concatenate([np.full((d,), i) for i, d in enumerate(dims)])
        # per-child input mask over the concatenated vector, repeated per hidden unit
        self.register_buffer("mask1", torch.from_numpy(np.repeat(
            adj[col_factor, :].astype(np.float32), hidden, axis=1)).to(dtype),
            persistent=False)
        has_parents = adj.sum(axis=0) > 0
        self.register_buffer("keep", torch.from_numpy(np.concatenate(
            [np.full((d,), bool(has_parents[i])) for i, d in enumerate(dims)])),
            persistent=False)
        heads = 2 if gaussian else 1
        self.w1 = nn.Parameter(torch.empty(total, n * hidden, dtype=dtype))
        self.b1 = nn.Parameter(torch.empty(n * hidden, dtype=dtype))
        self.w2 = nn.Parameter(torch.empty(n, hidden, heads * width, dtype=dtype))
        self.b2 = nn.Parameter(torch.empty(n, heads * width, dtype=dtype))
        flax_init_(self, int(torch.randint(2 ** 31, ())))

    def forward(self, values: torch.Tensor):
        """values: (..., sum(dims)), the factor values concatenated. Returns
        every factor's prediction in that layout, in ``dtype``; with
        ``gaussian``, (mu, logvar)."""
        dims = [d for _, d in self.factors]
        n, width = len(dims), max(dims)
        x = values.to(self.dtype)
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

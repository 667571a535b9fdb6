"""Abduction / intervention / prediction (``causalvae_tpu/scm/intervene.py``).

    ABDUCTION    z ~ q(z | x, m, t)     (mean or sampled)
    INTERVENTION do(T := t') with m' = f(t')
    PREDICTION   x' = decode(m', z)

Model-agnostic: any module with ``encode(x, m, t)``, ``decode(m, z)`` and
``predict_m(t)`` works. The weights live in the module, so the JAX
``variables`` argument has no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

from causalvae_tpu_torch.models.vae import reparameterize


def abduct(model, x: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Infer the exogenous style z: the posterior mean by default, a sample
    when ``generator`` is given."""
    mu, logvar = model.encode(x, m, t)
    if generator is None:
        return mu
    return reparameterize(mu, logvar, generator=generator)


def decode(model, m: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return model.decode(m, z)


def predict_m(model, t: torch.Tensor) -> torch.Tensor:
    """Mechanism mean M' = f(T) (do(T) propagation through the SCM)."""
    return model.predict_m(t)


def do_t_grid(model, x: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
              t_targets: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """do(T) intervention grid: for every source's abducted z and every target
    condition t', x' = decode(f(t'), z). Returns (S, T, H, W, C).

    The JAX ``vmap`` over targets is a loop here, one decode of the S sources
    per target, so peak memory is that of one S-row decode."""
    z = abduct(model, x, m, t, generator)  # (S, z)
    m_targets = predict_m(model, t_targets)  # (T, m)
    grid = [decode(model, m_t.expand(z.shape[0], -1), z) for m_t in m_targets]
    return torch.stack(grid, dim=1)

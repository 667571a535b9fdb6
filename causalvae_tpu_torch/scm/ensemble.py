"""Ensemble (k-fold) inference (``causalvae_tpu/scm/ensemble.py``).

JAX stacks the fold parameters along a leading member axis and ``vmap``s
each ensemble op over it. Here the members are an ``nn.ModuleList`` of the
fold models (``stack_fold_variables`` builds it), each op is a loop over
them, and ``torch.stack`` gives the same (K, ...) member-leading result.
Spreads are population standard deviations (divided by K, as ``jnp.std``).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch import nn


def stack_fold_variables(models: Sequence[nn.Module]) -> nn.ModuleList:
    """The fold models as one ensemble (a ``ModuleList``, member order kept)."""
    return nn.ModuleList(models)


def _stack(outs):
    if isinstance(outs[0], (tuple, list)):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def ensemble_apply(fn: Callable, models: Sequence[nn.Module], *args):
    """fn(member, *args) for every member, stacked along a new leading axis
    (a tuple result stacked element by element); args broadcast."""
    return _stack([fn(member, *args) for member in models])


def _mean_std(stacked: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return stacked.mean(dim=0), stacked.std(dim=0, correction=0)


def ensemble_decode(models, m: torch.Tensor, z: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, per-pixel std) of the members' reconstructions."""
    return _mean_std(ensemble_apply(lambda mdl, mm, zz: mdl.decode(mm, zz), models, m, z))


def ensemble_predict_m(models, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) over the members of the mechanism's prediction M' = f(T)."""
    return _mean_std(ensemble_apply(lambda mdl, tt: mdl.predict_m(tt), models, t))


def ensemble_morph_distribution(models, t: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-member (m_mu, m_sigma) of the Gaussian mechanism head, each
    (K, B, m): sigma = exp(0.5 * clamp(logvar, -10, 10))."""

    def one(mdl, tt):
        m_mu, m_logvar = mdl.morph(tt)
        return m_mu, torch.exp(0.5 * m_logvar.clamp(-10.0, 10.0))

    return ensemble_apply(one, models, t)

"""Train and eval steps (``causalvae_tpu/train/loop.py``).

``make_vae_step`` is the counterpart of the JAX generic single-optimizer VAE
step that ``bench.py`` drives for the vessel flagship: the model in train
mode (batch-statistics BatchNorm, dropout), the loss, the backward pass, the
optimizer step (``train/state.py`` ``ClippedAdam``: global-norm clipping and
Adam) and the running-statistics update (inside each ``BatchNorm``). Where
JAX threads an explicit PRNG key, the port takes an explicit CPU
``torch.Generator``: it draws the reparameterisation noise and one attention
dropout seed per layer; ``nn.Dropout`` (positional and MLP dropout) draws from
torch's own generator of the device. Tests hand both frameworks the same
noise through ``eps``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn


def batch_args(batch) -> Tuple:
    """Standard batch layout: dict with x (NHWC), m, t."""
    return batch["x"], batch["m"], batch["t"]


def make_vae_step(model: nn.Module, loss_fn: Callable,
                  optimizer: torch.optim.Optimizer):
    """One training step: ``step(batch, generator=None, eps=None)`` -> the
    loss function's metrics (detached 0-d tensors).

    loss_fn(out, batch) -> (total, metrics). ``eps`` (B, z) replaces the
    drawn reparameterisation noise."""

    def step(batch, generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = model(*batch_args(batch), eps=eps, generator=generator)
        total, metrics = loss_fn(out, batch)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_vae_eval_step(model: nn.Module, loss_fn: Callable):
    """Eval step: the model in eval mode (running statistics, no dropout),
    no gradient; ``step(batch, generator=None, eps=None)`` -> metrics."""

    def step(batch, generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            out = model(*batch_args(batch), eps=eps, generator=generator)
            _, metrics = loss_fn(out, batch)
        return metrics

    return step


def vessel_loss_fn(cfg):
    """loss_fn(out, batch) of the vessel objective with ``cfg``'s weights
    (``bench.py``'s flagship loss)."""
    from causalvae_tpu_torch.ops import losses as L

    def loss_fn(out, batch):
        return L.vessel_loss(out, batch["x"], batch["m"], beta=cfg.beta,
                             lambda_morph=cfg.lambda_morph,
                             lambda_sparsity=cfg.lambda_sparsity)

    return loss_fn

"""Explicit-collective data-parallel training
(``causalvae_tpu/parallel/shard_step.py``).

The JAX step runs per shard under ``shard_map`` and reduces the gradients
and the loss across the mesh with one collective, then every device applies
the same update to its replicated parameters. Here each rank computes its
shard's loss and gradients, then the step's one collective sums the
gradients, flattened into one buffer with the loss beside them, over the
ranks, and every rank's optimizer takes the same step.

Reduction semantics, to match the loss convention:

- ``loss_reduction="sum"``: gradients and loss summed over the ranks, so
  the update is the one-process step's on the concatenated batch for a
  loss summed over samples (the repo's VAE losses);
- ``loss_reduction="mean"``: the sum divided by the number of ranks (gloo
  has no average), which a loss averaged over samples needs.

As under ``shard_map`` without an axis name, anything inside ``loss_fn``
that reads the batch as a whole sees only this rank's shard: a BatchNorm's
statistics, and the random draws per sample (dropout masks, noise). The
global-batch step is ``train/loop.py make_vae_step(mesh=...)``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from causalvae_tpu_torch.parallel.mesh import Mesh, all_reduce_sum


def all_reduce_gradients(params: Sequence[torch.Tensor], extras: Sequence[torch.Tensor],
                         mesh: Mesh, reduction: str = "sum") -> List[torch.Tensor]:
    """Sum every parameter's ``.grad`` (a missing one as zeros) and the 0-d
    ``extras`` over the ranks in ONE all-reduce of one float32 buffer;
    "mean" divides the sums by the ranks. Sets each ``.grad`` to its reduced
    values and returns the reduced extras."""
    params = list(params)
    dev = params[0].device if params else extras[0].device
    parts = [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
             for p in params]
    parts.append(torch.stack([e.detach().float().reshape(()) for e in extras]).to(dev)
                 if extras else torch.zeros(0, device=dev))
    flat = all_reduce_sum(torch.cat(parts), mesh)
    if reduction == "mean":
        flat /= mesh.size
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p).to(p.dtype)
        offset += p.numel()
    return list(flat[offset:].unbind(0))


def make_shard_map_step(loss_fn: Callable, mesh: Mesh,
                        loss_reduction: str = "sum") -> Callable:
    """An explicitly collective data-parallel step.

    ``loss_fn(model, batch, generator)`` -> the 0-d loss of ONE shard.
    Returns ``step(model, optimizer, batch, generator=None)`` -> the reduced
    loss (a detached 0-d tensor), where ``batch`` is this rank's shard
    (``shard_batch``) and ``model`` is replicated (``replicate``)."""
    if loss_reduction not in ("sum", "mean"):
        raise ValueError(f"loss_reduction must be 'sum' or 'mean', got {loss_reduction!r}")

    def step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, batch: Dict,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, generator)
        loss.backward()
        # the ONLY cross-rank communication: one gradient/loss all-reduce
        (loss,) = all_reduce_gradients(list(model.parameters()), [loss], mesh,
                                       loss_reduction)
        optimizer.step()
        return loss

    return step

"""Eval-mode BatchNorm with the JAX package's parameter names and math.

Counterpart of ``causalvae_tpu/ops/kernels/batchnorm.py`` ``BatchNorm``
(eval branch). Parameters ``scale``/``bias`` and buffers ``mean``/``var``,
where ``var`` is the biased running variance, stored as the JAX package
stores it (torch's own ``BatchNorm*d`` keeps the unbiased one). Eval math is
plain elementwise: ``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32,
cast back to the input dtype. Train mode needs the per-channel statistics
kernel (``_sum_sq_kernel``), which comes with the training slice of the port.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of (B, C) or (B, C, H, W) inputs; eval mode only."""

    def __init__(self, num_features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm (batch statistics through the "
                "_sum_sq_kernel port) comes with the training slice; call "
                ".eval() to serve")
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.var.float() + self.epsilon) * self.scale.float()
        y = (x.float() - self.mean.float().view(shape)) * mul.view(shape) \
            + self.bias.float().view(shape)
        return y.to(x.dtype)

"""Model helpers of ``causalvae_tpu/models/vae.py`` (PyTorch, NCHW inside).

``VAEOutput``, ``reparameterize`` and the torch-equivalent layer constructors
``conv``/``conv_t``/``batch_norm``; ``seeded_init_`` fills a model's weights
from a numpy seed (for serving and measuring without a checkpoint). The
model classes of that module other than the ViT family come later.

The compute dtype is flax's ``dtype`` field: every layer keeps float32
parameters, casts its input and its parameters to ``dtype`` (``ops.subpixel.promote``,
flax's ``promote_dtype``) and computes in it, so the gradients reach the
float32 leaves through the casts' backward. ``Dense`` and ``LayerNorm`` are
``nn.Linear`` and ``nn.LayerNorm`` with that contract (the LayerNorm's
statistics, scale and bias in float32, its output cast, as flax's).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from torch.nn import functional as F

from causalvae_tpu_torch.ops.kernels.batchnorm import BatchNorm
from causalvae_tpu_torch.ops.subpixel import SubpixelConvTranspose2x, promote


class VAEOutput(NamedTuple):
    """Forward result; m_mu/m_logvar are None for deterministic mechanisms."""

    recon_x: torch.Tensor
    m_hat: torch.Tensor
    mu: torch.Tensor
    logvar: torch.Tensor
    m_mu: Optional[torch.Tensor] = None
    m_logvar: Optional[torch.Tensor] = None


class Dense(nn.Linear):
    """``nn.Dense(features, dtype=dtype)``: float32 parameters, input and
    parameters cast to ``dtype``; below float32 the bias is added to the
    product after it (the product rounds first, as flax's does)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promote(self.dtype, x, self.weight, self.bias)
        if self.dtype == torch.float32:
            return F.linear(x, w, b)
        return F.linear(x, w) + b


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm(epsilon, dtype=dtype)``: mean, variance, scale and bias
    in float32 on the input, the result cast to ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.dtype)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, *,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """z = mu + eps * exp(0.5 * logvar), in mu's dtype. ``eps`` is drawn in
    mu's dtype from ``generator`` (on the generator's device, then moved to
    mu's) unless given (tests pass the JAX side's noise, cast to mu's
    dtype)."""
    if eps is None:
        dev = mu.device if generator is None else generator.device
        eps = torch.randn(mu.shape, generator=generator, device=dev,
                          dtype=mu.dtype)
    return mu + eps.to(mu.device, mu.dtype) * torch.exp(0.5 * logvar)


def conv(in_channels: int, features: int, k: int, s: int, p: int) -> nn.Conv2d:
    """torch Conv2d(k, s, p) (the JAX helper's explicit symmetric padding)."""
    return nn.Conv2d(in_channels, features, k, stride=s, padding=p)


def conv_t(in_channels: int, features: int, k: int, s: int, p: int,
           output_padding: int = 0, dtype: torch.dtype = torch.float32) -> nn.ConvTranspose2d:
    """torch ConvTranspose2d(k, s, p, output_padding); the (3, 2, 1, 1)
    upsampler is the ViT decoder's ``SubpixelConvTranspose2x``, computing in
    ``dtype`` (no other transposed conv takes one)."""
    if (k, s, p, output_padding) == (3, 2, 1, 1):
        return SubpixelConvTranspose2x(in_channels, features, dtype=dtype)
    if dtype != torch.float32:
        raise ValueError(f"conv_t({k}, {s}, {p}, {output_padding}) computes in float32 only")
    return nn.ConvTranspose2d(in_channels, features, k, stride=s, padding=p,
                              output_padding=output_padding)


def batch_norm(features: int, dtype: torch.dtype = torch.float32) -> BatchNorm:
    """torch BatchNorm (eps 1e-5) with the JAX package's names and biased
    running variance; its output in ``dtype``."""
    return BatchNorm(features, epsilon=1e-5, dtype=dtype)


@torch.no_grad()
def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and buffer from ``numpy.random.default_rng(seed)``,
    in place: weights N(0, 1/fan_in), biases N(0, 0.01²), LayerNorm/BatchNorm
    scales 1 + N(0, 0.1²), running means N(0, 0.1²) and variances
    U(0.5, 1.5), embeddings N(0, 1). Same seed, same weights on any device."""
    rng = np.random.default_rng(seed)

    def fill(t: torch.Tensor, values: np.ndarray):
        t.copy_(torch.from_numpy(values.astype(np.float32)).to(t.dtype))

    def normal(shape, std, mean=0.0):
        return mean + std * rng.standard_normal(shape, dtype=np.float32)

    for mod in model.modules():
        for name, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            shape = tuple(t.shape)
            if isinstance(mod, nn.ConvTranspose2d) and name == "weight":
                # stride-2 3x3: each output pixel sees ~9/4 taps per input channel
                fan_in = shape[0] * shape[2] * shape[3] / 4
                fill(t, normal(shape, fan_in ** -0.5))
            elif isinstance(mod, (nn.Conv2d, nn.Linear)) and name == "weight":
                fill(t, normal(shape, (t.numel() / shape[0]) ** -0.5))
            elif name == "scale" or (isinstance(mod, nn.LayerNorm)
                                     and name == "weight"):
                fill(t, normal(shape, 0.1, 1.0))
            elif name == "mean":
                fill(t, normal(shape, 0.1))
            elif name == "var":
                fill(t, rng.uniform(0.5, 1.5, shape))
            elif name == "bias":
                fill(t, normal(shape, 0.01))
            else:  # positional embedding, CLS token
                fill(t, normal(shape, 1.0))
    return model

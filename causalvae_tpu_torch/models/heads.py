"""Auxiliary heads (``causalvae_tpu/models/heads.py``): the adversarial latent
discriminator and the external classifier."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from causalvae_tpu_torch.device import DeviceLike, resolve_device
from causalvae_tpu_torch.models.vae import Dense, conv


class LatentDiscriminator(nn.Module):
    """Adversarial head z -> T logits (C2, ref mnist_test/01_baseline_causal_vae/
    models.py:93-111): Dense 64 - LeakyReLU(0.2) - Dense 64 - LeakyReLU(0.2)
    - Dense t_dim. flax names the layers ``Dense_0..2``: ``port_maps``
    renames the first two ``fc1`` and ``fc2``, and ``jax_names`` the third
    ``out``. ``dtype`` is the JAX module's compute dtype (float32
    parameters, ``models.vae.Dense``)."""

    jax_names = {"Dense_2": "out"}

    def __init__(self, t_dim: int = 10, z_dim: int = 10, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.fc1 = Dense(z_dim, 64, dtype)
        self.fc2 = Dense(64, 64, dtype)
        self.out = Dense(64, t_dim, dtype)
        self.to(dev)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.fc1(z), 0.2)
        h = F.leaky_relu(self.fc2(h), 0.2)
        return self.out(h)


class SimpleClassifier(nn.Module):
    """External CNN eval classifier (C3, ref mnist_test/01 models.py:74-91):
    conv5x5 -> max-pool -> conv5x5 -> max-pool -> fc 320 -> 50 -> n_classes.
    Takes NHWC images (B, 28, 28, 1); the pooled (4, 4, 20) activation is
    flattened in JAX's NHWC order. Returns the 50-d feature (for t-SNE) and
    the log-softmax logits. ``port_maps`` renames flax's ``Conv_0``,
    ``Conv_1``, ``Dense_0``, ``Dense_1`` onto ``conv0``, ``conv1``, ``fc1``,
    ``fc2``. ``dtype`` is the JAX module's compute dtype (float32
    parameters): below float32 the max-pools and the log-softmax run in it,
    as JAX's do."""

    def __init__(self, n_classes: int = 10, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.conv0 = conv(1, 10, 5, 1, 0, dtype)
        self.conv1 = conv(10, 20, 5, 1, 0, dtype)
        self.fc1 = Dense(320, 50, dtype)
        self.fc2 = Dense(50, n_classes, dtype)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.relu(F.max_pool2d(self.conv0(x.permute(0, 3, 1, 2)), 2))
        h = F.relu(F.max_pool2d(self.conv1(h), 2))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        feature = F.relu(self.fc1(h))
        return feature, F.log_softmax(self.fc2(feature), dim=-1)

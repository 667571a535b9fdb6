"""Spatial forms of the convolutions of ``causalvae_tpu/ops/subpixel.py``.

At packing level 0 (the spatial formulation the port runs) the three JAX
classes are plain convolutions with the same parameters; phase packing is a
layout transform for the TPU's (8, 128) tiling, not ported. Weights follow
torch's layouts (OIHW, and (C_in, C_out, kH, kW) for the transposed conv);
``train/port_maps.py`` converts the JAX kernels.
"""

from __future__ import annotations

from torch import nn


class LiftableStemConv(nn.Conv2d):
    """Stride-2, pad-1 KxK conv (torch Conv2d(k, stride=2, padding=1))."""

    def __init__(self, in_channels: int, features: int, ksize: int = 3):
        super().__init__(in_channels, features, ksize, stride=2, padding=1)


class PhaseableConv3x3(nn.Conv2d):
    """Pad-1 3x3 conv."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(in_channels, features, 3, padding=1)


class SubpixelConvTranspose2x(nn.ConvTranspose2d):
    """torch ConvTranspose2d(3, stride=2, padding=1, output_padding=1): 2x
    upsampling, the ViT decoder's stage op."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(in_channels, features, 3, stride=2, padding=1,
                         output_padding=1)

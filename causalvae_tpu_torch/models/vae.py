"""Models and helpers of ``causalvae_tpu/models/vae.py`` (PyTorch, NCHW inside).

``VAEOutput``, ``reparameterize`` and the torch-equivalent layer constructors
``conv``/``conv_t``/``batch_norm``. ``flax_init_`` fills a model's weights
from a numpy seed with flax's default initializers, as JAX's ``model.init``
draws them (every trainer starts from it); ``seeded_init_`` fills them from
a numpy seed with non-trivial biases, scales and BatchNorm statistics (for
serving and measuring without a checkpoint).
``CausalConvVAE`` is the MNIST causal VAE (C1, and C4 with the Gaussian
mechanism decoding the real M), ``ConditionalVAE`` the conditional VAE
T -> X (C5), ``MDecoder`` the conditional-independence probe (C6),
``CausalVesselVAE`` the reference's CNN vessel VAE (C7) and
``CausalBioVAE`` the causal cascade's compact VAE (C10).

The compute dtype is flax's ``dtype`` field: every layer keeps float32
parameters, casts its input and its parameters to ``dtype`` (``ops.subpixel.promote``,
flax's ``promote_dtype``) and computes in it, so the gradients reach the
float32 leaves through the casts' backward. ``Dense`` and ``LayerNorm`` are
``nn.Linear`` and ``nn.LayerNorm`` with that contract (the LayerNorm's
statistics, scale and bias in float32, its output cast, as flax's);
``Conv`` and ``ConvTranspose`` (``conv``, ``conv_t``) are ``nn.Conv2d`` and
``nn.ConvTranspose2d`` with it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from causalvae_tpu_torch.device import DeviceLike, resolve_device
from causalvae_tpu_torch.ops import draws
from causalvae_tpu_torch.ops.kernels.batchnorm import BatchNorm
from causalvae_tpu_torch.ops.subpixel import (LiftableStemConv, PhaseableConv3x3,
                                              SubpixelConvTranspose2x, depth_to_space_2x,
                                              promote, space_to_depth_2x)
from causalvae_tpu_torch.parallel.mesh import current_global_batch


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


class Dropout(nn.Dropout):
    """``nn.Dropout`` with its mask drawn as a bool tensor: uniforms from
    torch's generator on x's device, kept where >= p, the kept entries
    scaled by 1/(1 - p) in x's type. Inside a ``parallel.mesh.global_batch``
    block, in training, the mask is this rank's rows of the whole batch's
    draw (the same draw, so the same generator offsets, as the one-process
    step's). A caller may draw the mask ahead of the tensor it is for
    (``keep_mask``) and apply it later (``apply_mask``): ``models/vit.py``
    draws its blocks' masks before a checkpointed call, so the recompute
    needs no generator state."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_mask(x, self.keep_mask(x.shape, x.device))

    def keep_mask(self, shape, device) -> Optional[torch.Tensor]:
        """A bool mask of ``shape`` (True: kept); None where no dropout
        runs (eval mode or rate 0), which draws nothing."""
        if not self.training or self.p == 0.0:
            return None

        def draw(s):
            return torch.rand(s, device=device) >= self.p

        gb = current_global_batch()
        return draw(tuple(shape)) if gb is None else gb.take(draw, shape)

    def apply_mask(self, x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
        """x with the entries ``keep`` drops set to 0 and the kept ones
        scaled by 1/(1 - p) in x's type (None: x)."""
        return x if keep is None else torch.where(keep, x * (1.0 / (1.0 - self.p)), 0.0)


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
    mu's; ``ops/draws.py``) unless given (tests pass the JAX side's noise, cast to mu's
    dtype); inside a ``parallel.mesh.global_batch`` block, this rank's rows
    of the whole batch's draw."""
    if eps is None:
        on = mu.device if generator is None else generator.device

        def draw(shape):
            return draws.normal(shape, mu.dtype, generator, on, mu.device)

        gb = current_global_batch()
        eps = draw(mu.shape) if gb is None else gb.take(draw, mu.shape)
    return mu + eps.to(mu.device, mu.dtype) * torch.exp(0.5 * logvar)


class Conv(nn.Conv2d):
    """``nn.Conv(features, (k, k), strides, padding, dtype=dtype)`` on NCHW:
    float32 parameters, input and parameters cast to ``dtype``; below
    float32 the bias is added after the convolution (as ``Dense``)."""

    def __init__(self, in_channels: int, features: int, k: int, s: int, p: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, features, k, stride=s, padding=p)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promote(self.dtype, x, self.weight, self.bias)
        if self.dtype == torch.float32:
            return self._conv_forward(x, w, b)
        return self._conv_forward(x, w, None) + b.view(1, -1, 1, 1)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(..., transpose_kernel=True, dtype=dtype)`` with
    torch's (k, s, p, output_padding) on NCHW, in ``dtype`` as ``Conv``."""

    def __init__(self, in_channels: int, features: int, k: int, s: int, p: int,
                 output_padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, features, k, stride=s, padding=p,
                         output_padding=output_padding)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promote(self.dtype, x, self.weight, self.bias)
        y = F.conv_transpose2d(x, w, b if self.dtype == torch.float32 else None,
                               self.stride, self.padding, self.output_padding)
        return y if self.dtype == torch.float32 else y + b.view(1, -1, 1, 1)


def conv(in_channels: int, features: int, k: int, s: int, p: int,
         dtype: torch.dtype = torch.float32) -> Conv:
    """torch Conv2d(k, s, p) (the JAX helper's explicit symmetric padding),
    computing in ``dtype``."""
    return Conv(in_channels, features, k, s, p, dtype)


def conv_t(in_channels: int, features: int, k: int, s: int, p: int,
           output_padding: int = 0, dtype: torch.dtype = torch.float32) -> nn.ConvTranspose2d:
    """torch ConvTranspose2d(k, s, p, output_padding), computing in
    ``dtype``; the (3, 2, 1, 1) upsampler is the ViT decoder's
    ``SubpixelConvTranspose2x``."""
    if (k, s, p, output_padding) == (3, 2, 1, 1):
        return SubpixelConvTranspose2x(in_channels, features, dtype=dtype)
    return ConvTranspose(in_channels, features, k, s, p, output_padding, dtype)


def batch_norm(features: int, dtype: torch.dtype = torch.float32) -> BatchNorm:
    """torch BatchNorm (eps 1e-5) with the JAX package's names and biased
    running variance; its output in ``dtype``."""
    return BatchNorm(features, epsilon=1e-5, dtype=dtype)


class CausalConvVAE(nn.Module):
    """MNIST causal VAE: (X, M, T) -> Z; T -> M'; (M', Z) -> X.

    ``gaussian_mechanism=False, decode_real_m=False`` is C1 (the decoder
    consumes the predicted M'); ``gaussian_mechanism=True,
    decode_real_m=True`` is C4 (a Gaussian P(M|T), the decoder consumes the
    real M). Images are NHWC (B, 28, 28, 1) at the interface and NCHW inside:
    ``encode`` flattens the (7, 7, 64) activation in JAX's NHWC order before
    ``enc_fc1``, and ``decode`` reads ``dec_fc``'s output as NHWC (B, 7, 7,
    64), so the weights keep the JAX layouts. The two 4x4 stride-2
    transposed convs are ``nn.ConvTranspose2d(4, 2, 1)``, flax's
    ``ConvTranspose`` with pads (2, 2) and ``transpose_kernel``. ``dtype``
    is the JAX module's compute dtype (float32 parameters, ``promote``),
    passed to its ``MorphPredictor``."""

    def __init__(self, m_dim: int = 12, t_dim: int = 10, z_dim: int = 10,
                 gaussian_mechanism: bool = False, decode_real_m: bool = False,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None):
        from causalvae_tpu_torch.models.mechanism import MorphPredictor

        super().__init__()
        dev = resolve_device(device)
        self.m_dim, self.t_dim, self.z_dim, self.dtype = m_dim, t_dim, z_dim, dtype
        self.gaussian_mechanism = gaussian_mechanism
        self.decode_real_m = decode_real_m
        self.img_size = (28, 28)
        d = dtype
        self.enc_conv1 = conv(1, 32, 4, 2, 1, d)
        self.enc_conv2 = conv(32, 64, 4, 2, 1, d)
        self.enc_fc1 = Dense(64 * 7 * 7 + m_dim + t_dim, 512, d)
        self.enc_fc2 = Dense(512, 2 * z_dim, d)
        self.morph = MorphPredictor(t_dim, m_dim, hidden=(128,),
                                    gaussian=gaussian_mechanism, logvar_clip=None, dtype=d)
        self.dec_fc = Dense(m_dim + z_dim, 64 * 7 * 7, d)
        self.dec_conv1 = conv_t(64, 32, 4, 2, 1, dtype=d)
        self.dec_conv2 = conv_t(32, 1, 4, 2, 1, dtype=d)
        self.to(dev)

    def encode(self, x, m, t) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.relu(self.enc_conv1(x.permute(0, 3, 1, 2)))
        h = F.relu(self.enc_conv2(h))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # JAX's NHWC flatten
        h = torch.cat([h, m.to(h.dtype), t.to(h.dtype)], dim=1)
        h = F.relu(self.enc_fc1(h))
        mu, logvar = self.enc_fc2(h).chunk(2, dim=1)
        return mu, logvar

    def decode(self, m, z) -> torch.Tensor:
        h = F.relu(self.dec_fc(torch.cat([m.to(z.dtype), z], dim=1)))
        h = h.reshape(-1, 7, 7, 64).permute(0, 3, 1, 2)  # dec_fc's output is NHWC
        h = F.relu(self.dec_conv1(h))
        return torch.sigmoid(self.dec_conv2(h)).permute(0, 2, 3, 1)

    def predict_m(self, t) -> torch.Tensor:
        """Mechanism mean."""
        return self.morph.mean(t)

    def forward(self, x, m, t, *, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> VAEOutput:
        mu, logvar = self.encode(x, m, t)
        z = reparameterize(mu, logvar, eps=eps, generator=generator)
        if self.gaussian_mechanism:
            m_mu, m_logvar = self.morph(t)
            m_hat = m_mu
        else:
            m_hat = self.morph(t)
            m_mu = m_logvar = None
        recon = self.decode(m if self.decode_real_m else m_hat, z)
        return VAEOutput(recon, m_hat, mu, logvar, m_mu, m_logvar)


class ConditionalVAE(nn.Module):
    """CVAE for T -> X generation, M unused (C5, ref cvae_models.py:7-85):
    three 4x4 stride-2 convs (28 -> 14 -> 7 -> 3), the (3, 3, 64)
    activation flattened in JAX's NHWC order beside t into ``fc_mu`` and
    ``fc_logvar``; ``dec_fc`` (no activation) read as NHWC (7, 7, 64), then
    the two transposed convs of ``CausalConvVAE``. NHWC at the interface;
    ``dtype`` is the JAX module's compute dtype (float32 parameters)."""

    def __init__(self, t_dim: int = 10, z_dim: int = 10,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.t_dim, self.z_dim, self.dtype = t_dim, z_dim, dtype
        d = dtype
        self.enc_conv1 = conv(1, 32, 4, 2, 1, d)
        self.enc_conv2 = conv(32, 64, 4, 2, 1, d)
        self.enc_conv3 = conv(64, 64, 4, 2, 1, d)
        self.fc_mu = Dense(3 * 3 * 64 + t_dim, z_dim, d)
        self.fc_logvar = Dense(3 * 3 * 64 + t_dim, z_dim, d)
        self.dec_fc = Dense(z_dim + t_dim, 64 * 7 * 7, d)
        self.dec_conv1 = conv_t(64, 32, 4, 2, 1, dtype=d)
        self.dec_conv2 = conv_t(32, 1, 4, 2, 1, dtype=d)
        self.to(dev)

    def encode(self, x, t) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.relu(self.enc_conv1(x.permute(0, 3, 1, 2)))
        h = F.relu(self.enc_conv2(h))
        h = F.relu(self.enc_conv3(h))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # JAX's NHWC flatten
        h = torch.cat([h, t.to(h.dtype)], dim=1)
        return self.fc_mu(h), self.fc_logvar(h)

    def decode(self, z, t) -> torch.Tensor:
        h = self.dec_fc(torch.cat([z, t.to(z.dtype)], dim=1))
        h = h.reshape(-1, 7, 7, 64).permute(0, 3, 1, 2)
        h = F.relu(self.dec_conv1(h))
        return torch.sigmoid(self.dec_conv2(h)).permute(0, 2, 3, 1)

    def forward(self, x, t, *, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """(recon, mu, logvar)."""
        mu, logvar = self.encode(x, t)
        z = reparameterize(mu, logvar, eps=eps, generator=generator)
        return self.decode(z, t), mu, logvar


class MDecoder(nn.Module):
    """Conditional-independence probe M -> X, or [M, T] -> X with ``t_dim``
    (C6, ref verify_independence.py:14-55): Dense 3136 - ReLU, read as NHWC
    (7, 7, 64), two 4x4 stride-2 transposed convs (ReLU, sigmoid). flax names
    the layers ``Dense_0``, ``ConvTranspose_0``, ``ConvTranspose_1``
    (``jax_names``: ``fc``, ``conv1``, ``conv2``); the JAX module infers its
    input width, the port takes ``m_dim`` and ``t_dim`` (0: no T).
    ``dtype`` is the JAX module's compute dtype (float32 parameters)."""

    jax_names = {"Dense_0": "fc", "ConvTranspose_0": "conv1", "ConvTranspose_1": "conv2"}

    def __init__(self, m_dim: int = 12, t_dim: int = 0, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.fc = Dense(m_dim + t_dim, 64 * 7 * 7, dtype)
        self.conv1 = conv_t(64, 32, 4, 2, 1, dtype=dtype)
        self.conv2 = conv_t(32, 1, 4, 2, 1, dtype=dtype)
        self.to(dev)

    def forward(self, m, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = m if t is None else torch.cat([m, t.to(m.dtype)], dim=1)
        h = F.relu(self.fc(h)).reshape(-1, 7, 7, 64).permute(0, 3, 1, 2)
        h = F.relu(self.conv1(h))
        return torch.sigmoid(self.conv2(h)).permute(0, 2, 3, 1)


def upsample2x_nearest(h: torch.Tensor, nhwc: bool = False) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling (torch ``nn.Upsample(scale_factor=2)``)
    of an NCHW tensor, or of an NHWC one with ``nhwc``; exact in any dtype."""
    if nhwc:
        b, hh, ww, c = h.shape
        return h[:, :, None, :, None, :].expand(b, hh, 2, ww, 2, c).reshape(
            b, 2 * hh, 2 * ww, c)
    b, c, hh, ww = h.shape
    return h[:, :, :, None, :, None].expand(b, c, hh, 2, ww, 2).reshape(b, c, 2 * hh, 2 * ww)


class CausalVesselVAE(nn.Module):
    """The reference's CNN vessel causal VAE (C7, ref vessel_analysis/00_core/
    models.py:9-166): seven 4x4 stride-2 convs (``LiftableStemConv``) with
    BatchNorm and LeakyReLU(0.2) to a (gh, gw, 512) map, flattened in JAX's
    NHWC order beside M and T into ``enc_fc1`` (1024) - ``enc_fc_bn`` -
    LeakyReLU(0.2) - ``enc_fc2``; logvar clamped to [-10, 10] and mu to
    [-100, 100]. The mechanism is a Gaussian ``MorphPredictor`` (64, 64,
    LeakyReLU(0.2), m_logvar clamped to ±10). The decoder takes the REAL M:
    [M, z] -> ``dec_fc1`` - ``dec_fc_bn`` - LeakyReLU(0.2) - ReLU(``dec_fc2``),
    read as NHWC (gh, gw, 512), then six [nearest 2x, 3x3 conv, BatchNorm,
    ReLU] and a nearest 2x, 3x3 conv and sigmoid to (128·gh, 128·gw, 1).

    Images are NHWC at the interface. ``packed=False`` (the port's default)
    computes NCHW inside, permuting the activation at both fc boundaries so
    the weights keep the JAX layouts. ``packed=True`` is the JAX
    ``packed`` formulation (``ops/subpixel.py``): the encoder consumes the
    image space-to-depth-packed three times, its first three convs each
    consuming a level (BatchNorm ``groups`` 16, 4, 1); decoder stages 0-3
    run on NHWC tensors, stages 4-5 and ``dec_out`` phase-packed (the
    nearest 2x as a channel tile). The JAX default is ``packed=True``; the
    port defaults to the spatial form because the lifted kernels carry
    structural zeros that cuDNN pays for on the H100 (``ROADMAP.md``), as
    for the ViT models. ``dtype`` is the JAX module's compute dtype (float32
    parameters, ``promote``). Every train-mode BatchNorm (15 of them) runs
    the BN kernels (``ops/kernels/batchnorm.py``), the channels-last entries
    in the packed form's NHWC ones."""

    ENC_CH = (32, 64, 128, 256, 512, 512, 512)
    DEC_CH = (512, 512, 256, 128, 64, 32)
    _ENC_LEVELS = (3, 2, 1, 0, 0, 0, 0)  # packed: input levels of each encoder conv

    def __init__(self, m_dim: int = 12, t_dim: int = 19, z_dim: int = 128,
                 grid_hw: Tuple[int, int] = (6, 10), dtype: torch.dtype = torch.float32,
                 packed: bool = False, device: DeviceLike = None):
        from causalvae_tpu_torch.models.mechanism import MorphPredictor

        super().__init__()
        dev = resolve_device(device)
        self.m_dim, self.t_dim, self.z_dim = m_dim, t_dim, z_dim
        self.grid_hw = tuple(grid_hw)
        self.dtype, self.packed = dtype, packed
        d = dtype
        gh, gw = self.grid_hw
        enc = (1, *self.ENC_CH)
        self.enc_convs = nn.ModuleList(LiftableStemConv(a, b, ksize=4, dtype=d)
                                       for a, b in zip(enc[:-1], enc[1:]))
        self.enc_bns = nn.ModuleList(batch_norm(c, d) for c in self.ENC_CH)
        self.enc_fc1 = Dense(512 * gh * gw + m_dim + t_dim, 1024, d)
        self.enc_fc_bn = batch_norm(1024, d)
        self.enc_fc2 = Dense(1024, 2 * z_dim, d)
        self.morph = MorphPredictor(t_dim, m_dim, hidden=(64, 64), gaussian=True,
                                    activation="leaky_relu", logvar_clip=10.0, dtype=d)
        self.dec_fc1 = Dense(m_dim + z_dim, 1024, d)
        self.dec_fc_bn = batch_norm(1024, d)
        self.dec_fc2 = Dense(1024, gh * gw * 512, d)
        dec = (512, *self.DEC_CH)
        self.dec_convs = nn.ModuleList(PhaseableConv3x3(a, b, d)
                                       for a, b in zip(dec[:-1], dec[1:]))
        self.dec_bns = nn.ModuleList(batch_norm(c, d) for c in self.DEC_CH)
        self.dec_out = PhaseableConv3x3(self.DEC_CH[-1], 1, d)
        self.to(dev)

    @property
    def img_size(self) -> Tuple[int, int]:
        """The image size the fc layers fit: 2^7 times the grid."""
        return 128 * self.grid_hw[0], 128 * self.grid_hw[1]

    def encode(self, x, m, t) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.packed:
            h = x
            for _ in range(3):
                h = space_to_depth_2x(h)
            for lv, cv, bn in zip(self._ENC_LEVELS, self.enc_convs, self.enc_bns):
                h = cv.nhwc(h, in_levels=lv)
                h = F.leaky_relu(bn.nhwc(h, groups=4 ** max(lv - 1, 0)), 0.2)
        else:
            h = x.permute(0, 3, 1, 2)
            for cv, bn in zip(self.enc_convs, self.enc_bns):
                h = F.leaky_relu(bn(cv(h)), 0.2)
            h = h.permute(0, 2, 3, 1)  # JAX's NHWC flatten
        h = h.reshape(h.shape[0], -1)
        h = torch.cat([h, m.to(h.dtype), t.to(h.dtype)], dim=1)
        h = F.leaky_relu(self.enc_fc_bn(self.enc_fc1(h)), 0.2)
        mu, logvar = self.enc_fc2(h).chunk(2, dim=1)
        return mu.clamp(-100.0, 100.0), logvar.clamp(-10.0, 10.0)

    def decode(self, m, z) -> torch.Tensor:
        h = torch.cat([m.to(z.dtype), z], dim=1)
        h = F.leaky_relu(self.dec_fc_bn(self.dec_fc1(h)), 0.2)
        h = F.relu(self.dec_fc2(h)).reshape(-1, *self.grid_hw, 512)  # NHWC rows
        if self.packed:
            return self._packed_decode(h)
        h = h.permute(0, 3, 1, 2)
        for cv, bn in zip(self.dec_convs, self.dec_bns):
            h = F.relu(bn(cv(upsample2x_nearest(h))))
        return torch.sigmoid(self.dec_out(upsample2x_nearest(h))).permute(0, 2, 3, 1)

    def _packed_decode(self, h: torch.Tensor) -> torch.Tensor:
        """JAX ``decode`` with ``packed=True`` from the NHWC (B, gh, gw, 512)
        map: stages 0-3 on NHWC tensors, then the nearest 2x in phase space
        (the channel tile ``repeat``, or inside the phase blocks once packed)
        before stages 4-5 at level 1 and ``dec_out`` at level 2."""
        for cv, bn in zip(self.dec_convs[:4], self.dec_bns[:4]):
            h = F.relu(bn.nhwc(cv.nhwc(upsample2x_nearest(h, nhwc=True))))
        h = h.repeat(1, 1, 1, 4)                               # up #4 in phase space
        h = F.relu(self.dec_bns[4].nhwc(self.dec_convs[4].nhwc(h, levels=1), groups=4))
        h = depth_to_space_2x(h).repeat(1, 1, 1, 4)            # up #5 in phase space
        h = F.relu(self.dec_bns[5].nhwc(self.dec_convs[5].nhwc(h, levels=1), groups=4))
        b, hh, ww, ch = h.shape                                # the last up, inside
        c = self.DEC_CH[5]                                     # the phase blocks
        h = h.reshape(b, hh, ww, ch // c, 1, c).expand(b, hh, ww, ch // c, 4, c)
        o = torch.sigmoid(self.dec_out.nhwc(h.reshape(b, hh, ww, 4 * ch), levels=2))
        return depth_to_space_2x(depth_to_space_2x(o))

    def predict_m(self, t) -> torch.Tensor:
        return self.morph.mean(t)

    def forward(self, x, m, t, *, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> VAEOutput:
        mu, logvar = self.encode(x, m, t)
        z = reparameterize(mu, logvar, eps=eps, generator=generator)
        m_mu, m_logvar = self.morph(t)
        return VAEOutput(self.decode(m, z), m_mu, mu, logvar, m_mu, m_logvar)


class CausalBioVAE(nn.Module):
    """The causal cascade's compact VAE (C10, ref causal_cascade/models.py:5-89):
    four 4x4 stride-2 convs (1 -> 32 -> 64 -> 128 -> 256, ReLU), an adaptive
    4x4 mean, flattened in JAX's NHWC order beside M and the one-hot T into
    ``enc_fc1`` (512) and ``enc_fc2`` (256), then ``fc_mu`` / ``fc_logvar``;
    the mechanism T -> M' a ``MorphPredictor`` (64, 64) with a
    ``PlainBatchNorm`` after its first layer; the decoder takes [z, M']
    (the PREDICTED M, unlike C7) through ``dec_input`` read as NHWC (4, 4,
    256), three 4x4 stride-2 transposed convs (ReLU) and ``dec_out`` to a
    64x64 map, bilinearly upscaled to the input's size. H and W must be
    multiples of 64. NHWC at the interface; ``forward`` takes T as integer
    labels and one-hots it; ``predict_m`` takes one-hot T and runs the
    mechanism on its running statistics whatever the module's mode (JAX's
    ``train=False``). ``dtype`` is the JAX module's compute dtype (float32
    parameters). It launches none of the port's kernels."""

    def __init__(self, m_dim: int = 12, t_dim: int = 19, z_dim: int = 64,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None):
        from causalvae_tpu_torch.models.mechanism import MorphPredictor

        super().__init__()
        dev = resolve_device(device)
        self.m_dim, self.t_dim, self.z_dim, self.dtype = m_dim, t_dim, z_dim, dtype
        d = dtype
        chans = (1, 32, 64, 128, 256)
        self.enc_convs = nn.ModuleList(conv(a, b, 4, 2, 1, d)
                                       for a, b in zip(chans[:-1], chans[1:]))
        self.enc_fc1 = Dense(256 * 4 * 4 + m_dim + t_dim, 512, d)
        self.enc_fc2 = Dense(512, 256, d)
        self.fc_mu = Dense(256, z_dim, d)
        self.fc_logvar = Dense(256, z_dim, d)
        self.mechanism = MorphPredictor(t_dim, m_dim, hidden=(64, 64), gaussian=False,
                                        bn_layers=(0,), dtype=d)
        self.dec_input = Dense(z_dim + m_dim, 256 * 4 * 4, d)
        self.dec_convs = nn.ModuleList(conv_t(a, b, 4, 2, 1, dtype=d)
                                       for a, b in ((256, 128), (128, 64), (64, 32)))
        self.dec_out = conv_t(32, 1, 4, 2, 1, dtype=d)
        self.to(dev)

    def encode(self, x, m, t_onehot) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x.permute(0, 3, 1, 2)
        for cv in self.enc_convs:
            h = F.relu(cv(h))
        b, c, hh, ww = h.shape
        assert hh % 4 == 0 and ww % 4 == 0, "input H/W must be divisible by 64"
        h = h.reshape(b, c, 4, hh // 4, 4, ww // 4).mean(dim=(3, 5))  # adaptive 4x4
        h = h.permute(0, 2, 3, 1).reshape(b, -1)  # JAX's NHWC flatten
        h = torch.cat([h, m.to(h.dtype), t_onehot.to(h.dtype)], dim=1)
        h = F.relu(self.enc_fc1(h))
        h = F.relu(self.enc_fc2(h))
        return self.fc_mu(h), self.fc_logvar(h)

    def decode(self, z, m_hat, out_hw: Tuple[int, int]) -> torch.Tensor:
        h = self.dec_input(torch.cat([z, m_hat.to(z.dtype)], dim=1))
        h = h.reshape(-1, 4, 4, 256).permute(0, 3, 1, 2)  # dec_input's output is NHWC
        for cv in self.dec_convs:
            h = F.relu(cv(h))
        h = F.interpolate(self.dec_out(h), size=tuple(out_hw), mode="bilinear",
                          align_corners=False)
        return h.permute(0, 2, 3, 1)

    def predict_m(self, t) -> torch.Tensor:
        """Mechanism mean from one-hot T, on the BatchNorm's running statistics."""
        return self.mechanism(t, train=False)

    def forward(self, x, m, t, *, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> VAEOutput:
        t_onehot = F.one_hot(t.long(), self.t_dim).to(x.dtype)
        mu, logvar = self.encode(x, m, t_onehot)
        z = reparameterize(mu, logvar, eps=eps, generator=generator)
        m_hat = self.mechanism(t_onehot)
        return VAEOutput(self.decode(z, m_hat, x.shape[1:3]), m_hat, mu, logvar)


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
                # stride 2: each output pixel sees ~k²/4 taps per input channel
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


_TRUNCATED_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


@torch.no_grad()
def flax_init_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and persistent buffer from
    ``numpy.random.default_rng(seed)`` with flax's default initializers, in
    place, as JAX's ``model.init`` draws them (the values differ, the
    distributions are the same; same seed, same weights on any device):

    - kernels ``lecun_normal``: a normal truncated to ±2, scaled by
      sqrt(1/fan_in) / 0.8796 (so its std is sqrt(1/fan_in)), fan_in read
      from the JAX layout: a Dense (in, out) ``in`` (the attention's
      DenseGenerals flattened to it too), a Conv (k, k, in, out) k²·in, a
      transposed conv (``ConvTranspose(transpose_kernel=True)``,
      ``SubpixelConvTranspose2x``: (k, k, out, in)) k²·out, and
      ``DAGMechanism``'s ``w1`` (total, n·hidden) total and ``w2`` (n,
      hidden, d) n·hidden;
    - biases and running means zeros, scales and running variances ones;
    - ``pos_embedding`` and ``cls_token`` N(0, 1).

    A leaf none of these rules names raises."""
    from causalvae_tpu_torch.models.mechanism import DAGMechanism

    rng = np.random.default_rng(seed)

    def lecun(shape, fan_in):
        v = rng.standard_normal(int(np.prod(shape)), dtype=np.float32)
        out = np.abs(v) > 2.0
        while out.any():
            v[out] = rng.standard_normal(int(out.sum()), dtype=np.float32)
            out = np.abs(v) > 2.0
        return v.reshape(shape) * np.float32(fan_in ** -0.5 / _TRUNCATED_STD)

    for mod in model.modules():
        skip = getattr(mod, "_non_persistent_buffers_set", set())
        leaves = list(mod.named_parameters(recurse=False)) + [
            (n, b) for n, b in mod.named_buffers(recurse=False) if n not in skip]
        for name, t in leaves:
            shape = tuple(t.shape)
            if isinstance(mod, nn.ConvTranspose2d) and name == "weight":
                values = lecun(shape, shape[1] * shape[2] * shape[3])
            elif isinstance(mod, (nn.Conv2d, nn.Linear)) and name == "weight":
                values = lecun(shape, t.numel() // shape[0])
            elif isinstance(mod, DAGMechanism) and name in ("w1", "w2"):
                values = lecun(shape, int(np.prod(shape[:-1])))
            elif name in ("bias", "b1", "b2", "mean"):
                values = np.zeros(shape, np.float32)
            elif name in ("scale", "var") or (isinstance(mod, nn.LayerNorm)
                                              and name == "weight"):
                values = np.ones(shape, np.float32)
            elif name in ("pos_embedding", "cls_token"):
                values = rng.standard_normal(shape, dtype=np.float32)
            else:
                raise ValueError(f"flax_init_: no flax initializer known for {name!r} "
                                 f"of {type(mod).__name__}")
            t.copy_(torch.from_numpy(values).to(t.dtype))
    return model

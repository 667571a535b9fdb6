"""Hybrid conv-stem ViT VAE and its causal adapter wrapper (PyTorch).

Counterparts of ``causalvae_tpu/models/vit.py``: ``ResBlock``,
``MultiHeadAttention``, ``ViTBlock``, ``ViTVAE`` (C8) and ``CausalViTVAE``
(C9), in the spatial formulation (``packed=False`` there); phase packing,
``packed_io``, ``fused_stages`` and ``remat_blocks`` are TPU execution options
and not ported. Eval mode only for now: the BatchNorms raise in train mode.

Layouts: public images are NHWC (B, H, W, 1) as in the JAX package; inside,
convolutions run NCHW. Attention runs through the CUDA kernel of
``ops/kernels/attention.py`` on the GPU (plain PyTorch on the CPU).

Details held to the reference: LeakyReLU 0.01 in the stem and decoder, 0.2 in
the ResBlock and the adapters; exact GELU; LayerNorm eps 1e-5; C9 clips
logvar to ±10 and mu to ±100; ``decoder_input`` output rows are in the JAX
(gh, gw, E) order, so its output is viewed NHWC and then permuted to NCHW.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from causalvae_tpu_torch.device import DeviceLike, resolve_device
from causalvae_tpu_torch.models.mechanism import MorphPredictor
from causalvae_tpu_torch.models.vae import VAEOutput, batch_norm, conv_t, reparameterize
from causalvae_tpu_torch.ops.kernels.attention import flash_attention
from causalvae_tpu_torch.ops.subpixel import LiftableStemConv, PhaseableConv3x3


class ResBlock(nn.Module):
    """conv3-BN-LeakyReLU(0.2)-conv3-BN with identity skip."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv0 = PhaseableConv3x3(channels, channels)
        self.bn0 = batch_norm(channels)
        self.conv1 = PhaseableConv3x3(channels, channels)
        self.bn1 = batch_norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.bn0(self.conv0(x)), 0.2)
        return x + self.bn1(self.conv1(h))


class MultiHeadAttention(nn.Module):
    """MHA over the token sequence through the attention kernel.

    ``qkv`` packs q, k, v as (3, heads, head_dim) along its output, the order
    of the JAX ``DenseGeneral`` kernel (E, 3, H, D). Attention dropout runs
    only in training, which comes with the training slice."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.1):
        super().__init__()
        self.heads = heads
        self.dropout = dropout
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.dropout > 0.0:
            raise NotImplementedError(
                "attention dropout (the backward kernel's hash mask) comes "
                "with the training slice; call .eval() to serve")
        b, n, e = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.heads, e // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, N, D) each
        out = flash_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, e))


class ViTBlock(nn.Module):
    """Pre-norm transformer encoder block."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, dropout: float = 0.1):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadAttention(dim, heads, dropout)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        h = self.drop(F.gelu(self.fc1(self.norm2(x)), approximate="none"))
        return x + self.drop(self.fc2(h))


class ViTVAE(nn.Module):
    """Hybrid ViT VAE: conv stem (/32) -> transformer -> CLS latent; CNN
    decoder with ResBlocks after the first ``dec_res_stages`` stages (3 for
    the vessel backbone, 4 for the latent-translator variant); no output
    sigmoid. ``latent_heads=False`` leaves out ``fc_mu``/``fc_var``, which
    the causal wrapper never uses (its JAX variables have none)."""

    def __init__(self, img_size: Tuple[int, int] = (768, 1280),
                 in_channels: int = 1, latent_dim: int = 512,
                 embed_dim: int = 256, depth: int = 6, heads: int = 8,
                 mlp_dim: int = 512, dropout: float = 0.1,
                 dec_res_stages: int = 3, latent_heads: bool = True,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.img_size = tuple(img_size)
        self.embed_dim = embed_dim
        gh, gw = self.grid_hw
        stem_ch = (in_channels, 32, 64, 128, embed_dim, embed_dim)
        self.stem_convs = nn.ModuleList(
            LiftableStemConv(a, b) for a, b in zip(stem_ch[:-1], stem_ch[1:]))
        self.stem_bns = nn.ModuleList(batch_norm(c) for c in stem_ch[1:])
        self.pos_embedding = nn.Parameter(torch.zeros(1, gh * gw + 1, embed_dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_dropout = nn.Dropout(dropout)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, heads, mlp_dim, dropout) for _ in range(depth))
        self.to_latent = nn.LayerNorm(embed_dim, eps=1e-5)
        if latent_heads:
            self.fc_mu = nn.Linear(embed_dim, latent_dim)
            self.fc_var = nn.Linear(embed_dim, latent_dim)
        self.decoder_input = nn.Linear(latent_dim, embed_dim * gh * gw)
        dec_ch = (embed_dim, 128, 64, 32, 16, 16)
        self.dec_ct = nn.ModuleList(
            conv_t(a, b, 3, 2, 1, output_padding=1)
            for a, b in zip(dec_ch[:-1], dec_ch[1:]))
        self.dec_bns = nn.ModuleList(batch_norm(c) for c in dec_ch[1:])
        self.dec_res = nn.ModuleList(
            ResBlock(c) for c in dec_ch[1:1 + dec_res_stages])
        self.dec_out = PhaseableConv3x3(dec_ch[-1], in_channels)
        self.to(dev)

    @property
    def grid_hw(self) -> Tuple[int, int]:
        return self.img_size[0] // 32, self.img_size[1] // 32

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> stem + CLS + positional embedding + transformer
        -> (B, gh*gw + 1, E)."""
        h = x.permute(0, 3, 1, 2)
        for cv, bn in zip(self.stem_convs, self.stem_bns):
            h = F.leaky_relu(bn(cv(h)), 0.01)
        h = h.flatten(2).transpose(1, 2)  # (B, gh*gw, E), row-major grid
        cls = self.cls_token.to(h.dtype).expand(h.shape[0], -1, -1)
        h = torch.cat([cls, h], dim=1)
        h = self.pos_dropout(h + self.pos_embedding[:, :h.shape[1]].to(h.dtype))
        for blk in self.blocks:
            h = blk(h)
        return h

    def encode_cls(self, x: torch.Tensor) -> torch.Tensor:
        """CLS representation before the latent heads."""
        return self.to_latent(self.tokens(x)[:, 0])

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cls_out = self.encode_cls(x)
        return self.fc_mu(cls_out), self.fc_var(cls_out)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, latent) -> NHWC reconstruction (B, H, W, in_channels)."""
        gh, gw = self.grid_hw
        h = self.decoder_input(z).view(-1, gh, gw, self.embed_dim)
        h = h.permute(0, 3, 1, 2)  # NHWC rows (JAX order) -> NCHW
        for i, ct in enumerate(self.dec_ct):
            h = F.leaky_relu(self.dec_bns[i](ct(h)), 0.01)
            if i < len(self.dec_res):
                h = self.dec_res[i](h)
        return self.dec_out(h).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, *, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        mu, logvar = self.encode(x)
        z = reparameterize(mu, logvar, eps=eps, generator=generator)
        return self.decode(z), x, mu, logvar


class CausalViTVAE(nn.Module):
    """Causal adapter around a ViTVAE backbone (C9): CLS + (M, T) ->
    enc_adapter -> Z; (M, Z) -> dec_adapter -> backbone latent ->
    backbone.decode."""

    def __init__(self, img_size: Tuple[int, int] = (768, 1280), m_dim: int = 12,
                 t_dim: int = 19, z_dim: int = 128, vit_latent_dim: int = 512,
                 embed_dim: int = 256, depth: int = 6, heads: int = 8,
                 mlp_dim: int = 512, dropout: float = 0.1,
                 dec_res_stages: int = 3, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.img_size = tuple(img_size)
        self.m_dim, self.t_dim, self.z_dim = m_dim, t_dim, z_dim
        self.backbone = ViTVAE(
            img_size=img_size, latent_dim=vit_latent_dim, embed_dim=embed_dim,
            depth=depth, heads=heads, mlp_dim=mlp_dim, dropout=dropout,
            dec_res_stages=dec_res_stages, latent_heads=False, device="cpu")
        self.enc_adapter_fc1 = nn.Linear(embed_dim + m_dim + t_dim, 512)
        self.enc_adapter_bn = batch_norm(512)
        self.enc_adapter_fc2 = nn.Linear(512, 2 * z_dim)
        self.dec_adapter_fc1 = nn.Linear(m_dim + z_dim, 256)
        self.dec_adapter_bn = batch_norm(256)
        self.dec_adapter_fc2 = nn.Linear(256, vit_latent_dim)
        self.morph = MorphPredictor(t_dim, m_dim, hidden=(64, 64),
                                    logvar_clip=10.0)
        self.to(dev)

    def encode(self, x, m, t) -> Tuple[torch.Tensor, torch.Tensor]:
        cls_out = self.backbone.encode_cls(x)
        h = torch.cat([cls_out, m.to(cls_out.dtype), t.to(cls_out.dtype)], dim=1)
        h = F.leaky_relu(self.enc_adapter_bn(self.enc_adapter_fc1(h)), 0.2)
        mu, logvar = self.enc_adapter_fc2(h).chunk(2, dim=1)
        return mu.clamp(-100.0, 100.0), logvar.clamp(-10.0, 10.0)

    def decode(self, m, z) -> torch.Tensor:
        h = torch.cat([m.to(z.dtype), z], dim=1)
        h = F.leaky_relu(self.dec_adapter_bn(self.dec_adapter_fc1(h)), 0.2)
        return self.backbone.decode(self.dec_adapter_fc2(h))

    def predict_m(self, t) -> torch.Tensor:
        return self.morph.mean(t)

    def forward(self, x, m, t, *, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> VAEOutput:
        mu, logvar = self.encode(x, m, t)
        z = reparameterize(mu, logvar, eps=eps, generator=generator)
        m_mu, m_logvar = self.morph(t)
        recon = self.decode(m, z)
        return VAEOutput(recon, m_mu, mu, logvar, m_mu, m_logvar)

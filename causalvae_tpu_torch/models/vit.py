"""Hybrid conv-stem ViT VAE and its causal adapter wrapper (PyTorch).

Counterparts of ``causalvae_tpu/models/vit.py``: ``ResBlock``,
``MultiHeadAttention``, ``ViTBlock``, ``ViTVAE`` (C8) and ``CausalViTVAE``
(C9), in both formulations of the JAX package, with the same parameters:

- spatial (``packed=False``, the port's default): convolutions on NCHW
  tensors, the transposed convs as ``ConvTranspose2d``;
- phase-packed (``packed=True``, the JAX default): NHWC throughout; the
  stem consumes a space-to-depth-packed image and the decoder runs on coarse
  grids with lifted kernels (``ops/subpixel.py``), BatchNorm statistics
  folded per real channel. ``packed_io`` takes the image already
  ``space_to_depth_n(x, 3)``-packed and returns the reconstruction in that
  layout (the losses are pixel-permutation-invariant). ``fused_stages``
  folds each BatchNorm-apply + LeakyReLU into the consuming conv through the
  stage kernels (``ops/kernels/stage.py``): 14 stage calls per forward of
  the vessel model.

The port's default stays spatial until a measurement on the card says which
is faster (``PERF.md``). Train mode
(``.train()``) runs the BatchNorms on batch statistics through the BN kernels
and applies dropout: attention-probability dropout inside the attention
kernels, with one uint32 seed per layer per call drawn from the caller's
``torch.Generator`` before the block runs (as the JAX model draws one from
its dropout rng) and passed to it, and
``nn.Dropout`` on the positional embedding and the MLP (``models.vae.Dropout``:
inside a data-parallel step over the whole batch, each rank's rows of the
whole batch's masks, as the attention hash's heads are; the MLP's keep
masks drawn from torch's generator before the block, ``ViTBlock.draw_masks``).

``dtype`` is the JAX modules' compute dtype (``VesselConfig.compute_dtype``):
every layer keeps float32 parameters and computes in ``dtype`` on its cast
input and parameters (``ops.subpixel.promote``; ``Dense``, ``LayerNorm``, the
convs of ``ops/subpixel.py``, ``BatchNorm(dtype)``), so in bfloat16 the
attention, BatchNorm and stage kernels take bfloat16 operands; the
positional embedding and CLS token are cast to the tokens' dtype, the
prologue's skip is computed in float32 and cast, the noise is drawn in mu's
dtype, and the losses cast to float32. No ``torch.autocast``.

``remat_blocks`` (the JAX option) recomputes each transformer block in the
backward (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
activations. Nothing inside the checkpointed call draws: the attention seed
and the keep masks of the block's two MLP dropouts (``ViTBlock.draw_masks``,
from torch's generator) are drawn by ``tokens`` before it and passed in, in
both modes, so the recompute applies the forward's masks and the checkpoint
keeps no generator state (``preserve_rng_state=False``). That leaves the
step free of host reads of the card's generator, so ``train/scan_loop.py``
captures a remat model in a CUDA graph, and the remat step equals the plain
step bit for bit.

Layouts: public images are NHWC (B, H, W, 1) as in the JAX package (packed:
(B, H/8, W/8, 64) with ``packed_io``). Attention runs through the CUDA kernel
of ``ops/kernels/attention.py`` on the GPU (plain PyTorch on the CPU).

Details held to the reference: LeakyReLU 0.01 in the stem and decoder, 0.2 in
the ResBlock and the adapters; exact GELU; LayerNorm eps 1e-5; C9 clips
logvar to ±10 and mu to ±100; ``decoder_input`` output rows are in the JAX
(gh, gw, E) order, so its output is viewed NHWC and then permuted to NCHW.

``vessel_model`` builds the CausalViTVAE of a ``VesselConfig`` (the JAX
``train_vessel`` and serving CLI build it in place); the trainer and the
CLI both call it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from causalvae_tpu_torch.config import VesselConfig
from causalvae_tpu_torch.device import DeviceLike, resolve_device
from causalvae_tpu_torch.models.mechanism import MorphPredictor
from causalvae_tpu_torch.models.vae import (Dense, Dropout, LayerNorm, VAEOutput, batch_norm,
                                           conv_t, reparameterize, seeded_init_)
from causalvae_tpu_torch.ops import draws
from causalvae_tpu_torch.ops.kernels.attention import flash_attention
from causalvae_tpu_torch.ops.subpixel import (LiftableStemConv, PhaseableConv3x3,
                                              depth_to_space_2x, space_to_depth_2x)
from causalvae_tpu_torch.parallel.mesh import current_global_batch


class ResBlock(nn.Module):
    """conv3-BN-LeakyReLU(0.2)-conv3-BN with identity skip, in ``dtype``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = PhaseableConv3x3(channels, channels, dtype)
        self.bn0 = batch_norm(channels, dtype)
        self.conv1 = PhaseableConv3x3(channels, channels, dtype)
        self.bn1 = batch_norm(channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.bn0(self.conv0(x)), 0.2)
        return x + self.bn1(self.conv1(h))

    def nhwc(self, x: torch.Tensor, levels: int = 0,
             prologue: Optional[tuple] = None, fused: bool = False) -> torch.Tensor:
        """The JAX call on an NHWC tensor packed ``levels`` times.
        ``prologue`` (mul, add, slope) of a preceding BatchNorm + LeakyReLU
        is folded into conv0 and recomputed elementwise at the skip (the
        residual is the normalized input); ``fused`` folds bn0 + LeakyReLU
        (0.2) into conv1 the same way."""
        g = 4 ** levels
        h = self.conv0.nhwc(x, levels=levels, prologue=prologue)
        if fused:
            mul0, add0 = self.bn0.nhwc(h, groups=g, emit_affine=True)
            h = self.conv1.nhwc(h, levels=levels,
                                prologue=(mul0.repeat(g), add0.repeat(g), 0.2))
        else:
            h = F.leaky_relu(self.bn0.nhwc(h, groups=g), 0.2)
            h = self.conv1.nhwc(h, levels=levels)
        h = self.bn1.nhwc(h, groups=g)
        if prologue is not None:
            mul, add, slope = prologue
            pre = x.float() * mul + add
            x = torch.where(pre >= 0.0, pre, slope * pre).to(h.dtype)
        return x + h


class MultiHeadAttention(nn.Module):
    """MHA over the token sequence through the attention kernel.

    ``qkv`` packs q, k, v as (3, heads, head_dim) along its output, the order
    of the JAX ``DenseGeneral`` kernel (E, 3, H, D). Attention dropout runs
    inside the kernels with the uint32 ``seed`` the caller drew
    (``draw_seed``: a 0-d int64 tensor on the device; an int also does);
    None runs none."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.dropout = dropout
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def draw_seed(self, generator: Optional[torch.Generator] = None,
                  device: DeviceLike = None) -> Optional[torch.Tensor]:
        """This call's uint32 dropout seed from ``generator``, as a 0-d int64
        tensor on ``device`` (``ops/draws.py seed``); None when no dropout
        runs (eval mode or rate 0), which draws nothing."""
        if not (self.training and self.dropout > 0.0):
            return None
        return draws.seed(generator, resolve_device(device))

    def forward(self, x: torch.Tensor, seed=None) -> torch.Tensor:
        b, n, e = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.heads, e // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, N, D) each
        if seed is not None:
            # a data-parallel rank's heads start at its first row's, so its
            # masks are the whole batch's
            gb = current_global_batch()
            out = flash_attention(q, k, v, dropout_rate=self.dropout, dropout_seed=seed,
                                  dropout_bh0=0 if gb is None else gb.start * self.heads)
        else:
            out = flash_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, e))


class ViTBlock(nn.Module):
    """Pre-norm transformer encoder block, in ``dtype``; ``seed`` as in
    ``MultiHeadAttention``."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-5, dtype)
        self.attn = MultiHeadAttention(dim, heads, dropout, dtype)
        self.norm2 = LayerNorm(dim, 1e-5, dtype)
        self.fc1 = Dense(dim, mlp_dim, dtype)
        self.fc2 = Dense(mlp_dim, dim, dtype)
        self.drop = Dropout(dropout)

    def draw_masks(self, x: torch.Tensor) -> tuple:
        """The keep masks of the MLP's two dropouts for an input x (B, N, E):
        after GELU (B, N, mlp_dim) and after fc2 (B, N, E), drawn in that
        order (``Dropout.keep_mask``; None each in eval mode)."""
        b, n, _ = x.shape
        return (self.drop.keep_mask((b, n, self.fc1.out_features), x.device),
                self.drop.keep_mask((b, n, self.fc2.out_features), x.device))

    def forward(self, x: torch.Tensor, seed=None, masks=None) -> torch.Tensor:
        """``masks``: ``draw_masks``' pair, drawn here when not given."""
        keep1, keep2 = self.draw_masks(x) if masks is None else masks
        x = x + self.attn(self.norm1(x), seed)
        h = self.drop.apply_mask(F.gelu(self.fc1(self.norm2(x)), approximate="none"), keep1)
        return x + self.drop.apply_mask(self.fc2(h), keep2)


class ViTVAE(nn.Module):
    """Hybrid ViT VAE: conv stem (/32) -> transformer -> CLS latent; CNN
    decoder with ResBlocks after the first ``dec_res_stages`` stages (3 for
    the vessel backbone, 4 for the latent-translator variant); no output
    sigmoid. ``latent_heads=False`` leaves out ``fc_mu``/``fc_var``, which
    the causal wrapper never uses (its JAX variables have none).
    ``packed``, ``packed_io``, ``fused_stages``, ``remat_blocks`` and
    ``dtype`` as in the module docstring (the JAX options of the same names;
    the JAX default is ``packed=True``, the port's is the spatial form)."""

    def __init__(self, img_size: Tuple[int, int] = (768, 1280),
                 in_channels: int = 1, latent_dim: int = 512,
                 embed_dim: int = 256, depth: int = 6, heads: int = 8,
                 mlp_dim: int = 512, dropout: float = 0.1,
                 dec_res_stages: int = 3, latent_heads: bool = True,
                 packed: bool = False, packed_io: bool = False,
                 fused_stages: bool = False, remat_blocks: bool = False,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        if (packed_io or fused_stages) and not packed:
            raise ValueError("packed_io and fused_stages need packed=True")
        self.img_size = tuple(img_size)
        self.embed_dim = embed_dim
        self.packed, self.packed_io, self.fused_stages = packed, packed_io, fused_stages
        self.remat_blocks, self.dtype = remat_blocks, dtype
        d = dtype
        gh, gw = self.grid_hw
        stem_ch = (in_channels, 32, 64, 128, embed_dim, embed_dim)
        self.stem_convs = nn.ModuleList(
            LiftableStemConv(a, b, dtype=d) for a, b in zip(stem_ch[:-1], stem_ch[1:]))
        self.stem_bns = nn.ModuleList(batch_norm(c, d) for c in stem_ch[1:])
        self.pos_embedding = nn.Parameter(torch.zeros(1, gh * gw + 1, embed_dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_dropout = Dropout(dropout)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, heads, mlp_dim, dropout, d) for _ in range(depth))
        self.to_latent = LayerNorm(embed_dim, 1e-5, d)
        if latent_heads:
            self.fc_mu = Dense(embed_dim, latent_dim, d)
            self.fc_var = Dense(embed_dim, latent_dim, d)
        self.decoder_input = Dense(latent_dim, embed_dim * gh * gw, d)
        dec_ch = (embed_dim, 128, 64, 32, 16, 16)
        self.dec_ct = nn.ModuleList(
            conv_t(a, b, 3, 2, 1, output_padding=1, dtype=d)
            for a, b in zip(dec_ch[:-1], dec_ch[1:]))
        self.dec_bns = nn.ModuleList(batch_norm(c, d) for c in dec_ch[1:])
        self.dec_res = nn.ModuleList(
            ResBlock(c, d) for c in dec_ch[1:1 + dec_res_stages])
        self.dec_out = PhaseableConv3x3(dec_ch[-1], in_channels, d)
        self.to(dev)

    @property
    def grid_hw(self) -> Tuple[int, int]:
        return self.img_size[0] // 32, self.img_size[1] // 32

    def tokens(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC image -> stem + CLS + positional embedding + transformer
        -> (B, gh*gw + 1, E); ``generator`` seeds attention dropout."""
        if self.packed:
            h = self._packed_stem(x)
            h = h.reshape(h.shape[0], -1, h.shape[-1])  # (B, gh*gw, E), row-major grid
        else:
            h = x.permute(0, 3, 1, 2)
            for cv, bn in zip(self.stem_convs, self.stem_bns):
                h = F.leaky_relu(bn(cv(h)), 0.01)
            h = h.flatten(2).transpose(1, 2)  # (B, gh*gw, E), row-major grid
        cls = self.cls_token.to(h.dtype).expand(h.shape[0], -1, -1)
        h = torch.cat([cls, h], dim=1)
        h = self.pos_dropout(h + self.pos_embedding[:, :h.shape[1]].to(h.dtype))
        remat = self.remat_blocks and torch.is_grad_enabled()
        for blk in self.blocks:
            seed = blk.attn.draw_seed(generator, h.device)
            masks = blk.draw_masks(h)
            h = (checkpoint(blk, h, seed, masks, use_reentrant=False, preserve_rng_state=False)
                 if remat else blk(h, seed, masks))
        return h

    def _packed_stem(self, x: torch.Tensor) -> torch.Tensor:
        """The stem on the image packed three times: each stride-2 conv
        consumes a level (channels 64 -> 512 -> 256 -> 128 at (H/8, W/8)),
        the last two run spatially. With ``fused_stages`` the BatchNorms
        before the lifted convs 1 and 2 become their prologues."""
        h = x
        if not self.packed_io:
            for _ in range(3):
                h = space_to_depth_2x(h)
        in_lv = (3, 2, 1, 0, 0)
        pro = None
        for i, (cv, bn) in enumerate(zip(self.stem_convs, self.stem_bns)):
            h = cv.nhwc(h, in_levels=in_lv[i], prologue=pro)
            g = 4 ** max(in_lv[i] - 1, 0)
            if self.fused_stages and i + 1 < len(self.stem_convs) and in_lv[i + 1] > 0:
                mul, add = bn.nhwc(h, groups=g, emit_affine=True)
                pro = (mul.repeat(g), add.repeat(g), 0.01)
            else:
                h = F.leaky_relu(bn.nhwc(h, groups=g), 0.01)
                pro = None
        return h

    def encode_cls(self, x: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """CLS representation before the latent heads."""
        return self.to_latent(self.tokens(x, generator)[:, 0])

    def encode(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        cls_out = self.encode_cls(x, generator)
        return self.fc_mu(cls_out), self.fc_var(cls_out)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, latent) -> NHWC reconstruction (B, H, W, in_channels), or its
        ``space_to_depth_n(., 3)`` layout with ``packed_io``."""
        gh, gw = self.grid_hw
        h = self.decoder_input(z).view(-1, gh, gw, self.embed_dim)
        if self.packed:
            o = self._packed_decode(h)
            if self.packed_io:
                return o
            for _ in range(3):
                o = depth_to_space_2x(o)
            return o
        h = h.permute(0, 3, 1, 2)  # NHWC rows (JAX order) -> NCHW
        for i, ct in enumerate(self.dec_ct):
            h = F.leaky_relu(self.dec_bns[i](ct(h)), 0.01)
            if i < len(self.dec_res):
                h = self.dec_res[i](h)
        return self.dec_out(h).permute(0, 2, 3, 1)

    def _packed_decode(self, h: torch.Tensor) -> torch.Tensor:
        """The phase-packed decoder (JAX ``decode``, ``packed=True``): NHWC
        (B, gh, gw, E) -> (B, 4gh, 4gw, 64), the output packed three times.
        Every stage keeps >= 128 packed channels; the transposed convs add a
        level each, dec_res[2] runs at level 1 after a depth-to-space."""
        ct, bns, res = self.dec_ct, self.dec_bns, self.dec_res

        def bn_act(i, h, groups):
            return F.leaky_relu(bns[i].nhwc(h, groups=groups), 0.01)

        def bn_affine(i, h, groups, tiles):
            """BN_i's (mul, add) repeated to the consumer's packed width:
            the affine is per real channel, so it commutes with a
            depth-to-space between the BN and its consumer."""
            mul, add = bns[i].nhwc(h, groups=groups, emit_affine=True)
            return mul.repeat(tiles), add.repeat(tiles), 0.01

        if self.fused_stages:
            h = ct[0].nhwc(h, use_pallas=True)                      # (2gh, 2gw, 128)
            h = res[0].nhwc(h, prologue=bn_affine(0, h, 1, 1), fused=True)
            h = ct[1].nhwc(h, phase_output=True, use_pallas=True)   # L1: 256
            h = res[1].nhwc(h, levels=1, prologue=bn_affine(1, h, 4, 4), fused=True)
            h = ct[2].nhwc(h, phase_output=True, in_levels=1, use_pallas=True)  # L2: 512
            pro2 = bn_affine(2, h, 16, 4)                           # post-d2s width 128
            h = depth_to_space_2x(h)                                # L1: (4gh, 4gw, 128)
            h = res[2].nhwc(h, levels=1, prologue=pro2, fused=True)
            h = ct[3].nhwc(h, phase_output=True, in_levels=1, use_pallas=True)  # L2: 256
            if len(res) > 3:  # translator variant (4 ResBlocks)
                h = res[3].nhwc(h, levels=2, prologue=bn_affine(3, h, 16, 16), fused=True)
            else:
                h = bn_act(3, h, 16)
            h = ct[4].nhwc(h, phase_output=True, in_levels=2, use_pallas=True)  # L3: 1024
            return self.dec_out.nhwc(h, levels=3, prologue=bn_affine(4, h, 64, 64))
        h = bn_act(0, ct[0].nhwc(h), 1)
        h = res[0].nhwc(h)
        h = bn_act(1, ct[1].nhwc(h, phase_output=True), 4)
        h = res[1].nhwc(h, levels=1)
        h = bn_act(2, ct[2].nhwc(h, phase_output=True, in_levels=1), 16)
        h = res[2].nhwc(depth_to_space_2x(h), levels=1)
        h = bn_act(3, ct[3].nhwc(h, phase_output=True, in_levels=1), 16)
        if len(res) > 3:
            h = res[3].nhwc(h, levels=2)
        h = bn_act(4, ct[4].nhwc(h, phase_output=True, in_levels=2), 64)
        return self.dec_out.nhwc(h, levels=3)

    def forward(self, x: torch.Tensor, *, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        mu, logvar = self.encode(x, generator)
        z = reparameterize(mu, logvar, eps=eps, generator=generator)
        return self.decode(z), x, mu, logvar


class CausalViTVAE(nn.Module):
    """Causal adapter around a ViTVAE backbone (C9): CLS + (M, T) ->
    enc_adapter -> Z; (M, Z) -> dec_adapter -> backbone latent ->
    backbone.decode. ``packed``, ``packed_io``, ``fused_stages`` and
    ``remat_blocks`` go to the backbone, ``dtype`` to every layer (see
    ``ViTVAE``)."""

    def __init__(self, img_size: Tuple[int, int] = (768, 1280), m_dim: int = 12,
                 t_dim: int = 19, z_dim: int = 128, vit_latent_dim: int = 512,
                 embed_dim: int = 256, depth: int = 6, heads: int = 8,
                 mlp_dim: int = 512, dropout: float = 0.1,
                 dec_res_stages: int = 3, packed: bool = False,
                 packed_io: bool = False, fused_stages: bool = False,
                 remat_blocks: bool = False, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.img_size = tuple(img_size)
        self.m_dim, self.t_dim, self.z_dim = m_dim, t_dim, z_dim
        self.dtype = d = dtype
        self.backbone = ViTVAE(
            img_size=img_size, latent_dim=vit_latent_dim, embed_dim=embed_dim,
            depth=depth, heads=heads, mlp_dim=mlp_dim, dropout=dropout,
            dec_res_stages=dec_res_stages, latent_heads=False, packed=packed,
            packed_io=packed_io, fused_stages=fused_stages, remat_blocks=remat_blocks,
            dtype=d, device="cpu")
        self.enc_adapter_fc1 = Dense(embed_dim + m_dim + t_dim, 512, d)
        self.enc_adapter_bn = batch_norm(512, d)
        self.enc_adapter_fc2 = Dense(512, 2 * z_dim, d)
        self.dec_adapter_fc1 = Dense(m_dim + z_dim, 256, d)
        self.dec_adapter_bn = batch_norm(256, d)
        self.dec_adapter_fc2 = Dense(256, vit_latent_dim, d)
        self.morph = MorphPredictor(t_dim, m_dim, hidden=(64, 64), gaussian=True,
                                    activation="leaky_relu", logvar_clip=10.0, dtype=d)
        self.to(dev)

    def encode(self, x, m, t, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        cls_out = self.backbone.encode_cls(x, generator)
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
        mu, logvar = self.encode(x, m, t, generator)
        z = reparameterize(mu, logvar, eps=eps, generator=generator)
        m_mu, m_logvar = self.morph(t)
        recon = self.decode(m, z)
        return VAEOutput(recon, m_mu, mu, logvar, m_mu, m_logvar)


def vessel_model(img_hw: Optional[Sequence[int]] = None, device: DeviceLike = None,
                 seed: Optional[int] = 0, dropout: float = 0.1, packed: bool = False,
                 packed_io: bool = False, fused_stages: bool = False,
                 remat_blocks: bool = False, cfg: VesselConfig = VesselConfig()):
    """(model, img_hw): the vessel CausalViTVAE at ``cfg``'s widths, m, t
    sizes and ``compute_dtype``, at ``img_hw`` (default ``cfg``'s), weights
    from ``seed`` (``models.vae.seeded_init_``, the same float32 weights in
    either formulation and dtype; None leaves torch's initialisation for a
    checkpoint to overwrite); ``packed``, ``packed_io``, ``fused_stages``,
    ``remat_blocks`` as in ``ViTVAE`` (default the spatial form)."""
    hw: Tuple[int, int] = (tuple(img_hw) if img_hw
                           else (cfg.img_height, cfg.img_width))
    model = CausalViTVAE(
        img_size=hw, m_dim=cfg.m_dim, t_dim=cfg.t_dim, z_dim=cfg.z_dim,
        vit_latent_dim=cfg.vit_latent_dim, embed_dim=cfg.vit_embed_dim,
        depth=cfg.vit_depth, heads=cfg.vit_heads, mlp_dim=cfg.vit_mlp_dim,
        dropout=dropout, packed=packed, packed_io=packed_io,
        fused_stages=fused_stages, remat_blocks=remat_blocks,
        dtype=getattr(torch, cfg.compute_dtype), device=device)
    if seed is not None:
        seeded_init_(model, seed)
    return model, hw

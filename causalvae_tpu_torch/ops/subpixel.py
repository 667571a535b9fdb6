"""Subpixel and phase-packed convolutions of ``causalvae_tpu/ops/subpixel.py``.

The stride-2 transposed 3x3 convolution of the ViT decoder is four small
convolutions, one per output phase (``phase_kernel_2x``). Phase packing
(``space_to_depth_2x`` and its inverse) moves 2x2 pixel blocks into the
channel axis, channel index ``phase * C + c`` with new phases outermost; a
same-size conv on the fine grid is then a same-size conv on the coarse grid
with a lifted kernel (``lift_once``), and a stride-2 conv consumes one level
(``consume_once``). The lifted kernels carry structural zeros: they trade
more arithmetic for dense channel counts, the layout the TPU's (8, 128)
tiling wanted. Public functions keep the JAX layouts: images NHWC, kernels
HWIO, the transposed-conv kernel (3, 3, C_out, C_in).

The three classes hold torch's parameters (``Conv2d`` OIHW, ``ConvTranspose2d``
(C_in, C_out, kH, kW); ``train/port_maps.py`` converts the JAX kernels by
``transpose(3, 2, 0, 1)``, whose inverse ``permute(2, 3, 1, 0)`` gives the
JAX kernel back for both). ``forward`` is the spatial form on NCHW tensors,
which the ``packed=False`` model runs; ``nhwc`` is the JAX ``__call__`` with
its arguments, on NHWC tensors at any packing level, which the packed model
runs. There the lifted kernel is gathered at each call from the parameter,
one ``index_select`` through a cached tap index, so gradients reach the same
``weight``/``bias`` leaves as in the spatial model. With a ``prologue``
(or ``use_pallas``) the conv goes through ``ops/kernels/stage.py``'s
``affine_act_conv`` (the hand-written stage kernels on the card).

Not ported yet: ``conv3x3_phase_kernel``/``phase_conv3x3`` and the flat
(anisotropic) packing variants, which no model path runs.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from causalvae_tpu_torch.ops.kernels.stage import affine_act_conv


def phase_kernel_2x(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C_out, C_in) transpose-layout kernel -> (2, 2, C_in, 4*C_out),
    output channel ``(a*2 + b) * C_out + c`` (matching ``depth_to_space_2x``)."""
    k, k2, _, _ = w.shape
    assert (k, k2) == (3, 3), "phase decomposition is for k=3, s=2, p=1, op=1"
    blocks = []
    for a in (0, 1):
        for b in (0, 1):
            taps = []
            for di in (0, 1):
                row = []
                for dj in (0, 1):
                    ki, kj = a + 1 - 2 * di, b + 1 - 2 * dj
                    row.append(w[ki, kj] if 0 <= ki < 3 and 0 <= kj < 3
                               else torch.zeros_like(w[0, 0]))
                taps.append(torch.stack(row))
            blocks.append(torch.stack(taps).permute(0, 1, 3, 2))
    return torch.cat(blocks, dim=-1)


def _permute(x, perm):
    """Axis permutation of a torch tensor or a numpy array."""
    return x.permute(*perm) if isinstance(x, torch.Tensor) else x.transpose(*perm)


def depth_to_space_2x(y: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4C) -> (B, 2H, 2W, C) with channel blocks as 2x2 phases."""
    b, h, w, c4 = y.shape
    c = c4 // 4
    return y.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)


def space_to_depth_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, 2H, 2W, C) -> (B, H, W, 4C); inverse of ``depth_to_space_2x``."""
    b, h2, w2, c = x.shape
    x = x.reshape(b, h2 // 2, 2, w2 // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h2 // 2, w2 // 2, 4 * c)


def space_to_depth_n(x, n: int):
    """n nested ``space_to_depth_2x`` as one reshape-permute-reshape; takes
    torch tensors and numpy arrays alike (host packing of a batch)."""
    if n == 0:
        return x
    b, h, w, c = x.shape
    f = 1 << n
    bits = x.reshape(b, h // f, *([2] * n), w // f, *([2] * n), c)
    perm = [0, 1, n + 2]
    for k in range(n):
        perm += [2 + k, n + 3 + k]
    perm += [2 * n + 3]
    return _permute(bits, perm).reshape(b, h // f, w // f, f * f * c)


def depth_to_space_n(y, n: int):
    """Inverse of ``space_to_depth_n`` (n nested ``depth_to_space_2x``)."""
    if n == 0:
        return y
    b, h, w, c4 = y.shape
    f = 1 << n
    c = c4 // (f * f)
    bits = y.reshape(b, h, w, *([2, 2] * n), c)
    perm = [0, 1] + [3 + 2 * k for k in range(n)] + [2]
    perm += [4 + 2 * k for k in range(n)] + [3 + 2 * n]
    return _permute(bits, perm).reshape(b, h * f, w * f, c)


def lift_once(w: torch.Tensor, pad_lo: int) -> Tuple[torch.Tensor, int]:
    """A same-size stride-1 KxK conv on grid 2G as a conv on grid G whose
    input and output gain one 2x2 packing level: (K', K', 4C_in, 4C_out)
    and its pad_lo' (K3 pad 1, K2 pad 0 and K2 pad 1 map to themselves)."""
    k = w.shape[0]
    dus = sorted({(u - pad_lo - a + ap) // 2
                  for a in (0, 1) for ap in (0, 1) for u in range(k)
                  if (u - pad_lo - a + ap) % 2 == 0})
    zero = torch.zeros_like(w[0, 0])
    rows = []
    for du in dus:
        cols = []
        for dv in dus:
            in_blocks = []
            for a in (0, 1):
                for b in (0, 1):
                    out_blocks = []
                    for ap in (0, 1):
                        for bp in (0, 1):
                            u = 2 * du + pad_lo + a - ap
                            v = 2 * dv + pad_lo + b - bp
                            out_blocks.append(w[u, v] if 0 <= u < k and 0 <= v < k else zero)
                    in_blocks.append(torch.cat(out_blocks, dim=-1))
            cols.append(torch.cat(in_blocks, dim=0))
        rows.append(torch.stack(cols))
    return torch.stack(rows), -dus[0]


def consume_once(w: torch.Tensor, pad_lo: int) -> Tuple[torch.Tensor, int]:
    """A stride-2 KxK conv (grid 2G -> G) as a same-size stride-1 conv on
    grid G that consumes one packing level of its input: (K', K', 4C_in,
    C_out) and its pad_lo'."""
    k = w.shape[0]
    dus = sorted({(u - pad_lo - phi) // 2 for phi in (0, 1) for u in range(k)
                  if (u - pad_lo - phi) % 2 == 0})
    zero = torch.zeros_like(w[0, 0])
    rows = []
    for du in dus:
        cols = []
        for dv in dus:
            in_blocks = []
            for phi in (0, 1):
                for psi in (0, 1):
                    u, v = 2 * du + pad_lo + phi, 2 * dv + pad_lo + psi
                    in_blocks.append(w[u, v] if 0 <= u < k and 0 <= v < k else zero)
            cols.append(torch.cat(in_blocks, dim=0))
        rows.append(torch.stack(cols))
    return torch.stack(rows), -dus[0]


def same_conv(x: torch.Tensor, w: torch.Tensor, pad_lo: int) -> torch.Tensor:
    """Same-size NHWC conv, HWIO kernel, zero pad (pad_lo, K-1-pad_lo) on
    both axes (plain PyTorch: ``F.conv2d``)."""
    k = w.shape[0]
    hi = k - 1 - pad_lo
    xp = F.pad(x, (0, 0, pad_lo, hi, pad_lo, hi))
    y = F.conv2d(xp.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _tap_index(recipe: str, k: int, levels: int,
               device: torch.device = torch.device("cpu")) -> Tuple[torch.Tensor, int]:
    """Where each block of a lifted kernel comes from: (K', K', P_in, P_out)
    int64, 0 for a structural zero and 1 + u*K + v for the base tap (u, v),
    and the lifted pad_lo. Built by running the lifting functions on a
    (K, K, 1, 1) kernel of tap numbers, so it follows them exactly.

    recipe: "conv" (a pad-1 conv lifted ``levels`` times), "stem" (a stride-2
    pad-1 conv consuming one level, then lifted ``levels - 1`` times) or
    "convT" (``phase_kernel_2x``, then lifted ``levels`` times). Cached per
    ``device`` and built outside inference mode, so an index first made while
    serving (``torch.inference_mode``) still serves a later backward."""
    with torch.inference_mode(False):
        taps = torch.arange(1, k * k + 1, dtype=torch.float64).view(k, k, 1, 1)
        if recipe == "conv":
            pk, pl, lifts = taps, 1, levels
        elif recipe == "stem":
            (pk, pl), lifts = consume_once(taps, 1), levels - 1
        elif recipe == "convT":
            pk, pl, lifts = phase_kernel_2x(taps), 0, levels
        else:
            raise ValueError(f"unknown recipe {recipe!r}")
        for _ in range(lifts):
            pk, pl = lift_once(pk, pl)
        return pk.round().long().to(device), pl


def lifted_kernel(w: torch.Tensor, recipe: str, levels: int) -> Tuple[torch.Tensor, int]:
    """The lifted HWIO kernel of ``_tap_index(recipe, K, levels)`` gathered
    from ``w`` (K, K, C_in, C_out) in one differentiable ``index_select``,
    and its pad_lo. Equal to the chain of lifting functions on ``w``."""
    idx, pl = _tap_index(recipe, w.shape[0], levels, w.device)
    k, _, ci, co = w.shape
    kk, _, pi, po = idx.shape
    flat = torch.cat([w.new_zeros(1, ci, co), w.reshape(k * k, ci, co)])
    g = flat.index_select(0, idx.view(-1))
    return g.view(kk, kk, pi, po, ci, co).permute(0, 1, 2, 4, 3, 5).reshape(
        kk, kk, pi * ci, po * co), pl


def _apply(x, pk, pl, bias_t, prologue=None, use_pallas=False):
    """The lifted conv: through the stage op with a prologue (mul, add,
    slope) or ``use_pallas``, else plain ``same_conv`` plus bias."""
    if prologue is not None:
        mul, add, slope = prologue
        return affine_act_conv(x, mul, add, pk, bias_t, slope=slope, pad_lo=pl)
    if use_pallas:
        return affine_act_conv(x, None, None, pk, bias_t, pad_lo=pl)
    return same_conv(x, pk, pl) + bias_t.to(x.dtype)


class LiftableStemConv(nn.Conv2d):
    """Stride-2, pad-1 KxK conv (torch Conv2d(k, stride=2, padding=1))."""

    def __init__(self, in_channels: int, features: int, ksize: int = 3):
        super().__init__(in_channels, features, ksize, stride=2, padding=1)

    def nhwc(self, x: torch.Tensor, in_levels: int = 0,
             prologue: Optional[tuple] = None) -> torch.Tensor:
        """The JAX call: ``x`` NHWC packed ``in_levels`` times; the conv
        consumes one level and carries ``in_levels - 1`` to its output.
        ``prologue`` (mul, add, slope) folds a preceding BatchNorm affine and
        LeakyReLU into the conv (lifted form only)."""
        if in_levels == 0:
            assert prologue is None, "prologue fusion needs the lifted form"
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        pk, pl = lifted_kernel(self.weight.permute(2, 3, 1, 0), "stem", in_levels)
        return _apply(x, pk, pl, self.bias.repeat(4 ** (in_levels - 1)), prologue)


class PhaseableConv3x3(nn.Conv2d):
    """Pad-1 3x3 conv."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(in_channels, features, 3, padding=1)

    def nhwc(self, x: torch.Tensor, levels: int = 0,
             prologue: Optional[tuple] = None) -> torch.Tensor:
        """The JAX call: ``x`` NHWC packed ``levels`` times on input and
        output; ``prologue`` (mul, add, slope) as in ``LiftableStemConv``."""
        w = self.weight.permute(2, 3, 1, 0)
        if levels:
            pk, pl = lifted_kernel(w, "conv", levels)
            bias_t = self.bias.repeat(4 ** levels)
        else:
            pk, pl, bias_t = w, 1, self.bias
        return _apply(x, pk, pl, bias_t, prologue)


class SubpixelConvTranspose2x(nn.ConvTranspose2d):
    """torch ConvTranspose2d(3, stride=2, padding=1, output_padding=1): 2x
    upsampling, the ViT decoder's stage op."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(in_channels, features, 3, stride=2, padding=1,
                         output_padding=1)

    def nhwc(self, x: torch.Tensor, phase_output: bool = False,
             in_levels: int = 0, use_pallas: bool = False) -> torch.Tensor:
        """The JAX call: a 2x2 conv on ``x`` (NHWC, packed ``in_levels``
        times) whose output gains one packing level (``phase_output``) or is
        unpacked by ``depth_to_space_2x`` (only at ``in_levels`` 0).
        ``use_pallas`` (the JAX argument's name) routes the conv through the
        stage op, without a prologue."""
        # (C_in, C_out, 3, 3) -> (3, 3, C_in, C_out): the blocks
        # phase_kernel_2x takes from the JAX (3, 3, C_out, C_in) kernel
        pk, pl = lifted_kernel(self.weight.permute(2, 3, 0, 1), "convT", in_levels)
        y = _apply(x, pk, pl, self.bias.repeat(4 ** (in_levels + 1)),
                   use_pallas=use_pallas)
        if phase_output:
            return y
        assert in_levels == 0, "unpacked output only supported at in_levels=0"
        return depth_to_space_2x(y)

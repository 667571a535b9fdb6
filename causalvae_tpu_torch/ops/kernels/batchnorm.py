"""BatchNorm with the JAX package's parameter names and math: eval and train.

Counterpart of ``causalvae_tpu/ops/kernels/batchnorm.py``: ``BatchNorm`` and
``bn_train``. Parameters ``scale``/``bias`` and buffers ``mean``/``var``,
where ``var`` is the biased running variance, stored as the JAX package
stores it (torch's own ``BatchNorm*d`` keeps the unbiased one).

Eval: ``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32, plain
elementwise, cast back to the input dtype.

Train (``bn_train``, a ``torch.autograd.Function``): the per-channel sums go
through the CUDA kernels of ``csrc/bn_reduce.cu`` over the tensor seen as
(N, C, S), S = H*W (or 1 for (B, C)):

- forward: ``bn_stats`` gives Σx and Σx² (replaces ``_sum_sq_kernel``); then,
  in plain torch, mean = Σx/n, var = max(Σx²/n − mean², 0) (the JAX fast
  variance, f32), inv = rsqrt(var + eps), y = (x − mean)·(inv·scale) + bias;
- backward: ``bn_bwd_sums`` gives Σdy and Σdy·x̂ (replaces
  ``_dy_dyxhat_kernel``); dscale = Σdy·x̂, dbias = Σdy and
  dx = scale·inv·(dy − Σdy/n − x̂·Σdy·x̂/n) in plain torch.

The TPU took the kernels only for 4-D tensors whose C divides 128 (its lane
width); here every train-mode BatchNorm of a CUDA tensor goes through them.
The module updates its running statistics without gradient as flax does:
``ra = 0.9·ra + 0.1·batch``, with the biased batch variance.

The phase-packed model calls ``BatchNorm.nhwc`` (the JAX ``__call__``'s
``groups`` and ``emit_affine``) on NHWC tensors. Their sums go through the
kernels' channels-last entries (``bn_stats_rows``, ``bn_bwd_sums_rows``) over
the tensor seen as (M, C) rows, read in place. With ``groups`` the channel
axis holds ``groups`` phase blocks of the same C real channels (packed index
``phase·C + c``): the per-packed-channel sums fold over the blocks, and the
per-real-channel vectors repeat ``groups`` times. ``emit_affine`` returns
the per-real-channel ``(mul, add)`` with ``x·mul + add`` the normalized
tensor, for the next conv's prologue (``ops/kernels/stage.py``); its batch
statistics stay differentiable (``batch_stats_nhwc``, an autograd Function
whose backward is elementwise: dx = dmean/n + dvar·2(x − mean)/n), so the
gradient reaching (mul, add) flows back to x as the JAX package's jnp
statistics let it.

The sum wrappers run the kernel for CUDA tensors and the plain version for
CPU tensors only; there is no fallback from one to the other.
``STATS_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches (both
layouts).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import nn

STATS_LAUNCHES = 0  # bn_stats kernel launches since import (or a reset)
BWD_LAUNCHES = 0    # bn_bwd kernel launches since import (or a reset)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 4096        # elements of one (n, c) row per block (csrc/bn_reduce.cu)
_ROWS = 256          # rows of one chunk in the channels-last entries
_MAX_SLABS = 65535


def _as_ncs(x: torch.Tensor) -> torch.Tensor:
    """(B, C) or (B, C, H, W) -> contiguous (N, C, S) view."""
    if x.dim() not in (2, 4):
        raise ValueError(f"BatchNorm takes (B, C) or (B, C, H, W), got {tuple(x.shape)}")
    return x.contiguous().view(x.shape[0], x.shape[1], -1)


def bn_stats_reference(x3: torch.Tensor) -> torch.Tensor:
    """(N, C, S) -> (2, C) float32: per-channel Σx and Σx²."""
    xf = x3.float()
    return torch.stack([xf.sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2))])


def bn_bwd_reference(dy3: torch.Tensor, x3: torch.Tensor, mean: torch.Tensor,
                     inv: torch.Tensor) -> torch.Tensor:
    """(N, C, S) dy and x, (C,) mean and inv -> (2, C) float32: Σdy and
    Σdy·(x − mean)·inv per channel."""
    dyf = dy3.float()
    xhat = (x3.float() - mean.view(1, -1, 1)) * inv.view(1, -1, 1)
    return torch.stack([dyf.sum(dim=(0, 2)), (dyf * xhat).sum(dim=(0, 2))])


def _launch(name: str, x: torch.Tensor, inputs) -> torch.Tensor:
    """Run ``csrc/bn_reduce.cu``'s ``name`` (bn_stats/bn_stats_rows: inputs
    [x]; bn_bwd/bn_bwd_rows: [dy, x, mean, inv]) on x, (N, C, S) or, for the
    ``_rows`` entries, (M, C); returns the (2, C) sums."""
    from causalvae_tpu_torch.ops.kernels import _build

    if x.dtype not in _DTYPES:
        raise TypeError(f"bn kernels take float32 or bfloat16, got {x.dtype}")
    if any(t.device != x.device or not t.is_contiguous() for t in inputs):
        raise ValueError(f"{name}: inputs must be contiguous, on {x.device}")
    dims = tuple(x.shape)
    c = dims[1]
    slabs = (-(-dims[0] // _ROWS) if name.endswith("_rows")
             else dims[0] * -(-dims[2] // _CHUNK))
    if slabs > _MAX_SLABS:
        raise ValueError(f"{name}: shape {dims} needs {slabs} slabs > {_MAX_SLABS}")
    fn = getattr(_build.load("bn_reduce"), name)
    fn.argtypes = ([ctypes.c_void_p] * len(inputs) + [ctypes.c_int] * (len(dims) + 1)
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        partials = torch.empty(2 * c * slabs, dtype=torch.float32, device=x.device)
        out = torch.empty((2, c), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in inputs), *dims, _DTYPES[x.dtype],
                 partials.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def bn_stats(x3: torch.Tensor) -> torch.Tensor:
    """(N, C, S) -> (2, C) float32 [Σx, Σx²]: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    global STATS_LAUNCHES
    if x3.device.type == "cuda":
        x3 = x3.contiguous()
        out = _launch("bn_stats", x3, [x3])
        STATS_LAUNCHES += 1
        return out
    if x3.device.type == "cpu":
        return bn_stats_reference(x3)
    raise ValueError(f"unsupported device {x3.device}")


def bn_bwd_sums(dy3: torch.Tensor, x3: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor) -> torch.Tensor:
    """(2, C) float32 [Σdy, Σdy·x̂]: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global BWD_LAUNCHES
    if dy3.shape != x3.shape or dy3.dtype != x3.dtype:
        raise ValueError(f"dy {tuple(dy3.shape)} {dy3.dtype} and x "
                         f"{tuple(x3.shape)} {x3.dtype} differ")
    if x3.device.type == "cuda":
        x3 = x3.contiguous()
        out = _launch("bn_bwd", x3, [dy3.contiguous(), x3, mean.float().contiguous(),
                                     inv.float().contiguous()])
        BWD_LAUNCHES += 1
        return out
    if x3.device.type == "cpu":
        return bn_bwd_reference(dy3, x3, mean, inv)
    raise ValueError(f"unsupported device {x3.device}")


def bn_stats_rows(x2: torch.Tensor) -> torch.Tensor:
    """Channels-last (M, C) -> (2, C) float32 [Σx, Σx²]: the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    global STATS_LAUNCHES
    if x2.device.type == "cuda":
        x2 = x2.contiguous()
        out = _launch("bn_stats_rows", x2, [x2])
        STATS_LAUNCHES += 1
        return out
    if x2.device.type == "cpu":
        return bn_stats_reference(x2.t().unsqueeze(0))
    raise ValueError(f"unsupported device {x2.device}")


def bn_bwd_sums_rows(dy2: torch.Tensor, x2: torch.Tensor, mean: torch.Tensor,
                     inv: torch.Tensor) -> torch.Tensor:
    """Channels-last (M, C): (2, C) float32 [Σdy, Σdy·x̂], the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    global BWD_LAUNCHES
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype:
        raise ValueError(f"dy {tuple(dy2.shape)} {dy2.dtype} and x "
                         f"{tuple(x2.shape)} {x2.dtype} differ")
    if x2.device.type == "cuda":
        out = _launch("bn_bwd_rows", x2, [dy2.contiguous(), x2.contiguous(),
                                          mean.float().contiguous(),
                                          inv.float().contiguous()])
        BWD_LAUNCHES += 1
        return out
    if x2.device.type == "cpu":
        return bn_bwd_reference(dy2.t().unsqueeze(0), x2.t().unsqueeze(0), mean, inv)
    raise ValueError(f"unsupported device {x2.device}")


def _fold(v: torch.Tensor, groups: int) -> torch.Tensor:
    """(..., groups·C) per packed channel -> (..., C) per real channel."""
    return v.reshape(*v.shape[:-1], groups, -1).sum(-2)


def _grouped_stats(x: torch.Tensor, groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 batch (mean, biased var) per real channel of an NHWC tensor with
    ``groups`` phase blocks, through ``bn_stats_rows``."""
    c = x.shape[-1] // groups
    n = x.numel() // c
    s = _fold(bn_stats_rows(x.reshape(-1, x.shape[-1])), groups)
    mean = s[0] / n
    return mean, torch.clamp(s[1] / n - mean * mean, min=0.0)


class _BatchStats(torch.autograd.Function):
    """Differentiable (mean, biased var) of ``_grouped_stats``; the backward
    is elementwise, dx = dmean/n + dvar·2(x − mean)/n repeated over the
    groups (the terms of JAX ``_bn_train_bwd``), centred before it is
    scaled so that a large mean does not cancel it away."""

    @staticmethod
    def forward(ctx, x, groups):
        mean, var = _grouped_stats(x, groups)
        ctx.save_for_backward(x, mean)
        ctx.groups = groups
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        x, mean = ctx.saved_tensors
        g = ctx.groups
        n = x.numel() // mean.numel()
        dx = (dmean / n).repeat(g) + (2.0 / n) * dvar.repeat(g) * (x.float() - mean.repeat(g))
        return dx.to(x.dtype), None


def batch_stats_nhwc(x: torch.Tensor, groups: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable f32 batch (mean, biased var) per real channel of an
    NHWC tensor with ``groups`` phase blocks (JAX ``_stats``)."""
    return _BatchStats.apply(x, groups)


class _BNTrainRows(torch.autograd.Function):
    """Train-mode BatchNorm of an NHWC tensor with ``groups`` phase blocks
    (JAX ``bn_train`` with ``groups``): statistics per real channel."""

    @staticmethod
    def forward(ctx, x, scale, bias, epsilon, groups):
        mean, var = _grouped_stats(x, groups)
        inv = torch.rsqrt(var + epsilon)
        mul = (inv * scale.float()).repeat(groups)
        y = ((x.float() - mean.repeat(groups)) * mul
             + bias.float().repeat(groups)).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.groups = groups
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, inv = ctx.saved_tensors
        g = ctx.groups
        n = x.numel() // mean.numel()
        mean_t, inv_t = mean.repeat(g), inv.repeat(g)
        s1, s2 = _fold(bn_bwd_sums_rows(dy.to(x.dtype).reshape(-1, x.shape[-1]),
                                        x.reshape(-1, x.shape[-1]), mean_t, inv_t), g)
        xhat = (x.float() - mean_t) * inv_t
        dx = (scale.float() * inv).repeat(g) * (dy.float() - (s1 / n).repeat(g)
                                                - xhat * (s2 / n).repeat(g))
        return dx.to(x.dtype), s2.to(scale.dtype), s1.to(scale.dtype), None, None


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, epsilon):
        x3 = _as_ncs(x)
        n = x3.shape[0] * x3.shape[2]
        sums = bn_stats(x3)
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + epsilon)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = inv * scale.float()
        y = ((x.float() - mean.view(shape)) * mul.view(shape)
             + bias.float().view(shape)).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, inv = ctx.saved_tensors
        x3 = _as_ncs(x)
        n = x3.shape[0] * x3.shape[2]
        s1, s2 = bn_bwd_sums(_as_ncs(dy.to(x.dtype)), x3, mean, inv)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xhat = (x.float() - mean.view(shape)) * inv.view(shape)
        dx = ((scale.float() * inv).view(shape)
              * (dy.float() - (s1 / n).view(shape) - xhat * (s2 / n).view(shape)))
        return dx.to(x.dtype), s2.to(scale.dtype), s1.to(scale.dtype), None


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             epsilon: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training BatchNorm over dim 1 of (B, C) or (B, C, H, W): (y, mean,
    var), mean and var the f32 batch statistics (biased var)."""
    return _BNTrain.apply(x, scale, bias, epsilon)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of (B, C) or (B, C, H, W) inputs; momentum 0.9
    in flax's sense (0.1 in torch's)."""

    def __init__(self, num_features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y, mean, var = bn_train(x, self.scale, self.bias, self.epsilon)
            self._update(mean, var)
            return y
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.var.float() + self.epsilon) * self.scale.float()
        y = (x.float() - self.mean.float().view(shape)) * mul.view(shape) \
            + self.bias.float().view(shape)
        return y.to(x.dtype)

    def _update(self, mean: torch.Tensor, var: torch.Tensor):
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean.detach())
            self.var.copy_(m * self.var + (1.0 - m) * var.detach())

    def nhwc(self, x: torch.Tensor, groups: int = 1, emit_affine: bool = False):
        """The JAX call on an NHWC tensor whose channel axis holds ``groups``
        phase blocks of the real channels: train mode (``self.training``)
        normalizes by the batch statistics and updates the running ones,
        eval mode by the running ones. ``emit_affine`` returns the
        per-real-channel ``(mul, add)`` (float32) instead of the normalized
        tensor, differentiable through the batch statistics."""
        if emit_affine:
            if self.training:
                mean, var = batch_stats_nhwc(x, groups)
                self._update(mean, var)
            else:
                mean, var = self.mean.float(), self.var.float()
            mul = torch.rsqrt(var + self.epsilon) * self.scale.float()
            return mul, self.bias.float() - mean * mul
        if self.training:
            y, mean, var = _BNTrainRows.apply(x, self.scale, self.bias, self.epsilon,
                                              groups)
            self._update(mean, var)
            return y
        mul = torch.rsqrt(self.var.float() + self.epsilon) * self.scale.float()
        y = ((x.float() - self.mean.float().repeat(groups)) * mul.repeat(groups)
             + self.bias.float().repeat(groups))
        return y.to(x.dtype)

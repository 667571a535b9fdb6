"""BatchNorm with the JAX package's parameter names and math: eval and train.

Counterpart of ``causalvae_tpu/ops/kernels/batchnorm.py``: ``BatchNorm`` and
``bn_train``. Parameters ``scale``/``bias`` and buffers ``mean``/``var``,
where ``var`` is the biased running variance, stored as the JAX package
stores it (torch's own ``BatchNorm*d`` keeps the unbiased one).

Eval: ``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32, plain
elementwise, cast to the module's ``dtype`` (float32 unless the model
computes in bfloat16; train mode casts ``bn_train``'s y the same way).

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

The sum wrappers call the operators ``cvae::bn_stats``, ``bn_bwd_sums``,
``bn_stats_rows`` and ``bn_bwd_sums_rows`` (``registry.py``), which run the
kernel for CUDA tensors and the plain version for CPU tensors only; there
is no fallback from one to the other. Eval mode reads the running
statistics in plain elementwise code and updates nothing, so it traces
(``torch.export``) as it runs.
``STATS_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches (both
layouts), ``STATS_LAUNCHES_BF16`` and ``BWD_LAUNCHES_BF16`` those of them
on bfloat16 tensors.

Inside a data-parallel step over the whole batch (``parallel/mesh.py
global_batch``) the statistics are the whole batch's: the forward sums
(Σx, Σx² and the count) are summed over the ranks between the kernel and
the normalisation, the backward's (Σdy, Σdy·x̂; for ``batch_stats_nhwc``,
the gradients of the mean and variance) before dx, so dx is the whole
batch's; dscale and dbias stay this rank's part, which the step's gradient
all-reduce adds up. The running statistics are then updated from the same
global statistics on every rank.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import nn

from causalvae_tpu_torch.ops.kernels import registry
from causalvae_tpu_torch.parallel.mesh import all_reduce_sum, current_global_batch

STATS_LAUNCHES = 0  # bn_stats kernel launches since import (or a reset)
BWD_LAUNCHES = 0    # bn_bwd kernel launches since import (or a reset)
STATS_LAUNCHES_BF16 = 0  # of STATS_LAUNCHES, those on a bfloat16 x
BWD_LAUNCHES_BF16 = 0    # of BWD_LAUNCHES, those on bfloat16 dy and x

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


def _count_stats(x: torch.Tensor):
    global STATS_LAUNCHES, STATS_LAUNCHES_BF16
    STATS_LAUNCHES += 1
    STATS_LAUNCHES_BF16 += x.dtype == torch.bfloat16


def _count_bwd(x: torch.Tensor):
    global BWD_LAUNCHES, BWD_LAUNCHES_BF16
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BF16 += x.dtype == torch.bfloat16


def _stats_cuda(name: str):
    """The CUDA implementation of ``bn_stats`` (``name``) or ``bn_stats_rows``."""
    def launch(x):
        x = x.contiguous()
        out = _launch(name, x, [x])
        _count_stats(x)
        return out
    return launch


def _bwd_cuda(name: str):
    """The CUDA implementation of ``bn_bwd_sums`` (kernel ``name``) or
    ``bn_bwd_sums_rows``."""
    def launch(dy, x, mean, inv):
        x = x.contiguous()
        out = _launch(name, x, [dy.contiguous(), x, mean.float().contiguous(),
                                inv.float().contiguous()])
        _count_bwd(x)
        return out
    return launch


def _stats_fake(x):
    return torch.empty((2, x.shape[1]), dtype=torch.float32, device=x.device)


def _bwd_fake(dy, x, mean, inv):
    return _stats_fake(x)


_STATS_OP = registry.define("bn_stats(Tensor x) -> Tensor", cpu=bn_stats_reference,
                            cuda=_stats_cuda("bn_stats"), fake=_stats_fake)
_BWD_OP = registry.define(
    "bn_bwd_sums(Tensor dy, Tensor x, Tensor mean, Tensor inv) -> Tensor",
    cpu=bn_bwd_reference, cuda=_bwd_cuda("bn_bwd"), fake=_bwd_fake)
_STATS_ROWS_OP = registry.define(
    "bn_stats_rows(Tensor x) -> Tensor",
    cpu=lambda x: bn_stats_reference(x.t().unsqueeze(0)),
    cuda=_stats_cuda("bn_stats_rows"), fake=_stats_fake)
_BWD_ROWS_OP = registry.define(
    "bn_bwd_sums_rows(Tensor dy, Tensor x, Tensor mean, Tensor inv) -> Tensor",
    cpu=lambda dy, x, mean, inv: bn_bwd_reference(dy.t().unsqueeze(0),
                                                  x.t().unsqueeze(0), mean, inv),
    cuda=_bwd_cuda("bn_bwd_rows"), fake=_bwd_fake)


def _check_bwd(dy: torch.Tensor, x: torch.Tensor):
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} and x "
                         f"{tuple(x.shape)} {x.dtype} differ")
    registry.check_device(x)


def bn_stats(x3: torch.Tensor) -> torch.Tensor:
    """(N, C, S) -> (2, C) float32 [Σx, Σx²] through ``cvae::bn_stats``:
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    registry.check_device(x3)
    return _STATS_OP(x3)


def bn_bwd_sums(dy3: torch.Tensor, x3: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor) -> torch.Tensor:
    """(2, C) float32 [Σdy, Σdy·x̂] through ``cvae::bn_bwd_sums``: the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    _check_bwd(dy3, x3)
    return _BWD_OP(dy3, x3, mean, inv)


def bn_stats_rows(x2: torch.Tensor) -> torch.Tensor:
    """Channels-last (M, C) -> (2, C) float32 [Σx, Σx²] through
    ``cvae::bn_stats_rows``: the kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    registry.check_device(x2)
    return _STATS_ROWS_OP(x2)


def bn_bwd_sums_rows(dy2: torch.Tensor, x2: torch.Tensor, mean: torch.Tensor,
                     inv: torch.Tensor) -> torch.Tensor:
    """Channels-last (M, C): (2, C) float32 [Σdy, Σdy·x̂] through
    ``cvae::bn_bwd_sums_rows``: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check_bwd(dy2, x2)
    return _BWD_ROWS_OP(dy2, x2, mean, inv)


def _fold(v: torch.Tensor, groups: int) -> torch.Tensor:
    """(..., groups·C) per packed channel -> (..., C) per real channel."""
    return v.reshape(*v.shape[:-1], groups, -1).sum(-2)


def _global_sums(sums: torch.Tensor, n: int):
    """(sums, count) of this rank, or, inside a ``global_batch`` block,
    both summed over its ranks in one all-reduce (the count as a float32
    0-d tensor)."""
    gb = current_global_batch()
    if gb is None:
        return sums, n
    buf = torch.cat([sums.reshape(-1), sums.new_full((1,), float(n))])
    all_reduce_sum(buf, gb.mesh)
    return buf[:-1].view_as(sums), buf[-1]


def _grouped_stats(x: torch.Tensor, groups: int):
    """f32 batch (mean, biased var) per real channel of an NHWC tensor with
    ``groups`` phase blocks, through ``bn_stats_rows``, and their count (the
    whole batch's inside a ``global_batch`` block)."""
    c = x.shape[-1] // groups
    s, n = _global_sums(_fold(bn_stats_rows(x.reshape(-1, x.shape[-1])), groups),
                        x.numel() // c)
    mean = s[0] / n
    return mean, torch.clamp(s[1] / n - mean * mean, min=0.0), n


class _BatchStats(torch.autograd.Function):
    """Differentiable (mean, biased var) of ``_grouped_stats``; the backward
    is elementwise, dx = dmean/n + dvar·2(x − mean)/n repeated over the
    groups (the terms of JAX ``_bn_train_bwd``), centred before it is
    scaled so that a large mean does not cancel it away."""

    @staticmethod
    def forward(ctx, x, groups):
        mean, var, n = _grouped_stats(x, groups)
        ctx.save_for_backward(x, mean)
        ctx.groups, ctx.n, ctx.gb = groups, n, current_global_batch()
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        x, mean = ctx.saved_tensors
        g, n = ctx.groups, ctx.n
        if ctx.gb is not None:
            both = all_reduce_sum(torch.cat([dmean.float(), dvar.float()]), ctx.gb.mesh)
            dmean, dvar = both.chunk(2)
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
        mean, var, n = _grouped_stats(x, groups)
        inv = torch.rsqrt(var + epsilon)
        mul = (inv * scale.float()).repeat(groups)
        y = ((x.float() - mean.repeat(groups)) * mul
             + bias.float().repeat(groups)).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.groups, ctx.n, ctx.gb = groups, n, current_global_batch()
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, inv = ctx.saved_tensors
        g, n = ctx.groups, ctx.n
        mean_t, inv_t = mean.repeat(g), inv.repeat(g)
        local = _fold(bn_bwd_sums_rows(dy.to(x.dtype).reshape(-1, x.shape[-1]),
                                       x.reshape(-1, x.shape[-1]), mean_t, inv_t), g)
        s1, s2 = _bwd_sums_global(local, ctx.gb)
        xhat = (x.float() - mean_t) * inv_t
        dx = (scale.float() * inv).repeat(g) * (dy.float() - (s1 / n).repeat(g)
                                                - xhat * (s2 / n).repeat(g))
        return dx.to(x.dtype), local[1].to(scale.dtype), local[0].to(scale.dtype), None, None


def _bwd_sums_global(local: torch.Tensor, gb) -> torch.Tensor:
    """The (2, C) [Σdy, Σdy·x̂] for dx: this rank's, or summed over the ranks
    of ``gb`` (a copy: the parameters' gradients keep this rank's part)."""
    if gb is None:
        return local
    return all_reduce_sum(local.clone(), gb.mesh)


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, epsilon):
        x3 = _as_ncs(x)
        sums, n = _global_sums(bn_stats(x3), x3.shape[0] * x3.shape[2])
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + epsilon)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = inv * scale.float()
        y = ((x.float() - mean.view(shape)) * mul.view(shape)
             + bias.float().view(shape)).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.n, ctx.gb = n, current_global_batch()
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, inv = ctx.saved_tensors
        x3 = _as_ncs(x)
        n = ctx.n
        local = bn_bwd_sums(_as_ncs(dy.to(x.dtype)), x3, mean, inv)
        s1, s2 = _bwd_sums_global(local, ctx.gb)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xhat = (x.float() - mean.view(shape)) * inv.view(shape)
        dx = ((scale.float() * inv).view(shape)
              * (dy.float() - (s1 / n).view(shape) - xhat * (s2 / n).view(shape)))
        return dx.to(x.dtype), local[1].to(scale.dtype), local[0].to(scale.dtype), None


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             epsilon: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training BatchNorm over dim 1 of (B, C) or (B, C, H, W): (y, mean,
    var), mean and var the f32 batch statistics (biased var)."""
    return _BNTrain.apply(x, scale, bias, epsilon)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of (B, C) or (B, C, H, W) inputs; momentum 0.9
    in flax's sense (0.1 in torch's). Statistics and the affine in float32,
    the result cast to ``dtype`` (the JAX module's ``dtype``, not the
    input's); parameters and running statistics stay float32."""

    def __init__(self, num_features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y, mean, var = bn_train(x, self.scale, self.bias, self.epsilon)
            self._update(mean, var)
            return y.to(self.dtype)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.var.float() + self.epsilon) * self.scale.float()
        y = (x.float() - self.mean.float().view(shape)) * mul.view(shape) \
            + self.bias.float().view(shape)
        return y.to(self.dtype)

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
            return y.to(self.dtype)
        mul = torch.rsqrt(self.var.float() + self.epsilon) * self.scale.float()
        y = ((x.float() - self.mean.float().repeat(groups)) * mul.repeat(groups)
             + self.bias.float().repeat(groups))
        return y.to(self.dtype)

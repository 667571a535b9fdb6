"""Fused BatchNorm-apply + LeakyReLU + KxK conv stage: CUDA kernels + plain version.

Counterpart of ``causalvae_tpu/ops/kernels/stage.py``::

    y = conv_same_KxK(leaky_relu(x * mul + add, slope)) + bias

x NHWC (B, H, W, Ci); kernel HWIO (K, K, Ci, Co), already lifted by the
caller (``ops/subpixel.py``); zero padding (pad_lo, K-1-pad_lo) on both axes,
applied AFTER the activation (an out-of-image tap adds 0, not
leaky(add)); mul/add (Ci,) and bias (Co,) float32. Without a prologue
(``mul`` and ``add`` None) the conv reads x as it is.

- ``stage_fwd`` runs ``csrc/stage_fwd.cu`` (replaces ``_stage_kernel``): an
  implicit GEMM that applies the affine and the activation as it stages its
  input tile, f32 accumulation, bias in the epilogue, output in x's dtype.
- ``stage_bwd`` runs ``csrc/stage_bwd.cu`` (replaces ``_stage_bwd_kernel``):
  dx, dW (f32), db, dmul and dadd, by a dgrad kernel, a split-K wgrad
  kernel that recomputes the activation, and fixed-order folds.
- ``affine_act_conv`` is the differentiable op (``_StageFn``); its backward
  returns (dx, dmul, dadd, dW, db) from ``stage_bwd``.

The TPU took its kernels only where its gates admitted them (bf16, C % 128,
VMEM budgets): those were measurements of the TPU. Here every
``affine_act_conv`` on a CUDA tensor launches the kernels, in float32 or
bfloat16 (bf16: the activation rounds to bf16 before the conv, as the JAX
reference casts it; sums stay f32). CPU tensors take the plain versions,
``stage_reference`` and ``stage_bwd_reference`` (its autograd backward);
there is no fallback from one to the other. ``FWD_LAUNCHES`` and
``BWD_LAUNCHES`` count wrapper calls that launched the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

FWD_LAUNCHES = 0  # stage forward kernel launches since import (or a reset)
BWD_LAUNCHES = 0  # stage backward launches (one per wrapper call)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def stage_reference(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
                    kernel: torch.Tensor, bias: torch.Tensor, slope: float,
                    pad_lo: int, has_prologue: bool = True) -> torch.Tensor:
    """Plain PyTorch: the activation in f32 cast to x's dtype, then
    ``same_conv`` (``F.conv2d``) plus bias (the JAX ``_ref_fwd``)."""
    from causalvae_tpu_torch.ops.subpixel import same_conv

    if has_prologue:
        pre = x.float() * mul.float() + add.float()
        a = torch.where(pre >= 0.0, pre, slope * pre).to(x.dtype)
    else:
        a = x
    y = same_conv(a, kernel.to(a.dtype), pad_lo)
    return y + bias.to(y.dtype)


def stage_bwd_reference(x, dy, mul, add, kernel, slope: float, pad_lo: int,
                        has_prologue: bool = True):
    """(dx, dW, db, dmul, dadd) of ``stage_reference`` by its autograd
    backward; dmul and dadd are zeros without a prologue."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, mul, add, kernel)]
        bias = torch.zeros(kernel.shape[-1], dtype=torch.float32, device=x.device,
                           requires_grad=True)
        y = stage_reference(*leaves, bias, slope, pad_lo, has_prologue)
        grads = torch.autograd.grad(y, leaves + [bias], dy.to(y.dtype),
                                    allow_unused=True)
    dx, dmul, dadd, dw, db = grads
    if not has_prologue:
        dmul, dadd = torch.zeros_like(mul), torch.zeros_like(add)
    return dx, dw, db, dmul, dadd


def _check(x: torch.Tensor, kernel: torch.Tensor, pad_lo: int):
    if x.dim() != 4 or kernel.dim() != 4 or kernel.shape[0] != kernel.shape[1]:
        raise ValueError(f"x (B, H, W, Ci) and kernel (K, K, Ci, Co), got "
                         f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    if kernel.shape[2] != x.shape[3]:
        raise ValueError(f"kernel Ci {kernel.shape[2]} != x channels {x.shape[3]}")
    if not 0 <= pad_lo < kernel.shape[0]:
        raise ValueError(f"pad_lo {pad_lo} outside [0, {kernel.shape[0]})")
    if x.dtype not in _DTYPES:
        raise TypeError(f"stage kernels take float32 or bfloat16, got {x.dtype}")


def _f32(t: torch.Tensor, device) -> torch.Tensor:
    return t.detach().to(device, torch.float32).contiguous()


def _launch_fwd(x, mul, add, kernel, bias, slope, pad_lo, has_prologue):
    from causalvae_tpu_torch.ops.kernels import _build

    b, h, w, ci = x.shape
    k, co = kernel.shape[0], kernel.shape[3]
    x = x.detach().contiguous()
    wk = kernel.detach().to(x.dtype).contiguous()
    mul, add, bias = (_f32(t, x.device) for t in (mul, add, bias))
    fn = _build.load("stage_fwd").stage_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        y = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), mul.data_ptr(), add.data_ptr(), wk.data_ptr(),
                 bias.data_ptr(), y.data_ptr(), b, h, w, ci, co, k, pad_lo,
                 float(slope), int(has_prologue), _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"stage_fwd kernel launch failed: cudaError {err}")
    return y


def _wgrad_splits(m: int, ci: int, co: int, k: int) -> int:
    """Split-K count of the wgrad kernel: about four blocks per SM of the
    H100's 132, each split at least 1024 pixels (csrc/stage_bwd.cu)."""
    tiles = -(-ci // 128) * -(-co // (64 if co <= 64 else 128)) * k * k
    return max(1, min(-(-4 * 132 // tiles), m // 1024))


def _launch_bwd(x, dy, mul, add, kernel, slope, pad_lo, has_prologue):
    from causalvae_tpu_torch.ops.kernels import _build

    b, h, w, ci = x.shape
    k, co = kernel.shape[0], kernel.shape[3]
    x = x.detach().contiguous()
    dy = dy.detach().to(x.dtype).contiguous()
    wk = kernel.detach().to(x.dtype).contiguous()
    mul, add = (_f32(t, x.device) for t in (mul, add))
    splits = _wgrad_splits(b * h * w, ci, co, k)
    lib = _build.load("stage_bwd")
    size = lib.stage_bwd_scratch_floats
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    fn = lib.stage_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        dev = x.device
        dx = torch.empty_like(x)
        dw = torch.empty((k, k, ci, co), dtype=torch.float32, device=dev)
        db = torch.empty(co, dtype=torch.float32, device=dev)
        dmul = torch.zeros(ci, dtype=torch.float32, device=dev)
        dadd = torch.zeros(ci, dtype=torch.float32, device=dev)
        scratch = torch.empty(size(b * h * w, ci, co, k, splits), dtype=torch.float32,
                              device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), mul.data_ptr(), add.data_ptr(),
                 wk.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
                 dmul.data_ptr(), dadd.data_ptr(), b, h, w, ci, co, k, pad_lo,
                 float(slope), int(has_prologue), _DTYPES[x.dtype], splits,
                 scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"stage_bwd kernel launch failed: cudaError {err}")
    return dx, dw, db, dmul, dadd


def stage_fwd(x, mul, add, kernel, bias, slope: float, pad_lo: int,
              has_prologue: bool = True) -> torch.Tensor:
    """The stage forward: the kernel for a CUDA tensor, ``stage_reference``
    for a CPU tensor."""
    global FWD_LAUNCHES
    _check(x, kernel, pad_lo)
    if x.device.type == "cuda":
        y = _launch_fwd(x, mul, add, kernel, bias, slope, pad_lo, has_prologue)
        FWD_LAUNCHES += 1
        return y
    if x.device.type == "cpu":
        return stage_reference(x, mul, add, kernel, bias, slope, pad_lo, has_prologue)
    raise ValueError(f"unsupported device {x.device}")


def stage_bwd(x, dy, mul, add, kernel, slope: float, pad_lo: int,
              has_prologue: bool = True):
    """(dx, dW, db, dmul, dadd) of the stage: the kernels for CUDA tensors,
    ``stage_bwd_reference`` for CPU tensors. dW, db, dmul, dadd float32."""
    global BWD_LAUNCHES
    _check(x, kernel, pad_lo)
    if dy.shape[:3] != x.shape[:3] or dy.shape[3] != kernel.shape[3]:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x {tuple(x.shape)} "
                         f"and kernel {tuple(kernel.shape)}")
    if x.device.type == "cuda":
        out = _launch_bwd(x, dy, mul, add, kernel, slope, pad_lo, has_prologue)
        BWD_LAUNCHES += 1
        return out
    if x.device.type == "cpu":
        dx, dw, db, dmul, dadd = stage_bwd_reference(x, dy, mul, add, kernel, slope,
                                                     pad_lo, has_prologue)
        return dx, dw.float(), db.float(), dmul.float(), dadd.float()
    raise ValueError(f"unsupported device {x.device}")


class _StageFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mul, add, kernel, bias, slope, pad_lo, has_prologue):
        ctx.save_for_backward(x, mul, add, kernel)
        ctx.cfg = (slope, pad_lo, has_prologue, bias.dtype)
        return stage_fwd(x, mul, add, kernel, bias, slope, pad_lo, has_prologue)

    @staticmethod
    def backward(ctx, dy):
        x, mul, add, kernel = ctx.saved_tensors
        slope, pad_lo, has_prologue, bias_dtype = ctx.cfg
        dx, dw, db, dmul, dadd = stage_bwd(x, dy, mul, add, kernel, slope, pad_lo,
                                           has_prologue)
        if not has_prologue:
            dmul = dadd = None
        else:
            dmul, dadd = dmul.to(mul.dtype), dadd.to(add.dtype)
        return (dx.to(x.dtype), dmul, dadd, dw.to(kernel.dtype), db.to(bias_dtype),
                None, None, None)


def affine_act_conv(x: torch.Tensor, mul: Optional[torch.Tensor],
                    add: Optional[torch.Tensor], kernel: torch.Tensor,
                    bias: torch.Tensor, *, slope: float = 0.01,
                    pad_lo: int = 1) -> torch.Tensor:
    """y = conv_same(leaky_relu(x*mul + add, slope), kernel) + bias,
    differentiable in x, mul, add, kernel and bias.

    x (B, H, W, Ci) NHWC; mul/add (Ci,) per packed channel, or None for
    both (no prologue: the conv reads x itself); kernel (K, K, Ci, Co) the
    lifted kernel; bias (Co,) at packed width."""
    has_prologue = mul is not None
    if not has_prologue:
        ci = x.shape[-1]
        mul = torch.ones(ci, dtype=torch.float32, device=x.device)
        add = torch.zeros(ci, dtype=torch.float32, device=x.device)
    return _StageFn.apply(x, mul, add, kernel, bias, float(slope), int(pad_lo),
                          bool(has_prologue))

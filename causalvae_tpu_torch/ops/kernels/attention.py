"""Multi-head attention for the ViT encoder: CUDA kernels + plain versions.

Counterpart of ``causalvae_tpu/ops/kernels/attention.py``: ``attention_fwd``
replaces ``_fwd_call``/``_fwd_kernel``, ``attention_bwd`` replaces
``_bwd_call``/``_bwd_fused_kernel``, and ``flash_attention`` keeps the JAX
entry point's (B, H, N, D) contract, with attention-probability dropout
(``dropout_rate``, ``dropout_seed``) as a ``torch.autograd.Function`` over
the two kernels.

Dropout follows the JAX kernel: applied after the softmax (the normaliser and
the logsumexp use the undropped probabilities), kept entries scaled by
1/(1 − rate), and the mask is the counter-based hash of ``dropout_keep``:
keep iff mix32(((r·M1) ^ (c·M2) ^ (bh·M3)) + seed) >= uint32(rate·2³²), for
the global query row r, key column c and head bh = b·H + h, in uint32
arithmetic. It is bit-identical to the JAX package's interpret-mode mask
(its TPU hardware generator ``_hw_tile_bits`` is not ported), and the
forward and backward kernels regenerate it from the same coordinates
(``csrc/dropout_hash.cuh``).

The forward kernel (``csrc/attention_fwd.cu``) and the backward kernels
(``csrc/attention_bwd.cu``) are bound by operations at the vessel shape
(BH = 8 * batch, N = 961, D = 32); their designs are explained in the
sources. Both mask keys past N themselves, so nothing is padded.

``attention_fwd``/``attention_bwd`` run the kernels for CUDA tensors and
the plain versions (``attention_reference``/``attention_bwd_reference``) for
CPU tensors only; there is no fallback from one to the other. ``LAUNCHES``
(forward) and ``BWD_LAUNCHES`` (backward) count kernel launches, once per
call, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

LAUNCHES = 0      # forward kernel launches since import (or since a caller reset it)
BWD_LAUNCHES = 0  # backward kernel launches (one per call: dk/dv and dq kernels)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64)
_BWD_HEAD_DIMS = (8, 16, 32)
_MAX_BH = 65535

_M1, _M2, _M3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
_U32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# The dropout mask (plain torch, int64 holding uint32 values)
# --------------------------------------------------------------------------


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2³² for int64 a in [0, 2³²) and a constant c < 2³², with
    every partial product below 2⁴⁸ (no int64 overflow)."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_bits(seed: int, bh: torch.Tensor, row: torch.Tensor,
                 col: torch.Tensor) -> torch.Tensor:
    """The hash's uint32 bits (as int64) at broadcast integer coordinates
    (``dropout_keep`` of the JAX package evaluated at global indices)."""
    h = _mul32(row, _M1) ^ _mul32(col, _M2) ^ _mul32(bh, _M3)
    return _mix32((h + (int(seed) & _U32)) & _U32)


def keep_threshold(rate: float) -> int:
    """uint32(min(rate·2³², 2³² − 1)), as ``keep_from_bits``."""
    return min(int(rate * 2**32), 2**32 - 1)


def dropout_keep(seed: int, bh: int, n: int, device=None) -> torch.Tensor:
    """(bh, n, n) hash bits (int64 holding uint32) of heads 0..bh-1 over n
    queries and keys; an entry is kept where bits >= keep_threshold(rate)."""
    ar = torch.arange(n, dtype=torch.int64, device=device)
    heads = torch.arange(bh, dtype=torch.int64, device=device).view(-1, 1, 1)
    return dropout_bits(seed, heads, ar.view(1, -1, 1), ar.view(1, 1, -1))


def _keep_mask(seed: int, bh: int, n: int, rate: float, device) -> torch.Tensor:
    return dropout_keep(seed, bh, n, device) >= keep_threshold(rate)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rate: float = 0.0, seed: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain softmax attention with f32 accumulation.

    q, k, v: (BH, N, D) -> (o (BH, N, D) in the input dtype, lse (BH, N) f32),
    o = dropout(softmax(q kᵀ / √D)) v and lse the row logsumexp of the scaled
    scores (undropped)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        keep = _keep_mask(seed, q.shape[0], q.shape[1], rate, q.device)
        p = torch.where(keep, p, 0.0) / (1.0 - rate)
    o = torch.matmul(p, v.float())
    return o.to(q.dtype), lse


def attention_bwd_reference(q, k, v, o, lse, do, rate: float = 0.0, seed: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward of ``attention_reference`` from the saved lse:
    (dq, dk, dv) in the input dtype, the math of ``_bwd_fused_kernel``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    pd = p
    if rate > 0.0:
        keep = _keep_mask(seed, q.shape[0], q.shape[1], rate, q.device)
        inv_keep = 1.0 / (1.0 - rate)
        pd = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, dp * inv_keep, 0.0)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dv = torch.matmul(pd.transpose(-1, -2), dof)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# Kernel launches
# --------------------------------------------------------------------------


def _check(*ts: torch.Tensor):
    q = ts[0]
    if q.dim() != 3 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"q, k, v (and o, do) must share one (BH, N, D) shape, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"q, k, v must be float32 or bfloat16 alike, got "
                        f"{[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError(f"q, k, v on different devices: {[t.device for t in ts]}")


def _check_launch(ts, dims):
    bh, n, d = ts[0].shape
    if d not in dims:
        raise ValueError(f"head dim {d} not supported by the kernel ({dims})")
    if not 1 <= bh <= _MAX_BH or n < 1:
        raise ValueError(f"(BH, N) = ({bh}, {n}) outside 1 <= BH <= {_MAX_BH}, N >= 1")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("attention inputs must be contiguous")


def _dropout_args(rate: float, seed: Optional[int]):
    """(on, seed, thresh) as the kernels take them."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if rate == 0.0:
        return 0, 0, 0
    if seed is None:
        raise ValueError("dropout rate > 0 requires a seed")
    return 1, int(seed) & _U32, keep_threshold(rate)


def _launch_fwd(q, k, v, rate, on, seed32, thresh):
    from causalvae_tpu_torch.ops.kernels import _build

    global LAUNCHES
    _check_launch((q, k, v), _HEAD_DIMS)
    bh, n, d = q.shape
    fn = _build.load("attention_fwd").attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        o = torch.empty_like(q)
        lse = torch.empty((bh, n), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), bh, n, d, _DTYPES[q.dtype], 1.0 / math.sqrt(d),
                 on, seed32, thresh, 1.0 - rate, stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return o, lse


def _launch_bwd(q, k, v, o, lse, do, rate, on, seed32, thresh):
    from causalvae_tpu_torch.ops.kernels import _build

    global BWD_LAUNCHES
    _check_launch((q, k, v, o, do), _BWD_HEAD_DIMS)
    bh, n, d = q.shape
    if lse.shape != (bh, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 ({bh}, {n})")
    fn = _build.load("attention_bwd").attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), bh, n, d, _DTYPES[q.dtype], 1.0 / math.sqrt(d),
                 on, seed32, thresh, 1.0 / (1.0 - rate), stream)
    if err != 0:
        raise RuntimeError(f"attention_bwd kernel launch failed: cudaError {err}")
    BWD_LAUNCHES += 1
    return dq, dk, dv


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  rate: float = 0.0, seed: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, N, D) q, k, v -> (o, lse); the kernel for CUDA tensors, the plain
    version for CPU tensors (same contract as ``attention_reference``)."""
    _check(q, k, v)
    on, seed32, thresh = _dropout_args(rate, seed)
    if q.device.type == "cuda":
        return _launch_fwd(q, k, v, rate, on, seed32, thresh)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, rate, seed32)
    raise ValueError(f"unsupported device {q.device}")


def attention_bwd(q, k, v, o, lse, do, rate: float = 0.0,
                  seed: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_fwd`` from its o and lse and the output
    gradient do; the kernels for CUDA tensors, the plain version for CPU."""
    _check(q, k, v, o, do)
    on, seed32, thresh = _dropout_args(rate, seed)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, o, lse, do, rate, on, seed32, thresh)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, o, lse, do, rate, seed32)
    raise ValueError(f"unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rate, seed):
        o, lse = attention_fwd(q, k, v, rate, seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.rate, ctx.seed = rate, seed
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.rate,
                                   ctx.seed)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None) -> torch.Tensor:
    """MHA with inputs (B, H, N, D) -> output (B, H, N, D), scale 1/√D.

    ``dropout_rate`` > 0 drops attention probabilities by the hash mask of
    ``dropout_seed`` (a uint32; required then), differentiably."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    b, h, n, d = q.shape
    q3, k3, v3 = (t.contiguous().view(b * h, n, d) for t in (q, k, v))
    o = _FlashAttention.apply(q3, k3, v3, float(dropout_rate), dropout_seed)
    return o.view(b, h, n, d)

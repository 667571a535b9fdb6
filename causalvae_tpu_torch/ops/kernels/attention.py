"""Multi-head attention forward for the ViT encoder: CUDA kernel + plain version.

Counterpart of ``causalvae_tpu/ops/kernels/attention.py``: ``attention_fwd``
replaces ``_fwd_call``/``_fwd_kernel`` and ``flash_attention`` keeps the JAX
entry point's (B, H, N, D) contract, at dropout rate 0 (the serving path).

The kernel (``csrc/attention_fwd.cu``) is bound by operations at the vessel
shape (BH = 8 * batch, N = 961, D = 32; ~240 flops per byte in f32). Its
design, a block per (head, 64 query rows) with an online-softmax loop over key
tiles staged in shared memory, is explained in the source. It masks keys past
N itself, so nothing is padded.

``attention_fwd`` runs the kernel for CUDA tensors and ``attention_reference``
for CPU tensors only; there is no fallback from one to the other.
``LAUNCHES`` counts kernel launches, so a run can show that it went through
the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64)
_MAX_BH = 65535


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain softmax attention with f32 accumulation.

    q, k, v: (BH, N, D) -> (o (BH, N, D) in the input dtype, lse (BH, N) f32),
    o = softmax(q kᵀ / √D) v and lse the row logsumexp of the scaled scores."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype), lse


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError(f"q, k, v must share one (BH, N, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must be float32 or bfloat16 alike, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: "
                         f"{q.device}, {k.device}, {v.device}")


def _launch(q, k, v):
    from causalvae_tpu_torch.ops.kernels import _build

    global LAUNCHES
    bh, n, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel ({_HEAD_DIMS})")
    if not 1 <= bh <= _MAX_BH or n < 1:
        raise ValueError(f"(BH, N) = ({bh}, {n}) outside 1 <= BH <= {_MAX_BH}, N >= 1")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    lib = _build.load("attention_fwd")
    fn = lib.attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        o = torch.empty_like(q)
        lse = torch.empty((bh, n), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), bh, n, d, _DTYPES[q.dtype],
                 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return o, lse


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, N, D) q, k, v -> (o, lse); the kernel for CUDA tensors, the plain
    version for CPU tensors (same contract as ``attention_reference``)."""
    _check(q, k, v)
    if q.device.type == "cuda":
        return _launch(q, k, v)
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    raise ValueError(f"unsupported device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """MHA with inputs (B, H, N, D) -> output (B, H, N, D), scale 1/√D."""
    b, h, n, d = q.shape
    o, _ = attention_fwd(*(t.contiguous().view(b * h, n, d) for t in (q, k, v)))
    return o.view(b, h, n, d)

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
arithmetic. The seed reaches the kernels in device memory: a 0-d int64 tensor
on the inputs' device (the low 32 bits count), which ``models/vit.py`` fills
from the step's draw (``ops/draws.py``) and which a CUDA graph of the step
(``train/scan_loop.py``) refills before each replay; an int seed is put into
such a tensor by the wrappers. ``bh0`` (``dropout_bh0`` of
``flash_attention``) offsets the head index: a rank of a data-parallel step
that holds rows b0.. of the global batch passes b0·H, so its masks are the
global batch's (``parallel/``). It is bit-identical to the JAX package's
interpret-mode mask (its TPU hardware generator ``_hw_tile_bits`` is not
ported), and the
forward and backward kernels regenerate it from the same coordinates
(``csrc/dropout_hash.cuh``).

The forward kernel (``csrc/attention_fwd.cu``) and the backward kernels
(``csrc/attention_bwd.cu``; above D = 256 ``csrc/attention_fwd_deep.cu`` and
``csrc/attention_bwd_deep.cu``) are bound by operations at the vessel shape
(BH = 8 * batch, N = 961, D = 32); their designs are explained in the
sources. In bfloat16 the forward at padded head dims of 128 and above runs
``csrc/attention_fwd_large.cu`` instead (bf16 tensor-core products, the
head dim split over a thread-block cluster); in float32 it was slower there
than the wide and deep plans, which keep those head dims
(``_fwd_source``). Both run their products on the tensor cores (3xTF32 for f32,
``csrc/mma_tf32.cuh``; the tiles and fragment loads they share are in
``csrc/attention_tiles.cuh``) and give the same bits from launch to launch.
Both mask keys past N themselves, so N is never padded. They take every head
dim D from 1 to ``MAX_HEAD_DIM`` (1344), as the Pallas kernel takes any D:
up to 256 each kernel is compiled at D = 8, 16, 32, 64, 128 and 256
(``KERNEL_HEAD_DIMS``; a narrow plan for small D, a wide one for large D);
above 256 a deep plan takes D at run time in chunks of ``DEEP_CHUNK`` (64)
columns, its accumulators in shared memory. Another D is zero-padded here to
the next compiled D up to 256, and above it to the next multiple of 64, as
the JAX wrapper pads D to a multiple of 8 (the padded columns add nothing to
a score and their outputs are dropped; the scale stays 1/√D of the true D).
D > 1344 raises: the deep plan's dK/dV block, 2 x 16 x (D + 8) f32
accumulators beside its ring of chunks, would pass the 227 KB of shared
memory a block may have.

``attention_fwd``/``attention_bwd`` check their arguments and call the
operators ``cvae::attention_fwd``/``cvae::attention_bwd`` (``registry.py``),
which run the kernels for CUDA tensors and the plain versions
(``attention_reference``/``attention_bwd_reference``) for CPU tensors only;
there is no fallback from one to the other; their fake kernels let
``torch.export`` trace ``flash_attention``. ``LAUNCHES``
(forward) and ``BWD_LAUNCHES`` (backward) count kernel launches, once per
call, so a run can show that it went through the kernels; ``LAUNCHES_BF16``
and ``BWD_LAUNCHES_BF16`` count those of them on bfloat16 operands, and
``LARGE_LAUNCHES`` those of the forward's that ran ``attention_fwd_large``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from causalvae_tpu_torch.ops.kernels import registry

LAUNCHES = 0      # forward kernel launches since import (or since a caller reset it)
BWD_LAUNCHES = 0  # backward kernel launches (one per call: delta, dk/dv and dq kernels)
LAUNCHES_BF16 = 0      # of LAUNCHES, those on bfloat16 q, k, v
LARGE_LAUNCHES = 0     # of LAUNCHES, those of csrc/attention_fwd_large.cu
BWD_LAUNCHES_BF16 = 0  # of BWD_LAUNCHES, those on bfloat16 operands

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # the head dims the kernels are compiled at
DEEP_CHUNK = 64       # above 256, D runs padded to a multiple of this (csrc/attention_tiles.cuh)
MAX_HEAD_DIM = 1344   # DEEP_MAX_D of csrc/attention_tiles.cuh: shared memory binds there
LARGE_MIN_D = 128     # the least padded head dim of csrc/attention_fwd_large.cu

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


def dropout_keep(seed: int, bh: int, n: int, device=None, bh0: int = 0) -> torch.Tensor:
    """(bh, n, n) hash bits (int64 holding uint32) of heads bh0..bh0+bh-1
    over n queries and keys; an entry is kept where bits >=
    keep_threshold(rate)."""
    ar = torch.arange(n, dtype=torch.int64, device=device)
    heads = torch.arange(bh0, bh0 + bh, dtype=torch.int64, device=device).view(-1, 1, 1)
    return dropout_bits(seed, heads & _U32, ar.view(1, -1, 1), ar.view(1, 1, -1))


def _keep_mask(seed: int, bh: int, n: int, rate: float, device, bh0: int = 0
               ) -> torch.Tensor:
    return dropout_keep(seed, bh, n, device, bh0) >= keep_threshold(rate)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rate: float = 0.0, seed: int = 0, bh0: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain softmax attention with f32 accumulation (f64 for f64 inputs).

    q, k, v: (BH, N, D) -> (o (BH, N, D) in the input dtype, lse (BH, N) in the
    accumulation type),
    o = dropout(softmax(q kᵀ / √D)) v and lse the row logsumexp of the scaled
    scores (undropped); the mask's heads start at ``bh0``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    acc = _acc_dtype(q)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        keep = _keep_mask(seed, q.shape[0], q.shape[1], rate, q.device, bh0)
        p = torch.where(keep, p, 0.0) / (1.0 - rate)
    o = torch.matmul(p, v.to(acc))
    return o.to(q.dtype), lse


def attention_bwd_reference(q, k, v, o, lse, do, rate: float = 0.0, seed: int = 0,
                            bh0: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward of ``attention_reference`` from the saved lse:
    (dq, dk, dv) in the input dtype, the math of ``_bwd_fused_kernel``
    (f32 accumulation, f64 for f64 inputs)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    acc = _acc_dtype(q)
    qf, kf, vf, dof = (t.to(acc) for t in (q, k, v, do))
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    pd = p
    if rate > 0.0:
        keep = _keep_mask(seed, q.shape[0], q.shape[1], rate, q.device, bh0)
        inv_keep = 1.0 / (1.0 - rate)
        pd = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, dp * inv_keep, 0.0)
    delta = (dof * o.to(acc)).sum(dim=-1, keepdim=True)
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


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a head dim ``d`` at (the inputs
    zero-padded to it): up to 256 the least of ``KERNEL_HEAD_DIMS`` that is
    >= d, above it the next multiple of ``DEEP_CHUNK`` (the deep plan)."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside the kernels' 1..{MAX_HEAD_DIM} (above it "
                         f"the deep plan's dK/dV block passes a block's shared memory)")
    if d > KERNEL_HEAD_DIMS[-1]:
        return -(-d // DEEP_CHUNK) * DEEP_CHUNK
    return next(k for k in KERNEL_HEAD_DIMS if k >= d)


def pad_head_dim(t: torch.Tensor, dp: int) -> torch.Tensor:
    """(BH, N, D) -> (BH, N, dp), zeros in the new columns (``t`` itself
    when D = dp)."""
    return t if t.shape[-1] == dp else torch.nn.functional.pad(t, (0, dp - t.shape[-1]))


def _source(kernel: str, dp: int) -> str:
    """The source (and C entry) of ``kernel`` at the head dim ``dp`` it runs
    at: the deep plan's above the compiled ones."""
    return f"{kernel}_deep" if dp > KERNEL_HEAD_DIMS[-1] else kernel


def _fwd_source(dp: int, dtype: torch.dtype) -> str:
    """The forward's source (and C entry) at the head dim ``dp`` it runs
    at: in bfloat16 the large-D kernel from ``LARGE_MIN_D`` on (faster than
    the wide and deep plans at every timed shape, ``ab_attention_fwd_large.py``);
    in float32 those plans (the large-D kernel was slower there)."""
    if dtype == torch.bfloat16 and dp >= LARGE_MIN_D:
        return "attention_fwd_large"
    return _source("attention_fwd", dp)


def _check_launch(ts) -> int:
    """Checks the kernels' operands; returns the head dim they run at."""
    bh, n, d = ts[0].shape
    dp = kernel_head_dim(d)
    if bh < 1 or n < 1:
        raise ValueError(f"(BH, N) = ({bh}, {n}) outside BH >= 1, N >= 1")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("attention inputs must be contiguous")
    return dp


def seed_tensor(seed, device) -> torch.Tensor:
    """The dropout seed as the kernels read it: a 0-d int64 tensor on
    ``device`` (an int is put into one; a tensor must be 0-d or one element,
    int64, on ``device``)."""
    if not isinstance(seed, torch.Tensor):
        return torch.full((), int(seed) & _U32, dtype=torch.int64, device=device)
    if seed.dtype != torch.int64 or seed.numel() != 1 or seed.device != torch.device(device):
        raise ValueError(f"a seed tensor must hold one int64 on {device}, got "
                         f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
    return seed.reshape(())


def _dropout_args(rate: float, seed, bh0: int, device):
    """(on, seed, thresh) as the operators take them: the seed a 0-d int64
    tensor on ``device`` with dropout on, else None."""
    if not 0 <= bh0 <= _U32:
        raise ValueError(f"bh0 {bh0} outside [0, 2^32)")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if rate == 0.0:
        return 0, None, 0
    if seed is None:
        raise ValueError("dropout rate > 0 requires a seed")
    return 1, seed_tensor(seed, device), keep_threshold(rate)


def _seed_value(seed: Optional[torch.Tensor]) -> int:
    """The plain versions' int seed (0 with dropout off)."""
    return 0 if seed is None else int(seed) & _U32


def _seed_ptr(seed: Optional[torch.Tensor], on: int, device) -> Optional[int]:
    if not on:
        return None
    if seed is None:
        raise ValueError("dropout rate > 0 requires a seed")
    return seed_tensor(seed, device).data_ptr()


def _launch_fwd(q, k, v, rate, on, seed, thresh, bh0=0, name=None):
    """The forward kernel of ``_fwd_source`` (or of the source ``name``)."""
    from causalvae_tpu_torch.ops.kernels import _build

    global LAUNCHES, LAUNCHES_BF16, LARGE_LAUNCHES
    dp = _check_launch((q, k, v))
    bh, n, d = q.shape
    name = name or _fwd_source(dp, q.dtype)
    fn = getattr(_build.load(name), name)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint, ctypes.c_float,
        ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    seed_ptr = _seed_ptr(seed, on, q.device)
    with torch.cuda.device(q.device):
        qp, kp, vp = (pad_head_dim(t, dp) for t in (q, k, v))
        o = torch.empty_like(qp)
        lse = torch.empty((bh, n), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), bh, n, dp, _DTYPES[q.dtype], 1.0 / math.sqrt(d),
                 on, seed_ptr, thresh, 1.0 - rate, bh0, stream)
        if err != 0:
            raise RuntimeError(f"attention_fwd kernel launch failed: cudaError {err}")
        if dp != d:
            o = o[..., :d].contiguous()
    LAUNCHES += 1
    LAUNCHES_BF16 += q.dtype == torch.bfloat16
    LARGE_LAUNCHES += name == "attention_fwd_large"
    return o, lse


def _launch_bwd(q, k, v, o, lse, do, rate, on, seed, thresh, bh0=0):
    from causalvae_tpu_torch.ops.kernels import _build

    global BWD_LAUNCHES, BWD_LAUNCHES_BF16
    dp = _check_launch((q, k, v, o, do))
    bh, n, d = q.shape
    if lse.shape != (bh, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 ({bh}, {n})")
    name = _source("attention_bwd", dp)
    fn = getattr(_build.load(name), name)
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint, ctypes.c_float,
        ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    seed_ptr = _seed_ptr(seed, on, q.device)
    with torch.cuda.device(q.device):
        qp, kp, vp, op, dop = (pad_head_dim(t, dp) for t in (q, k, v, o, do))
        dq, dk, dv = (torch.empty_like(qp) for _ in range(3))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), op.data_ptr(),
                 dop.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), bh, n, dp, _DTYPES[q.dtype], 1.0 / math.sqrt(d),
                 on, seed_ptr, thresh, 1.0 / (1.0 - rate), bh0, stream)
        if err != 0:
            raise RuntimeError(f"attention_bwd kernel launch failed: cudaError {err}")
        if dp != d:
            dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BF16 += q.dtype == torch.bfloat16
    return dq, dk, dv


def _fwd_fake(q, k, v, rate, on, seed, thresh, bh0=0):
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty(q.shape[:2], dtype=torch.float32, device=q.device))


def _bwd_fake(q, k, v, o, lse, do, rate, on, seed, thresh, bh0=0):
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))


_FWD_OP = registry.define(
    "attention_fwd(Tensor q, Tensor k, Tensor v, float rate, int on, Tensor? seed, "
    "int thresh, int bh0=0) -> (Tensor, Tensor)",
    cpu=lambda q, k, v, rate, on, seed, thresh, bh0=0: attention_reference(
        q, k, v, rate, _seed_value(seed), bh0),
    cuda=_launch_fwd, fake=_fwd_fake)
_BWD_OP = registry.define(
    "attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, Tensor do, "
    "float rate, int on, Tensor? seed, int thresh, int bh0=0) -> (Tensor, Tensor, Tensor)",
    cpu=lambda q, k, v, o, lse, do, rate, on, seed, thresh, bh0=0: attention_bwd_reference(
        q, k, v, o, lse, do, rate, _seed_value(seed), bh0),
    cuda=_launch_bwd, fake=_bwd_fake)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  rate: float = 0.0, seed=None, bh0: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, N, D) q, k, v -> (o, lse) through ``cvae::attention_fwd``: the
    kernel for CUDA tensors, the plain version for CPU tensors (same
    contract as ``attention_reference``). ``seed``: an int or a 0-d int64
    tensor on q's device (``seed_tensor``)."""
    _check(q, k, v)
    registry.check_device(q)
    on, seed_t, thresh = _dropout_args(rate, seed, bh0, q.device)
    return _FWD_OP(q, k, v, float(rate), on, seed_t, thresh, int(bh0))


def attention_fwd_large(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        rate: float = 0.0, seed=None, bh0: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``attention_fwd`` through ``csrc/attention_fwd_large.cu`` in either
    dtype, at head dims the wrapper pads to ``LARGE_MIN_D`` or more:
    ``attention_fwd`` takes that kernel for bfloat16 only, and this entry
    holds and times its float32 path beside the plans float32 keeps
    (``chip_smoke.py``, ``tests/test_torch_cuda.py``). CPU tensors take the
    plain version."""
    _check(q, k, v)
    registry.check_device(q)
    if kernel_head_dim(q.shape[-1]) < LARGE_MIN_D:
        raise ValueError(f"head dim {q.shape[-1]} pads to {kernel_head_dim(q.shape[-1])}, "
                         f"below the large-D kernel's {LARGE_MIN_D}")
    on, seed_t, thresh = _dropout_args(rate, seed, bh0, q.device)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, rate, _seed_value(seed_t), bh0)
    return _launch_fwd(q, k, v, float(rate), on, seed_t, thresh, int(bh0),
                       name="attention_fwd_large")


def attention_bwd(q, k, v, o, lse, do, rate: float = 0.0, seed=None, bh0: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_fwd`` from its o and lse and the output
    gradient do, through ``cvae::attention_bwd``: the kernels for CUDA
    tensors, the plain version for CPU tensors."""
    _check(q, k, v, o, do)
    if lse.device != q.device:
        raise ValueError(f"lse on {lse.device}, q on {q.device}")
    registry.check_device(q)
    on, seed_t, thresh = _dropout_args(rate, seed, bh0, q.device)
    return _BWD_OP(q, k, v, o, lse, do, float(rate), on, seed_t, thresh, int(bh0))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rate, seed, bh0):
        o, lse = attention_fwd(q, k, v, rate, seed, bh0)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.rate, ctx.seed, ctx.bh0 = rate, seed, bh0
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.rate,
                                   ctx.seed, ctx.bh0)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    dropout_rate: float = 0.0,
                    dropout_seed=None,
                    dropout_bh0: int = 0) -> torch.Tensor:
    """MHA with inputs (B, H, N, D) -> output (B, H, N, D), scale 1/√D.

    ``dropout_rate`` > 0 drops attention probabilities by the hash mask of
    ``dropout_seed`` (a uint32, or a 0-d int64 tensor on q's device holding
    it; required then), differentiably, at heads ``dropout_bh0`` + b·H + h."""
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    b, h, n, d = q.shape
    q3, k3, v3 = (t.contiguous().view(b * h, n, d) for t in (q, k, v))
    if dropout_rate > 0.0:  # one seed tensor for the forward and the backward
        dropout_seed = seed_tensor(dropout_seed, q.device)
    o = _FlashAttention.apply(q3, k3, v3, float(dropout_rate), dropout_seed,
                              int(dropout_bh0))
    return o.view(b, h, n, d)

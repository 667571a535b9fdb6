"""The vessel ELBO's image terms: CUDA kernels + plain versions.

Counterpart of ``causalvae_tpu/ops/kernels/elbo.py``: ``elbo_terms``
replaces ``_pallas_terms``/``_kernel`` and the ``pos_weight`` reduction
before it, ``elbo_terms_bwd`` the custom VJP's ``_fused_bwd``, and
``vessel_recon_terms_fused`` keeps the JAX entry point's contract::

    recon_loss = sum((recon - x)^2 * (1 + (pos_weight - 1) * x))
    sparsity   = sum(|recon| * (x < 0.1))

``pos_weight`` is the batch's foreground fraction f = sum(x) / (numel +
1e-6) turned into clamp((1 - f)/(f + 1e-6), 1, 50), without gradient.

On the card (``csrc/elbo_terms.cu``) each direction is one launch that reads
recon (float32 or bfloat16, widened in registers) and x (float32; another
type is cast first) once: the forward computes pos_weight in the same pass
(or takes the caller's) and folds its cross-block partials in the same
launch, deterministically; the backward writes d recon in recon's type, and
d x only when asked, with the same bits as the plain backward
(``_plain_bwd``) on the CPU. The forward's scratch (partials and a ticket)
is kept per device: two streams must not run it on one device at once.

``elbo_terms`` and ``elbo_terms_bwd`` run the kernel for CUDA tensors and
the plain version for CPU tensors only; there is no fallback from one to
the other. ``LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches,
``LAUNCHES_BF16`` and ``BWD_LAUNCHES_BF16`` those of them on a bfloat16
recon.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

LAUNCHES = 0  # forward kernel launches since import (or since a caller reset it)
BWD_LAUNCHES = 0  # backward kernel launches
LAUNCHES_BF16 = 0  # of LAUNCHES, those on a bfloat16 recon
BWD_LAUNCHES_BF16 = 0  # of BWD_LAUNCHES, those on a bfloat16 recon

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None
_scratch: Dict[int, Tuple[int, torch.Tensor, torch.Tensor]] = {}
_lock = threading.Lock()


def pos_weight(x: torch.Tensor) -> torch.Tensor:
    """clamp((1 - f) / (f + 1e-6), 1, 50) of the foreground fraction f, as a
    0-d float32 tensor on x's device, without gradient."""
    with torch.no_grad():
        x32 = x.float()
        fraction = x32.sum() / (x32.numel() + 1e-6)
        return ((1.0 - fraction) / (fraction + 1e-6)).clamp(1.0, 50.0)


def _plain_terms(recon: torch.Tensor, x: torch.Tensor, pw: torch.Tensor
                 ) -> torch.Tensor:
    """The two sums in plain torch (``_xla_terms``' math) and pw: a (3,)
    float32 [recon_loss, sparsity, pw]."""
    r, x = recon.float(), x.float()
    weight = 1.0 + (pw - 1.0) * x
    return torch.stack([((r - x) ** 2 * weight).sum(), (r.abs() * (x < 0.1)).sum(),
                        pw.detach().float().reshape(())])


def _plain_bwd(g: torch.Tensor, recon: torch.Tensor, x: torch.Tensor, pw: torch.Tensor,
               need_recon: bool = True, need_x: bool = False):
    """(d recon, d x) of ``_plain_terms`` given g = (g_recon_loss, g_sparsity,
    ...), elementwise as ``_fused_bwd``: d recon = g0·2(r−x)w +
    g1·sign(r)(x<0.1) in recon's type, d x = g0·(−2(r−x)w + (r−x)²(pw−1)) in
    x's; None where not asked."""
    r32, x32 = recon.float(), x.float()
    d = r32 - x32
    weight = 1.0 + (pw - 1.0) * x32
    d_recon = d_x = None
    if need_recon:
        d_recon = (g[0] * 2.0 * d * weight
                   + g[1] * torch.sign(r32) * (x32 < 0.1)).to(recon.dtype)
    if need_x:
        d_x = (g[0] * (-2.0 * d * weight + d ** 2 * (pw - 1.0))).to(x.dtype)
    return d_recon, d_x


def _library() -> ctypes.CDLL:
    """``csrc/elbo_terms.cu``, built on first use, its argtypes set once."""
    global _lib
    if _lib is None:
        from causalvae_tpu_torch.ops.kernels import _build

        lib = _build.load("elbo_terms")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.elbo_terms_blocks.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.elbo_terms.argtypes = [ptr, i32, ptr, i64, ptr, ptr, i32, ptr, ptr, ptr]
        lib.elbo_terms_bwd.argtypes = [ptr, i32, ptr, i64, ptr, ptr, ptr, ptr, i32, ptr]
        for fn in (lib.elbo_terms_blocks, lib.elbo_terms, lib.elbo_terms_bwd):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _device_scratch(device: torch.device) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """(blocks, partials, ticket) of ``device``: the kernels' grid and the
    forward's scratch, made once, outside inference mode (a first call while
    serving must not leave an inference tensor for later training)."""
    index = device.index
    with _lock:
        entry = _scratch.get(index)
        if entry is None:
            lib = _library()
            blocks = ctypes.c_int(0)
            with torch.cuda.device(index), torch.inference_mode(False):
                err = lib.elbo_terms_blocks(ctypes.byref(blocks))
                if err != 0:
                    raise RuntimeError(f"elbo_terms_blocks failed: cudaError {err}")
                partials = torch.empty(4 * blocks.value, dtype=torch.float32,
                                       device=device)
                ticket = torch.zeros(1, dtype=torch.int32, device=device)
            entry = _scratch[index] = (blocks.value, partials, ticket)
        return entry


def _kernel_inputs(recon: torch.Tensor, x: torch.Tensor):
    """Flat contiguous recon (float32 or bfloat16; another type as float32)
    and x (float32) for the kernels."""
    r = recon.detach()
    if r.dtype not in _DTYPES:
        r = r.float()
    return r.contiguous().view(-1), x.detach().float().contiguous().view(-1)


def _check(recon: torch.Tensor, x: torch.Tensor):
    if recon.shape != x.shape:
        raise ValueError(f"recon {tuple(recon.shape)} and x {tuple(x.shape)} differ")
    if recon.numel() == 0:
        raise ValueError("empty input")
    if recon.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {recon.device}")
    if x.device != recon.device:
        raise ValueError(f"recon on {recon.device}, x on {x.device}")


def _launch(recon: torch.Tensor, x: torch.Tensor, pw: Optional[torch.Tensor]
            ) -> torch.Tensor:
    global LAUNCHES, LAUNCHES_BF16
    r, xf = _kernel_inputs(recon, x)
    pwf = None
    if pw is not None:
        if pw.device != r.device:
            raise ValueError(f"pos_weight on {pw.device}, recon on {r.device}")
        pwf = pw.detach().float().reshape(1).contiguous()
    blocks, partials, ticket = _device_scratch(r.device)
    out = torch.empty(3, dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = _library().elbo_terms(
            r.data_ptr(), _DTYPES[r.dtype], xf.data_ptr(), r.numel(),
            None if pwf is None else pwf.data_ptr(), partials.data_ptr(), blocks,
            ticket.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"elbo_terms kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    LAUNCHES_BF16 += r.dtype == torch.bfloat16
    return out


def elbo_terms(recon: torch.Tensor, x: torch.Tensor,
               pw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(3,) float32 [recon_loss, sparsity, pos_weight], with the caller's
    ``pw`` or, where it is None, ``pos_weight(x)``: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(recon, x)
    if recon.device.type == "cuda":
        return _launch(recon, x, pw)
    return _plain_terms(recon, x, pos_weight(x) if pw is None else pw)


def elbo_terms_bwd(g: torch.Tensor, recon: torch.Tensor, x: torch.Tensor,
                   pw: torch.Tensor, need_recon: bool = True, need_x: bool = False):
    """(d recon, d x) of ``elbo_terms`` for the gradient g of its output
    (only g[0] and g[1] are read) and its pw; None where not asked: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    global BWD_LAUNCHES, BWD_LAUNCHES_BF16
    _check(recon, x)
    if not (need_recon or need_x):
        return None, None
    if recon.device.type == "cpu":
        return _plain_bwd(g, recon, x, pw, need_recon, need_x)
    r, xf = _kernel_inputs(recon, x)
    gf = g.detach().float().contiguous()
    pwf = pw.detach().float().reshape(1).contiguous()
    if gf.numel() < 2 or gf.device != r.device or pwf.device != r.device:
        raise ValueError(f"g {tuple(gf.shape)} on {gf.device} and pos_weight on "
                         f"{pwf.device} for recon on {r.device}")
    blocks = _device_scratch(r.device)[0]
    d_recon = torch.empty_like(r) if need_recon else None
    d_x = torch.empty_like(xf) if need_x else None
    with torch.cuda.device(r.device):
        err = _library().elbo_terms_bwd(
            r.data_ptr(), _DTYPES[r.dtype], xf.data_ptr(), r.numel(), gf.data_ptr(),
            pwf.data_ptr(), None if d_recon is None else d_recon.data_ptr(),
            None if d_x is None else d_x.data_ptr(), blocks,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"elbo_terms_bwd kernel launch failed: cudaError {err}")
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BF16 += r.dtype == torch.bfloat16
    if d_recon is not None:
        d_recon = d_recon.view(recon.shape).to(recon.dtype)
    if d_x is not None:
        d_x = d_x.view(x.shape).to(x.dtype)
    return d_recon, d_x


class _ElboTerms(torch.autograd.Function):
    """``elbo_terms`` with pos_weight inside; backward ``elbo_terms_bwd``
    with the forward's pos_weight (out[2])."""

    @staticmethod
    def forward(ctx, recon, x):
        out = elbo_terms(recon, x)
        ctx.save_for_backward(recon, x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        recon, x, out = ctx.saved_tensors
        return elbo_terms_bwd(g, recon, x, out[2], ctx.needs_input_grad[0],
                              ctx.needs_input_grad[1])


def vessel_recon_terms_fused(recon: torch.Tensor, x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(recon_loss, sparsity) of ``ops.losses.vessel_recon_terms`` (no sample
    mask) through the kernels; differentiable in recon (and x)."""
    out = _ElboTerms.apply(recon, x)
    return out[0], out[1]


def reference_terms(recon: torch.Tensor, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same two sums through plain autograd (no kernel, any device)."""
    out = _plain_terms(recon, x, pos_weight(x))
    return out[0], out[1]

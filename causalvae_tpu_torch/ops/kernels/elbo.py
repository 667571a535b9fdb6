"""The vessel ELBO's image terms: CUDA kernel + plain version.

Counterpart of ``causalvae_tpu/ops/kernels/elbo.py``: ``elbo_terms`` replaces
``_pallas_terms``/``_kernel``, and ``vessel_recon_terms_fused`` keeps the JAX
entry point's contract::

    recon_loss = sum((recon - x)^2 * (1 + (pos_weight - 1) * x))
    sparsity   = sum(|recon| * (x < 0.1))

``pos_weight`` is computed in plain torch without gradient, from the batch's
foreground fraction: f = sum(x) / (numel + 1e-6), clamp((1 - f)/(f + 1e-6),
1, 50). The kernel (``csrc/elbo_terms.cu``) then reads recon and x once and
gives both sums by a deterministic two-stage reduction; it is bound by bytes
(63 MB at the vessel batch). The gradient is the elementwise formula of the
JAX custom VJP, in plain torch.

``elbo_terms`` runs the kernel for CUDA tensors and ``_plain_terms`` for CPU
tensors only; there is no fallback from one to the other. ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

LAUNCHES = 0  # kernel launches since import (or since a caller reset it)

_THREADS = 256
_MAX_BLOCKS = 1024


def pos_weight(x: torch.Tensor) -> torch.Tensor:
    """clamp((1 - f) / (f + 1e-6), 1, 50) of the foreground fraction f, as a
    0-d float32 tensor on x's device, without gradient."""
    with torch.no_grad():
        x32 = x.float()
        fraction = x32.sum() / (x32.numel() + 1e-6)
        return ((1.0 - fraction) / (fraction + 1e-6)).clamp(1.0, 50.0)


def _plain_terms(recon: torch.Tensor, x: torch.Tensor, pw: torch.Tensor
                 ) -> torch.Tensor:
    """The two sums in plain torch (``_xla_terms``' math): a (2,) float32."""
    r, x = recon.float(), x.float()
    weight = 1.0 + (pw - 1.0) * x
    return torch.stack([((r - x) ** 2 * weight).sum(), (r.abs() * (x < 0.1)).sum()])


def _launch(recon: torch.Tensor, x: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    from causalvae_tpu_torch.ops.kernels import _build

    global LAUNCHES
    r = recon.detach().float().contiguous().view(-1)
    xf = x.detach().float().contiguous().view(-1)
    pwf = pw.detach().float().reshape(1).contiguous()
    if not (r.device == xf.device == pwf.device):
        raise ValueError(f"recon, x, pos_weight on different devices: "
                         f"{r.device}, {xf.device}, {pwf.device}")
    n = r.numel()
    blocks = min(_MAX_BLOCKS, max(1, -(-n // (4 * _THREADS))))
    lib = _build.load("elbo_terms")
    fn = lib.elbo_terms
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(r.device):
        partials = torch.empty(2 * blocks, dtype=torch.float32, device=r.device)
        out = torch.empty(2, dtype=torch.float32, device=r.device)
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), xf.data_ptr(), pwf.data_ptr(), n,
                 partials.data_ptr(), blocks, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"elbo_terms kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def elbo_terms(recon: torch.Tensor, x: torch.Tensor, pw: torch.Tensor
               ) -> torch.Tensor:
    """(2,) float32 [recon_loss, sparsity]: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if recon.shape != x.shape:
        raise ValueError(f"recon {tuple(recon.shape)} and x {tuple(x.shape)} differ")
    if recon.numel() == 0:
        raise ValueError("empty input")
    if recon.device.type == "cuda":
        return _launch(recon, x, pw)
    if recon.device.type == "cpu":
        return _plain_terms(recon, x, pw)
    raise ValueError(f"unsupported device {recon.device}")


class _ElboTerms(torch.autograd.Function):
    """Forward through ``elbo_terms``; backward elementwise (``elbo.py``
    ``_fused_bwd``): d recon = g0·2(r−x)w + g1·sign(r)(x<0.1),
    d x = g0·(−2(r−x)w + (r−x)²(pw−1))."""

    @staticmethod
    def forward(ctx, recon, x, pw):
        ctx.save_for_backward(recon, x, pw)
        return elbo_terms(recon, x, pw)

    @staticmethod
    def backward(ctx, g):
        recon, x, pw = ctx.saved_tensors
        r32, x32 = recon.float(), x.float()
        d = r32 - x32
        weight = 1.0 + (pw - 1.0) * x32
        d_recon = d_x = None
        if ctx.needs_input_grad[0]:
            d_recon = (g[0] * 2.0 * d * weight
                       + g[1] * torch.sign(r32) * (x32 < 0.1)).to(recon.dtype)
        if ctx.needs_input_grad[1]:
            d_x = (g[0] * (-2.0 * d * weight + d ** 2 * (pw - 1.0))).to(x.dtype)
        return d_recon, d_x, None


def vessel_recon_terms_fused(recon: torch.Tensor, x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(recon_loss, sparsity) of ``ops.losses.vessel_recon_terms`` (no sample
    mask) through the kernel; differentiable in recon (and x)."""
    out = _ElboTerms.apply(recon, x, pos_weight(x))
    return out[0], out[1]


def reference_terms(recon: torch.Tensor, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same two sums through plain autograd (no kernel, any device)."""
    out = _plain_terms(recon, x, pos_weight(x))
    return out[0], out[1]

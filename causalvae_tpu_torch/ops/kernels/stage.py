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
- ``stage_fwd_fine`` runs ``csrc/stage_fwd_fine.cu`` (replaces
  ``_stage_kernel`` on the model's path): the same function computed as the
  model's base 3x3 conv (recipe "conv", "stem" or "convT") on the fine
  pixel grid, only its real taps, reading and writing the packed tensors
  where they lie.
- ``stage_dgrad_fine`` runs ``csrc/stage_dgrad_fine.cu`` (replaces the dx,
  dmul and dadd of ``_stage_bwd_kernel`` on the model's path): the
  transpose of that conv on the fine grid (conv -> conv with the kernel
  rotated by 180 degrees and transposed, stem -> the convT structure, convT
  -> the stem structure; ``stage_dgrad_weight``), with the epilogue dx =
  da * leaky'(pre) * mul and fixed-order sums of dmul and dadd per packed
  channel. What bounds it (the real work's operations for base Ci >= 32,
  the bytes of dy, x and dx at the two Ci = 16 decoder-tail shapes) and
  what the design does about it: the note in the source.
- ``stage_wgrad_fine`` runs ``csrc/stage_wgrad_fine.cu`` (replaces the dW
  and db of ``_stage_bwd_kernel`` on the model's path): dW on the base
  (3, 3, Ci, Co) kernel over the real taps of the fine grid, and db per
  packed output channel, by split-K partials folded in a fixed order. What
  bounds it and what the design does about it: the note in the source.
- ``stage_bwd_wgrad`` runs steps 2-4 of ``csrc/stage_bwd.cu`` alone (dW and
  db on the lifted kernel, no dgrad): no path runs it; ``chip_smoke.py``
  times it beside ``stage_wgrad_fine`` as the lifted wgrad's yardstick.
- ``affine_act_conv_fine`` is the fine op: forward through
  ``stage_fwd_fine``; backward dx, dmul and dadd from ``stage_dgrad_fine``,
  dW and db from ``stage_wgrad_fine``.

The TPU took its kernels only where its gates admitted them (bf16, C % 128,
VMEM budgets): those were measurements of the TPU. Here every
``affine_act_conv`` on a CUDA tensor launches the kernels, in float32 or
bfloat16 (bf16: the activation rounds to bf16 before the conv, as the JAX
reference casts it; sums stay f32). CPU tensors take the plain versions,
``stage_reference``, ``stage_bwd_reference`` (its autograd backward),
``stage_fine_reference``, ``stage_dgrad_fine_reference`` (its autograd
backward in x, mul and add) and ``stage_wgrad_fine_reference`` (in the
weight and the bias); there is no fallback from one to the other. Each
entry is an operator of the same name in ``cvae`` (``registry.py``), with
``recipe``, ``levels``, ``slope``, ``pad_lo`` and ``has_prologue`` in its
schema.
``FWD_LAUNCHES``, ``BWD_LAUNCHES``, ``WGRAD_LAUNCHES``, ``FINE_FWD_LAUNCHES``,
``FINE_DGRAD_LAUNCHES`` and ``FINE_WGRAD_LAUNCHES`` count wrapper calls that
launched the kernels; the fine-grid ones' ``*_BF16`` twins count those of
them on a bfloat16 x.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.nn import functional as F

from causalvae_tpu_torch.ops.kernels import registry

FWD_LAUNCHES = 0  # stage forward kernel launches since import (or a reset)
BWD_LAUNCHES = 0  # stage backward launches (one per wrapper call)
WGRAD_LAUNCHES = 0  # stage backward launches of the wgrad-only entry
FINE_FWD_LAUNCHES = 0  # fine-grid stage forward launches
FINE_DGRAD_LAUNCHES = 0  # fine-grid stage dgrad launches
FINE_WGRAD_LAUNCHES = 0  # fine-grid stage wgrad launches
FINE_FWD_LAUNCHES_BF16 = 0    # of FINE_FWD_LAUNCHES, those on a bfloat16 x
FINE_DGRAD_LAUNCHES_BF16 = 0  # of FINE_DGRAD_LAUNCHES, those on a bfloat16 x
FINE_WGRAD_LAUNCHES_BF16 = 0  # of FINE_WGRAD_LAUNCHES, those on a bfloat16 x

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# fine-grid recipes (ops/subpixel.py _tap_index): C id and the change of
# packing level from input to output
_RECIPES = {"conv": (0, 0), "stem": (1, -1), "convT": (2, 1)}
# the recipe whose structure the transpose of each recipe has
_TRANSPOSED = {"conv": "conv", "stem": "convT", "convT": "stem"}


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


def out_levels(recipe: str, levels: int) -> int:
    """Packing levels of the output of a ``recipe`` conv whose input is
    packed ``levels`` times: conv keeps them, stem consumes one, convT adds one."""
    return levels + _RECIPES[recipe][1]


def stage_fine_reference(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
                         weight: torch.Tensor, bias: torch.Tensor, slope: float,
                         recipe: str, levels: int, has_prologue: bool = True) -> torch.Tensor:
    """Plain PyTorch of the fine-grid stage: the activation on the packed
    tensor with the packed-width mul/add in f32, cast to x's dtype (as
    ``stage_reference``), unpacked by ``depth_to_space_n(., levels)``, the
    module's own op with the base kernel ``weight`` (3, 3, Ci, Co) (the tensor
    ``ops/subpixel.py lifted_kernel`` lifts; for convT ``weight[kh, kw, ci,
    co]`` is torch's ``ConvTranspose2d.weight[ci, co, kh, kw]``), packed again
    ``out_levels`` times, plus the packed bias."""
    from causalvae_tpu_torch.ops.subpixel import depth_to_space_n, space_to_depth_n

    if has_prologue:
        pre = x.float() * mul.float() + add.float()
        a = torch.where(pre >= 0.0, pre, slope * pre).to(x.dtype)
    else:
        a = x
    a = depth_to_space_n(a, levels).permute(0, 3, 1, 2)
    w = weight.to(a.dtype)
    if recipe == "convT":
        y = F.conv_transpose2d(a, w.permute(2, 3, 0, 1), stride=2, padding=1,
                               output_padding=1)
    else:
        y = F.conv2d(a, w.permute(3, 2, 0, 1), stride=2 if recipe == "stem" else 1,
                     padding=1)
    y = space_to_depth_n(y.permute(0, 2, 3, 1), out_levels(recipe, levels))
    return y + bias.to(y.dtype)


def _check_fine(x, mul, add, weight, recipe: str, levels: int) -> int:
    """Checks the fine-grid stage's x, mul, add and base weight; returns the
    output's packing levels."""
    if recipe not in _RECIPES:
        raise ValueError(f"unknown recipe {recipe!r}")
    lout = out_levels(recipe, levels)
    if levels < 0 or lout < 0:
        raise ValueError(f"{recipe} at {levels} input levels has no packed output")
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[:2]) != (3, 3):
        raise ValueError(f"x (B, Hc, Wc, 4^L Ci) and weight (3, 3, Ci, Co), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    ci = weight.shape[2]
    if x.shape[3] != ci << (2 * levels):
        raise ValueError(f"x channels {x.shape[3]} != 4^{levels} * Ci {ci}")
    for name, t in (("mul", mul), ("add", add)):
        if t.shape != (x.shape[3],):
            raise ValueError(f"{name} {tuple(t.shape)}, want ({x.shape[3]},)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"stage kernels take float32 or bfloat16, got {x.dtype}")
    return lout


def _launch_fwd_fine(x, mul, add, weight, bias, slope, recipe, levels, has_prologue):
    from causalvae_tpu_torch.ops.kernels import _build

    global FINE_FWD_LAUNCHES, FINE_FWD_LAUNCHES_BF16
    b, hc, wc, _ = x.shape
    ci, co = weight.shape[2], weight.shape[3]
    x = x.detach().contiguous()
    wk = weight.detach().to(x.dtype).contiguous()
    mul, add, bias = (_f32(t, x.device) for t in (mul, add, bias))
    fn = _build.load("stage_fwd_fine").stage_fwd_fine
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        y = torch.empty((b, hc, wc, co << (2 * out_levels(recipe, levels))), dtype=x.dtype,
                        device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), mul.data_ptr(), add.data_ptr(), wk.data_ptr(),
                 bias.data_ptr(), y.data_ptr(), b, hc, wc, ci, co, _RECIPES[recipe][0],
                 levels, float(slope), int(has_prologue), _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"stage_fwd_fine kernel launch failed: cudaError {err}")
    FINE_FWD_LAUNCHES += 1
    FINE_FWD_LAUNCHES_BF16 += x.dtype == torch.bfloat16
    return y


def _fwd_fine_fake(x, mul, add, weight, bias, slope, recipe, levels, has_prologue):
    return x.new_empty((*x.shape[:3], weight.shape[3] << (2 * out_levels(recipe, levels))))


_FINE_ARGS = "float slope, str recipe, int levels, bool has_prologue"
_FWD_FINE_OP = registry.define(
    f"stage_fwd_fine(Tensor x, Tensor mul, Tensor add, Tensor weight, Tensor bias, "
    f"{_FINE_ARGS}) -> Tensor",
    cpu=stage_fine_reference, cuda=_launch_fwd_fine, fake=_fwd_fine_fake)


def stage_fwd_fine(x, mul, add, weight, bias, slope: float, recipe: str, levels: int,
                   has_prologue: bool = True) -> torch.Tensor:
    """The fine-grid stage forward: the kernel for a CUDA tensor,
    ``stage_fine_reference`` for a CPU tensor. x (B, Hc, Wc, 4^levels Ci)
    packed; mul/add per packed input channel; weight (3, 3, Ci, Co) base;
    bias per packed output channel; y (B, Hc, Wc, 4^out_levels Co)."""
    n = weight.shape[-1] << (2 * _check_fine(x, mul, add, weight, recipe, levels))
    if bias.shape != (n,):
        raise ValueError(f"bias {tuple(bias.shape)}, want ({n},)")
    registry.check_device(x)
    return _FWD_FINE_OP(x, mul, add, weight, bias, float(slope), recipe, int(levels),
                        bool(has_prologue))


def stage_dgrad_fine_reference(x, dy, mul, add, weight, slope: float, recipe: str,
                               levels: int, has_prologue: bool = True):
    """(dx, dmul, dadd) of ``stage_fine_reference`` by its autograd backward
    in (x, mul, add); dmul and dadd are zeros without a prologue."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, mul, add)]
        bias = torch.zeros(dy.shape[-1], dtype=torch.float32, device=x.device)
        y = stage_fine_reference(*leaves, weight.detach(), bias, slope, recipe, levels,
                                 has_prologue)
        dx, dmul, dadd = torch.autograd.grad(y, leaves, dy.to(y.dtype), allow_unused=True)
    if not has_prologue:
        dmul, dadd = torch.zeros_like(mul), torch.zeros_like(add)
    return dx, dmul, dadd


def stage_wgrad_fine_reference(x, dy, mul, add, weight, slope: float, recipe: str,
                               levels: int, has_prologue: bool = True):
    """(dW, db) of ``stage_fine_reference`` by its autograd backward in the
    base weight (3, 3, Ci, Co) and the packed bias (4^out_levels Co,)."""
    with torch.enable_grad():
        w = weight.detach().requires_grad_(True)
        bias = torch.zeros(dy.shape[-1], dtype=torch.float32, device=x.device,
                           requires_grad=True)
        y = stage_fine_reference(x.detach(), mul.detach(), add.detach(), w, bias, slope,
                                 recipe, levels, has_prologue)
        dw, db = torch.autograd.grad(y, (w, bias), dy.to(y.dtype))
    return dw, db


def _launch_wgrad_fine(x, dy, mul, add, weight, slope, recipe, levels, has_prologue):
    from causalvae_tpu_torch.ops.kernels import _build

    global FINE_WGRAD_LAUNCHES, FINE_WGRAD_LAUNCHES_BF16
    b, hc, wc, _ = x.shape
    ci, co = weight.shape[2], weight.shape[3]
    x = x.detach().contiguous()
    dy = dy.detach().to(x.dtype).contiguous()
    mul, add = (_f32(t, x.device) for t in (mul, add))
    lib = _build.load("stage_wgrad_fine")
    size = lib.stage_wgrad_fine_scratch_floats
    size.argtypes = [ctypes.c_int] * 9
    size.restype = ctypes.c_longlong
    fn = lib.stage_wgrad_fine
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    shape = (b, hc, wc, ci, co, _RECIPES[recipe][0], levels)
    dt = _DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        dev = x.device
        n = size(*shape, int(has_prologue), dt)
        if n < 0:
            raise ValueError(f"stage_wgrad_fine does not take x {tuple(x.shape)}, "
                             f"{recipe} at {levels} levels")
        dw = torch.empty((3, 3, ci, co), dtype=torch.float32, device=dev)
        db = torch.empty(dy.shape[3], dtype=torch.float32, device=dev)
        scratch = torch.empty(max(n, 1), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), mul.data_ptr(), add.data_ptr(), dw.data_ptr(),
                 db.data_ptr(), scratch.data_ptr(), *shape, float(slope), int(has_prologue), dt,
                 stream)
    if err != 0:
        raise RuntimeError(f"stage_wgrad_fine kernel launch failed: cudaError {err}")
    FINE_WGRAD_LAUNCHES += 1
    FINE_WGRAD_LAUNCHES_BF16 += x.dtype == torch.bfloat16
    return dw, db


def _wgrad_fine_cpu(x, dy, mul, add, weight, slope, recipe, levels, has_prologue):
    with registry.autograd_inside():
        dw, db = stage_wgrad_fine_reference(x, dy, mul, add, weight, slope, recipe, levels,
                                            has_prologue)
    return dw.float(), db.float()


def _wgrad_fake(x, dy, mul, add, weight, *_):
    return (torch.empty(weight.shape, dtype=torch.float32, device=x.device),
            torch.empty(dy.shape[3], dtype=torch.float32, device=x.device))


_WGRAD_FINE_OP = registry.define(
    f"stage_wgrad_fine(Tensor x, Tensor dy, Tensor mul, Tensor add, Tensor weight, "
    f"{_FINE_ARGS}) -> (Tensor, Tensor)",
    cpu=_wgrad_fine_cpu, cuda=_launch_wgrad_fine, fake=_wgrad_fake)


def stage_wgrad_fine(x, dy, mul, add, weight, slope: float, recipe: str, levels: int,
                     has_prologue: bool = True):
    """(dW, db) of the fine-grid stage, float32: the kernel for CUDA tensors,
    ``stage_wgrad_fine_reference`` for CPU tensors. x packed as in
    ``stage_fwd_fine``, dy at its output's shape, weight the base (3, 3, Ci,
    Co) (its shape only); dW (3, 3, Ci, Co), db (4^out_levels Co,)."""
    _check_fine_bwd(x, dy, mul, add, weight, recipe, levels)
    return _WGRAD_FINE_OP(x, dy, mul, add, weight, float(slope), recipe, int(levels),
                          bool(has_prologue))


def _check_fine_bwd(x, dy, mul, add, weight, recipe: str, levels: int):
    lout = _check_fine(x, mul, add, weight, recipe, levels)
    want = (*x.shape[:3], weight.shape[3] << (2 * lout))
    if tuple(dy.shape) != want:
        raise ValueError(f"dy {tuple(dy.shape)}, want {want}")
    registry.check_device(x)


def stage_dgrad_weight(weight: torch.Tensor, recipe: str) -> torch.Tensor:
    """The kernel (3, 3, Co, Ci) of the transposed conv from the base kernel
    (3, 3, Ci, Co): for conv ``W'[u][v] = W[2 - u][2 - v]^T``; for stem and
    convT, whose transposes have each other's structure, ``W[u][v]^T``. The
    transposed conv is ``_TRANSPOSED[recipe]`` with this kernel, from dy's
    packing levels to x's."""
    w = weight.flip(0, 1) if recipe == "conv" else weight
    return w.transpose(2, 3)


def _launch_dgrad_fine(x, dy, mul, add, weight, slope, recipe, levels, has_prologue):
    from causalvae_tpu_torch.ops.kernels import _build

    global FINE_DGRAD_LAUNCHES, FINE_DGRAD_LAUNCHES_BF16
    b, hc, wc, _ = x.shape
    ci, co = weight.shape[2], weight.shape[3]
    x = x.detach().contiguous()
    dy = dy.detach().to(x.dtype).contiguous()
    wt = stage_dgrad_weight(weight.detach(), recipe).to(x.dtype).contiguous()
    mul, add = (_f32(t, x.device) for t in (mul, add))
    lib = _build.load("stage_dgrad_fine")
    size = lib.stage_dgrad_fine_scratch_floats
    size.argtypes = [ctypes.c_int] * 9
    size.restype = ctypes.c_longlong
    fn = lib.stage_dgrad_fine
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    # the transposed conv as the kernel runs it: from dy's levels to x's, Co -> Ci
    shape = (b, hc, wc, co, ci, _RECIPES[_TRANSPOSED[recipe]][0], out_levels(recipe, levels))
    dt = _DTYPES[x.dtype]
    with torch.cuda.device(x.device):
        dev = x.device
        n = size(*shape, int(has_prologue), dt)
        if n < 0:
            raise ValueError(f"stage_dgrad_fine does not take x {tuple(x.shape)}, "
                             f"{recipe} at {levels} levels")
        dx = torch.empty_like(x)
        dmul = torch.zeros(x.shape[3], dtype=torch.float32, device=dev)
        dadd = torch.zeros(x.shape[3], dtype=torch.float32, device=dev)
        scratch = torch.empty(max(n, 1), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), mul.data_ptr(), add.data_ptr(), wt.data_ptr(),
                 dx.data_ptr(), dmul.data_ptr(), dadd.data_ptr(), scratch.data_ptr(), *shape,
                 float(slope), int(has_prologue), dt, stream)
    if err != 0:
        raise RuntimeError(f"stage_dgrad_fine kernel launch failed: cudaError {err}")
    FINE_DGRAD_LAUNCHES += 1
    FINE_DGRAD_LAUNCHES_BF16 += x.dtype == torch.bfloat16
    return dx, dmul, dadd


def _dgrad_fine_cpu(x, dy, mul, add, weight, slope, recipe, levels, has_prologue):
    with registry.autograd_inside():
        dx, dmul, dadd = stage_dgrad_fine_reference(x, dy, mul, add, weight, slope, recipe,
                                                    levels, has_prologue)
    return dx, dmul.float(), dadd.float()


def _dgrad_fake(x, *_):
    return (x.new_empty(x.shape), *(torch.empty(x.shape[3], dtype=torch.float32,
                                                device=x.device) for _ in range(2)))


_DGRAD_FINE_OP = registry.define(
    f"stage_dgrad_fine(Tensor x, Tensor dy, Tensor mul, Tensor add, Tensor weight, "
    f"{_FINE_ARGS}) -> (Tensor, Tensor, Tensor)",
    cpu=_dgrad_fine_cpu, cuda=_launch_dgrad_fine, fake=_dgrad_fake)


def stage_dgrad_fine(x, dy, mul, add, weight, slope: float, recipe: str, levels: int,
                     has_prologue: bool = True):
    """(dx, dmul, dadd) of the fine-grid stage: the kernel for CUDA tensors,
    ``stage_dgrad_fine_reference`` for CPU tensors. x packed as in
    ``stage_fwd_fine``, dy at its output's shape, weight the base (3, 3, Ci,
    Co); dx in x's dtype, dmul/dadd (4^levels Ci,) float32 (zeros without a
    prologue)."""
    _check_fine_bwd(x, dy, mul, add, weight, recipe, levels)
    return _DGRAD_FINE_OP(x, dy, mul, add, weight, float(slope), recipe, int(levels),
                          bool(has_prologue))


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

    global FWD_LAUNCHES
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
    FWD_LAUNCHES += 1
    return y


def _wgrad_splits(m: int, ci: int, co: int, k: int) -> int:
    """Split-K count of the wgrad kernel: about four blocks per SM of the
    H100's 132, each split at least 1024 pixels (csrc/stage_bwd.cu)."""
    tiles = -(-ci // 128) * -(-co // (64 if co <= 64 else 128)) * k * k
    return max(1, min(-(-4 * 132 // tiles), m // 1024))


def _launch_bwd(x, dy, mul, add, kernel, slope, pad_lo, has_prologue, with_dgrad=True):
    """stage_bwd's kernels: (dx, dW, db, dmul, dadd), or with ``with_dgrad``
    False the wgrad-only entry's (dW, db)."""
    from causalvae_tpu_torch.ops.kernels import _build

    global BWD_LAUNCHES, WGRAD_LAUNCHES
    b, h, w, ci = x.shape
    k, co = kernel.shape[0], kernel.shape[3]
    x = x.detach().contiguous()
    dy = dy.detach().to(x.dtype).contiguous()
    mul, add = (_f32(t, x.device) for t in (mul, add))
    splits = _wgrad_splits(b * h * w, ci, co, k)
    lib = _build.load("stage_bwd")
    size = lib.stage_bwd_scratch_floats
    size.argtypes = [ctypes.c_int] * 6
    size.restype = ctypes.c_longlong
    name = "stage_bwd" if with_dgrad else "stage_bwd_wgrad"
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * (10 if with_dgrad else 6) + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        dev = x.device
        dw = torch.empty((k, k, ci, co), dtype=torch.float32, device=dev)
        db = torch.empty(co, dtype=torch.float32, device=dev)
        scratch = torch.empty(size(b * h * w, ci, co, k, splits, int(with_dgrad)),
                              dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [x.data_ptr(), dy.data_ptr(), mul.data_ptr(), add.data_ptr()]
        if with_dgrad:
            wk = kernel.detach().to(x.dtype).contiguous()
            dx = torch.empty_like(x)
            dmul = torch.zeros(ci, dtype=torch.float32, device=dev)
            dadd = torch.zeros(ci, dtype=torch.float32, device=dev)
            ptrs += [wk.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
                     dmul.data_ptr(), dadd.data_ptr()]
        else:
            ptrs += [dw.data_ptr(), db.data_ptr()]
        err = fn(*ptrs, b, h, w, ci, co, k, pad_lo, float(slope), int(has_prologue),
                 _DTYPES[x.dtype], splits, scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    if with_dgrad:
        BWD_LAUNCHES += 1
        return dx, dw, db, dmul, dadd
    WGRAD_LAUNCHES += 1
    return dw, db


def _bwd_cpu(x, dy, mul, add, kernel, slope, pad_lo, has_prologue):
    with registry.autograd_inside():
        dx, dw, db, dmul, dadd = stage_bwd_reference(x, dy, mul, add, kernel, slope,
                                                     pad_lo, has_prologue)
    return dx, dw.float(), db.float(), dmul.float(), dadd.float()


def _bwd_fake(x, dy, mul, add, kernel, *_):
    f32 = dict(dtype=torch.float32, device=x.device)
    return (x.new_empty(x.shape), torch.empty(kernel.shape, **f32),
            torch.empty(kernel.shape[3], **f32), torch.empty(x.shape[3], **f32),
            torch.empty(x.shape[3], **f32))


_LIFTED_ARGS = "float slope, int pad_lo, bool has_prologue"
_FWD_OP = registry.define(
    f"stage_fwd(Tensor x, Tensor mul, Tensor add, Tensor kernel, Tensor bias, "
    f"{_LIFTED_ARGS}) -> Tensor",
    cpu=stage_reference, cuda=_launch_fwd,
    fake=lambda x, mul, add, kernel, *_: x.new_empty((*x.shape[:3], kernel.shape[3])))
_BWD_OP = registry.define(
    f"stage_bwd(Tensor x, Tensor dy, Tensor mul, Tensor add, Tensor kernel, "
    f"{_LIFTED_ARGS}) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    cpu=_bwd_cpu, cuda=_launch_bwd, fake=_bwd_fake)
_BWD_WGRAD_OP = registry.define(
    f"stage_bwd_wgrad(Tensor x, Tensor dy, Tensor mul, Tensor add, Tensor kernel, "
    f"{_LIFTED_ARGS}) -> (Tensor, Tensor)",
    cpu=lambda *args: _bwd_cpu(*args)[1:3],
    cuda=lambda *args: _launch_bwd(*args, with_dgrad=False),
    fake=lambda *args: _bwd_fake(*args)[1:3])


def stage_fwd(x, mul, add, kernel, bias, slope: float, pad_lo: int,
              has_prologue: bool = True) -> torch.Tensor:
    """The stage forward: the kernel for a CUDA tensor, ``stage_reference``
    for a CPU tensor."""
    _check(x, kernel, pad_lo)
    registry.check_device(x)
    return _FWD_OP(x, mul, add, kernel, bias, float(slope), int(pad_lo), bool(has_prologue))


def stage_bwd(x, dy, mul, add, kernel, slope: float, pad_lo: int,
              has_prologue: bool = True):
    """(dx, dW, db, dmul, dadd) of the stage: the kernels for CUDA tensors,
    ``stage_bwd_reference`` for CPU tensors. dW, db, dmul, dadd float32."""
    _check_bwd(x, dy, kernel, pad_lo)
    return _BWD_OP(x, dy, mul, add, kernel, float(slope), int(pad_lo), bool(has_prologue))


def stage_bwd_wgrad(x, dy, mul, add, kernel, slope: float, pad_lo: int,
                    has_prologue: bool = True):
    """(dW, db) of the stage, float32: ``stage_bwd``'s wgrad and db kernels
    alone (no dgrad) for CUDA tensors, ``stage_bwd_reference``'s for CPU
    tensors."""
    _check_bwd(x, dy, kernel, pad_lo)
    return _BWD_WGRAD_OP(x, dy, mul, add, kernel, float(slope), int(pad_lo),
                         bool(has_prologue))


def _check_bwd(x, dy, kernel, pad_lo):
    _check(x, kernel, pad_lo)
    if dy.shape[:3] != x.shape[:3] or dy.shape[3] != kernel.shape[3]:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x {tuple(x.shape)} "
                         f"and kernel {tuple(kernel.shape)}")
    registry.check_device(x)


class _StageFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mul, add, kernel, bias, slope, pad_lo, has_prologue):
        ctx.save_for_backward(x, mul, add, kernel)
        ctx.cfg = (slope, pad_lo, has_prologue, bias.dtype)
        return stage_fwd(x, mul, add, kernel, bias, slope, pad_lo, has_prologue)

    @staticmethod
    def backward(ctx, dy):
        return _stage_grads(ctx, dy) + (None, None, None)


def _stage_grads(ctx, dy):
    """(dx, dmul, dadd, dW, db) of the stage from the saved (x, mul, add,
    lifted kernel) by ``stage_bwd``; dmul and dadd None without a prologue."""
    x, mul, add, kernel = ctx.saved_tensors
    slope, pad_lo, has_prologue, bias_dtype = ctx.cfg
    dx, dw, db, dmul, dadd = stage_bwd(x, dy, mul, add, kernel, slope, pad_lo, has_prologue)
    if not has_prologue:
        dmul = dadd = None
    else:
        dmul, dadd = dmul.to(mul.dtype), dadd.to(add.dtype)
    return dx.to(x.dtype), dmul, dadd, dw.to(kernel.dtype), db.to(bias_dtype)


class _FineStageFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mul, add, weight, bias, slope, recipe, levels, has_prologue):
        ctx.save_for_backward(x, mul, add, weight)
        ctx.cfg = (slope, recipe, levels, has_prologue, bias.dtype)
        return stage_fwd_fine(x, mul, add, weight, bias, slope, recipe, levels, has_prologue)

    @staticmethod
    def backward(ctx, dy):
        x, mul, add, weight = ctx.saved_tensors
        slope, recipe, levels, has_prologue, bias_dtype = ctx.cfg
        args = (slope, recipe, levels, has_prologue)
        dx, dmul, dadd = stage_dgrad_fine(x, dy, mul, add, weight, *args)
        dw, db = stage_wgrad_fine(x, dy, mul, add, weight, *args)
        if not has_prologue:
            dmul = dadd = None
        else:
            dmul, dadd = dmul.to(mul.dtype), dadd.to(add.dtype)
        return ((dx.to(x.dtype), dmul, dadd, dw.to(weight.dtype), db.to(bias_dtype))
                + (None,) * 4)


def _no_prologue(x, mul, add):
    """(mul, add, has_prologue): ones and zeros when ``mul`` is None."""
    if mul is not None:
        return mul, add, True
    ci = x.shape[-1]
    return (torch.ones(ci, dtype=torch.float32, device=x.device),
            torch.zeros(ci, dtype=torch.float32, device=x.device), False)


def affine_act_conv(x: torch.Tensor, mul: Optional[torch.Tensor],
                    add: Optional[torch.Tensor], kernel: torch.Tensor,
                    bias: torch.Tensor, *, slope: float = 0.01,
                    pad_lo: int = 1) -> torch.Tensor:
    """y = conv_same(leaky_relu(x*mul + add, slope), kernel) + bias,
    differentiable in x, mul, add, kernel and bias.

    x (B, H, W, Ci) NHWC; mul/add (Ci,) per packed channel, or None for
    both (no prologue: the conv reads x itself); kernel (K, K, Ci, Co) the
    lifted kernel; bias (Co,) at packed width."""
    mul, add, has_prologue = _no_prologue(x, mul, add)
    return _StageFn.apply(x, mul, add, kernel, bias, float(slope), int(pad_lo),
                          bool(has_prologue))


def affine_act_conv_fine(x: torch.Tensor, mul: Optional[torch.Tensor],
                         add: Optional[torch.Tensor], weight: torch.Tensor,
                         bias: torch.Tensor, *, slope: float = 0.01, recipe: str,
                         levels: int) -> torch.Tensor:
    """``affine_act_conv`` on the fine grid: the same y from the base kernel
    ``weight`` (3, 3, Ci, Co) by ``stage_fwd_fine``; in the backward dx,
    dmul and dadd by ``stage_dgrad_fine``, dW (for ``weight`` itself) and db
    by ``stage_wgrad_fine``: the lifted op's gradients, summed in another
    order."""
    mul, add, has_prologue = _no_prologue(x, mul, add)
    return _FineStageFn.apply(x, mul, add, weight, bias, float(slope), recipe, int(levels),
                              bool(has_prologue))

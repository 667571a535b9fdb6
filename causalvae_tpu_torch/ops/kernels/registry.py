"""The port's kernels as ``torch.library`` operators, all in one namespace.

Every kernel entry of ``ops/kernels`` (attention, BatchNorm sums, ELBO terms,
stage convolutions) is an operator ``torch.ops.cvae.<name>`` with three
implementations:

- CUDA: the kernel's launch (``ctypes`` on ``data_ptr()``), which counts it;
- CPU: the kernel's plain PyTorch version;
- fake: the outputs' shapes, dtypes and (contiguous) strides from the
  inputs alone, so that ``torch.export`` and the other tracers of PyTorch
  trace through the kernel and an exported program calls it by name.

The Python wrappers of each module check their arguments and call the
operator; an argument the kernel takes as a Python number (a dropout rate, a
recipe) is in the operator's schema. Loading an exported program needs
these modules imported (``serve/export.py`` does it), not the model code.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

NAMESPACE = "cvae"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def _contiguous(out):
    if isinstance(out, tuple):
        return tuple(_contiguous(o) for o in out)
    return out if out is None else out.contiguous()


def define(schema: str, *, cpu: Callable, cuda: Callable, fake: Callable):
    """Define ``cvae::<schema>`` with its CPU, CUDA and fake implementations;
    returns the operator's overload (``torch.ops.cvae.<name>.default``). The
    CPU outputs are made contiguous, as the kernels write theirs and the
    fake kernels describe them."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, lambda *args: _contiguous(cpu(*args)), "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def check_device(x: torch.Tensor):
    """The operators have CUDA and CPU implementations only: another device
    (``meta`` among them, which the fake kernels would answer) raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")


@contextlib.contextmanager
def autograd_inside():
    """Record autograd inside an operator's implementation. The dispatcher
    runs an implementation below the autograd keys (under a tracer or a
    dispatch mode too), so a plain version that is itself an autograd
    backward (the stage gradients' references) re-enables them here."""
    exclude = torch._C._dispatch_tls_local_exclude_set()
    for key in (torch._C.DispatchKey.AutogradFunctionality,
                torch._C.DispatchKey.ADInplaceOrView,
                torch._C.DispatchKey.AutogradOther):
        exclude = exclude.remove(key)
    with torch._C._ForceDispatchKeyGuard(torch._C._dispatch_tls_local_include_set(),
                                         exclude), torch.enable_grad():
        yield

"""The random draws a training step makes on the host: the
reparameterisation noise (``models/vae.py reparameterize``, the MNIST
step's four draws in ``train/loop.py``) and the attention-dropout seeds
(``models/vit.py MultiHeadAttention.draw_seed``).

Eagerly (no tape open), each draw is made from the caller's
``torch.Generator`` as it always was, and the result is put on the device
the step needs it on: ``normal`` moves the noise there, ``seed`` writes the
uint32 seed into a 0-d int64 tensor there (``torch.full``: no host copy, no
synchronise), which the attention kernels read from device memory.

A CUDA graph cannot run the host's generator, so the scanned trainer
(``train/scan_loop.py``) opens a tape around each step it runs: a tape
records the draws' kinds and shapes in their order, or hands out, in that
order, views of the device buffers into which the host copied the group's
draws before the replay. ``nn.Dropout`` draws from torch's generator of
the device, which CUDA graphs replay on their own, and passes by here.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

import torch

_TAPE = None


def normal(shape: Sequence[int], dtype: torch.dtype, generator: Optional[torch.Generator],
           on, to) -> torch.Tensor:
    """``torch.randn(shape, generator=generator, device=on, dtype=dtype)``
    moved to ``to``; under a tape, the tape's."""
    if _TAPE is not None:
        return _TAPE.normal(tuple(shape), dtype, generator, on, to)
    return torch.randn(tuple(shape), generator=generator, device=on, dtype=dtype).to(to)


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """One uint32 from ``generator`` (the host's draw of an attention seed)."""
    return int(torch.randint(0, 2**32, (), generator=generator, dtype=torch.int64))


def seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """A uint32 attention-dropout seed drawn from ``generator``, as a 0-d
    int64 tensor on ``device``; under a tape, the tape's."""
    if _TAPE is not None:
        return _TAPE.seed(generator, device)
    return torch.full((), draw_seed(generator), dtype=torch.int64, device=device)


@contextlib.contextmanager
def taped(tape) -> Iterator[None]:
    """Route every draw of the block to ``tape`` (None: draw eagerly). A
    module variable, as ``parallel.mesh.global_batch``: the draws happen in
    the forward, and CUDA's autograd runs the backward in a thread of its
    own."""
    global _TAPE
    if tape is not None and _TAPE is not None:
        raise RuntimeError("a draw tape is already open")
    prev, _TAPE = _TAPE, tape
    try:
        yield
    finally:
        _TAPE = prev

"""The optimizers of the training steps (``causalvae_tpu/train/state.py``).

``ClippedAdam`` (the counterpart of ``adam_clipped``) is optax
``chain(clip_by_global_norm(max_norm), adam(lr, mu_dtype=...))`` in PyTorch,
with optax's default b1 0.9, b2 0.999 and eps 1e-8, step for step (optax
0.2.6). ``max_norm=None`` is ``adam_clipped``'s unclipped form, plain
``optax.adam(lr, mu_dtype=...)``: no norm, no clip (the MNIST workloads'
optimizers, with a float32 mu):

- clipping: with the global norm ‖g‖ over every gradient, g ← (g / ‖g‖)·max_norm
  only when ‖g‖ >= max_norm, with no epsilon (torch's ``clip_grad_norm_``
  adds 1e-6 and always rescales);
- Adam: mu = (1−b1)·g + b1'·mu and nu = (1−b2)·g² + b2·nu in float32, the
  stored mu read back as float32. b1' is b1 rounded to ``mu_dtype``: optax
  multiplies the stored moment by the weakly typed Python float b1, which
  JAX rounds to the moment's dtype (0.8984375 for 0.9 in bfloat16), and
  under ``jit`` XLA keeps that product in float32 (its default excess
  precision); the port follows the jitted step the JAX trainers run. The update
  (mu/(1−b1ᵗ)) / (√(nu/(1−b2ᵗ)) + eps) uses this step's float32 mu, and only
  then is mu stored in ``mu_dtype`` (bfloat16 for the vessel workload, which
  halves the first moment of the 126M-parameter ``decoder_input``); nu stays
  float32; the bias corrections are computed in float32.

``torch.optim.Adam`` has neither the bfloat16 first moment nor this
clipping, hence the class. The clip factor stays on the device (no host
sync).

As optax's ``opt_state``, the optimizer's state holds the step count (each
param group's ``"count"``), so ``state_dict()``/``load_state_dict()`` carry the
bias correction across a reload; and every parameter is updated at every
step, one without a gradient (``.grad`` None) as a zero gradient: its mu
and nu still decay and it still moves by the decayed moment.

Nothing of a step lives on the host, so that a CUDA graph can replay it
(``train/scan_loop.py``): the count is a 0-d int64 tensor on the
parameters' device, incremented in place, and the bias corrections
1 − b1ᵗ and 1 − b2ᵗ are computed there, the power in float64 and rounded
to float32 (the correctly rounded float32 power; the host's numpy float32
power it replaces differs by one ulp of b2ᵗ at t = 2958 and 3606 in the
first 20,000 steps); mu and nu are written in place (``copy_``), so their
addresses never change, across ``load_state_dict`` too. ``state_dict()``
gives the count as an int (the checkpoint format of earlier versions, which
load as they did); ``init_state()`` makes every moment before a first step.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch


B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults, which bench.py keeps


class ClippedAdam(torch.optim.Optimizer):
    """Global-norm clipping followed by Adam with a ``mu_dtype`` first
    moment; ``step()`` returns the global gradient norm before clipping (a
    0-d tensor on the parameters' device). ``max_norm=None`` skips the norm
    and the clip (``step()`` then returns None)."""

    def __init__(self, params: Iterable, lr: float, max_norm: Optional[float],
                 mu_dtype: torch.dtype):
        super().__init__(params, dict(lr=lr, count=0))
        self.max_norm = max_norm
        self.mu_dtype = mu_dtype
        self.b1_mu = float(torch.tensor(B1, dtype=mu_dtype))  # b1 rounded to mu_dtype
        for group in self.param_groups:
            self._count(group)

    @staticmethod
    def _count(group) -> torch.Tensor:
        """The group's step count as a 0-d int64 tensor on its parameters'
        device (a loaded or added group's int made into one)."""
        count = group["count"]
        if not isinstance(count, torch.Tensor):
            dev = group["params"][0].device if group["params"] else "cpu"
            count = group["count"] = torch.tensor(int(count), dtype=torch.int64, device=dev)
        return count

    def init_state(self) -> None:
        """Make every parameter's mu and nu (zeros, as a first step would)."""
        for group in self.param_groups:
            self._count(group)
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    state["nu"] = torch.zeros_like(p, dtype=torch.float32)

    def state_dict(self):
        sd = super().state_dict()
        for group in sd["param_groups"]:
            group["count"] = int(group["count"])
        return sd

    def load_state_dict(self, state_dict) -> None:
        # written into the tensors already held, so their addresses stay; torch
        # casts floating state to the parameter's dtype on load: the first
        # moment goes back to mu_dtype (exact: it was stored in it)
        counts = [g["count"] for g in self.param_groups]
        held = {p: dict(self.state[p]) for g in self.param_groups for p in g["params"]
                if self.state.get(p)}
        super().load_state_dict(state_dict)
        for group, old in zip(self.param_groups, counts):
            new = group["count"]
            group["count"] = old
            if isinstance(old, torch.Tensor):
                old.copy_(torch.as_tensor(new, dtype=torch.int64))
            else:
                self._count(group)
        for p, state in self.state.items():
            if "mu" in state:
                state["mu"] = state["mu"].to(self.mu_dtype)
            for key, before in held.get(p, {}).items():
                if key in state:
                    state[key] = before.copy_(state[key])

    @torch.no_grad()
    def step(self, closure=None) -> Optional[torch.Tensor]:
        if closure is not None:
            raise ValueError("ClippedAdam.step takes no closure")
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float()
                 for p in params]
        norm = None
        if self.max_norm is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = norm < self.max_norm
            grads = [torch.where(keep, g, g / norm * self.max_norm) for g in grads]
        at = {id(p): g for p, g in zip(params, grads)}
        for group in self.param_groups:
            count = self._count(group)
            count.add_(1)
            t = count.double()
            bc1 = 1 - torch.pow(_B1_F32, t).float()
            bc2 = 1 - torch.pow(_B2_F32, t).float()
            for p in group["params"]:
                g = at[id(p)]
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    state["nu"] = torch.zeros_like(p, dtype=torch.float32)
                mu = (1 - B1) * g + self.b1_mu * state["mu"].float()
                nu = (1 - B2) * (g * g) + B2 * state["nu"]
                update = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
                p.add_((update * -group["lr"]).to(p.dtype))
                state["mu"].copy_(mu)
                state["nu"].copy_(nu)
        return norm


_B1_F32, _B2_F32 = float(np.float32(B1)), float(np.float32(B2))  # as the float32 b1, b2

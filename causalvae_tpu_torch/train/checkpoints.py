"""Checkpoints with the reference's cadence, and resume
(``causalvae_tpu/train/checkpoints.py`` ``CheckpointBook``).

The cadence and names of the JAX book, per run directory:

  best     — on a lower val loss, with ``best.meta.json`` {"epoch", "val_loss"}
  latest   — every epoch, with ``latest.meta.json`` {"epoch"}
  epoch_N  — every ``period`` epochs

A checkpoint is one ``torch.save`` file, ``<name>.pt``, of
``{"model": model.state_dict(), "optimizer": optimizer.state_dict()}``: the
parameters, the BatchNorm running statistics, and ``ClippedAdam``'s
bfloat16 mu, float32 nu and per-group step count. Where the JAX trainer
saves a tuple of states (the MNIST pair ``(vae_state, d_state)``), the book
takes named parts in place of the model, ``{"vae": (vae, vae_opt), "disc":
(disc, d_opt)}``, and the file holds ``{"vae": {"model": ..., "optimizer":
...}, "disc": {...}}``; a restore loads the parts it is given (serving
restores the ``vae`` alone). The file is written under a
temporary name and renamed into place, so a crash while saving leaves the
previous file whole (orbax's save is atomic too). Loading reads with
``weights_only=True`` onto the model's device; a model is loaded strictly.

The JAX module's converters of reference PyTorch state dicts into flax
trees (``load_torch_checkpoint``, ``smart_port``,
``interpolate_pos_embedding``) are not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from causalvae_tpu_torch.device import module_device

# one model (its optimizer beside it), or named (model, optimizer) parts
Parts = Dict[str, Tuple[nn.Module, Optional[torch.optim.Optimizer]]]
Model = Union[nn.Module, Parts]


def _state(model: Model, optimizer) -> dict:
    if isinstance(model, dict):
        return {name: _state(m, opt) for name, (m, opt) in model.items()}
    return {"model": model.state_dict(), "optimizer": optimizer.state_dict()}


def _load(payload: dict, model: Model, optimizer) -> None:
    if isinstance(model, dict):
        for name, (m, opt) in model.items():
            _load(payload[name], m, opt)
        return
    model.load_state_dict(payload["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])


def device_of(model: Model) -> Optional[torch.device]:
    """The device of one model, or of the first of named parts."""
    if isinstance(model, dict):
        return module_device(next(iter(model.values()))[0])
    return module_device(model)


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class CheckpointBook:
    """best/latest/periodic checkpoint cadence + resume, per run directory."""

    def __init__(self, run_dir: str, period: int = 50):
        self.run_dir = os.path.abspath(run_dir)
        self.period = period
        self.best_val = float("inf")
        os.makedirs(self.run_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.run_dir, f"{name}.pt")

    # -- save ------------------------------------------------------------
    def _save(self, name: str, model: Model, optimizer: Optional[torch.optim.Optimizer],
              epoch: int):
        path = self.path(name)
        torch.save(_state(model, optimizer), path + ".tmp")
        os.replace(path + ".tmp", path)
        _write_json(os.path.join(self.run_dir, f"{name}.meta.json"), {"epoch": epoch})

    def end_of_epoch(self, model: Model, optimizer: Optional[torch.optim.Optimizer],
                     epoch: int, val_loss: Optional[float] = None):
        """Apply the reference cadence: latest every epoch, best on val-loss
        improvement, periodic snapshot every ``period`` epochs. ``model`` is
        one module with its ``optimizer``, or named parts (``optimizer``
        None)."""
        self._save("latest", model, optimizer, epoch)
        if val_loss is not None and val_loss < self.best_val:
            self.best_val = float(val_loss)
            self._save("best", model, optimizer, epoch)
            _write_json(os.path.join(self.run_dir, "best.meta.json"),
                        {"epoch": epoch, "val_loss": self.best_val})
        if self.period and (epoch + 1) % self.period == 0:
            self._save(f"epoch_{epoch + 1}", model, optimizer, epoch)

    # -- restore ----------------------------------------------------------
    def restore(self, name: str, model: Model,
                optimizer: Optional[torch.optim.Optimizer] = None) -> None:
        """Load checkpoint ``name`` into ``model`` (strictly) and, if given,
        ``optimizer``, in place; for named parts, into each part given (an
        optimizer of None is not loaded)."""
        payload = torch.load(self.path(name), map_location=device_of(model),
                             weights_only=True)
        _load(payload, model, optimizer)

    def restore_latest(self, model: Model,
                       optimizer: Optional[torch.optim.Optimizer] = None) -> int:
        """True resume: loads ``latest`` and returns the next epoch (0, and
        nothing loaded, if there is no checkpoint).

        Also restores the best-val watermark so a resumed run cannot
        overwrite a better pre-interruption 'best' checkpoint."""
        meta_path = os.path.join(self.run_dir, "latest.meta.json")
        if not os.path.exists(meta_path):
            return 0
        with open(meta_path) as f:
            epoch = json.load(f)["epoch"]
        best_meta = os.path.join(self.run_dir, "best.meta.json")
        if os.path.exists(best_meta):
            with open(best_meta) as f:
                self.best_val = float(json.load(f).get("val_loss", float("inf")))
        self.restore("latest", model, optimizer)
        return epoch + 1

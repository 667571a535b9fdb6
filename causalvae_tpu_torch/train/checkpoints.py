"""Checkpoints with the reference's cadence, and resume
(``causalvae_tpu/train/checkpoints.py`` ``CheckpointBook``).

The cadence and names of the JAX book, per run directory:

  best     — on a lower val loss, with ``best.meta.json`` {"epoch", "val_loss"}
  latest   — every epoch, with ``latest.meta.json`` {"epoch"}
  epoch_N  — every ``period`` epochs

A checkpoint is one ``torch.save`` file, ``<name>.pt``, of
``{"model": model.state_dict(), "optimizer": optimizer.state_dict()}``: the
parameters, the BatchNorm running statistics, and ``ClippedAdam``'s
bfloat16 mu, float32 nu and per-group step count. It is written under a
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
from typing import Optional

import torch
from torch import nn

from causalvae_tpu_torch.device import module_device


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
    def _save(self, name: str, model: nn.Module, optimizer: torch.optim.Optimizer,
              epoch: int):
        path = self.path(name)
        torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict()},
                   path + ".tmp")
        os.replace(path + ".tmp", path)
        _write_json(os.path.join(self.run_dir, f"{name}.meta.json"), {"epoch": epoch})

    def end_of_epoch(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                     epoch: int, val_loss: Optional[float] = None):
        """Apply the reference cadence: latest every epoch, best on val-loss
        improvement, periodic snapshot every ``period`` epochs."""
        self._save("latest", model, optimizer, epoch)
        if val_loss is not None and val_loss < self.best_val:
            self.best_val = float(val_loss)
            self._save("best", model, optimizer, epoch)
            _write_json(os.path.join(self.run_dir, "best.meta.json"),
                        {"epoch": epoch, "val_loss": self.best_val})
        if self.period and (epoch + 1) % self.period == 0:
            self._save(f"epoch_{epoch + 1}", model, optimizer, epoch)

    # -- restore ----------------------------------------------------------
    def restore(self, name: str, model: nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None) -> None:
        """Load checkpoint ``name`` into ``model`` (strictly) and, if given,
        ``optimizer``, in place."""
        payload = torch.load(self.path(name), map_location=module_device(model),
                             weights_only=True)
        model.load_state_dict(payload["model"], strict=True)
        if optimizer is not None:
            optimizer.load_state_dict(payload["optimizer"])

    def restore_latest(self, model: nn.Module,
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

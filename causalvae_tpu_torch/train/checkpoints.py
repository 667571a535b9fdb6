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

Reference PyTorch checkpoints (the JAX module's converter half):
``load_torch_checkpoint`` reads a reference ``torch.save`` file, bare or
under ``model_state_dict``; ``smart_port`` fills a port ``state_dict`` from
it through a name map (``train/port_maps.py`` ``port_*_checkpoint``) with
the reference's ``load_state_dict(strict=False)`` semantics; and
``interpolate_pos_embedding`` resizes a ViT positional embedding to another
token grid on the way.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

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


# ---------------------------------------------------------------------------
# Reference PyTorch checkpoints -> port state dicts
# ---------------------------------------------------------------------------

# {port state_dict key: (reference key, converter of the reference tensor)}
NameMap = Dict[str, Tuple[str, Callable[[torch.Tensor], torch.Tensor]]]


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``torch.save`` file as {key: CPU tensor}: a bare
    ``state_dict`` or a dict holding one under ``model_state_dict``.

    It reads with ``weights_only=False``, as the JAX function does, so it
    unpickles arbitrary objects: load only files you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("model_state_dict", blob) if isinstance(blob, dict) else blob
    return {k: v.detach().cpu() for k, v in state.items()}


def interpolate_pos_embedding(pos: torch.Tensor, src_hw: Tuple[int, int],
                              dst_hw: Tuple[int, int]) -> torch.Tensor:
    """Bicubic 2-D resize of a ViT positional embedding (1, src_h·src_w + 1,
    E) -> (1, dst_h·dst_w + 1, E), the CLS token kept (the shape-adaptive
    load of ref latent_translator/main.py:35-87). ``F.interpolate``'s
    antialiased bicubic is Keys' cubic with a = -0.5, widened when it
    downscales: ``jax.image.resize(..., "bicubic")``'s kernel."""
    cls_tok, grid = pos[:, :1], pos[:, 1:]
    (sh, sw), (dh, dw) = src_hw, dst_hw
    e = grid.shape[-1]
    grid = grid.reshape(1, sh, sw, e).permute(0, 3, 1, 2).float()
    resized = F.interpolate(grid, size=(dh, dw), mode="bicubic", align_corners=False,
                            antialias=True)
    resized = resized.permute(0, 2, 3, 1).reshape(1, dh * dw, e).to(pos.dtype)
    return torch.cat([cls_tok, resized], dim=1)


def smart_port(target: Dict[str, torch.Tensor], torch_state: Dict, name_map: NameMap, *,
               pos_embedding_key: Optional[str] = None,
               src_grid: Optional[Tuple[int, int]] = None,
               dst_grid: Optional[Tuple[int, int]] = None,
               strict: bool = False) -> Tuple[Dict[str, torch.Tensor], List[tuple]]:
    """Fill the port state dict ``target`` from a reference state dict
    (tensors or numpy arrays) through ``name_map``: (ported, skipped).

    The reference's ``load_state_dict(strict=False)`` semantics (ref
    vessel_analysis/00_core/models.py:203-206): a reference key that is
    absent (``"missing"``) or converts to another shape (``"shape ... !=
    ..."``) is skipped and reported, and the entry keeps its value in
    ``target``; ``strict=True`` raises ``KeyError`` for an absent key. A
    mismatched ``pos_embedding_key`` is resized from ``src_grid`` to
    ``dst_grid`` first when both are given. Ported entries take the target
    entry's dtype and device."""
    out = dict(target)
    skipped = []
    for key, (tkey, conv) in name_map.items():
        if tkey not in torch_state:
            if strict:
                raise KeyError(tkey)
            skipped.append((key, "missing"))
            continue
        arr = conv(torch.as_tensor(torch_state[tkey]))
        want = tuple(out[key].shape)
        if tuple(arr.shape) != want:
            if (pos_embedding_key is not None and key == pos_embedding_key
                    and src_grid is not None and dst_grid is not None):
                arr = interpolate_pos_embedding(arr, src_grid, dst_grid)
            if tuple(arr.shape) != want:
                skipped.append((key, f"shape {tuple(arr.shape)} != {want}"))
                continue
        out[key] = arr.to(device=out[key].device, dtype=out[key].dtype).contiguous()
    return out, skipped

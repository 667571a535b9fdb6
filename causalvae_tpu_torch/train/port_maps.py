"""JAX variables -> port state_dict (inverse of ``causalvae_tpu/train/port_maps.py``).

``from_jax_variables(model, variables)`` takes the JAX ``{"params",
"batch_stats"}`` tree as nested dicts of numpy arrays and returns a
``state_dict`` that ``model`` loads with ``strict=True``. The JAX module path
of every leaf names the port module; the port module's type names the layout
conversion:

- Dense kernel (in, out) -> Linear weight (out, in); the attention ``qkv``
  DenseGeneral kernel (E, 3, H, D) -> ``reshape(E, 3E).T``, its bias
  (3, H, D) -> (3E,);
- Conv kernel HWIO -> OIHW;
- transposed-conv kernel (kH, kW, C_out, C_in) (flax ``transpose_kernel``) ->
  torch (C_in, C_out, kH, kW), both by ``transpose(3, 2, 0, 1)``;
- LayerNorm ``scale`` -> ``weight``; BatchNorm ``scale``/``bias``/``mean``/
  ``var`` keep their names (the port's BatchNorm uses the JAX ones);
- a bare parameter (``pos_embedding``, ``DAGMechanism``'s ``w1``...) keeps
  its name and layout.

flax auto-names (``Dense_0``, ``LayerNorm_1``...) become the port's attribute
names through the port module's own ``jax_names`` where it has one (the
heads of ``models/heads.py``), else through ``_RENAME`` (the ViT and ResNet
blocks'), and a flax list member ``blocks_3`` becomes ``blocks.3``.

``decoder_input`` needs no row permutation: the port keeps the JAX (gh, gw, E)
output order and permutes the activation instead (models/vit.py). Every JAX
leaf is consumed exactly once; a leaf with no port home, a port key with no
JAX leaf, or a shape mismatch raises.

A tree without ``batch_stats`` (JAX gradients, say) maps to the model's
parameters only: every layout conversion above is linear, so gradients
convert as the parameters do.

``from_jax_stacked_variables(models, stacked)`` does the same for a k-fold
ensemble: JAX stacks the fold trees along a leading axis K; member f of
``models`` gets the state dict of fold f's slice.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from causalvae_tpu_torch.ops.kernels.batchnorm import BatchNorm

# flax auto-names inside ViTBlock / ResBlock -> the port's attribute names
_RENAME = {
    "LayerNorm_0": "norm1", "LayerNorm_1": "norm2",
    "Dense_0": "fc1", "Dense_1": "fc2",
    "Conv_0": "conv0", "Conv_1": "conv1",
    "BatchNorm_0": "bn0", "BatchNorm_1": "bn1",
}
_LIST_ITEM = re.compile(r"^(.+)_(\d+)$")  # flax list member "blocks_3" -> "blocks.3"


def _flatten(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _module_path(model: nn.Module, jax_path: Tuple[str, ...]) -> str:
    """The port module path of a JAX module path. A port module's own
    ``jax_names`` (flax auto-name -> attribute) renames its children first;
    then ``_RENAME`` and the list-member rule."""
    parts = []
    module = model
    for seg in jax_path:
        own = getattr(module, "jax_names", {}) if module is not None else {}
        if seg in own:
            parts.append(own[seg])
        elif seg in _RENAME:
            parts.append(_RENAME[seg])
        elif _LIST_ITEM.match(seg):
            parts.append(_LIST_ITEM.sub(r"\1.\2", seg))
        else:
            parts.append(seg)
        try:
            module = model.get_submodule(".".join(parts))
        except AttributeError:
            module = None
    return ".".join(parts)


def _convert(module: nn.Module, leaf: str, value: np.ndarray, mod_path: str
             ) -> Tuple[str, np.ndarray]:
    """(port parameter name, converted array) for one JAX leaf."""
    if isinstance(module, nn.Linear):
        if leaf == "kernel":
            return "weight", value.reshape(value.shape[0], -1).T
        if leaf == "bias":
            return "bias", value.reshape(-1)
    elif isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
        if leaf == "kernel":
            return "weight", value.transpose(3, 2, 0, 1)
        if leaf == "bias":
            return "bias", value
    elif isinstance(module, nn.LayerNorm):
        if leaf in ("scale", "bias"):
            return {"scale": "weight", "bias": "bias"}[leaf], value
    elif isinstance(module, BatchNorm):
        if leaf in ("scale", "bias", "mean", "var"):
            return leaf, value
    elif leaf in dict(module.named_parameters(recurse=False)):
        return leaf, value  # a bare parameter (pos_embedding, cls_token)
    raise KeyError(f"JAX leaf {leaf!r} has no home in port module "
                   f"{mod_path or '<root>'} ({type(module).__name__})")


def from_jax_variables(model: nn.Module, variables: Dict) -> Dict[str, torch.Tensor]:
    """State dict for ``model`` from JAX variables (numpy leaves); for a
    params-only tree, the entries of ``model``'s parameters."""
    target = model.state_dict()
    if "batch_stats" not in variables:
        target = {k: target[k] for k, _ in model.named_parameters()}
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            mod_path = _module_path(model, path[:-1])
            try:
                module = model.get_submodule(mod_path)
            except AttributeError:
                raise KeyError(f"JAX leaf {collection}/{'/'.join(path)} has no "
                               f"port module {mod_path!r}") from None
            name, arr = _convert(module, path[-1], value, mod_path)
            key = f"{mod_path}.{name}" if mod_path else name
            if key not in target:
                raise KeyError(f"JAX leaf {collection}/{'/'.join(path)} maps to "
                               f"{key!r}, which the port model does not have")
            if key in out:
                raise KeyError(f"two JAX leaves map to {key!r}")
            ref = target[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: JAX {'/'.join(path)} converts to shape "
                                 f"{arr.shape}, port expects {tuple(ref.shape)}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(ref.dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port keys with no JAX leaf: {missing}")
    return out


def _slice_tree(tree: Dict, f: int) -> Dict:
    return {k: _slice_tree(v, f) if isinstance(v, dict) else np.asarray(v)[f]
            for k, v in tree.items()}


def from_jax_stacked_variables(models: Sequence[nn.Module], stacked: Dict
                               ) -> List[Dict[str, torch.Tensor]]:
    """One state dict per fold model from JAX variables stacked along a
    leading fold axis (numpy leaves): fold f's slice through
    ``from_jax_variables`` for ``models[f]``. Every leaf's leading axis must
    be ``len(models)``."""
    k = len(models)
    for path, value in _flatten(stacked):
        if value.ndim == 0 or value.shape[0] != k:
            raise ValueError(f"JAX leaf {'/'.join(path)} of shape {value.shape} has no "
                             f"leading fold axis of {k}")
    return [from_jax_variables(model, _slice_tree(stacked, f))
            for f, model in enumerate(models)]

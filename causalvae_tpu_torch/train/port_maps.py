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
heads of ``models/heads.py``, ``MDecoder``'s ``Dense_0`` and
``ConvTranspose_0/1``), else through ``_RENAME`` (the ViT and ResNet
blocks'), and a flax list member ``blocks_3`` becomes ``blocks.3``. Named
flax modules (``CausalConvVAE``, ``ConditionalVAE``) map by their names.

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

Reference PyTorch checkpoints -> port (the other half of the JAX module):
``port_mnist_checkpoint`` (C1/C4), ``port_simple_checkpoint`` with
``conditional_vae_name_maps`` (C5) or ``cascade_vae_name_maps`` (C10),
``port_vessel_cnn_checkpoint`` (C7) and ``port_vitvae_checkpoint`` (C8, and
C9 with ``causal``) each take the port model and a reference state dict
(``checkpoints.load_torch_checkpoint``) and return ``(state_dict,
skipped)``: a state dict the model loads with ``strict=True``, and the
(port key, reason) pairs ``checkpoints.smart_port`` skipped. The name maps
go from reference keys straight to port keys, ``{port key: (reference key,
converter)}``, in the JAX maps' order; both sides are torch layouts, so
most entries are renames: BatchNorm ``weight``/``running_mean``/
``running_var`` -> ``scale``/``mean``/``var`` (``num_batches_tracked`` is
not read), ``in_proj_weight`` is the port's ``qkv`` as it is, and the one
layout change is at the conv/fc boundaries, where the reference flattens
and views NCHW (channel-major) and the port keeps the JAX NHWC order: the
columns of a Linear that reads a flattened map (``_hwc_columns``) and the
rows of one whose output is viewed as a map (``_hwc_rows``: the MNIST and
C5 ``dec_fc``, C10's ``dec_input``, C7's ``dec_fc2``, the ViT's
``decoder_input``) are permuted chw -> hwc.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from causalvae_tpu_torch.ops.kernels.batchnorm import BatchNorm
from causalvae_tpu_torch.train.checkpoints import NameMap, smart_port

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
            if arr.dtype.name == "bfloat16":  # ml_dtypes, which torch cannot take;
                arr = arr.astype(np.float32)  # the widening is exact
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


# ---------------------------------------------------------------------------
# Reference PyTorch checkpoints -> port state dicts
# ---------------------------------------------------------------------------

Maps = Tuple[NameMap, NameMap]  # (parameters, BatchNorm running statistics)


def _id(a: torch.Tensor) -> torch.Tensor:
    return a


def _hwc_columns(c: int, h: int, w: int):
    """Converter for a Linear weight that reads a flattened (c, h, w) map:
    the reference flattens it channel-major, the port in (h, w, c) order, so
    the first c·h·w columns are permuted; the trailing ones (M, T) pass."""

    def conv(wt: torch.Tensor) -> torch.Tensor:
        img = wt[:, :c * h * w].reshape(-1, c, h, w).permute(0, 2, 3, 1)
        return torch.cat([img.reshape(-1, c * h * w), wt[:, c * h * w:]], dim=1)

    return conv


def _hwc_rows(c: int, h: int, w: int):
    """Converter for the weight or bias of a Linear whose output is viewed
    as a (c, h, w) map by the reference and as (h, w, c) by the port: its
    rows permuted chw -> hwc."""

    def conv(wt: torch.Tensor) -> torch.Tensor:
        return wt.reshape(c, h, w, *wt.shape[1:]).movedim(0, 2).reshape(wt.shape)

    return conv


def _linear(P: NameMap, port: str, ref: str, conv_w=_id, conv_b=_id):
    """A layer's weight and bias (Linear, Conv2d, ConvTranspose2d, LayerNorm)."""
    P[f"{port}.weight"] = (f"{ref}.weight", conv_w)
    P[f"{port}.bias"] = (f"{ref}.bias", conv_b)


def _bn(port: str, ref: str, P: NameMap, S: NameMap):
    P[f"{port}.scale"] = (f"{ref}.weight", _id)
    P[f"{port}.bias"] = (f"{ref}.bias", _id)
    S[f"{port}.mean"] = (f"{ref}.running_mean", _id)
    S[f"{port}.var"] = (f"{ref}.running_var", _id)


# torch stem Sequential indices: conv at 0,3,6,9,12; BN at 1,4,7,10,13
_STEM_CONV_IDX = (0, 3, 6, 9, 12)
_STEM_BN_IDX = (1, 4, 7, 10, 13)


def _dec_indices(dec_res_stages: int):
    """Reference ViTVAE decoder Sequential indices (ConvTranspose, BatchNorm,
    ResBlock, output conv) when the first ``dec_res_stages`` stages are
    followed by a ResBlock: 3 in the vessel backbone (ref vessel_analysis/
    00_core/vit_backbone.py:124-156), 4 in the latent translator's (ref
    latent_translator/models.py:86-93)."""
    ct, bn, res = [], [], []
    pos = 0
    for i in range(5):
        ct.append(pos)
        bn.append(pos + 1)
        pos += 3  # ConvTranspose, BatchNorm, LeakyReLU
        if i < dec_res_stages:
            res.append(pos)
            pos += 1
    return tuple(ct), tuple(bn), tuple(res), pos


def vitvae_name_maps(*, depth: int = 6, embed_dim: int = 256, prefix: str = "",
                     dec_res_stages: int = 3,
                     grid_hw: Optional[Tuple[int, int]] = None) -> Maps:
    """Maps of the ViTVAE (ref vessel_analysis/00_core/vit_backbone.py:50-156,
    near-duplicate latent_translator/models.py:40-126); ``prefix``
    "backbone." inside CausalViTVAE (the same on both sides). The arguments
    are keywords: the JAX function's ``heads`` (its qkv layout) has no
    counterpart, since the port's ``qkv`` is the reference's ``in_proj``
    as it is. ``grid_hw`` is
    the reference model's (gh, gw), which ``decoder_input``'s row permutation
    needs; without it its rows are taken as they are (the JAX fallback)."""
    ct_idx, bn_idx, res_idx, out_idx = _dec_indices(dec_res_stages)
    pre = prefix
    P: NameMap = {}
    S: NameMap = {}
    for i, (ci, bi) in enumerate(zip(_STEM_CONV_IDX, _STEM_BN_IDX)):
        _linear(P, f"{pre}stem_convs.{i}", f"{pre}stem.{ci}")
        _bn(f"{pre}stem_bns.{i}", f"{pre}stem.{bi}", P, S)
    P[f"{pre}pos_embedding"] = (f"{pre}pos_embedding", _id)
    P[f"{pre}cls_token"] = (f"{pre}cls_token", _id)
    for d in range(depth):
        pb, tb = f"{pre}blocks.{d}", f"{pre}transformer.{d}"
        _linear(P, f"{pb}.norm1", f"{tb}.norm1")
        P[f"{pb}.attn.qkv.weight"] = (f"{tb}.attn.in_proj_weight", _id)
        P[f"{pb}.attn.qkv.bias"] = (f"{tb}.attn.in_proj_bias", _id)
        _linear(P, f"{pb}.attn.proj", f"{tb}.attn.out_proj")
        _linear(P, f"{pb}.norm2", f"{tb}.norm2")
        _linear(P, f"{pb}.fc1", f"{tb}.mlp.0")
        _linear(P, f"{pb}.fc2", f"{tb}.mlp.3")
    for name in ("to_latent", "fc_mu", "fc_var"):
        _linear(P, f"{pre}{name}", f"{pre}{name}")
    rows = _hwc_rows(embed_dim, *grid_hw) if grid_hw is not None else _id
    _linear(P, f"{pre}decoder_input", f"{pre}decoder_input", rows, rows)
    for i, (ci, bi) in enumerate(zip(ct_idx, bn_idx)):
        _linear(P, f"{pre}dec_ct.{i}", f"{pre}decoder.{ci}")
        _bn(f"{pre}dec_bns.{i}", f"{pre}decoder.{bi}", P, S)
    for i, ri in enumerate(res_idx):
        pr, tr = f"{pre}dec_res.{i}", f"{pre}decoder.{ri}.conv"
        _linear(P, f"{pr}.conv0", f"{tr}.0")
        _bn(f"{pr}.bn0", f"{tr}.1", P, S)
        _linear(P, f"{pr}.conv1", f"{tr}.3")
        _bn(f"{pr}.bn1", f"{tr}.4", P, S)
    _linear(P, f"{pre}dec_out", f"{pre}decoder.{out_idx}")
    return P, S


def causal_vitvae_name_maps(*, depth: int = 6, embed_dim: int = 256, dec_res_stages: int = 3,
                            grid_hw: Optional[Tuple[int, int]] = None) -> Maps:
    """Maps of the CausalViTVAE: the backbone's, the adapters and the
    Gaussian mechanism (ref vessel_analysis/00_core/models.py:207-250)."""
    P, S = vitvae_name_maps(depth=depth, embed_dim=embed_dim, prefix="backbone.",
                            dec_res_stages=dec_res_stages, grid_hw=grid_hw)
    for port, ref in (("enc_adapter_fc1", "enc_adapter.0"), ("enc_adapter_fc2", "enc_adapter.3"),
                      ("dec_adapter_fc1", "dec_adapter.0"), ("dec_adapter_fc2", "dec_adapter.3")):
        _linear(P, port, ref)
    _bn("enc_adapter_bn", "enc_adapter.1", P, S)
    _bn("dec_adapter_bn", "dec_adapter.1", P, S)
    _gaussian_morph(P, "morph_predictor_shared", (0, 2))
    return P, S


def _gaussian_morph(P: NameMap, shared: str, idx: Sequence[int]):
    """The Gaussian mechanism: the shared trunk's Linears at ``idx`` of the
    reference's ``shared`` Sequential, and the mu / logvar heads."""
    for i, ti in enumerate(idx):
        _linear(P, f"morph.shared.{i}", f"{shared}.{ti}")
    for head in ("mu", "logvar"):
        _linear(P, f"morph.{head}", f"morph_predictor_{head}")


def causal_conv_vae_name_maps(gaussian: bool = False) -> Maps:
    """Maps of the MNIST CausalConvVAE against the reference's
    CausalMorphVAE12 (C1, ref mnist_test/01 models.py:6-48; C4 with
    ``gaussian``, ref mnist_test/06 models.py:6-50)."""
    P: NameMap = {}
    _linear(P, "enc_conv1", "enc_conv.0")
    _linear(P, "enc_conv2", "enc_conv.2")
    _linear(P, "enc_fc1", "enc_fc.0", _hwc_columns(64, 7, 7))
    _linear(P, "enc_fc2", "enc_fc.2")
    if gaussian:
        _gaussian_morph(P, "morph_predictor_shared", (0,))
    else:
        _linear(P, "morph.shared.0", "morph_predictor.0")
        _linear(P, "morph.out", "morph_predictor.2")
    rows = _hwc_rows(64, 7, 7)
    _linear(P, "dec_fc", "dec_fc.0", rows, rows)
    _linear(P, "dec_conv1", "dec_conv.0")
    _linear(P, "dec_conv2", "dec_conv.2")
    return P, {}


def conditional_vae_name_maps() -> Maps:
    """Maps of the MNIST CVAE against the reference's ConditionalVAE (C5,
    ref mnist_test/03 cvae_models.py:7-85)."""
    P: NameMap = {}
    for i, ci in enumerate((0, 2, 4)):
        _linear(P, f"enc_conv{i + 1}", f"enc_conv.{ci}")
    for head in ("mu", "logvar"):
        _linear(P, f"fc_{head}", f"enc_fc_{head}", _hwc_columns(64, 3, 3))
    rows = _hwc_rows(64, 7, 7)
    _linear(P, "dec_fc", "dec_fc", rows, rows)
    _linear(P, "dec_conv1", "dec_conv.0")
    _linear(P, "dec_conv2", "dec_conv.2")
    return P, {}


def cascade_vae_name_maps() -> Maps:
    """Maps of the cascade VAE against the reference's CausalBioVAE (C10,
    ref causal_cascade/models.py:5-89)."""
    P: NameMap = {}
    S: NameMap = {}
    for i, ci in enumerate((0, 2, 4, 6)):
        _linear(P, f"enc_convs.{i}", f"enc_conv.{ci}")
    _linear(P, "enc_fc1", "enc_fc.0", _hwc_columns(256, 4, 4))
    _linear(P, "enc_fc2", "enc_fc.2")
    for head in ("mu", "logvar"):
        _linear(P, f"fc_{head}", f"fc_{head}")
    _linear(P, "mechanism.shared.0", "mechanism_net.0")
    _bn("mechanism.shared_bn.0", "mechanism_net.1", P, S)
    _linear(P, "mechanism.shared.1", "mechanism_net.3")
    _linear(P, "mechanism.out", "mechanism_net.5")
    rows = _hwc_rows(256, 4, 4)
    _linear(P, "dec_input", "dec_input", rows, rows)
    for i, ci in enumerate((0, 2, 4)):
        _linear(P, f"dec_convs.{i}", f"dec_conv.{ci}")
    _linear(P, "dec_out", "dec_conv.6")
    return P, S


# CausalVesselVAE (C7) reference Sequential indices; the live dec_conv only
# (the first definition at ref models.py:71-105 is dead code, overwritten at
# :108, so state dicts carry the second)
_VES_ENC_CONV_IDX = (0, 3, 6, 9, 12, 15, 18)
_VES_ENC_BN_IDX = (1, 4, 7, 10, 13, 16, 19)
_VES_DEC_CONV_IDX = (1, 5, 9, 13, 17, 21)
_VES_DEC_BN_IDX = (2, 6, 10, 14, 18, 22)
_VES_DEC_OUT_IDX = 25


def causal_vessel_vae_name_maps(grid_hw: Tuple[int, int] = (6, 10)) -> Maps:
    """Maps of the CNN vessel VAE against the reference's CausalVesselVAE (C7,
    ref vessel_analysis/00_core/models.py:9-166)."""
    gh, gw = grid_hw
    P: NameMap = {}
    S: NameMap = {}
    for i, (ci, bi) in enumerate(zip(_VES_ENC_CONV_IDX, _VES_ENC_BN_IDX)):
        _linear(P, f"enc_convs.{i}", f"enc_conv.{ci}")
        _bn(f"enc_bns.{i}", f"enc_conv.{bi}", P, S)
    _linear(P, "enc_fc1", "enc_fc.0", _hwc_columns(512, gh, gw))
    _bn("enc_fc_bn", "enc_fc.1", P, S)
    _linear(P, "enc_fc2", "enc_fc.3")
    _gaussian_morph(P, "morph_predictor_shared", (0, 2))
    _linear(P, "dec_fc1", "dec_fc.0")
    _bn("dec_fc_bn", "dec_fc.1", P, S)
    rows = _hwc_rows(512, gh, gw)
    _linear(P, "dec_fc2", "dec_fc.3", rows, rows)
    for i, (ci, bi) in enumerate(zip(_VES_DEC_CONV_IDX, _VES_DEC_BN_IDX)):
        _linear(P, f"dec_convs.{i}", f"dec_conv.{ci}")
        _bn(f"dec_bns.{i}", f"dec_conv.{bi}", P, S)
    _linear(P, "dec_out", f"dec_conv.{_VES_DEC_OUT_IDX}")
    return P, S


def port_simple_checkpoint(model: nn.Module, torch_state: Dict, maps: Maps
                           ) -> Tuple[Dict[str, torch.Tensor], List[tuple]]:
    """A reference state dict through precomputed ``maps`` into ``model``'s
    state dict, the parameters' map first, then the running statistics'
    (the JAX order of ``skipped``): the C5 and C10 entry
    (``conditional_vae_name_maps``, ``cascade_vae_name_maps``)."""
    out, skipped = smart_port(model.state_dict(), torch_state, maps[0])
    out, skipped_s = smart_port(out, torch_state, maps[1])
    return out, skipped + skipped_s


def port_mnist_checkpoint(model: nn.Module, torch_state: Dict, *, gaussian: bool = False
                          ) -> Tuple[Dict[str, torch.Tensor], List[tuple]]:
    """A reference CausalMorphVAE12 state dict into ``CausalConvVAE`` (C1;
    C4 with ``gaussian``)."""
    return port_simple_checkpoint(model, torch_state, causal_conv_vae_name_maps(gaussian))


def port_vessel_cnn_checkpoint(model: nn.Module, torch_state: Dict,
                               grid_hw: Tuple[int, int] = (6, 10)
                               ) -> Tuple[Dict[str, torch.Tensor], List[tuple]]:
    """A reference CausalVesselVAE state dict into ``CausalVesselVAE`` (C7),
    parameters and BatchNorm running statistics."""
    return port_simple_checkpoint(model, torch_state, causal_vessel_vae_name_maps(grid_hw))


def port_vitvae_checkpoint(model: nn.Module, torch_state: Dict, *, causal: bool = False,
                           depth: int = 6, embed_dim: int = 256, dec_res_stages: int = 3,
                           grid_hw: Optional[Tuple[int, int]] = None,
                           src_grid: Optional[Tuple[int, int]] = None,
                           dst_grid: Optional[Tuple[int, int]] = None
                           ) -> Tuple[Dict[str, torch.Tensor], List[tuple]]:
    """A reference ViTVAE (C8) or, with ``causal``, CausalViTVAE (C9) state
    dict into the port model. ``dec_res_stages`` 3 for the vessel family, 4
    for latent-translator checkpoints. ``grid_hw`` is the reference model's
    decoder grid (``decoder_input``'s rows), by default ``src_grid``, then
    ``dst_grid``; given both, a positional embedding of another grid is
    resized from ``src_grid`` to ``dst_grid``. Map rows whose port key the
    model does not have are skipped as ``"not-instantiated"``: the causal
    wrapper's backbone has no ``fc_mu``/``fc_var`` (the reference reads the
    CLS token directly, ref models.py:281-302), so those reference weights
    have no home, as under the reference's ``load_state_dict(strict=False)``."""
    maps = (causal_vitvae_name_maps if causal else vitvae_name_maps)(
        depth=depth, embed_dim=embed_dim, dec_res_stages=dec_res_stages,
        grid_hw=grid_hw or src_grid or dst_grid)
    target = model.state_dict()
    absent = [k for k in maps[0] if k not in target]
    out, skipped = smart_port(target, torch_state,
                              {k: v for k, v in maps[0].items() if k in target},
                              pos_embedding_key=("backbone." if causal else "") + "pos_embedding",
                              src_grid=src_grid, dst_grid=dst_grid)
    out, skipped_s = smart_port(out, torch_state, maps[1])
    return out, skipped + [(k, "not-instantiated") for k in absent] + skipped_s

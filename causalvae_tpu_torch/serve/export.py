"""Deployment bundles through ``torch.export`` (``causalvae_tpu/serve/export.py``).

``export_endpoints`` exports each serving endpoint (serve/endpoints.py) at a
ladder of static batch-size buckets and writes each program with
``torch.export.save``. A ``BoundEndpoint``'s weights are NOT in its programs:
each program takes the bound model's parameters and buffers as its leading
inputs (``torch.func.functional_call``), and the weights are written ONCE per
bound model as an ``.npz`` blob, so a flagship-sized model gives small
per-bucket programs plus one shared weights file:

    out/
      manifest.json            # shapes, dtypes, buckets, platform, versions
      params.0.npz             # weight leaves, shared across endpoints
      encode.b1.pt2            # torch.export.save archive (small program)
      encode.b8.pt2
      ...

A serving host then needs only ``load_exported(out)``: no model code (nothing
under ``causalvae_tpu_torch.models`` is imported) and no tracing. The
programs call the kernels as the ``cvae`` operators of ``ops/kernels``
(imported here, which registers them), so an exported call launches the same
kernels as an eager one. ``ExportedBundle`` moves the weights to the device
once and routes a request of any batch size to the smallest bucket that fits
(padding by row repetition, slicing the result back; chunking above the top
bucket).

A bundle records the device type it was exported on (``platform``): its
programs hold that device in their constants and allocations, so it loads
only on that type, and ``load_exported`` refuses another rather than moving
a program. Serving elsewhere means exporting again there.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.export.graph_signature import InputKind, OutputKind
from torch.utils import _pytree as pytree

from causalvae_tpu_torch.device import DeviceLike, resolve_device
# the cvae operators the exported programs call
from causalvae_tpu_torch.ops.kernels import attention, batchnorm, elbo, stage  # noqa: F401

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 8, 32)
FORMAT = "causalvae-tpu-torch.serve/1"
_MANIFEST = "manifest.json"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _save_leaves(path: str, leaves) -> list:
    """Write tensors as ``p0..pN`` in one npz; bfloat16 (which the npy format
    cannot hold) is stored bit-cast to uint16. Returns the per-leaf dtype
    names for the manifest."""
    arrs, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        t = leaf.detach().cpu()
        dtypes.append(_dtype_name(t.dtype))
        if t.dtype == torch.bfloat16:
            arrs[f"p{i}"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrs[f"p{i}"] = t.numpy()
    np.savez(path, **arrs)
    return dtypes


def _load_leaves(path: str, dtypes: Sequence[str], device: torch.device) -> list:
    out = []
    with np.load(path) as z:
        for i, dt in enumerate(dtypes):
            a = z[f"p{i}"]
            if dt == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            if t.dtype != getattr(torch, dt):
                raise ValueError(f"{path}: leaf p{i} is {t.dtype}, the manifest says {dt}")
            out.append(t.to(device))
    return out


class _Call(nn.Module):
    """``fn(model, *args)`` as a module's forward."""

    def __init__(self, fn: Callable, model: nn.Module):
        super().__init__()
        self.fn, self.model = fn, model

    def forward(self, *args):
        return self.fn(self.model, *args)


class _Flat(nn.Module):
    """``fn_flat(*leaves, *args)``: the endpoint with the bound model's
    parameters and buffers (``names``) as its leading inputs. The bound
    module is held in a tuple, out of this module's registered children, so
    that ``torch.export`` lifts none of its weights into the program."""

    def __init__(self, call: _Call, names: Sequence[str]):
        super().__init__()
        self._call = (call,)
        self.names = tuple(names)

    def forward(self, *flat):
        n = len(self.names)
        return torch.func.functional_call(self._call[0], dict(zip(self.names, flat[:n])),
                                          flat[n:])


def _flatten_bound(ep) -> Tuple[nn.Module, list]:
    """(module computing ``fn_flat(*leaves, *args)``, leaves) of a
    ``BoundEndpoint``: the leaves are its model's parameters and buffers."""
    if not (isinstance(getattr(ep, "model", None), nn.Module) and callable(
            getattr(ep, "fn", None))):
        raise TypeError(f"export takes BoundEndpoints (fn, model), got {type(ep).__name__}")
    named = list(itertools.chain(ep.model.named_parameters(), ep.model.named_buffers()))
    return (_Flat(_Call(ep.fn, ep.model), [f"model.{k}" for k, _ in named]),
            [t.detach() for _, t in named])


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def export_endpoints(
    endpoints: Dict[str, Callable],
    arg_specs: Dict[str, Sequence[Tuple[int, ...]]],
    out_dir: str,
    *,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    dtype: torch.dtype = torch.float32,
    metadata: Optional[dict] = None,
) -> dict:
    """Export every (endpoint x bucket) to ``out_dir``; returns the manifest.

    ``endpoints`` are ``BoundEndpoint``s (``serve/endpoints.py``); the
    weights of each bound model go into one params file. ``arg_specs[name]`` lists the per-sample shapes of the endpoint's
    arguments (batch axis stripped), as ``serve/endpoints.py``
    ``endpoint_arg_specs`` gives them; every argument is ``dtype``.
    Endpoints present in ``endpoints`` but missing from ``arg_specs`` are
    skipped (and vice versa). Each program is traced under
    ``torch.no_grad()`` with its bound model in eval mode, on the device of
    the endpoints (one device for all). The manifest records, per endpoint,
    the seconds each bucket's export and save took (``export_s``).
    """
    os.makedirs(out_dir, exist_ok=True)
    buckets = tuple(sorted(set(int(b) for b in buckets)))
    chosen = {name: (fn, *_flatten_bound(fn)) for name, fn in endpoints.items()
              if name in arg_specs}
    devices = {fn.device for fn, _, _ in chosen.values()}
    if len(devices) != 1:
        raise ValueError(f"endpoints must lie on one device, got {devices}")
    device = devices.pop()
    manifest: dict = {
        "format": FORMAT,
        "platform": device.type,
        "torch_version": torch.__version__,
        "device_name": _device_name(device),
        "dtype": _dtype_name(dtype),
        "buckets": list(buckets),
        "endpoints": {},
    }
    if metadata:
        manifest["metadata"] = metadata
    params_files: dict = {}  # id(bound model) -> (file name, dtype names)
    for name, (fn, module, leaves) in chosen.items():
        shapes = arg_specs[name]
        fn.model.eval()
        key = id(fn.model)
        if key not in params_files:
            pname = f"params.{len(params_files)}.npz"
            params_files[key] = (pname, _save_leaves(os.path.join(out_dir, pname), leaves))
        entry: dict = {"arg_shapes": [list(s) for s in shapes], "files": {}, "export_s": {},
                       "params_file": params_files[key][0],
                       "params_dtypes": params_files[key][1]}
        for b in buckets:
            t0 = time.perf_counter()
            args = [torch.zeros((b, *s), dtype=dtype, device=device) for s in shapes]
            with torch.no_grad():
                program = torch.export.export(module, (*leaves, *args))
            # the example inputs hold the weights, and the nodes' stack traces
            # the exporting host's source lines: keep both out of the file
            program.example_inputs = None
            for node in program.graph.nodes:
                node.meta.pop("stack_trace", None)
            fname = f"{name}.b{b}.pt2"
            torch.export.save(program, os.path.join(out_dir, fname))
            entry["files"][str(b)] = fname
            entry["export_s"][str(b)] = time.perf_counter() - t0
        manifest["endpoints"][name] = entry
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class _Program:
    """An exported program called on its graph: its lifted constants, then
    the flat inputs; the outputs put back in the endpoint's structure. The
    program's ``module()`` re-checks and re-flattens all ~200 inputs of a
    vessel endpoint by key path on every call (an exported reconstruct ran
    2.6-2.9 ms behind eager that way, on an H100 machine's host);
    ``ExportedBundle.call`` checks the shapes itself."""

    def __init__(self, path: str):
        program = torch.export.load(path)
        signature = program.graph_signature
        lifted = [s for s in signature.input_specs if s.kind != InputKind.USER_INPUT]
        if (any(s.kind != InputKind.CONSTANT_TENSOR for s in lifted)
                or signature.input_specs[:len(lifted)] != lifted
                or any(s.kind != OutputKind.USER_OUTPUT for s in signature.output_specs)):
            raise ValueError(f"{path}: not a program of export_endpoints")
        self.constants = tuple(program.constants[s.target] for s in lifted)
        self.graph = program.graph_module
        self.out_spec = program.call_spec.out_spec

    def __call__(self, *inputs):
        return pytree.tree_unflatten(list(self.graph(*self.constants, *inputs)),
                                     self.out_spec)


class _BundleEndpoint:
    """One endpoint of a bundle as ``BatchingEngine`` takes it: callable on
    (n, ...) tensors, with the ``device`` the engine puts requests on."""

    __slots__ = ("bundle", "name")

    def __init__(self, bundle: "ExportedBundle", name: str):
        self.bundle, self.name = bundle, name

    @property
    def device(self) -> torch.device:
        return self.bundle.device

    def __call__(self, *args):
        return self.bundle.call(self.name, *args)


class ExportedBundle:
    """A loaded bundle: routes any-batch requests onto the bucket ladder.
    The weights go to the device once, here; a program is loaded at its
    first call. ``as_endpoints()`` is the endpoint table of a
    ``serve.engine.BatchingEngine``."""

    def __init__(self, out_dir: str, device: DeviceLike = None):
        self.dir = os.path.abspath(out_dir)
        with open(os.path.join(self.dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"{self.dir}: format {self.manifest.get('format')!r}, "
                             f"not {FORMAT!r}")
        platform = self.manifest["platform"]
        want = torch.device(platform if device is None else device)
        if want.type != platform:
            raise ValueError(
                f"{self.dir} was exported on {platform}; it loads only on {platform}, "
                f"not on {want.type} (export it again on {want.type})")
        self.device = resolve_device(want)
        self.dtype = getattr(torch, self.manifest["dtype"])
        # weights made in the engine's worker (inference mode) would be
        # inference tensors: load them outside it, once
        with torch.inference_mode(False):
            self._params = {}
            for entry in self.manifest["endpoints"].values():
                fname = entry["params_file"]
                if fname not in self._params:
                    self._params[fname] = tuple(_load_leaves(
                        os.path.join(self.dir, fname), entry["params_dtypes"], self.device))
        self._fns: Dict[Tuple[str, int], Callable] = {}
        self._lock = threading.Lock()

    @property
    def endpoint_names(self):
        return sorted(self.manifest["endpoints"])

    def buckets(self, name: str) -> Tuple[int, ...]:
        return tuple(sorted(int(b) for b in self.manifest["endpoints"][name]["files"]))

    def _fn(self, name: str, bucket: int) -> Callable:
        key = (name, bucket)
        with self._lock:
            if key not in self._fns:
                fname = self.manifest["endpoints"][name]["files"][str(bucket)]
                self._fns[key] = _Program(os.path.join(self.dir, fname))
            return self._fns[key]

    def call(self, name: str, *args):
        """Invoke an endpoint on (n, ...) tensors or arrays; n is padded up to
        the smallest exported bucket (requests above the top bucket are
        chunked). Returns tensors on the bundle's device."""
        if name not in self.manifest["endpoints"]:
            raise KeyError(f"endpoint {name!r} not in bundle; have {self.endpoint_names}")
        entry = self.manifest["endpoints"][name]
        ts = [torch.as_tensor(a).to(self.device, self.dtype) for a in args]
        shapes = [tuple(t.shape[1:]) for t in ts]
        if shapes != [tuple(s) for s in entry["arg_shapes"]] or len(
                {t.shape[0] for t in ts}) != 1:
            raise ValueError(f"{name}: arguments {[tuple(t.shape) for t in ts]}, per "
                             f"sample {entry['arg_shapes']}")
        n = ts[0].shape[0]
        ladder = self.buckets(name)
        top = ladder[-1]
        if n > top:
            parts = [self.call(name, *(t[s:s + top] for t in ts)) for s in range(0, n, top)]
            return pytree.tree_map(lambda *xs: torch.cat(xs), *parts)
        bucket = next(b for b in ladder if n <= b)
        if n < bucket:
            ts = [torch.cat([t, t[-1:].expand(bucket - n, *t.shape[1:])]) for t in ts]
        out = self._fn(name, bucket)(*self._params[entry["params_file"]], *ts)
        return pytree.tree_map(lambda t: t[:n], out)

    def as_endpoints(self) -> Dict[str, Callable]:
        """Endpoint table for ``BatchingEngine``: each callable takes the
        engine's bucket batches and picks the matching program."""
        return {name: _BundleEndpoint(self, name) for name in self.endpoint_names}


def load_exported(out_dir: str, device: DeviceLike = None) -> ExportedBundle:
    """The bundle in ``out_dir``, on ``device`` (default: the device type it
    was exported on; another type raises)."""
    return ExportedBundle(out_dir, device)

"""The kernels' operators (``ops/kernels/registry.py``) and the deployment
bundles (``serve/export.py``) of the port, on the CPU.

- Every ``cvae`` operator passes ``torch.library.opcheck`` (schema, autograd
  registration, its fake kernel against its plain version, AOT dispatch) at
  small shapes, in float32 and, where the kernel takes it, bfloat16.
- A bundle of the small CausalViTVAE (``torch_port_helpers.SMALL``) at
  buckets (1, 4): ``encode``, ``predict_m``, ``reconstruct`` and ``do_t``
  (over three targets, which keeps its unrolled program small) equal the
  eager port endpoints to 1e-6 max|ref| (both run the same ATen ops and plain
  versions; the bucket's padded batch may sum in another order), with
  padding (3 rows -> bucket 4), chunking (6 rows > 4), tuple outputs and
  ``BatchingEngine`` over ``as_endpoints()``; and they equal JAX's
  ``vae_endpoints`` and JAX's own bundle on the same weights at
  ``test_torch_serve.py``'s bound, 1e-4 max|ref| + 1e-5.
- The weights are runtime inputs (``tests/test_serve.py``'s bound): one
  shared params file at least the parameter bytes, each program below a
  quarter of them; bfloat16 leaves survive the npz.
- A packed-fused model's programs call ``cvae::stage_fwd_fine``; an
  ensemble bundle; a bundle refuses another device type; the CLI's
  ``export vessel`` and ``serve vessel --export-dir --smoke``.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from causalvae_tpu.models.vit import CausalViTVAE as JaxCausalViTVAE
from causalvae_tpu.serve.endpoints import endpoint_arg_specs as jax_arg_specs
from causalvae_tpu.serve.endpoints import vae_endpoints as jax_endpoints
from causalvae_tpu.serve.export import export_endpoints as jax_export
from causalvae_tpu.serve.export import load_exported as jax_load

from causalvae_tpu_torch.models.vae import seeded_init_
from causalvae_tpu_torch.models.vit import CausalViTVAE
from causalvae_tpu_torch.ops import subpixel as psub
from causalvae_tpu_torch.serve import (BatchingEngine, BoundEndpoint, ensemble_endpoints,
                                       export_endpoints, load_exported, vae_endpoints)
from causalvae_tpu_torch.serve.endpoints import endpoint_arg_specs
from causalvae_tpu_torch.serve.export import ExportedBundle

from torch_op_cases import CASE_IDS, DTYPES, case
from torch_port_helpers import SMALL, close, inputs, load_port, perturb, two_threads  # noqa: F401

BUCKETS = (1, 4)
ENDPOINTS = ("encode", "predict_m", "reconstruct", "do_t")
TARGETS = np.eye(19, dtype=np.float32)[[0, 7, 18]]  # do_t's three targets


def same(got, want, rel=1e-6):
    """max|Δ| <= rel * max|ref|: the bundle against the eager port."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, type(want)) and len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w, rel)
        return
    got, want = got.detach().cpu(), want.detach().cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()), f"max|Δ| {err:.3e}"


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# --------------------------------------------------------------------------
# Every operator through opcheck
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", CASE_IDS)
def test_opcheck(name, dtype):
    torch.library.opcheck(*case(name, DTYPES[dtype]))


def test_every_kernel_entry_is_an_operator():
    """The 14 kernel entries of ops/kernels, each with a CPU, a CUDA and a
    fake (Meta) implementation."""
    names = sorted({c.split("-")[0] for c in CASE_IDS})
    assert len(names) == 14, names
    for name in names:
        qual = f"cvae::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key), (qual, key)


# --------------------------------------------------------------------------
# A bundle of the small model
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(JAX model, JAX variables, port model, eager port endpoints, manifest,
    bundle directory)."""
    jm = JaxCausalViTVAE(**SMALL, packed=False)
    h, w = SMALL["img_size"]
    key = jax.random.PRNGKey(0)
    # torch_port_helpers.small_causal_pair with the init jitted (JAX's eager
    # CPU dispatch compiles every op of a first call: 35 s against a few)
    v = perturb(jax.jit(functools.partial(jm.init, rng=key, train=False))(
        {"params": key, "dropout": key}, jnp.zeros((1, h, w, 1)), jnp.zeros((1, 12)),
        jnp.zeros((1, 19))), 1)
    pm = load_port(CausalViTVAE(**SMALL, device="cpu"), v)
    peps = vae_endpoints(pm, t_targets=torch.from_numpy(TARGETS))
    out = str(tmp_path_factory.mktemp("bundle"))
    manifest = export_endpoints({k: peps[k] for k in ENDPOINTS}, endpoint_arg_specs(pm),
                                out, buckets=BUCKETS, metadata={"workload": "small"})
    return jm, v, pm, peps, manifest, out


def _args(name, b, seed):
    x, m, t = inputs(b, seed=seed)
    return (t,) if name == "predict_m" else (x, m, t)


def test_manifest(bundle):
    *_, manifest, out = bundle
    assert manifest["format"] == "causalvae-tpu-torch.serve/1"
    assert manifest["platform"] == "cpu" and manifest["device_name"] == "cpu"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["dtype"] == "float32" and manifest["buckets"] == list(BUCKETS)
    assert manifest["metadata"] == {"workload": "small"}
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == manifest
    for name in ENDPOINTS:
        entry = manifest["endpoints"][name]
        assert entry["files"] == {str(b): f"{name}.b{b}.pt2" for b in BUCKETS}
        assert sorted(entry["export_s"]) == ["1", "4"]
        assert entry["params_file"] == "params.0.npz"
        assert set(entry["params_dtypes"]) == {"float32"}
    assert manifest["endpoints"]["predict_m"]["arg_shapes"] == [[19]]


@pytest.mark.parametrize("name", ENDPOINTS)
def test_bundle_equals_eager_padded(bundle, name):
    """3 rows run in bucket 4 (the last row repeated) and are sliced back."""
    *_, peps, _, out = bundle
    args = _args(name, 3, seed=20)
    got = load_exported(out).call(name, *args)
    with torch.no_grad():
        want = peps[name](*_t(*args))
    same(got, want)


def test_bundle_chunks_above_the_top_bucket(bundle):
    *_, peps, _, out = bundle
    args = _args("reconstruct", 6, seed=21)  # 4 + (2 -> 4)
    got = load_exported(out).call("reconstruct", *args)
    with torch.no_grad():
        want = peps["reconstruct"](*_t(*args))
    assert got.shape == (6, 64, 96, 1)
    same(got, want)


def test_bundle_tuple_outputs_exact_buckets_and_checked_shapes(bundle):
    *_, peps, _, out = bundle
    b = load_exported(out)
    assert b.buckets("encode") == BUCKETS and b.endpoint_names == sorted(ENDPOINTS)
    for n in (1, 4):
        args = _args("encode", n, seed=22 + n)
        got = b.call("encode", *args)
        with torch.no_grad():
            want = peps["encode"](*_t(*args))
        assert isinstance(got, tuple) and len(got) == 2
        same(got, want)
    with pytest.raises(KeyError, match="decode"):
        b.call("decode", *_args("encode", 1, seed=1)[1:])
    x, m, t = _args("encode", 2, seed=1)
    with pytest.raises(ValueError, match="per sample"):
        b.call("encode", x[:, :32], m, t)
    with pytest.raises(ValueError, match="per sample"):
        b.call("encode", x, m)


def test_bundle_drives_the_engine(bundle):
    *_, peps, _, out = bundle
    x, m, t = inputs(3, seed=25)
    b = load_exported(out)
    with BatchingEngine(b.as_endpoints(), buckets=BUCKETS) as eng:
        rec = eng.infer("reconstruct", x, m, t)
        m_hat = eng.infer("predict_m", t)
        assert eng.stats == {"launches": 2, "rows": 6, "padded_rows": 2}
    assert isinstance(rec, np.ndarray)
    with torch.no_grad():
        same(torch.from_numpy(rec), peps["reconstruct"](*_t(x, m, t)))
        same(torch.from_numpy(m_hat), peps["predict_m"](*_t(t)))


def test_bundle_matches_jax_endpoints(bundle):
    jm, v, _, _, _, out = bundle
    jeps = jax_endpoints(jm, v, t_targets=TARGETS)
    b = load_exported(out)
    for name in ENDPOINTS:
        args = _args(name, 3, seed=26)
        # jitted: JAX's eager CPU dispatch compiles every op of a first call
        ep = jeps[name]
        got, want = b.call(name, *args), jax.jit(ep.fn)(ep.params, *args)
        if not isinstance(want, tuple):
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            close(g, w)


def test_bundle_matches_jax_bundle(bundle, tmp_path):
    """JAX's own export of the same weights, loaded and called, against the
    port's bundle."""
    jm, v, _, _, _, out = bundle
    jeps = jax_endpoints(jm, v, t_targets=TARGETS)
    jax_export({k: jeps[k] for k in ENDPOINTS}, jax_arg_specs(jm), str(tmp_path),
               buckets=(4,))
    jb, pb = jax_load(str(tmp_path)), load_exported(out)
    for name in ENDPOINTS:
        args = _args(name, 3, seed=27)
        got, want = pb.call(name, *args), jb.call(name, *args)
        if not isinstance(want, tuple):
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            close(g, w)


def test_bundle_calls_the_attention_operator(bundle):
    """The exported encoder calls cvae::attention_fwd once per block (its
    CUDA implementation launches the kernel)."""
    *_, out = bundle
    program = torch.export.load(os.path.join(out, "encode.b1.pt2"))
    calls = [n for n in program.graph.nodes
             if n.op == "call_function" and n.target == torch.ops.cvae.attention_fwd.default]
    assert len(calls) == SMALL["depth"]
    assert not program.state_dict and not program.example_inputs


def test_export_traces_attention_at_head_dim_512():
    """A ViT block at embed 512 and one head (head dim 512, the kernels' deep
    plan on the card) exported by ``torch.export``: the fake kernel takes the
    deep head dim, the program calls cvae::attention_fwd once and gives the
    eager output's bits (the same plain version on the CPU)."""
    from causalvae_tpu_torch.models.vit import ViTBlock

    block = seeded_init_(ViTBlock(512, 1, 64, dropout=0.0), 3).eval()
    x = torch.randn(2, 9, 512, generator=torch.Generator().manual_seed(0))
    program = torch.export.export(block, (x,))
    calls = [n for n in program.graph.nodes
             if n.op == "call_function" and n.target == torch.ops.cvae.attention_fwd.default]
    assert len(calls) == 1
    assert torch.equal(program.module()(x), block(x))


# --------------------------------------------------------------------------
# Weights as runtime inputs, bf16 leaves, devices
# --------------------------------------------------------------------------


def test_weights_are_runtime_inputs(bundle, tmp_path):
    """One params file shared by the endpoints of one model, holding the
    weights; each program below a quarter of them (tests/test_serve.py)."""
    _, _, pm, peps, _, _ = bundle
    manifest = export_endpoints({k: peps[k] for k in ("reconstruct", "predict_m")},
                                endpoint_arg_specs(pm), str(tmp_path), buckets=(1,))
    ents = manifest["endpoints"]
    assert ents["reconstruct"]["params_file"] == ents["predict_m"]["params_file"]
    assert sorted(os.listdir(tmp_path)) == ["manifest.json", "params.0.npz",
                                            "predict_m.b1.pt2", "reconstruct.b1.pt2"]
    leaves = list(pm.parameters()) + list(pm.buffers())
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    blob = os.path.getsize(tmp_path / ents["reconstruct"]["params_file"])
    assert blob >= param_bytes
    for name in ("reconstruct", "predict_m"):
        prog = os.path.getsize(tmp_path / ents[name]["files"]["1"])
        assert prog < 0.25 * param_bytes, (name, prog, param_bytes)
    args = _args("reconstruct", 1, seed=28)
    with torch.no_grad():
        same(load_exported(str(tmp_path)).call("reconstruct", *args),
             peps["reconstruct"](*_t(*args)))


class _Affine(nn.Module):
    def __init__(self):
        super().__init__()
        w = (torch.arange(8, dtype=torch.float32).reshape(2, 4) / 7.0).to(torch.bfloat16)
        self.w = nn.Parameter(w, requires_grad=False)
        self.register_buffer("shift", torch.tensor([0.5, -0.25, 1.0, 2.0]))


def test_bf16_leaves_roundtrip(tmp_path):
    """bfloat16 weight leaves survive the npz (bit-cast to uint16 on disk)."""
    ep = BoundEndpoint(lambda mdl, x: x @ mdl.w.float() + mdl.shift, _Affine())
    manifest = export_endpoints({"f": ep}, {"f": ((2,),)}, str(tmp_path), buckets=(1, 3))
    assert manifest["endpoints"]["f"]["params_dtypes"] == ["bfloat16", "float32"]
    with np.load(tmp_path / "params.0.npz") as z:
        assert z["p0"].dtype == np.uint16
    b = load_exported(str(tmp_path))
    x = np.ones((2, 2), np.float32)
    got = b.call("f", x)
    assert torch.equal(got, ep(torch.from_numpy(x)))
    assert b._params["params.0.npz"][0].dtype == torch.bfloat16
    with pytest.raises(TypeError, match="BoundEndpoints"):
        export_endpoints({"f": lambda x: x}, {"f": ((2,),)}, str(tmp_path / "plain"))


def test_bundle_loads_only_on_its_device_type(bundle, tmp_path):
    *_, out = bundle
    with pytest.raises(ValueError, match="exported on cpu.*not on cuda"):
        load_exported(out, "cuda")
    moved = tmp_path / "cuda_bundle"
    shutil.copytree(out, moved)
    with open(moved / "manifest.json") as f:
        manifest = json.load(f)
    manifest["platform"] = "cuda"
    with open(moved / "manifest.json", "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="exported on cuda.*not on cpu"):
        load_exported(str(moved), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ExportedBundle(str(moved))


def test_weights_are_not_inference_tensors(bundle):
    """A bundle made inside inference mode (as the engine's worker runs)
    still holds ordinary tensors."""
    *_, out = bundle
    with torch.inference_mode():
        b = load_exported(out)
    assert not any(t.is_inference() for t in b._params["params.0.npz"])


# --------------------------------------------------------------------------
# Other models: packed-fused, ensemble
# --------------------------------------------------------------------------


def test_packed_fused_model_exports_through_the_stage_operator(tmp_path):
    """A phase-packed model with fused stages: its programs call
    cvae::stage_fwd_fine (row 6's operator) and equal its eager endpoints,
    run after the export (whose trace must leave no fake tensor in the
    lifted kernels' cached tap index)."""
    psub._tap_index.cache_clear()  # the export must not leave its fake index there
    pm = seeded_init_(CausalViTVAE(**SMALL, packed=True, packed_io=True, fused_stages=True,
                                   device="cpu"), 3)
    peps = vae_endpoints(pm)
    h, w = SMALL["img_size"]
    specs = {"reconstruct": ((h // 8, w // 8, 64), (12,), (19,))}
    export_endpoints(peps, specs, str(tmp_path), buckets=(2,))
    program = torch.export.load(str(tmp_path / "reconstruct.b2.pt2"))
    fine = [n for n in program.graph.nodes if n.op == "call_function"
            and n.target == torch.ops.cvae.stage_fwd_fine.default]
    assert len(fine) == 14
    rng = np.random.default_rng(29)
    x = rng.random((2, h // 8, w // 8, 64), dtype=np.float32)
    _, m, t = inputs(2, seed=29)
    got = load_exported(str(tmp_path)).call("reconstruct", x, m, t)
    with torch.no_grad():
        same(got, peps["reconstruct"](*_t(x, m, t)))


def test_ensemble_bundle(tmp_path):
    members = nn.ModuleList(seeded_init_(CausalViTVAE(**SMALL, device="cpu"), s)
                            for s in (4, 5))
    eeps = ensemble_endpoints(members)
    z = np.random.default_rng(30).standard_normal((3, SMALL["z_dim"])).astype(np.float32)
    _, m, t = inputs(3, seed=30)
    specs = {"decode": ((12,), (SMALL["z_dim"],)), "predict_m": ((19,),),
             "uncertainty": ((19,),)}
    manifest = export_endpoints(eeps, specs, str(tmp_path), buckets=(2,))  # 2 + (1 -> 2)
    assert {e["params_file"] for e in manifest["endpoints"].values()} == {"params.0.npz"}
    b = load_exported(str(tmp_path))
    for name, args in (("decode", (m, z)), ("predict_m", (t,)), ("uncertainty", (t,))):
        got = b.call(name, *args)
        with torch.no_grad():
            want = eeps[name](*_t(*args))
        same(got, want)
    assert b.call("uncertainty", t)[0].shape == (3, 2, 12)


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------


def test_cli_export_then_serve_from_the_bundle(tmp_path, capsys):
    """``export vessel`` writes the six endpoints of the vessel model; ``serve
    vessel --export-dir --smoke`` serves them (shapes from the manifest)."""
    from causalvae_tpu_torch.cli.main import main

    summary = main(["--out", str(tmp_path), "export", "vessel", "--device", "cpu",
                    "--img-hw", "32", "64", "--buckets", "1"])
    out = tmp_path / "export_vessel"
    text = capsys.readouterr().out
    printed = json.loads(text[text.index("{"):])
    assert printed == summary
    assert printed["export_dir"] == str(out) and printed["platform"] == "cpu"
    assert sorted(printed["endpoints"]) == ["decode", "do_t", "encode", "predict_m",
                                            "reconstruct", "uncertainty"]
    for name, info in printed["endpoints"].items():
        assert info["buckets"] == [1]
        assert info["bytes"] == os.path.getsize(out / f"{name}.b1.pt2")
    assert printed["params_bytes"] == os.path.getsize(out / "params.0.npz")
    main(["serve", "vessel", "--export-dir", str(out), "--smoke", "--device", "cpu",
          "--buckets", "1", "4"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    res = json.loads(lines[-1])
    assert res["smoke"] == "ok"
    assert res["predict_m_shape"] == [3, 12]
    assert res["reconstruct_shape"] == [1, 32, 64, 1]
    assert res["engine_stats"]["rows"] == 4
    with pytest.raises(SystemExit):
        main(["serve", "vessel", "--export-dir", str(out), "--ckpt", str(tmp_path)])

"""The port stands alone: no module of causalvae_tpu_torch, and not
chip_smoke.py, imports jax, flax or the JAX package causalvae_tpu; and none
imports pandas, PIL, matplotlib, sklearn, orbax or tifffile at import (the
card's machine lacks most of them; ``data/vessel.py load_raw`` imports
tifffile or PIL only for a file its native decoder refuses). A bundle of
``serve/export.py`` is served without the model code: neither importing
``causalvae_tpu_torch.serve`` nor ``load_exported(...).call(...)`` imports
``causalvae_tpu_torch.models``."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import causalvae_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(causalvae_tpu_torch.__path__,
                                              "causalvae_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "causalvae_tpu"))
heavy = sorted(m for m in sys.modules if m.split(".")[0] in (
    "pandas", "PIL", "matplotlib", "sklearn", "orbax", "tifffile"))
print(json.dumps({"modules": mods, "bad": bad, "heavy": heavy}))
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""  # "without a GPU" even on a machine with one
    return env


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["heavy"] == []
    for name in ("causalvae_tpu_torch.ops.kernels.attention",
                 "causalvae_tpu_torch.serve.engine",
                 "causalvae_tpu_torch.train.port_maps",
                 "causalvae_tpu_torch.cli.main",
                 "causalvae_tpu_torch.ops.losses",
                 "causalvae_tpu_torch.ops.kernels.elbo",
                 "causalvae_tpu_torch.ops.kernels.batchnorm",
                 "causalvae_tpu_torch.ops.kernels.stage",
                 "causalvae_tpu_torch.ops.subpixel",
                 "causalvae_tpu_torch.train.loop",
                 "causalvae_tpu_torch.train.state",
                 "causalvae_tpu_torch.train.checkpoints",
                 "causalvae_tpu_torch.train.workloads",
                 "causalvae_tpu_torch.data.vessel",
                 "causalvae_tpu_torch.utils.metrics",
                 "causalvae_tpu_torch.analysis.plots",
                 "causalvae_tpu_torch.train.kfold",
                 "causalvae_tpu_torch.scm.ensemble",
                 "causalvae_tpu_torch.scm.uncertainty",
                 "causalvae_tpu_torch.scm.intervene",
                 "causalvae_tpu_torch.serve.endpoints",
                 "causalvae_tpu_torch.serve.export",
                 "causalvae_tpu_torch.ops.kernels.registry",
                 "causalvae_tpu_torch.analysis.mechanism",
                 "causalvae_tpu_torch.analysis.kfold_eval",
                 "causalvae_tpu_torch.analysis.vessel_report",
                 "causalvae_tpu_torch.native",
                 "causalvae_tpu_torch.data.mnist",
                 "causalvae_tpu_torch.ops.morphology_host",
                 "causalvae_tpu_torch.models.heads",
                 "causalvae_tpu_torch.models.mechanism"):
        assert name in res["modules"]


def test_native_build_compiles_only_the_ports_own_source():
    """The port's loader is built from ``causalvae_tpu_torch/native`` alone
    (never ``causalvae_tpu/native``) into ``build/native/``, and its source
    includes no file of the repository."""
    from causalvae_tpu_torch import native

    out = native.library_path()
    cmd = native.build_command(out)
    port = os.path.join(ROOT, "causalvae_tpu_torch", "native") + os.sep
    sources = [a for a in cmd if a.endswith((".cpp", ".cc", ".c", ".h", ".hpp"))]
    assert sources == [os.path.join(port, "loader.cpp")]
    assert not any(os.path.join("causalvae_tpu", "native") in a for a in cmd)
    assert str(out.parent) == os.path.join(ROOT, "build", "native")
    includes = [ln for ln in native.SOURCE.read_text().splitlines()
                if ln.startswith("#include")]
    assert includes and all("<" in ln for ln in includes), includes


def test_chip_smoke_refuses_without_a_gpu_or_the_repo(tmp_path):
    """Without CUDA, or alone in a directory, chip_smoke exits non-zero and
    prints no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    shutil.copy(script, tmp_path / "chip_smoke.py")
    for cwd, path in ((ROOT, script), (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        out = subprocess.run([sys.executable, path], cwd=cwd, env=_clean_env(),
                             capture_output=True, text=True, timeout=240)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


_SERVE_BUNDLE = r"""
import json, sys
import causalvae_tpu_torch.serve
after_package = sorted(m for m in sys.modules if m.startswith("causalvae_tpu_torch.models"))
from causalvae_tpu_torch.serve.export import load_exported
bundle = load_exported(sys.argv[1])
out = bundle.call("predict_m", [[0.0] * 18 + [1.0]] * 3)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "causalvae_tpu"))
print(json.dumps({"after_package": after_package, "shape": list(out.shape), "bad": bad,
                  "models": sorted(m for m in sys.modules
                                   if m.startswith("causalvae_tpu_torch.models"))}))
"""


def test_a_bundle_serves_without_the_model_code(tmp_path):
    """A fresh process imports the serving package and calls a bundle's
    endpoint: no module of causalvae_tpu_torch.models (nor JAX) is loaded."""
    from causalvae_tpu_torch.models.vae import seeded_init_
    from causalvae_tpu_torch.models.vit import CausalViTVAE
    from causalvae_tpu_torch.serve.endpoints import vae_endpoints
    from causalvae_tpu_torch.serve.export import export_endpoints

    model = seeded_init_(CausalViTVAE(img_size=(32, 32), z_dim=8, embed_dim=32, depth=1,
                                      heads=4, mlp_dim=64, vit_latent_dim=32, device="cpu"), 0)
    export_endpoints({"predict_m": vae_endpoints(model)["predict_m"]},
                     {"predict_m": ((19,),)}, str(tmp_path), buckets=(4,))
    out = subprocess.run([sys.executable, "-c", _SERVE_BUNDLE, str(tmp_path)], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"after_package": [], "shape": [3, 12], "bad": [], "models": []}

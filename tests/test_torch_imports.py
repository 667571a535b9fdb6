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

import pytest

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
                 "causalvae_tpu_torch.models.mechanism",
                 "causalvae_tpu_torch.ops.morphology",
                 "causalvae_tpu_torch.analysis.importance",
                 "causalvae_tpu_torch.analysis.independence",
                 "causalvae_tpu_torch.analysis.residual",
                 "causalvae_tpu_torch.analysis.gradcam",
                 "causalvae_tpu_torch.analysis.causal_checks",
                 "causalvae_tpu_torch.data.translator",
                 "causalvae_tpu_torch.data.cascade",
                 "causalvae_tpu_torch.analysis.translate",
                 "causalvae_tpu_torch.analysis.latent_viz",
                 "causalvae_tpu_torch.parallel.mesh",
                 "causalvae_tpu_torch.parallel.shard_step"):
        assert name in res["modules"]


_WITHOUT_SKLEARN = r"""
import json, sys
for name in ("sklearn", "matplotlib", "pandas", "PIL"):
    sys.modules[name] = None  # any import of them raises ImportError
import os, tempfile
import numpy as np
from causalvae_tpu_torch.analysis import latent_viz, plots, vessel_report
from causalvae_tpu_torch.parallel import mesh, shard_step
from causalvae_tpu_torch.utils.metrics import profile_trace
rng = np.random.default_rng(0)
z = rng.standard_normal((24, 4)).astype(np.float32)
labels = np.repeat(np.arange(3), 8)
emb, ratio = latent_viz.pca_embedding(z, device="cpu")
tsne = latent_viz.tsne_embedding(z, perplexity=5, device="cpu")
score = latent_viz.disentanglement_score(z, labels, device="cpu")
ens = vessel_report.discriminative_feature_ensemble(z, labels, list("abcd"))
d = tempfile.mkdtemp()
plots.embedding_scatter(tsne, labels, os.path.join(d, "e.png"))
plots.overlap_distributions({"g": z[:, 0]}, {"g": z[:, 1]}, os.path.join(d, "o.png"))
heavy = sorted(m for m in sys.modules if m.split(".")[0] in (
    "sklearn", "matplotlib", "pandas", "PIL") and sys.modules[m] is not None)
print(json.dumps({"heavy": heavy, "tsne": list(tsne.shape), "ranking": ens["consensus_ranking"],
                  "score": score, "pngs": sorted(os.listdir(d))}))
"""


def test_analysis_and_parallel_run_without_sklearn_or_matplotlib():
    """latent_viz, the vessel report, the charts and parallel/ import, and
    their numerics run, with sklearn, matplotlib, pandas and PIL blocked
    (the card's machine has neither sklearn nor matplotlib)."""
    out = subprocess.run([sys.executable, "-c", _WITHOUT_SKLEARN], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["heavy"] == []
    assert res["tsne"] == [24, 2] and len(res["ranking"]) == 4
    assert 0.0 <= res["score"] <= 1.0
    assert res["pngs"] == ["e.png", "o.png"]


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


def test_models_package_exports_the_jax_zoo():
    """``causalvae_tpu_torch.models`` exports the names of
    ``causalvae_tpu.models``, each bound to the port's own object."""
    import causalvae_tpu.models as jax_models

    import causalvae_tpu_torch.models as port_models

    assert port_models.__all__ == jax_models.__all__
    for name in port_models.__all__:
        obj = getattr(port_models, name)
        assert obj.__module__.startswith("causalvae_tpu_torch.models."), name


CONFIG_CLASSES = ["MnistConfig", "VesselConfig", "TranslatorConfig", "CascadeConfig",
                  "MeshConfig", "Config"]


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_dataclass_equals_jax(name):
    """Field names (in order), declared types and defaults of each dataclass
    of the config tree equal the JAX package's."""
    import dataclasses

    import causalvae_tpu.config as jcfg

    import causalvae_tpu_torch.config as pcfg

    def fields(cls):
        return [(f.name, f.type, dataclasses.asdict(f.default)
                 if dataclasses.is_dataclass(f.default) else f.default)
                for f in dataclasses.fields(cls)]

    assert fields(getattr(pcfg, name)) == fields(getattr(jcfg, name))


def test_config_default_tree_equals_jax():
    import dataclasses

    import causalvae_tpu.config as jcfg

    import causalvae_tpu_torch.config as pcfg

    assert dataclasses.asdict(pcfg.DEFAULT) == dataclasses.asdict(jcfg.DEFAULT)

"""The port stands alone: no module of causalvae_tpu_torch, and not
chip_smoke.py, imports jax, flax or the JAX package causalvae_tpu."""

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
print(json.dumps({"modules": mods, "bad": bad}))
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
                 "causalvae_tpu_torch.train.state"):
        assert name in res["modules"]


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

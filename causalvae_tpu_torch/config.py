"""Workload configuration: the port's own copy of ``causalvae_tpu/config.py``,
one typed dataclass tree (``Config``, ``DEFAULT``) of every workload's
settings and the MNIST feature names."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MnistConfig:
    """MNIST baseline causal-VAE workload (ref: mnist_test/01 config.py:6-17)."""

    batch_size: int = 128
    epochs: int = 100
    lr: float = 1e-3
    z_dim: int = 10
    m_dim: int = 12
    t_dim: int = 10
    seed: int = 42
    beta: float = 1.0          # KLD weight
    lambda_adv: float = 10.0   # adversarial confusion weight (applied x100)
    lambda_morph: float = 100.0
    image_hw: Tuple[int, int] = (28, 28)


# Feature names for the 12-feature morphology vector
# (ref: mnist_test/01_baseline_causal_vae/config.py:19-23)
FEATURE_NAMES_12: Sequence[str] = (
    "Area", "Perimeter", "Thickness", "MajorAxis", "Eccentricity",
    "Orientation", "Solidity", "Extent", "AspectRatio", "Euler",
    "H_Symmetry", "V_Symmetry",
)

# 16-feature variant of the measurement approach
# (ref: mnist_test/03_measurement_approach/dataset.py:11-96)
FEATURE_NAMES_16: Sequence[str] = (
    "Area", "Thickness", "Solidity", "AspectRatio", "Euler",
    "H_Symmetry", "V_Symmetry", "Endpoints", "Junctions",
    "Hu1", "Hu2", "Hu3", "Hu4", "Hu5", "Hu6", "Hu7",
)


@dataclasses.dataclass(frozen=True)
class VesselConfig:
    """Vessel-MIP causal-VAE workload (ref: vessel_analysis/00_core/config.py:9-23)."""

    epochs: int = 150
    batch_size: int = 8
    lr: float = 1e-4
    beta: float = 0.5
    lambda_morph: float = 10000.0
    lambda_sparsity: float = 0.3
    grad_clip_norm: float = 5.0
    img_height: int = 768
    img_width: int = 1280
    t_dim: int = 19
    m_dim: int = 12
    z_dim: int = 128
    # k-fold (train/kfold.py; the CLI's kfold and vessel-report)
    n_folds: int = 5
    kfold_seed: int = 42
    # ViT backbone (ref: vessel_analysis/00_core/models.py:193-201)
    vit_patch: int = 32
    vit_embed_dim: int = 256
    vit_depth: int = 6
    vit_heads: int = 8
    vit_mlp_dim: int = 512
    vit_latent_dim: int = 512
    # "bfloat16" computes every layer in bf16 on float32 parameters (the JAX
    # package's TPU production setting; models/vit.py); the losses, the
    # BatchNorm statistics and the optimizer's math stay float32
    compute_dtype: str = "float32"
    # Adam first-moment storage dtype (train/state.py); nu stays float32 and
    # the update math is float32 either way
    adam_mu_dtype: str = "bfloat16"
    # file corpus (data/vessel.py scan_corpus); None: the synthetic corpus
    data_csv: Optional[str] = None
    data_root: Optional[str] = None
    # the reference's output directories (no entry point of either package
    # reads them: the CLIs write under --out)
    save_dir: str = "outputs/saved_models_kfold"
    result_dir: str = "outputs/results_kfold"


@dataclasses.dataclass(frozen=True)
class TranslatorConfig:
    """latent_translator workload (ref: latent_translator/main.py:18-33)."""

    img_hw: Tuple[int, int] = (384, 640)
    latent_dim: int = 512
    embed_dim: int = 256
    depth: int = 6
    heads: int = 8
    mlp_dim: int = 512
    epochs: int = 50
    batch_size: int = 8
    lr: float = 1e-4
    beta: float = 1.0
    ridge_alpha: float = 1.0
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """causal_cascade workload (ref: causal_cascade/main.py:13-25)."""

    img_hw: Tuple[int, int] = (384, 640)
    latent_dim: int = 64
    m_dim: int = 12
    t_dim: int = 19
    epochs: int = 100
    batch_size: int = 4
    lr: float = 1e-4
    lambda_morph: float = 2000.0
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Data-parallel settings (``parallel/mesh.py``): the axis names and the
    number of ranks (None: the process group's size)."""

    data_axis: str = "data"
    fold_axis: str = "fold"
    n_devices: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Config:
    mnist: MnistConfig = MnistConfig()
    vessel: VesselConfig = VesselConfig()
    translator: TranslatorConfig = TranslatorConfig()
    cascade: CascadeConfig = CascadeConfig()
    mesh: MeshConfig = MeshConfig()


DEFAULT = Config()

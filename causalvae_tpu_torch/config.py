"""Workload configuration (copy of the serving, training, dtype, data and
k-fold fields of ``causalvae_tpu/config.py`` ``VesselConfig``; the port
keeps its own copy)."""

from __future__ import annotations

import dataclasses
from typing import Optional


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
    # k-fold (train/kfold.py; the CLI's kfold and vessel-report)
    n_folds: int = 5
    kfold_seed: int = 42
    # file corpus (data/vessel.py scan_corpus); None: the synthetic corpus
    data_csv: Optional[str] = None
    data_root: Optional[str] = None

"""PyTorch/CUDA port of causalvae_tpu for NVIDIA Hopper (H100).

The JAX package ``causalvae_tpu`` is the reference; this package mirrors its
module paths and class names so each counterpart is easy to find, and never
imports it (nor JAX). Public functions keep the JAX layouts: images NHWC
``(B, H, W, C)``, attention ``(B, H, N, D)``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; without a GPU they raise.

Every module of the JAX package has its counterpart here (``ROADMAP.md``
lists the few pieces left out, each with its reason): the model zoo
(``models``), the data pipelines (``data``, ``native``), training
(``train``: the steps, the optimizer, k-fold, the scanned trainer as CUDA
graphs, checkpoints), data parallelism (``parallel``), serving and export
(``serve``), interventions (``scm``), the analysis study (``analysis``)
and the CLI (``cli``). The TPU kernels are hand-written CUDA kernels
(``csrc/``): the attention forward and backward
(``ops/kernels/attention.py``), the train-mode BatchNorm reductions
(``ops/kernels/batchnorm.py``), the ELBO terms (``ops/kernels/elbo.py``)
and the fused decoder stages (``ops/kernels/stage.py``).
"""

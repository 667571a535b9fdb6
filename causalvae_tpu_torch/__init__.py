"""PyTorch/CUDA port of causalvae_tpu for NVIDIA Hopper (H100).

The JAX package ``causalvae_tpu`` is the reference; this package mirrors its
module paths and class names so each counterpart is easy to find, and never
imports it (nor JAX). Public functions keep the JAX layouts: images NHWC
``(B, H, W, C)``, attention ``(B, H, N, D)``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; without a GPU they raise.

Ported so far: the serving path of the vessel ``CausalViTVAE`` (eval mode)
and its training step (``train/loop.py``, ``train/state.py``,
``ops/losses.py``), with hand-written CUDA kernels (``csrc/``) for the
attention forward and backward (``ops/kernels/attention.py``), the
train-mode BatchNorm reductions (``ops/kernels/batchnorm.py``) and the ELBO
terms (``ops/kernels/elbo.py``).
"""

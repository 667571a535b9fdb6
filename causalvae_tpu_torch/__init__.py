"""PyTorch/CUDA port of causalvae_tpu for NVIDIA Hopper (H100).

The JAX package ``causalvae_tpu`` is the reference; this package mirrors its
module paths and class names so each counterpart is easy to find, and never
imports it (nor JAX). Public functions keep the JAX layouts: images NHWC
``(B, H, W, C)``, attention ``(B, H, N, D)``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; without a GPU they raise.

Ported so far: the serving path of the vessel ``CausalViTVAE`` (eval mode),
with the attention forward as a hand-written CUDA kernel
(``ops/kernels/attention.py`` + ``csrc/attention_fwd.cu``).
"""

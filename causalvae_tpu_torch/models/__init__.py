"""The model zoo (``causalvae_tpu/models``): the causal-VAE family over the
structural model T -> M -> X, in PyTorch.

  CausalConvVAE       — C1/C4: MNIST causal VAE, deterministic or Gaussian
                        mechanism head
  LatentDiscriminator — C2: adversarial z -> T head
  SimpleClassifier    — C3: external CNN eval classifier
  ConditionalVAE      — C5: T -> X CVAE (no M)
  MDecoder            — C6: M -> X / (M, T) -> X conditional-independence probes
  CausalVesselVAE     — C7: full-resolution vessel causal VAE (CNN)
  ViTVAE              — C8: hybrid conv-stem ViT VAE backbone
  CausalViTVAE        — C9: causal adapter wrapper around ViTVAE
  CausalBioVAE        — C10: compact resolution-agnostic cascade VAE
  MorphPredictor / DAGMechanism — the latent causal-mechanism layer
"""

from causalvae_tpu_torch.models.mechanism import DAGMechanism, MorphPredictor
from causalvae_tpu_torch.models.vae import (
    CausalBioVAE,
    CausalConvVAE,
    CausalVesselVAE,
    ConditionalVAE,
    MDecoder,
    VAEOutput,
    reparameterize,
)
from causalvae_tpu_torch.models.heads import LatentDiscriminator, SimpleClassifier
from causalvae_tpu_torch.models.vit import CausalViTVAE, ViTVAE

__all__ = [
    "CausalBioVAE",
    "CausalConvVAE",
    "CausalVesselVAE",
    "CausalViTVAE",
    "ConditionalVAE",
    "DAGMechanism",
    "LatentDiscriminator",
    "MDecoder",
    "MorphPredictor",
    "SimpleClassifier",
    "VAEOutput",
    "ViTVAE",
    "reparameterize",
]

"""Inference serving of the port (``causalvae_tpu/serve``).

- ``endpoints``  inference functions bound to a model (encode / decode /
                 reconstruct / predict_m / do_t / uncertainty, and the
                 k-fold ensemble's).
- ``engine``     a dynamic-batching engine: concurrent requests coalesced
                 into bucket batches, one device call each.
- ``export``     deployment bundles: the endpoints exported with
                 ``torch.export`` at a bucket ladder, the weights in one
                 shared file as the programs' runtime inputs; served by
                 ``load_exported`` without the model code.
- ``http``       a stdlib HTTP front end speaking ``.npz`` bodies.

Importing this package imports no model code (``causalvae_tpu_torch.models``).
"""

from causalvae_tpu_torch.serve.endpoints import (BoundEndpoint, ensemble_endpoints,
                                                 vae_endpoints)
from causalvae_tpu_torch.serve.engine import BatchingEngine
from causalvae_tpu_torch.serve.export import export_endpoints, load_exported

__all__ = [
    "vae_endpoints",
    "ensemble_endpoints",
    "BoundEndpoint",
    "BatchingEngine",
    "export_endpoints",
    "load_exported",
]

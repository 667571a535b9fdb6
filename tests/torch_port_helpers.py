"""Shared set-up of the port's parity tests (tests/test_torch_*.py): a small
JAX CausalViTVAE with perturbed weights and non-trivial BatchNorm statistics,
and its PyTorch port loaded through ``from_jax_variables``.

The small model: 64x96 images (a 2x3 token grid, so a transposed grid shows),
embed 32, depth 2, 4 heads, MLP 64, ViT latent 32, z 8, the vessel m 12 / t 19.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

SMALL = dict(img_size=(64, 96), z_dim=8, embed_dim=32, depth=2, heads=4,
             mlp_dim=64, vit_latent_dim=32)


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def perturb(variables, seed: int):
    """Every parameter gets N(0, 0.02²) added (so zero-initialized biases and
    unit scales are exercised); BatchNorm running means become N(0, 0.2²) and
    variances U(0.5, 2), so eval BatchNorm is not the identity."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32),
        to_numpy_tree(variables["params"]))
    out = {"params": params}
    if "batch_stats" in variables:
        def stat(path, a):
            if path[-1].key == "var":
                return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
            return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)

        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            stat, to_numpy_tree(variables["batch_stats"]))
    return out


def init_jax(module, *args, seed: int = 0, jit: bool = False, **kwargs):
    """``module.init`` perturbed; ``jit`` compiles the init first (the same
    values, several times faster for the ViT models than flax's eager
    init)."""
    key = jax.random.PRNGKey(seed)

    def init(key, *args):
        return module.init({"params": key, "dropout": key}, *args, **kwargs)

    variables = (jax.jit(init) if jit else init)(key, *args)
    return perturb(variables, seed + 1)


def small_causal_pair(seed: int = 0, jit: bool = False):
    """(jax_model, jax_variables (numpy), port_model on the CPU, eval mode)."""
    from causalvae_tpu.models.vit import CausalViTVAE as JaxCausalViTVAE

    from causalvae_tpu_torch.models.vit import CausalViTVAE
    from causalvae_tpu_torch.train.port_maps import from_jax_variables

    jm = JaxCausalViTVAE(**SMALL, packed=False)
    h, w = SMALL["img_size"]
    key = jax.random.PRNGKey(seed)
    variables = init_jax(jm, jnp.zeros((1, h, w, 1)), jnp.zeros((1, 12)),
                         jnp.zeros((1, 19)), rng=key, train=False, seed=seed, jit=jit)
    pm = CausalViTVAE(**SMALL, device="cpu")
    pm.load_state_dict(from_jax_variables(pm, variables), strict=True)
    return jm, variables, pm.eval()


def load_port(port_module, variables):
    from causalvae_tpu_torch.train.port_maps import from_jax_variables

    port_module.load_state_dict(from_jax_variables(port_module, variables),
                                strict=True)
    return port_module.eval()


def inputs(b: int, seed: int = 3, img_hw=SMALL["img_size"]):
    """(x NHWC in [0, 1), m ~ N(0, 1), one-hot t) as float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, *img_hw, 1), dtype=np.float32)
    m = rng.standard_normal((b, 12), dtype=np.float32)
    t = np.eye(19, dtype=np.float32)[rng.integers(0, 19, b)]
    return x, m, t


def close(got, want, rel=1e-4, abs_=1e-5):
    """max|Δ| <= rel * max|ref| + abs_ (the port's f32 parity tolerance)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    bound = rel * float(np.max(np.abs(want))) + abs_
    assert err <= bound, f"max|Δ| {err:.3e} > {bound:.3e}"


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for a module of small CPU runs (import it into
    the module to apply it there). The tier-1 run puts six workers on the
    host, and torch's default of one thread per core then oversubscribes it:
    one small k-fold run of two epochs took 118 s at eight threads beside
    five busy processes, 4.8 s at two."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

"""``models.vae.flax_init_`` against flax's ``model.init``, leaf by leaf.

Every JAX trainer starts from ``model.init`` (flax's default initializers:
``lecun_normal`` kernels, a normal truncated to ±2 with std sqrt(1/fan_in),
zero biases and running means, unit scales and running variances, N(0, 1)
positional embedding and CLS token); the port's trainers start from
``flax_init_``, which draws from numpy. The values differ, the
distributions must not. Each family's JAX ``init`` (jitted, not perturbed)
is carried across by ``from_jax_variables`` and held to ``flax_init_`` of
the port model, per leaf:

- a constant leaf (every JAX entry equal) is equal exactly;
- a drawn leaf of 256 or more entries has its std within 15% of JAX's and
  its mean within 5 standard errors of JAX's (worst readings over the
  twelve families at seed 7: 8.6% and 3.1);
- every entry of a ``lecun_normal`` leaf lies within the truncation bound
  2.2737·sqrt(1/fan_in), fan_in read from the JAX leaf (a kernel's
  prod(shape[:-1]); the attention's ``qkv`` DenseGeneral (E, 3, H, D),
  which flax initialises flattened to (E, 3E), E), JAX's own entries
  included.

The control: ``seeded_init_`` (the serving weights without a checkpoint)
misses C1's ``dec_conv2.weight`` (std 0.36x JAX's), C9's first upsampler
(3.98x) and every bias.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.models import heads as jheads
from causalvae_tpu.models import mechanism as jmech
from causalvae_tpu.models import vae as jvae
from causalvae_tpu.models import vit as jvit

from causalvae_tpu_torch.models import heads as pheads
from causalvae_tpu_torch.models import mechanism as pmech
from causalvae_tpu_torch.models import vae as pvae
from causalvae_tpu_torch.models import vit as pvit
from causalvae_tpu_torch.train.port_maps import from_jax_variables

from torch_port_helpers import SMALL, to_numpy_tree, two_threads  # noqa: F401

TRUNC_BOUND = 2.0 / 0.87962566103423978  # 2.2737: the bound over sqrt(1/fan_in)
STD_REL, MEAN_SE, MIN_N = 0.15, 5.0, 256
C7 = dict(z_dim=16, grid_hw=(1, 2))
VIT_KW = dict(img_size=(64, 96), latent_dim=32, embed_dim=32, depth=2, heads=4, mlp_dim=64)
GRAPH = (("t", 3), ("m", 4), ("u", 2))
ADJ = np.array([[0, 1, 1], [0, 0, 1], [0, 0, 0]], np.float32)


def _zeros(*shapes, dtype=jnp.float32):
    return [jnp.zeros(s, dtype) for s in shapes]


# family -> (JAX module, init arguments and keywords, port model)
FAMILIES = {
    "C1": lambda: (jvae.CausalConvVAE(), _zeros((1, 28, 28, 1), (1, 12), (1, 10)),
                   dict(rng=jax.random.PRNGKey(1)), pvae.CausalConvVAE(device="cpu")),
    "C4": lambda: (jvae.CausalConvVAE(gaussian_mechanism=True, decode_real_m=True),
                   _zeros((1, 28, 28, 1), (1, 12), (1, 10)), dict(rng=jax.random.PRNGKey(1)),
                   pvae.CausalConvVAE(gaussian_mechanism=True, decode_real_m=True,
                                      device="cpu")),
    "C5": lambda: (jvae.ConditionalVAE(), _zeros((1, 28, 28, 1), (1, 10)),
                   dict(rng=jax.random.PRNGKey(1)), pvae.ConditionalVAE(device="cpu")),
    "C6": lambda: (jvae.MDecoder(), _zeros((1, 12), (1, 10)), {},
                   pvae.MDecoder(12, 10, device="cpu")),
    "C2": lambda: (jheads.LatentDiscriminator(), _zeros((1, 10)), {},
                   pheads.LatentDiscriminator(device="cpu")),
    "C3": lambda: (jheads.SimpleClassifier(), _zeros((1, 28, 28, 1)), {},
                   pheads.SimpleClassifier(device="cpu")),
    "C7": lambda: (jvae.CausalVesselVAE(**C7), _zeros((1, 128, 256, 1), (1, 12), (1, 19)),
                   dict(rng=jax.random.PRNGKey(1), train=False),
                   pvae.CausalVesselVAE(**C7, device="cpu")),
    "C8": lambda: (jvit.ViTVAE(**VIT_KW, packed=False), _zeros((1, 64, 96, 1)),
                   dict(rng=jax.random.PRNGKey(1), train=False),
                   pvit.ViTVAE(**VIT_KW, device="cpu")),
    "C9": lambda: (jvit.CausalViTVAE(**SMALL, packed=False),
                   _zeros((1, 64, 96, 1), (1, 12), (1, 19)),
                   dict(rng=jax.random.PRNGKey(1), train=False),
                   pvit.CausalViTVAE(**SMALL, device="cpu")),
    "C10": lambda: (jvae.CausalBioVAE(t_dim=6, z_dim=16),
                    [jnp.zeros((1, 64, 128, 1)), jnp.zeros((1, 12)),
                     jnp.zeros((1,), jnp.int32)],
                    dict(rng=jax.random.PRNGKey(1), train=False),
                    pvae.CausalBioVAE(t_dim=6, z_dim=16, device="cpu")),
    "DAG": lambda: (jmech.DAGMechanism(factors=GRAPH, adjacency=ADJ, hidden=48),
                    _zeros((1, 9)), {}, pmech.DAGMechanism(GRAPH, ADJ, hidden=48)),
    "DAG-gaussian": lambda: (
        jmech.DAGMechanism(factors=GRAPH, adjacency=ADJ, hidden=48, gaussian=True),
        _zeros((1, 9)), {}, pmech.DAGMechanism(GRAPH, ADJ, hidden=48, gaussian=True)),
}


@functools.lru_cache(maxsize=None)
def _jax_init(family):
    """(the port model, the JAX init carried across, each leaf's fan_in
    carried across as a constant tensor; 0 where the leaf is not drawn by
    ``lecun_normal``)."""
    jm, args, kw, pm = FAMILIES[family]()
    key = jax.random.PRNGKey(0)
    v = to_numpy_tree(jax.jit(functools.partial(jm.init, **kw))(
        {"params": key, "dropout": key}, *args))

    def fan_in(path, a):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "kernel" and names[-2] == "qkv":
            return np.full(a.shape, a.shape[0], np.float32)
        if names[-1] in ("kernel", "w1", "w2"):
            return np.full(a.shape, np.prod(a.shape[:-1]), np.float32)
        return np.zeros(a.shape, np.float32)

    fans = jax.tree_util.tree_map_with_path(fan_in, v)
    return pm, from_jax_variables(pm, v), from_jax_variables(pm, fans)


def _misses(got, want, fans):
    """The leaves of ``got`` (port state dict) that break a rule, with why."""
    out = {}
    for k, w in want.items():
        g = got[k].float().numpy().ravel().astype(np.float64)
        w = w.float().numpy().ravel().astype(np.float64)
        fan = float(fans[k].reshape(-1)[0]) if fans[k].numel() else 0.0
        if w.size and np.all(w == w[0]):
            if not np.array_equal(g, w):
                out[k] = "constant differs"
            continue
        if fan:
            bound = TRUNC_BOUND * fan ** -0.5 * (1 + 1e-6)
            assert np.abs(w).max() <= bound, (k, "the JAX leaf breaks the bound")
            if np.abs(g).max() > bound:
                out[k] = f"max {np.abs(g).max():.4g} > bound {bound:.4g}"
                continue
        if w.size >= MIN_N:
            n = w.size
            ratio = g.std() / w.std()
            se = np.sqrt((g.var() + w.var()) / n)
            if abs(ratio - 1) > STD_REL:
                out[k] = f"std ratio {ratio:.3f}"
            elif abs(g.mean() - w.mean()) > MEAN_SE * se:
                out[k] = f"mean {g.mean():.3g} vs {w.mean():.3g} (se {se:.3g})"
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_flax_init_matches_jax_init(family):
    pm, want, fans = _jax_init(family)
    got = pvae.flax_init_(pm, 7).state_dict()
    assert set(got) == set(want)
    assert _misses(got, want, fans) == {}
    # the same seed gives the same weights
    again = pvae.flax_init_(FAMILIES[family]()[3], 7).state_dict()
    for k, v in got.items():
        assert torch.equal(again[k], v), k


def test_seeded_init_is_the_control_that_misses():
    pm, want, fans = _jax_init("C1")
    missed = _misses(pvae.seeded_init_(pm, 7).state_dict(), want, fans)
    assert "dec_conv2.weight" in missed and "enc_fc1.bias" in missed, missed
    pm, want, fans = _jax_init("C9")
    missed = _misses(pvae.seeded_init_(pm, 7).state_dict(), want, fans)
    assert "backbone.dec_ct.0.weight" in missed, missed


def test_dag_mechanism_starts_from_flax_init_and_keeps_its_dtype():
    """The constructor draws flax's init (seeded from torch's generator: the
    same seed, the same weights); in bfloat16 its four leaves are bfloat16,
    before and after a ``ClippedAdam`` step."""
    from causalvae_tpu_torch.train.state import ClippedAdam

    for family, gaussian in (("DAG", False), ("DAG-gaussian", True)):
        _, want, fans = _jax_init(family)
        torch.manual_seed(3)
        a = pmech.DAGMechanism(GRAPH, ADJ, hidden=48, gaussian=gaussian)
        assert _misses(a.state_dict(), want, fans) == {}
        torch.manual_seed(3)
        b = pmech.DAGMechanism(GRAPH, ADJ, hidden=48, gaussian=gaussian)
        for k, v in a.state_dict().items():
            assert torch.equal(b.state_dict()[k], v), k
    m = pmech.DAGMechanism(GRAPH, ADJ, hidden=48, dtype=torch.bfloat16)
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    opt = ClippedAdam(m.parameters(), 1e-2, None, torch.float32)
    m(torch.ones(4, 9)).float().square().sum().backward()
    opt.step()
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}


def test_flax_init_refuses_a_leaf_it_does_not_know():
    m = torch.nn.Module()
    m.odd = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="no flax initializer known for 'odd'"):
        pvae.flax_init_(m, 0)


class _Started(Exception):
    pass


def test_every_trainer_starts_from_flax_init(monkeypatch):
    """Each trainer that builds its own model hands it to ``flax_init_``
    (stopped there): the MNIST pair, the CVAE, the vessel flagship, the
    translator's ViT-VAE, C10, and the analysis probes."""
    from types import SimpleNamespace

    from causalvae_tpu_torch.analysis import independence, residual
    from causalvae_tpu_torch.config import MnistConfig
    from causalvae_tpu_torch.train import workloads as PW

    seen = []

    def record(model, seed):
        seen.append((type(model).__name__, seed))
        raise _Started

    monkeypatch.setattr(pvae, "flax_init_", record)
    corpus = SimpleNamespace(m=np.zeros((4, 12)), t_dim=19, group_names=["a", "b", "c"])
    calls = [
        lambda: PW.train_mnist(None, MnistConfig(), device="cpu"),
        lambda: PW.train_cvae(None, device="cpu"),
        lambda: PW.train_vessel(corpus, img_hw=(64, 96), device="cpu"),
        lambda: PW.train_vit_vae(None, (64, 96), latent_dim=8, device="cpu"),
        lambda: PW.train_cascade(corpus, device="cpu"),
        lambda: independence._train_probe(np.zeros((4, 28, 28, 1)), np.zeros((4, 12)), None,
                                          epochs=1, batch_size=2, lr=1e-3, seed=5,
                                          device="cpu"),
        lambda: residual.train_classifier_on(np.zeros((4, 28, 28, 1)), np.zeros(4),
                                             seed=6, device="cpu"),
    ]
    for call in calls:
        with pytest.raises(_Started):
            call()
    assert seen == [("CausalConvVAE", MnistConfig().seed), ("ConditionalVAE", 42),
                    ("CausalViTVAE", 42), ("ViTVAE", 42), ("CausalBioVAE", 42),
                    ("MDecoder", 5), ("SimpleClassifier", 6)]

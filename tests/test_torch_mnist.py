"""The port's MNIST modules against the JAX package on the CPU: config,
host morphology, data, models, heads, mechanism and ``port_maps``.

Inputs come from numpy seeds through both packages, at the small size of
``tests/test_workloads_cli.py`` (``synthetic_mnist(48, seed=7)``, z 6); the
JAX weights are initialised, perturbed (``torch_port_helpers.perturb``) and
carried across by ``from_jax_variables``.

Tolerances:
- bit for bit: ``synthetic_mnist``; ``extract_features_batch`` with 12 and
  16 features (the cv2 Hu-moment path on both sides); ``build_morph_mnist``'s
  m, t and cache digest, with a cache hit and a miss; ``MorphDataset.batches``
  order; ``load_idx`` / ``load_mnist_dir`` on IDX files the tests write;
- forwards at max|Δ| <= 1e-5 max|ref| + 1e-6: ``CausalConvVAE`` encode,
  decode and the whole forward (JAX's noise injected) as C1 and C4;
  ``MorphPredictor`` in its four (gaussian, activation) forms;
  ``DAGMechanism`` on the t -> m graph and a 3-factor graph, deterministic
  and Gaussian; ``LatentDiscriminator``; ``SimpleClassifier``. The worst
  reading over these was 4.6e-7 of max|ref|.
"""

import dataclasses
import gzip
import hashlib
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu import config as jcfg
from causalvae_tpu.data import mnist as JM
from causalvae_tpu.models import heads as jheads
from causalvae_tpu.models import mechanism as jmech
from causalvae_tpu.models import vae as jvae
from causalvae_tpu.ops import morphology_host as JMH

from causalvae_tpu_torch import config as pcfg
from causalvae_tpu_torch.data import mnist as PM
from causalvae_tpu_torch.models import heads as pheads
from causalvae_tpu_torch.models import mechanism as pmech
from causalvae_tpu_torch.models.vae import CausalConvVAE
from causalvae_tpu_torch.ops import morphology_host as PMH
from causalvae_tpu_torch.train.port_maps import from_jax_variables

from torch_port_helpers import close, init_jax, load_port, two_threads  # noqa: F401

FWD = dict(rel=1e-5, abs_=1e-6)  # the module docstring's forward bound
Z = 6


@pytest.fixture(scope="module")
def corpus():
    """The synthetic corpus of both packages: (JAX images, labels, port
    images, labels)."""
    return (*JM.synthetic_mnist(48, seed=7), *PM.synthetic_mnist(48, seed=7))


def test_config_and_feature_names_equal_jax():
    assert dataclasses.asdict(pcfg.MnistConfig()) == dataclasses.asdict(jcfg.MnistConfig())
    assert tuple(pcfg.FEATURE_NAMES_12) == tuple(jcfg.FEATURE_NAMES_12)
    assert tuple(pcfg.FEATURE_NAMES_16) == tuple(jcfg.FEATURE_NAMES_16)


def test_synthetic_mnist_bit_for_bit(corpus):
    ji, jl, pi, pl = corpus
    assert pi.dtype == ji.dtype == np.float32 and pi.shape == (48, 28, 28)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pl, jl)
    assert len(set(pl.tolist())) == 10 and pi.max() > 0.9 and (pi > 0.2).mean() > 0.05


def _edge_images():
    """An empty image, one pixel, a one-pixel line (a degenerate hull), a
    ring (Euler 0) and two blobs of equal area (the tie to the lowest label)."""
    imgs = np.zeros((5, 28, 28), np.float32)
    imgs[1, 5, 5] = 1.0
    imgs[2, 4, 3:20] = 0.7
    imgs[3, 8:20, 8:20] = 0.9
    imgs[3, 11:17, 11:17] = 0.0
    imgs[4, 2:6, 2:6] = 0.5
    imgs[4, 20:24, 20:24] = 0.6
    return imgs


@pytest.mark.parametrize("n_features", [12, 16])
def test_extract_features_batch_bit_for_bit(corpus, n_features):
    assert PMH._HAS_CV2 and JMH._HAS_CV2  # the cv2 Hu-moment path on both sides
    imgs = np.concatenate([corpus[2][:24], _edge_images()])
    got = PMH.extract_features_batch(imgs, n_features)
    want = JMH.extract_features_batch(imgs, n_features)
    assert got.shape == (29, n_features) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not got[-5].any()  # the empty image


@pytest.mark.parametrize("case", ["miss", "hit", "stale"])
def test_build_morph_mnist_bit_for_bit_and_its_cache(corpus, tmp_path, case):
    """m, t, labels and the cache file (m and digest) equal JAX's. ``hit``:
    each side reads the other's cache and does not measure; ``stale``: a
    cache of another corpus of the same size is measured anew."""
    ji, jl, pi, pl = corpus
    jpath, ppath = str(tmp_path / "j" / "c.npz"), str(tmp_path / "p" / "c.npz")
    if case == "stale":
        other = PM.build_morph_mnist(pi[::-1].copy(), pl[::-1].copy())
        for path in (jpath, ppath):
            os.makedirs(os.path.dirname(path))
            np.savez(path, m=other.m, digest="0" * 40)
    want = JM.build_morph_mnist(ji, jl, cache_path=jpath)
    if case == "hit":
        os.makedirs(os.path.dirname(ppath))
        np.savez(ppath, m=np.full_like(want.m, 7.0), digest=str(np.load(jpath)["digest"]))
    got = PM.build_morph_mnist(pi, pl, cache_path=ppath)
    if case == "hit":
        assert (got.m == 7.0).all()  # read from the cache, not measured
        got = PM.build_morph_mnist(pi, pl, cache_path=jpath)  # JAX's cache
    for k in ("x", "m", "t", "labels"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert getattr(got, k).dtype == getattr(want, k).dtype
    jblob, pblob = np.load(jpath), np.load(ppath)
    assert str(pblob["digest"]) == str(jblob["digest"]) == hashlib.sha1(
        np.ascontiguousarray(pi[::max(1, 48 // 64)]).tobytes() + b"|12|host").hexdigest()
    if case != "hit":
        np.testing.assert_array_equal(pblob["m"], jblob["m"])


def test_build_morph_mnist_limit_and_device_extractor(corpus):
    _, _, pi, pl = corpus
    ds = PM.build_morph_mnist(pi, pl, n_features=16, limit_count=10)
    want = JM.build_morph_mnist(pi, pl, n_features=16, limit_count=10)
    np.testing.assert_array_equal(ds.m, want.m)
    assert ds.x.shape == (10, 28, 28, 1) and ds.t.shape == (10, 10)
    with pytest.raises(NotImplementedError, match="ops/morphology.py"):
        PM.build_morph_mnist(pi, pl, use_device_extractor=True)


def test_batches_order_equals_jax(corpus):
    """Two epochs from one generator, a ragged corpus, and no shuffle."""
    _, _, pi, pl = corpus
    ds_p = PM.build_morph_mnist(pi[:45], pl[:45])
    ds_j = JM.MorphDataset(ds_p.x, ds_p.m, ds_p.t, ds_p.labels)
    for rng_of, kw in ((lambda: np.random.default_rng(42), {}),
                       (lambda: None, dict(drop_remainder=False))):
        rp, rj = rng_of(), rng_of()
        for _ in range(2):
            got = list(ds_p.batches(16, rp, **kw))
            want = list(ds_j.batches(16, rj, **kw))
            assert len(got) == len(want) == (2 if not kw else 3)
            for g, w in zip(got, want):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])


def _write_idx(path, arr, code):
    body = struct.pack(">HBB", 0, code, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape) + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    with (gzip.open if path.endswith(".gz") else open)(path, "wb") as f:
        f.write(body)


@pytest.mark.parametrize("ext", ["", ".gz"])
def test_load_idx_and_mnist_dir(tmp_path, ext):
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (7, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 7).astype(np.uint8)
    floats = rng.standard_normal((3, 4)).astype(np.float32)
    _write_idx(str(tmp_path / f"train-images-idx3-ubyte{ext}"), images, 8)
    _write_idx(str(tmp_path / f"train-labels-idx1-ubyte{ext}"), labels, 8)
    _write_idx(str(tmp_path / f"f{ext}"), floats, 13)
    for path in (f"train-images-idx3-ubyte{ext}", f"f{ext}"):
        got, want = PM.load_idx(str(tmp_path / path)), JM.load_idx(str(tmp_path / path))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(PM.load_idx(str(tmp_path / f"f{ext}")), floats)
    gi, gl = PM.load_mnist_dir(str(tmp_path))
    wi, wl = JM.load_mnist_dir(str(tmp_path))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)
    assert gi.dtype == np.float32 and gl.dtype == np.int32
    with pytest.raises(FileNotFoundError):
        PM.load_mnist_dir(str(tmp_path), train=False)
    (tmp_path / "bad").write_bytes(b"\x01\x00\x08\x01\x00\x00\x00\x00")
    with pytest.raises(ValueError, match="bad IDX magic"):
        PM.load_idx(str(tmp_path / "bad"))


def _mnist_inputs(b, seed=3, m_dim=12, t_dim=10):
    rng = np.random.default_rng(seed)
    x = rng.random((b, 28, 28, 1), dtype=np.float32)
    m = rng.standard_normal((b, m_dim), dtype=np.float32)
    t = np.eye(t_dim, dtype=np.float32)[rng.integers(0, t_dim, b)]
    return x, m, t


def _t(a):
    return torch.from_numpy(np.asarray(a))


def conv_vae_pair(bayes: bool, seed: int = 0, z_dim: int = Z):
    """(JAX CausalConvVAE, its perturbed variables, the port model)."""
    kw = dict(m_dim=12, t_dim=10, z_dim=z_dim, gaussian_mechanism=bayes, decode_real_m=bayes)
    jm = jvae.CausalConvVAE(**kw)
    x, m, t = _mnist_inputs(1)
    v = init_jax(jm, jnp.asarray(x), jnp.asarray(m), jnp.asarray(t),
                 rng=jax.random.PRNGKey(seed), seed=seed)
    return jm, v, load_port(CausalConvVAE(**kw, device="cpu"), v)


@pytest.mark.parametrize("bayes", [False, True], ids=["C1", "C4"])
def test_causal_conv_vae_matches_jax(bayes):
    jm, v, pm = conv_vae_pair(bayes)
    x, m, t = _mnist_inputs(5)
    key = jax.random.PRNGKey(11)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(m), jnp.asarray(t), rng=key)
    eps = np.asarray(jax.random.normal(key, (5, Z)))
    with torch.no_grad():
        got = pm(_t(x), _t(m), _t(t), eps=_t(eps))
        mu, logvar = pm.encode(_t(x), _t(m), _t(t))
        z = np.random.default_rng(4).standard_normal((5, Z)).astype(np.float32)
        dec = pm.decode(_t(m), _t(z))
    jmu, jlv = jm.apply(v, jnp.asarray(x), jnp.asarray(m), jnp.asarray(t), method=jm.encode)
    close(mu, jmu, **FWD)
    close(logvar, jlv, **FWD)
    close(dec, jm.apply(v, jnp.asarray(m), jnp.asarray(z), method=jm.decode), **FWD)
    assert got.recon_x.shape == (5, 28, 28, 1)
    for name in ("recon_x", "m_hat", "mu", "logvar", "m_mu", "m_logvar"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None) == (name in ("m_mu", "m_logvar") and not bayes)
        if w is not None:
            close(g, w, **FWD)
    close(pm.predict_m(_t(t)), jm.apply(v, jnp.asarray(t), method=jm.predict_m), **FWD)


def test_decode_flatten_order_is_nhwc():
    """A permutation of dec_fc's outputs that an NCHW reshape would need
    changes the port's decode: the (7, 7, 64) order is JAX's, not a lucky
    symmetry; the same for enc_fc1's inputs."""
    jm, v, pm = conv_vae_pair(False)
    x, m, t = _mnist_inputs(3)
    z = np.random.default_rng(4).standard_normal((3, Z)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(m), jnp.asarray(z), method=jm.decode)
    perm = torch.arange(3136).reshape(7, 7, 64).permute(2, 0, 1).reshape(-1)
    with torch.no_grad():
        pm.dec_fc.weight.copy_(pm.dec_fc.weight[perm])
        pm.dec_fc.bias.copy_(pm.dec_fc.bias[perm])
        wrong = pm.decode(_t(m), _t(z))
    assert float((wrong - _t(np.asarray(want))).abs().max()) > 1e-2


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("activation", ["relu", "leaky_relu"])
def test_morph_predictor_matches_jax(gaussian, activation):
    kw = dict(hidden=(32, 16), gaussian=gaussian, activation=activation, logvar_clip=None)
    jm = jmech.MorphPredictor(m_dim=12, **kw)
    t = np.eye(10, dtype=np.float32)[[0, 3, 9, 5]] + 0.1
    v = init_jax(jm, jnp.asarray(t), seed=2)
    pm = load_port(pmech.MorphPredictor(10, 12, **kw), v)
    sd = pm.state_dict()
    assert ("out.weight" in sd) != gaussian and ("mu.weight" in sd) == gaussian
    want = jm.apply(v, jnp.asarray(t))
    with torch.no_grad():
        got = pm(_t(t))
        mean = pm.mean(_t(t))
    want, got = (want, got) if gaussian else ((want,), (got,))
    for g, w in zip(got, want):
        close(g, w, **FWD)
    close(mean, jm.apply(v, jnp.asarray(t), method=jm.mean), **FWD)


def test_morph_predictor_logvar_clip_and_bn_layers():
    pm = pmech.MorphPredictor(10, 12, gaussian=True, logvar_clip=0.5)
    with torch.no_grad():
        pm.logvar.bias.fill_(3.0)
        assert float(pm(torch.eye(10))[1].max()) == 0.5
    with pytest.raises(NotImplementedError, match="cascade"):
        pmech.MorphPredictor(10, 12, bn_layers=(0,))
    with pytest.raises(ValueError):
        pmech.MorphPredictor(10, 12, activation="gelu")


DAG_3 = (("a", 3), ("b", 4), ("c", 2)), np.array([[0, 1, 1], [0, 0, 1], [0, 0, 0]])
DAG_TM = (("t", 10), ("m", 12)), np.array([[0, 1], [0, 0]])


@pytest.mark.parametrize("graph", [DAG_TM, DAG_3], ids=["t->m", "3-factor"])
@pytest.mark.parametrize("gaussian", [False, True])
def test_dag_mechanism_matches_jax(graph, gaussian):
    factors, adj = graph
    total = sum(d for _, d in factors)
    jm = jmech.DAGMechanism(factors=factors, adjacency=adj, hidden=16, gaussian=gaussian)
    vals = np.random.default_rng(8).standard_normal((6, total)).astype(np.float32)
    v = init_jax(jm, jnp.asarray(vals), seed=4)
    pm = load_port(pmech.DAGMechanism(factors, adj, hidden=16, gaussian=gaussian), v)
    want = jm.apply(v, jnp.asarray(vals))
    with torch.no_grad():
        got = pm(_t(vals))
    want, got = (want, got) if gaussian else ((want,), (got,))
    for g, w in zip(got, want):
        close(g, w, **FWD)
    root = factors[0][1]  # the first factor has no parents: passed through
    np.testing.assert_array_equal(got[0][:, :root].numpy(), vals[:, :root])
    if gaussian:
        assert not got[1][:, :root].any()


def test_latent_discriminator_matches_jax():
    jm = jheads.LatentDiscriminator(t_dim=10)
    z = np.random.default_rng(9).standard_normal((7, Z)).astype(np.float32)
    v = init_jax(jm, jnp.asarray(z), seed=5)
    assert sorted(v["params"]) == ["Dense_0", "Dense_1", "Dense_2"]
    pm = load_port(pheads.LatentDiscriminator(t_dim=10, z_dim=Z, device="cpu"), v)
    assert sorted(n for n, _ in pm.named_children()) == ["fc1", "fc2", "out"]
    with torch.no_grad():
        close(pm(_t(z)), jm.apply(v, jnp.asarray(z)), **FWD)


def test_simple_classifier_matches_jax():
    jm = jheads.SimpleClassifier()
    x = _mnist_inputs(4)[0]
    v = init_jax(jm, jnp.asarray(x), seed=6)
    pm = load_port(pheads.SimpleClassifier(device="cpu"), v)
    wf, wl = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        gf, gl = pm(_t(x))
    close(gf, wf, **FWD)
    close(gl, wl, **FWD)


def test_port_maps_is_strict_on_the_mnist_models():
    """A leaf without a port home, a missing leaf and a wrong shape raise;
    gradients (a params-only tree) map onto the parameters alone."""
    jm, v, pm = conv_vae_pair(False)
    extra = {"params": {**v["params"], "Dense_9": {"kernel": np.zeros((2, 2), np.float32)}}}
    with pytest.raises(KeyError, match="Dense_9"):
        from_jax_variables(pm, extra)
    missing = {"params": {k: w for k, w in v["params"].items() if k != "dec_conv2"}}
    with pytest.raises(KeyError, match="dec_conv2"):
        from_jax_variables(pm, missing)
    bad = {"params": {**v["params"], "enc_fc2": {
        "kernel": np.zeros((512, 3), np.float32), "bias": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError, match="enc_fc2"):
        from_jax_variables(pm, bad)
    sd = from_jax_variables(pm, {"params": v["params"]})
    assert set(sd) == {k for k, _ in pm.named_parameters()}
    # the 4x4 transposed convs: (kH, kW, C_out, C_in) -> (C_in, C_out, kH, kW)
    assert tuple(sd["dec_conv1.weight"].shape) == (64, 32, 4, 4)
    np.testing.assert_array_equal(
        sd["dec_conv1.weight"].numpy(), v["params"]["dec_conv1"]["kernel"].transpose(3, 2, 0, 1))

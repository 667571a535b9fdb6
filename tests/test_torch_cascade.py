"""The port's causal cascade against the JAX package on the CPU:
``data/cascade.py``, ``MorphPredictor(bn_layers=...)``, ``CausalBioVAE``
(C10), ``train_cascade`` and the CLI's ``train cascade`` and ``cascade``.

Inputs come from numpy seeds through both packages; JAX's weights (its own
initialisation, perturbed by ``torch_port_helpers.init_jax`` where the test
builds the model, else as ``_generic_train`` makes them) are carried across
by ``from_jax_variables``, and JAX's noise and augmentation draws are
injected. The JAX stack readers import tifffile, which these tests do not
require: the ``pil_tifffile`` fixture puts a stand-in built on PIL's
multi-frame reader into ``sys.modules`` (nothing of ``causalvae_tpu``
changes).
Tolerances, each with its worst reading here:
- the eval transform and the augmentation with JAX's draws (resize,
  flips, brightness / contrast, standardisation): 1e-5 max|ref|
  [<= 1.3e-6]; a warped image 3e-5 [<= 1.1e-5]: the sampling coordinates
  differ by an ulp (7.6e-6 near 64; XLA contracts y·cos - x·sin + cy into
  FMAs), times the neighbour differences of the noise images;
- ``scan_cascade_corpus`` against pandas, ``synthetic_cascade_corpus``, the
  batch order and the page-by-page MIP: equal;
- C10 in train and eval mode, and ``MorphPredictor(bn_layers=(0,))`` with
  its running statistics: 1e-5 max|ref| + 1e-6 [<= 4.6e-7];
- C10 at bf16 against JAX's bf16 model (``test_torch_bf16._jit``), every
  output bf16, mean|Δ| / mean|ref|: recon 6e-3 [4.3e-3], mu, logvar and M'
  3e-3 [1.6e-3, 7.5e-4, 0: M' equal bits]; the f32 port on the same weights
  (the control) misses each [9.3e-3, 6.7e-3, 6.1e-3, 5.7e-3];
- one C10 step: loss terms rel 1e-5, every gradient leaf 1e-4 of its
  max|ref|, the running statistics 1e-5;
- three steps of ``train_cascade`` (one an epoch: the step's metrics are
  logged per epoch): the loss terms at rel 1e-4 [<= 5.2e-6], but the KL
  term of step 2 at rel 1e-2 [2.4e-3]. From step 1 on, Adam turns
  gradients at the rounding level into updates of ±lr: after one step 3 of
  the 2.1 M ``enc_fc1`` weights and 2 of each 0.5 M conv kernel had moved by
  1e-3 in opposite directions on the two sides, and the BatchNorm-fed
  ``mechanism.shared.0.bias`` (gradient 0 up to rounding) by ±1e-3 in every
  entry; the encoder's mu and logvar, which the KL term reads directly, move
  with them. The repo's f32 trajectory bound is 2e-2
  (``tests/test_parity_trajectory.py``). The same run with each epoch given
  another epoch's augmentation draws misses (loss rel 1.8e-3 at step 0).
"""

import csv
import functools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from causalvae_tpu.data import cascade as JC
from causalvae_tpu.data import vessel as JV
from causalvae_tpu.models import mechanism as jmech
from causalvae_tpu.models import vae as jvae
from causalvae_tpu.train import workloads as JW

from causalvae_tpu_torch.data import cascade as PC
from causalvae_tpu_torch.models.mechanism import MorphPredictor
from causalvae_tpu_torch.models.vae import CausalBioVAE
from causalvae_tpu_torch.train import workloads as PW
from causalvae_tpu_torch.train.port_maps import from_jax_variables
from test_torch_bf16 import _errs, _jit
from torch_port_helpers import (close, init_jax, load_port, perturb, to_numpy_tree,  # noqa: F401
                                two_threads)

FWD = dict(rel=1e-5, abs_=1e-6)
XTOL = dict(rel=1e-5, abs_=0.0)
WARP_REL = 3e-5
BF16_MEAN = {"recon_x": 6e-3, "m_hat": 3e-3, "mu": 3e-3, "logvar": 3e-3}
TRAJ_REL = 1e-4
KLD_STEP2_REL = 1e-2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def pil_tifffile(monkeypatch):
    """A ``tifffile`` stand-in for the JAX readers: ``imread`` and
    ``TiffFile(...).pages[i].asarray()`` on PIL's multi-frame reader."""
    from PIL import Image

    def frames(path):
        with Image.open(path) as im:
            out = []
            for i in range(im.n_frames):
                im.seek(i)
                out.append(np.array(im))
        return out

    class Page:
        def __init__(self, a):
            self._a = a

        def asarray(self):
            return self._a

    class TiffFile:
        def __init__(self, path):
            self.pages = [Page(a) for a in frames(path)]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def imread(path):
        f = frames(path)
        return f[0] if len(f) == 1 else np.stack(f)

    mod = types.ModuleType("tifffile")
    mod.imread, mod.TiffFile = imread, TiffFile
    monkeypatch.setitem(sys.modules, "tifffile", mod)
    return mod


def jax_augment_params(key, n):
    """JAX's ``make_augment`` draws for a batch of ``n`` under ``key``, as the
    port's ``apply_augment`` takes them."""
    keys = jax.random.split(key, n)
    rows = []
    for k in keys:
        ks = jax.random.split(k, 8)
        rows.append({
            "hflip": bool(jax.random.bernoulli(ks[0])),
            "vflip": bool(jax.random.bernoulli(ks[1])),
            "shift": np.asarray(jax.random.uniform(ks[2], (2,), minval=-0.05, maxval=0.05)),
            "scale": 1.0 + float(jax.random.uniform(ks[3], (), minval=-0.05, maxval=0.05)),
            "angle": float(jax.random.uniform(ks[4], (), minval=-15.0, maxval=15.0)),
            "warp": bool(jax.random.bernoulli(ks[5])),
            "brightness": float(jax.random.uniform(ks[6], (), minval=-0.01, maxval=0.1)),
            "contrast": 1.0 + float(jax.random.uniform(ks[7], (), minval=-0.01, maxval=0.05)),
            "bc": bool(jax.random.bernoulli(jax.random.fold_in(ks[6], 1))),
        })
    out = {}
    for k in PC.AUGMENT_KEYS:
        vals = [r[k] for r in rows]
        out[k] = (torch.tensor(vals) if k in ("hflip", "vflip", "warp", "bc")
                  else torch.from_numpy(np.asarray(vals, np.float32)))
    return out


def jax_batch_params(n_batches, batch, seed):
    """The draws of JAX ``iterate_batches(train=True, seed=seed)``'s batches."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_batches):
        key, sub = jax.random.split(key)
        out.append(jax_augment_params(sub, batch))
    return out


def _raw(b, hw=(150, 170), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((b, *hw)) * 3000.0).astype(np.float32)


def test_eval_preprocess_matches_jax():
    raw = _raw(3)
    want = np.asarray(JC.make_eval_preprocess((64, 96))(jnp.asarray(raw)))
    got = PC.make_eval_preprocess((64, 96), "cpu")(_t(raw))
    close(got, want, **XTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_matches_jax_with_its_draws(seed):
    """JAX's ``make_augment`` on a key against ``apply_augment`` with the
    parameters that key draws; the three keys' 24 images take every branch
    (each coin both ways)."""
    raw = _raw(8, seed=seed)
    key = jax.random.PRNGKey(100 + seed)
    params = jax_augment_params(key, 8)
    want = np.asarray(JC.make_augment((64, 96))(jnp.asarray(raw), key))
    got = PC.make_augment((64, 96), "cpu")(_t(raw), params=params)
    assert got.shape == want.shape
    for i, warped in enumerate(params["warp"].tolist()):
        close(got[i], want[i], rel=WARP_REL if warped else XTOL["rel"], abs_=0.0)
    if seed == 0:  # the port's own draws: every coin both ways over a batch of 64
        drawn = PC.draw_augment(64, torch.Generator().manual_seed(0))
        for k in ("hflip", "vflip", "warp", "bc"):
            assert 0 < int(drawn[k].sum()) < 64, k
        assert drawn["angle"].abs().max() <= 15 and (drawn["scale"] - 1).abs().max() <= 0.05


def test_crop_and_clip_is_jax_s():
    img = _raw(1, (260, 40), seed=4)[0] * 2
    np.testing.assert_array_equal(PC.crop_and_clip(img), np.asarray(JC.crop_and_clip(img)))
    small = _raw(1, (50, 40), seed=5)[0] * 2
    np.testing.assert_array_equal(PC.crop_and_clip(small), np.asarray(JC.crop_and_clip(small)))


def _write_cascade_csv(root, groups, ids, features=None):
    """A CSV of ``Image ID,group_name,<features>`` under ``root`` (seeded
    features, ``features`` {(row, column): cell} replacing cells); returns
    its path."""
    rng = np.random.default_rng(3)
    path = os.path.join(root, "cascade.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Image ID", "group_name", *JV.FEATURE_COLUMNS])
        for i, (img_id, g) in enumerate(zip(ids, groups)):
            feats = [repr(float(v)) for v in rng.normal(0, 5, len(JV.FEATURE_COLUMNS))]
            if features is not None:
                feats = [features.get((i, c), v) for c, v in enumerate(feats)]
            w.writerow([img_id, g, *feats])
    return path


CASES = {
    # numeric groups, an unmatched row (its group absent from the result), NA
    # and text feature cells
    "int_groups": (["3", "1", "3", "2", "7", "1"], ["11", "12", "13", "14", "99", "16"],
                   {(0, 2): "", (1, 5): "abc", (3, 0): "NA"}),
    # text groups; an ID column with a missing cell reads as float ("11.0")
    "text_groups": (["ctrl", "drug_a", "ctrl", "drug_b"], ["11", "", "13", "14"],
                    {(2, 11): "nan"}),
    # a group column with a missing cell in an unmatched row reads as float
    "float_groups": (["1", "2", "", "2"], ["11", "12", "98", "14"], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_cascade_corpus_matches_jax_with_pandas(tmp_path, case):
    groups, ids, feats = CASES[case]
    csv_path = _write_cascade_csv(str(tmp_path), groups, ids, feats)
    sub = tmp_path / "stacks" / "deep"
    sub.mkdir(parents=True)
    for i in ("11", "12", "13", "14", "16", "11.0", "13.0"):
        (sub / f"Plate-A-{i}.vessel.tiff").write_bytes(b"")
    (sub / "Plate-A-15.tiff").write_bytes(b"")  # not *.vessel.tiff: unmatched
    want = JC.scan_cascade_corpus(csv_path, [str(tmp_path)])
    got = PC.scan_cascade_corpus(csv_path, [str(tmp_path)])
    assert got.paths == want.paths and len(got.paths) > 0
    assert got.group_names == list(want.group_names)
    assert [type(g) for g in got.group_names] == [type(g.item() if hasattr(g, "item") else g)
                                                  for g in want.group_names]
    for k in ("m_raw", "m", "t_idx", "m_min", "m_denom"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_synthetic_cascade_corpus_equals_jax():
    got, want = PC.synthetic_cascade_corpus(n=12, seed=3), JC.synthetic_cascade_corpus(n=12,
                                                                                      seed=3)
    np.testing.assert_array_equal(got.raw_images, want.raw_images)
    for k in ("m_raw", "m", "t_idx", "m_min", "m_denom"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert got.group_names == want.group_names


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_iterate_batches_order_and_eval_images_match_jax(train):
    corpus = PC.synthetic_cascade_corpus(n=11, seed=1)
    jcorpus = JC.synthetic_cascade_corpus(n=11, seed=1)
    kw = dict(train=train, seed=5, drop_remainder=train)
    got = list(PC.iterate_batches(corpus, 4, (64, 128), device="cpu", **kw))
    want = list(JC.iterate_batches(jcorpus, 4, (64, 128), **kw))
    assert len(got) == len(want) == (2 if train else 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["t"].numpy(), w["t"])
        np.testing.assert_array_equal(g["m"].numpy(), w["m"].astype(np.float32))
        assert g["x"].shape == w["x"].shape
        if not train:
            close(g["x"], np.asarray(w["x"]), **XTOL)


def test_load_mip_paged_and_file_corpus_batches_match_jax(tmp_path, pil_tifffile):
    """Stacks on disk (PIL multi-frame, 3-4 pages, 240 rows: cropped):
    JAX's reader through the stand-in against the native page walk, and the
    eval batches of a file corpus."""
    from PIL import Image

    rng = np.random.default_rng(8)
    ids = ["21", "22", "23", "24", "25"]
    for k, i in enumerate(ids):
        pages = [Image.fromarray(rng.integers(0, 4000, (240, 130)).astype(np.uint16))
                 for _ in range(3 + k % 2)]
        pages[0].save(str(tmp_path / f"P-{i}.vessel.tiff"), save_all=True,
                      append_images=pages[1:], compression="tiff_deflate")
    csv_path = _write_cascade_csv(str(tmp_path), ["a", "b", "a", "b", "a"], ids)
    corpus = PC.scan_cascade_corpus(csv_path, str(tmp_path))
    jcorpus = JC.scan_cascade_corpus(csv_path, [str(tmp_path)])
    for p in corpus.paths:
        np.testing.assert_array_equal(PC.load_mip_paged(p), JC.load_mip_paged(p))
    got = list(PC.iterate_batches(corpus, 2, (64, 128), train=False, drop_remainder=False,
                                  device="cpu"))
    want = list(JC.iterate_batches(jcorpus, 2, (64, 128), train=False, drop_remainder=False))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        close(g["x"], np.asarray(w["x"]), **XTOL)


def test_morph_predictor_with_batchnorm_matches_jax():
    """``bn_layers=(0,)``: train mode (batch statistics, the running ones
    updated with momentum 0.9 and the biased variance), then eval mode on
    them; ``shared_bn_0`` maps to ``shared_bn.0``."""
    rng = np.random.default_rng(2)
    t = np.eye(7, dtype=np.float32)[rng.integers(0, 7, 16)]
    jm = jmech.MorphPredictor(m_dim=5, hidden=(16, 8), bn_layers=(0,))
    v = init_jax(jm, jnp.asarray(t), train=False, seed=3)
    assert set(v["batch_stats"]) == {"shared_bn_0"}
    pm = load_port(MorphPredictor(7, 5, hidden=(16, 8), bn_layers=(0,)), v)
    want, mutated = jm.apply(v, jnp.asarray(t), train=True, mutable=["batch_stats"])
    got = pm.train()(_t(t))
    close(got, want, **FWD)
    stats = from_jax_variables(pm, {"params": v["params"],
                                    "batch_stats": to_numpy_tree(mutated["batch_stats"])})
    for k in ("shared_bn.0.mean", "shared_bn.0.var"):
        close(pm.state_dict()[k], stats[k].numpy(), **FWD)
    v2 = {"params": v["params"], "batch_stats": to_numpy_tree(mutated["batch_stats"])}
    close(pm.eval()(_t(t)), jm.apply(v2, jnp.asarray(t)), **FWD)
    with pytest.raises(ValueError, match="no hidden layer"):
        MorphPredictor(7, 5, hidden=(16,), bn_layers=(1,))


def _c10_pair(dtype=jnp.float32, seed=0, m_dim=12, t_dim=6, z_dim=16, hw=(64, 128)):
    """(JAX C10, its variables perturbed as ``init_jax``'s, the init jitted)."""
    jm = jvae.CausalBioVAE(m_dim=m_dim, t_dim=t_dim, z_dim=z_dim, dtype=dtype)
    key = jax.random.PRNGKey(seed)
    v = jax.jit(functools.partial(jm.init, train=False))(
        {"params": key, "dropout": key}, jnp.zeros((1, *hw, 1)), jnp.zeros((1, m_dim)),
        jnp.zeros((1,), jnp.int32), rng=key)
    return jm, perturb(v, seed + 1)


def _c10_inputs(b=6, hw=(64, 128), m_dim=12, t_dim=6, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, *hw, 1)).astype(np.float32),
            rng.random((b, m_dim), dtype=np.float32),
            rng.integers(0, t_dim, b).astype(np.int32))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_causal_bio_vae_matches_jax(train):
    jm, v = _c10_pair()
    pm = load_port(CausalBioVAE(t_dim=6, z_dim=16, device="cpu"), v).train(train)
    x, m, t = _c10_inputs()
    key = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.normal(key, (6, 16)))
    want = jax.jit(functools.partial(jm.apply, train=train,
                                     mutable=["batch_stats"] if train else False))(
        v, jnp.asarray(x), jnp.asarray(m), jnp.asarray(t), rng=key)
    if train:
        want, mutated = want
    got = pm(_t(x), _t(m), _t(t), eps=_t(eps))
    assert got.recon_x.shape == (6, 64, 128, 1)
    for name in ("recon_x", "m_hat", "mu", "logvar"):
        close(getattr(got, name), getattr(want, name), **FWD)
    if train:
        st = to_numpy_tree(mutated["batch_stats"])["mechanism"]["shared_bn_0"]
        for k in ("mean", "var"):
            close(pm.state_dict()[f"mechanism.shared_bn.0.{k}"], st[k], **FWD)
    with pytest.raises(AssertionError, match="divisible by 64"):
        pm(_t(x[:, :48]), _t(m), _t(t), eps=_t(eps))


def test_predict_m_runs_the_mechanism_in_eval_whatever_the_mode():
    jm, v = _c10_pair(seed=5)
    pm = load_port(CausalBioVAE(t_dim=6, z_dim=16, device="cpu"), v)
    eye = np.eye(6, dtype=np.float32)
    want = jm.apply(v, jnp.asarray(eye), method=jm.predict_m)
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    for mode in (False, True):
        close(pm.train(mode).predict_m(_t(eye)), want, **FWD)
    assert all(torch.equal(before[k], t) for k, t in pm.state_dict().items())
    # in train mode the mechanism itself reads batch statistics: a different M'
    assert not torch.allclose(pm.train().mechanism(_t(eye)), _t(np.asarray(want)), atol=1e-3)


def test_causal_bio_vae_in_bf16_matches_jax_with_an_f32_control():
    """Eval forward at ``dtype=bfloat16``: every output bf16, each mean
    relative error under its ``BF16_MEAN``, which the f32 port on the same
    weights misses."""
    jm, v = _c10_pair(dtype=jnp.bfloat16, seed=2)
    x, m, t = _c10_inputs(seed=6)
    key = jax.random.PRNGKey(1)
    eps = np.asarray(jax.random.normal(key, (6, 16), jnp.bfloat16).astype(jnp.float32))

    def fwd(variables, xx, mm, tt):
        return jm.apply(variables, xx, mm, tt, rng=key)

    want = _jit(fwd, v, jnp.asarray(x), jnp.asarray(m), jnp.asarray(t))
    outs = {}
    for dt in (torch.bfloat16, torch.float32):
        pm = load_port(CausalBioVAE(t_dim=6, z_dim=16, dtype=dt, device="cpu"), v)
        with torch.no_grad():
            outs[dt] = pm(_t(x), _t(m), _t(t), eps=_t(eps))
    for name in ("recon_x", "m_hat", "mu", "logvar"):
        ref = np.asarray(getattr(want, name).astype(jnp.float32))
        got = getattr(outs[torch.bfloat16], name)
        assert got.dtype == torch.bfloat16, name
        mean, _ = _errs(got.float().numpy(), ref)
        ctrl, _ = _errs(getattr(outs[torch.float32], name).numpy(), ref)
        assert mean <= BF16_MEAN[name] < ctrl, (name, mean, ctrl)


@pytest.fixture(scope="module")
def cascade_run():
    """JAX ``train_cascade`` for 3 epochs of one step (n = 4, batch 4,
    64x128), and a runner of the port's from JAX's initial weights, noise
    and augmentation draws."""
    jcorpus = JC.synthetic_cascade_corpus(n=4, n_groups=3, seed=2)
    corpus = PC.synthetic_cascade_corpus(n=4, n_groups=3, seed=2)
    hw, z = (64, 128), 8
    jmodel, _, jlog = JW.train_cascade(jcorpus, img_hw=hw, z_dim=z, epochs=3,
                                           batch_size=4)
    key = jax.random.PRNGKey(42)
    b0 = next(JC.iterate_batches(jcorpus, 2, hw, train=False))
    v0 = to_numpy_tree(jax.jit(functools.partial(jmodel.init, train=True))(
        {"params": key, "dropout": key}, jnp.asarray(b0["x"]), jnp.asarray(b0["m"]),
        jnp.asarray(b0["t"]), rng=key))
    noise, k = [], key
    for _ in range(3):
        k, sub = jax.random.split(k)
        noise.append(torch.from_numpy(np.asarray(
            jax.random.normal(jax.random.split(sub)[0], (4, z)))))
    augs = [jax_batch_params(1, 4, 42 + e)[0] for e in range(3)]

    def run(aug_list=augs):
        model = load_port(CausalBioVAE(m_dim=12, t_dim=3, z_dim=z, device="cpu"), v0)
        return PW.train_cascade(corpus, img_hw=hw, z_dim=z, epochs=3, batch_size=4,
                                model=model, noise=iter(noise), aug_params=iter(aug_list))

    return [r for r in jlog.history if r["step"] >= 0], run, augs


def _misses(want, plog):
    """{(step, term): (port, JAX)} of the terms off by more than their bound:
    rel ``TRAJ_REL``, the KL term of step 2 ``KLD_STEP2_REL``."""
    got = [r for r in plog.history if r["step"] >= 0]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1, 2]
    return {(r["step"], k): (g[k], r[k]) for g, r in zip(got, want)
            for k in ("train_loss", "train_recon", "train_morph", "train_kld")
            if abs(g[k] - r[k]) > (KLD_STEP2_REL if (r["step"], k) == (2, "train_kld")
                                   else TRAJ_REL) * abs(r[k])}


def test_train_cascade_trajectory_matches_jax(cascade_run):
    want, run, augs = cascade_run
    _, _, plog = run()
    assert _misses(want, plog) == {}
    assert plog.history[-1]["images_per_sec"] > 0
    _, _, wrong = run(augs[1:] + augs[:1])  # each epoch another epoch's draws
    assert _misses(want, wrong) != {}


def test_causal_bio_vae_step0_matches_jax():
    """One ``make_vae_step`` of C10 (train mode, batch 6) against JAX's
    ``make_vae_step`` with the same noise: the loss terms at rel 1e-5, every
    gradient leaf at 1e-4 of its max|ref| and the updated running
    statistics at 1e-5. ``mechanism.shared.0.bias`` feeds the BatchNorm,
    so its gradient is 0 up to rounding on both sides (held below 1e-6 of
    the largest gradient instead)."""
    import optax

    from causalvae_tpu.ops import losses as JL
    from causalvae_tpu.train.loop import make_vae_step as jax_vae_step
    from causalvae_tpu.train.state import TrainState

    from causalvae_tpu_torch.ops import losses as PL
    from causalvae_tpu_torch.train.loop import make_vae_step
    from causalvae_tpu_torch.train.state import ClippedAdam

    jm, v = _c10_pair(seed=7)
    x, m, t = _c10_inputs(seed=9)
    batch = {"x": x, "m": m, "t": t}
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    state = TrainState.create(v, optax.chain(capture, optax.adam(1e-3)))
    rng = jax.random.PRNGKey(11)
    state, jmet = jax.jit(jax_vae_step(jm, lambda o, b: JL.cascade_loss(o, b["x"], b["m"]),
                                       has_batch_stats=True))(
        state, {k: jnp.asarray(a) for k, a in batch.items()}, rng)
    eps = np.asarray(jax.random.normal(jax.random.split(rng)[0], (6, 16)))
    pm = load_port(CausalBioVAE(t_dim=6, z_dim=16, device="cpu"), v)
    opt = ClippedAdam(pm.parameters(), 1e-3, None, mu_dtype=torch.float32)
    pmet = make_vae_step(pm, lambda o, b: PL.cascade_loss(o, b["x"], b["m"]), opt)(
        {k: _t(a) for k, a in batch.items()}, eps=_t(eps))
    assert set(pmet) == set(jmet) == {"loss", "recon", "morph", "kld"}
    for k in jmet:
        assert abs(float(pmet[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), k
    grads = from_jax_variables(pm, {"params": to_numpy_tree(state.opt_state[0])})
    top = max(float(g.abs().max()) for g in grads.values())
    for name, p in pm.named_parameters():
        if name == "mechanism.shared.0.bias":
            assert max(float(p.grad.abs().max()), float(grads[name].abs().max())) < 1e-6 * top
            continue
        close(p.grad, grads[name].numpy(), rel=1e-4, abs_=0.0)
    stats = to_numpy_tree(state.batch_stats)["mechanism"]["shared_bn_0"]
    for k in ("mean", "var"):
        close(pm.state_dict()[f"mechanism.shared_bn.0.{k}"], stats[k], **FWD)


def _cli(tmp_path, *argv):
    from causalvae_tpu_torch.cli.main import main

    return main(["--out", str(tmp_path / "out"), "--n-synthetic", "8", *argv,
                 "--device", "cpu"])


def test_cli_train_cascade_and_cascade(tmp_path, capsys):
    """``train cascade`` and ``cascade`` at one epoch on the synthetic
    cascade corpus (n = 40, 128x192): the run directory, and the ranking CSV
    with one row per feature."""
    _, _, log = _cli(tmp_path, "train", "cascade", "--epochs", "1", "--batch-size", "8")
    run = tmp_path / "out" / "train_cascade"
    assert (run / "metrics.jsonl").exists() and (run / "latest.pt").exists()
    assert np.isfinite(log.history[0]["train_loss"])
    rep = _cli(tmp_path, "cascade", "--epochs", "1", "--batch-size", "8")
    with open(tmp_path / "out" / "sensitivity_ranking.csv") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["feature", "importance"]
    assert [r["feature"] for r in rows] == rep["ranking"] and len(rows) == 12
    assert (tmp_path / "out" / "train_cascade" / "latest.pt").exists()
    with pytest.raises(SystemExit):
        _cli(tmp_path, "train", "cascade", "--resume")
    capsys.readouterr()

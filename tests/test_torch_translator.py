"""The port's latent translator against the JAX package on the CPU:
``data/translator.py``, ``analysis/translate.py``, ``make_simple_vae_step``'s
options, ``train_vit_vae``, ``extract_vit_latents`` and the CLI's ``train
vit`` and ``translate``.

Inputs come from numpy seeds through both packages; JAX's weights (as its
``_generic_train`` initialises them, or perturbed by
``torch_port_helpers.perturb``) are carried across by ``from_jax_variables``
and JAX's noise is injected. JAX's ``load_stack`` imports tifffile, which
these tests do not require: the ``pil_tifffile`` fixture of
``tests/test_torch_cascade.py`` stands in (PIL's multi-frame reader).
Tolerances, each with its worst reading here:
- ``scan_image_roots``, ``match_table`` (against JAX on a pandas DataFrame
  of the same CSV), the stack reads and ``analysis/translate.py`` (numpy,
  the same seeds): equal;
- ``make_preprocess``, batched and ragged, and ``iterate_images``: 1e-5
  max|ref| [<= 2.4e-7]; ``percentile`` above 2^24 values, where
  ``torch.quantile`` refuses: equal to ``jnp.percentile``;
- one ``train_vit_vae`` step of the translator ViTVAE (depth 2, dropout 0):
  loss terms rel 1e-5 [<= 2.5e-7]; parameters after the step within 2·lr
  (Adam's first step moves every entry by about ±lr, so an entry whose
  tiny gradient differs in sign by rounding may land 2·lr away, as
  ``tests/test_torch_train.py`` holds the vessel step), and in each leaf at
  most 2 entries, or 1e-3 of them, more than lr away [worst 1 of 128,
  ``dec_res.0.bn0.scale``; 15 of 147,456], but for the biases of the
  convolutions before a BatchNorm, whose gradient is 0 up to rounding on
  both sides (``BN_FED``: Adam moves them by ±lr either way; 13 of 32
  entries of ``stem_convs.0.bias``); the running statistics at 1e-4 of
  max|ref|;
- ``extract_vit_latents``: 1e-5 max|ref| + 1e-6 [<= 3.6e-7].
"""

import csv
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from causalvae_tpu.analysis import translate as JT
from causalvae_tpu.data import translator as JD
from causalvae_tpu.models.vit import ViTVAE as JaxViTVAE
from causalvae_tpu.train import workloads as JW

from causalvae_tpu_torch.analysis import translate as PT
from causalvae_tpu_torch.data import translator as PD
from causalvae_tpu_torch.models.vae import ConditionalVAE
from causalvae_tpu_torch.models.vit import ViTVAE
from causalvae_tpu_torch.train import workloads as PW
from causalvae_tpu_torch.train.loop import make_simple_vae_step
from causalvae_tpu_torch.train.port_maps import from_jax_variables
from causalvae_tpu_torch.train.state import ClippedAdam
from test_torch_cascade import pil_tifffile  # noqa: F401
from torch_port_helpers import close, load_port, to_numpy_tree, two_threads  # noqa: F401

XTOL = dict(rel=1e-5, abs_=0.0)
HW = (64, 96)
SMALL_VIT = dict(img_size=HW, latent_dim=16, embed_dim=32, depth=2, heads=4, mlp_dim=64,
                 dropout=0.0, dec_res_stages=4)
LR = 1e-4
# the biases of the convolutions before a BatchNorm: gradient 0 up to rounding
BN_FED = re.compile(r"^(stem_convs\.\d+|dec_ct\.\d+|dec_res\.\d+\.conv[01])\.bias$")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _write_stacks(root, ids, seed=0, shapes=None, compression="tiff_deflate"):
    """Multi-page uint16 TIFF stacks (PIL ``save_all``) named
    ``<plate>-<id>.vessel.tiff`` under ``root``; ``shapes[i]`` the (pages, h,
    w) of stack i (default (3, 50, 70)). Returns {id: stack}."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = {}
    for k, i in enumerate(ids):
        p, h, w = (shapes or {}).get(k, (3, 50, 70))
        stack = rng.integers(0, 4000, (p, h, w)).astype(np.uint16)
        frames = [Image.fromarray(a) for a in stack]
        frames[0].save(os.path.join(root, f"Plate{k}-{i}.vessel.tiff"), save_all=True,
                       append_images=frames[1:], compression=compression)
        out[i] = stack
    return out


def test_scan_image_roots_equals_jax(tmp_path):
    for sub in ("a/b", "c"):
        (tmp_path / sub).mkdir(parents=True)
    for name in ("a/b/P1-101.vessel.tiff", "a/P2-102.tif", "c/X-Y-103.TIF",
                 "c/P3-104.vessel.mip.tiff", "c/notes.txt", "c/P9-105.png"):
        (tmp_path / name).write_bytes(b"")
    roots = [str(tmp_path / "a"), str(tmp_path / "c")]
    got = PD.scan_image_roots(roots)
    assert got == JD.scan_image_roots(roots)
    assert set(got) == {"101", "102", "103.TIF", "104.mip"}  # JAX strips lower case only
    assert PD.scan_image_roots(str(tmp_path / "a")) == JD.scan_image_roots(str(tmp_path / "a"))


ID_CASES = {
    "int_leading_zeros": ["007", "12", "0013", "99"],
    "missing_id": ["7", "", "13", "NA"],
    "text": ["a7", "12", "13", "b-2"],
}


@pytest.mark.parametrize("case", sorted(ID_CASES))
def test_match_table_types_ids_as_pandas(tmp_path, case):
    """``match_table`` on the stdlib CSV rows against JAX's on pandas'
    DataFrame of the same file: the kept rows and their ``Image ID``
    strings (an int column "007" -> "7"; a float one "7" -> "7.0")."""
    path = tmp_path / "table.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Image ID", "group_name", "Node count"])
        for k, i in enumerate(ID_CASES[case]):
            w.writerow([i, f"g{k % 2}", k * 1.5])
    path_map = {i: f"/x/{i}.tif" for i in ("7", "12", "13", "7.0", "13.0", "a7", "nan")}
    want = JD.match_table(pd.read_csv(path), path_map)
    with open(path, newline="") as f:
        got = PD.match_table(list(csv.DictReader(f)), path_map)
    assert [r["Image ID"] for r in got] == want["Image ID"].tolist()
    assert [r["group_name"] for r in got] == want["group_name"].tolist()
    typed = pd.read_csv(path)["Image ID"].astype(str)
    assert PD.id_strings(ID_CASES[case]) == [None if pd.isna(v) else v for v in typed]


def _raws(b, hw, seed):
    rng = np.random.default_rng(seed)
    raw = rng.gamma(2.0, 400.0, (b, *hw)).astype(np.float32)
    raw[0, :5, :5] = 60000.0  # outliers above the 99.5th percentile
    return raw


@pytest.mark.parametrize("hw", [(64, 96), (150, 90)], ids=["down", "mixed"])
def test_make_preprocess_matches_jax(hw):
    raw = _raws(3, (100, 130), seed=1)
    want = np.asarray(JD.make_preprocess(hw)(jnp.asarray(raw)))
    got = PD.make_preprocess(hw, device="cpu")(_t(raw))
    close(got, want, **XTOL)
    one = np.asarray(JD.make_preprocess(hw, batched=False)(jnp.asarray(raw[1])))
    close(PD.make_preprocess(hw, batched=False, device="cpu")(_t(raw[1])), one, **XTOL)
    const = np.full((1, 20, 30), 5.0, np.float32)  # a constant image: span 1e-5
    close(PD.make_preprocess(hw, device="cpu")(_t(const)),
          np.asarray(JD.make_preprocess(hw)(jnp.asarray(const))), **XTOL)


def test_percentile_above_two_to_the_24():
    """``torch.quantile`` raises above 2^24 values; the port's
    ``percentile`` gives ``jnp.percentile``'s linear interpolation there,
    bit for bit: the position (n - 1)·q in float32 (n = 2^24 + 3 rounds to
    2^24 + 4), its neighbours by ``numpy.partition`` (jnp.percentile itself
    is held at small sizes above)."""
    n = 2**24 + 3
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(torch.from_numpy(x), 0.995)
    pos = np.float32(np.float32(99.5) / np.float32(100)) * (np.float32(n) - np.float32(1))
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = np.float32(pos - np.floor(pos))
    part = np.partition(x, (lo, hi))
    want = part[lo] * (np.float32(1) - w_hi) + part[hi] * w_hi
    assert float(PD.percentile(torch.from_numpy(x)[None], 99.5)[0]) == float(want)


def test_iterate_images_matches_jax_on_stacks(tmp_path, pil_tifffile):
    """Stacks of 3 and 4 pages (one of another size: a ragged batch), a
    one-page file, batches of 2: the MIP, the transform and the short tail
    batch as JAX's, through the stand-in tifffile there and the native page
    walk here."""
    ids = ["11", "12", "13", "14", "15"]
    stacks = _write_stacks(str(tmp_path), ids, shapes={1: (4, 50, 70), 3: (3, 40, 60),
                                                       4: (1, 50, 70)})
    rows = [{"Image ID": i, "group_name": "g"} for i in ids + ["16"]]
    path_map = PD.scan_image_roots(str(tmp_path))
    assert path_map == JD.scan_image_roots(str(tmp_path))
    kept = PD.match_table(rows, path_map)
    assert [r["Image ID"] for r in kept] == ids
    for i in ids:
        got = PD.load_stack(path_map[i])
        np.testing.assert_array_equal(got, JD.load_stack(path_map[i]))
        np.testing.assert_array_equal(PD.mip(got), stacks[i].max(axis=0).astype(np.float32))
    want = list(JD.iterate_images(pd.DataFrame(kept), path_map, 2, resize_hw=HW))
    got = list(PD.iterate_images(kept, path_map, 2, resize_hw=HW, device="cpu"))
    assert [b["id"] for b in got] == [b["id"] for b in want] == [ids[:2], ids[2:4], ids[4:]]
    for g, w in zip(got, want):
        close(g["x"], np.asarray(w["x"]), **XTOL)
    raw = np.stack([PD.mip(PD.load_stack(path_map[i])) for i in ("11", "12")])
    (b,) = list(PD.iterate_images(kept[:2], path_map, 2, resize_hw=HW, raw_images=raw,
                                  device="cpu"))
    close(b["x"], np.asarray(want[0]["x"]), **XTOL)


def test_load_stack_zero_image_is_logged_and_counted(tmp_path, capsys):
    bad = tmp_path / "P-1.tiff"
    bad.write_bytes(b"II*\0not a tiff")
    before = PD.LOAD_FAILURES
    for path in (str(bad), str(tmp_path / "missing.tif")):
        out = PD.load_stack(path)
        assert out.shape == (100, 100) and not out.any()
        assert out.shape == JD.load_stack(path).shape
    assert PD.LOAD_FAILURES == before + 2
    err = capsys.readouterr().err
    assert err.count("a (100, 100) zero image stands in") == 2 and str(bad) in err
    np.save(tmp_path / "a.npy", np.arange(6, dtype=np.uint16).reshape(2, 3))
    np.testing.assert_array_equal(PD.load_stack(str(tmp_path / "a.npy")),
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    assert PD.LOAD_FAILURES == before + 2


def test_translate_analysis_equals_jax():
    rng = np.random.default_rng(5)
    z = rng.standard_normal((30, 8))
    m = z[:, :4] @ rng.standard_normal((4, 5)) + 0.3 * rng.standard_normal((30, 5))
    m[:, 4] = 1.0  # a constant feature
    names = [f"f{i}" for i in range(5)]
    groups = rng.integers(0, 3, 30)
    for a, b in ((PT.ridge_fit(z, m), JT.ridge_fit(z, m)),):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(PT.ridge_loocv_predictions(z, m, 0.5),
                                  JT.ridge_loocv_predictions(z, m, 0.5))
    got, want = PT.fit_translator(z, m, names), JT.fit_translator(z, m, names)
    assert got["ranking"] == want["ranking"] and got["r2"] == want["r2"]
    assert got["corr"] == want["corr"]
    for k in ("W", "intercept", "loo_predictions"):
        np.testing.assert_array_equal(got[k], want[k])
    assert PT.group_contrasts(z, groups, ["a", "b", "c"]) == JT.group_contrasts(
        z, groups, ["a", "b", "c"])
    assert PT.bootstrap_topk_stability(z, m, names, k=2, n_boot=20, seed=3) == \
        JT.bootstrap_topk_stability(z, m, names, k=2, n_boot=20, seed=3)


def test_simple_step_options_refuse_what_they_cannot_honour():
    vit = ViTVAE(**dict(SMALL_VIT, dropout=0.1), device="cpu")
    opt = ClippedAdam(vit.parameters(), LR, None, mu_dtype=torch.float32)
    with pytest.raises(ValueError, match="has_batch_stats=False"):
        make_simple_vae_step(vit, None, opt, arg_names=("x",), needs_dropout=True,
                             train_kw=True)
    with pytest.raises(ValueError, match="needs_dropout=True"):
        make_simple_vae_step(vit, None, opt, arg_names=("x",), has_batch_stats=True,
                             train_kw=True)
    # eval mode (train_kw=False) draws no dropout: accepted
    make_simple_vae_step(vit, None, opt, arg_names=("x",), has_batch_stats=True)
    cvae = ConditionalVAE(device="cpu")
    make_simple_vae_step(cvae, None, ClippedAdam(cvae.parameters(), LR, None, torch.float32))


@pytest.fixture(scope="module")
def vit_step():
    """One step (batch 4) of JAX's ``train_vit_vae`` on the small translator
    ViTVAE, built as that function builds it (``optax.adam(lr)``,
    ``make_simple_vae_step(arg_names=("x",), needs_dropout=True,
    has_batch_stats=True, train_kw=True)``, the key split as
    ``_generic_train`` splits it) with its init jitted (eagerly it takes
    ~30 s on a CPU); returns the model, the state after the step, its
    metrics, the initial variables, the batch and the step's noise."""
    import optax

    from causalvae_tpu.ops import losses as JL
    from causalvae_tpu.train.loop import make_simple_vae_step as jax_simple_step
    from causalvae_tpu.train.state import TrainState

    rng = np.random.default_rng(7)
    x = rng.random((4, *HW, 1), dtype=np.float32)
    jm = JaxViTVAE(**SMALL_VIT, packed=False)
    key = jax.random.PRNGKey(42)
    v0 = jax.jit(functools.partial(jm.init, train=True))(
        {"params": key, "dropout": key}, jnp.asarray(x), rng=key)

    def loss_fn(outputs, batch):
        recon, _, mu, logvar = outputs
        return JL.vit_vae_loss(recon, batch["x"], mu, logvar, beta=1.0)

    step = jax.jit(jax_simple_step(jm, loss_fn, arg_names=("x",), needs_dropout=True,
                                   has_batch_stats=True, train_kw=True))
    _, sub = jax.random.split(key)
    state, metrics = step(TrainState.create(v0, optax.adam(LR)), {"x": jnp.asarray(x)}, sub)
    eps = np.asarray(jax.random.normal(jax.random.split(sub)[0], (4, 16)))
    return jm, state, {k: float(v) for k, v in metrics.items()}, to_numpy_tree(v0), x, eps


def test_train_vit_vae_step_matches_jax(vit_step):
    jm, state, want, v0, x, eps = vit_step
    pm = load_port(ViTVAE(**SMALL_VIT, device="cpu"), v0)
    _, _, plog = PW.train_vit_vae(lambda e: iter([{"x": _t(x)}]), HW, epochs=1, lr=LR,
                                  model=pm, noise=iter([_t(eps)]))
    got = plog.history[0]
    for k in ("loss", "recon", "kld"):
        assert abs(got[f"train_{k}"] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)
    ref = from_jax_variables(pm, to_numpy_tree(state.variables))
    params = dict(pm.named_parameters())
    for name, t in pm.state_dict().items():
        if name in params:
            d = (t - ref[name]).abs().max()
            assert d <= 2 * LR * (1 + 1e-3), (name, float(d))
            if not BN_FED.match(name):  # few entries landed away from JAX's
                off = int(((t - ref[name]).abs() > LR).sum())
                assert off <= max(2, 1e-3 * t.numel()), (name, off, t.numel())
        else:
            close(t, ref[name].numpy(), rel=1e-4, abs_=0.0)
    assert pm.training  # train mode, as JAX's train=True


def test_extract_vit_latents_matches_jax(vit_step):
    jm, state, _, _, x, _ = vit_step
    pm = load_port(ViTVAE(**SMALL_VIT, device="cpu"),
                   to_numpy_tree(state.variables)).train()
    xs = np.concatenate([x, x[::-1] * 0.5])
    batches = [{"x": xs[:3]}, {"x": xs[3:]}]
    want = JW.extract_vit_latents(jm, state, iter(batches))
    got = PW.extract_vit_latents(pm, iter({"x": _t(b["x"])} for b in batches))
    assert got.shape == (8, 16) and not pm.training
    close(got, want, rel=1e-5, abs_=1e-6)


def _cli(tmp_path, *argv):
    from causalvae_tpu_torch.cli.main import main

    return main(["--out", str(tmp_path / "out"), "--n-synthetic", "8", *argv,
                 "--device", "cpu"])


def test_cli_train_vit_and_translate(tmp_path, capsys):
    """``train vit`` (the default widths, latent 128, 96x160) and
    ``translate`` at one epoch on the synthetic vessel corpus (n = 8): the
    run directories, and ``trackA_ranking.csv`` with one row per feature."""
    model, _, log = _cli(tmp_path, "train", "vit", "--epochs", "1")
    assert model.img_size == (96, 160) and model.fc_mu.out_features == 128
    assert len(model.dec_res) == 4 and np.isfinite(log.history[0]["train_loss"])
    assert (tmp_path / "out" / "train_vit" / "latest.pt").exists()
    rep = _cli(tmp_path, "translate", "--epochs", "1")
    with open(tmp_path / "out" / "trackA_ranking.csv") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["feature", "r2", "corr"] and len(rows) == 12
    assert [r["feature"] for r in rows] == rep["ranking"]
    assert rep["loo_predictions"].shape == (8, 12)  # every sample, the tail batch too
    with pytest.raises(SystemExit):
        _cli(tmp_path, "train", "vit", "--img-hw", "64", "96")
    capsys.readouterr()

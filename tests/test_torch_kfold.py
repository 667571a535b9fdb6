"""The port's k-fold trainer and its CLI on the CPU
(``causalvae_tpu_torch/train/kfold.py``, ``cli/main.py`` ``kfold`` and
``vessel-report``).

- ``stratified_kfold`` equals sklearn's ``StratifiedKFold(shuffle=True,
  random_state=seed)`` fold for fold: labels in order of first appearance
  and out of order, ragged classes, several seeds and ``n_splits``
  (hypothesis draws more), the synthetic corpus' ``t_idx``; the same
  ``ValueError`` and ``UserWarning`` messages.
- ``verify_stratification`` and ``FoldBatcher`` equal the JAX package's:
  the same report and the same index arrays, step for step, across
  reshuffles.
- One epoch of ``train_kfold`` against JAX's, K = 3 folds of the small ViT
  (``torch_port_helpers.SMALL``, dropout 0, t 19) on the 23-mask synthetic
  corpus, whose val folds are ragged (8, 8, 7): JAX's initial fold weights
  carried across by ``from_jax_stacked_variables``, JAX's noise handed to
  the port. Per fold, the train metrics (the mean over the epoch's 3 steps)
  within rel 5e-3 and the val loss, recon, kld and morph within rel 1e-3,
  the bounds of ``tests/test_torch_workloads.py`` (readings: train 7.7e-4,
  val 6.5e-4, both kld of fold 1). The val sparsity (the sum of |recon| over
  the background) reads 1.21e-3 and is held at the train bound, 5e-3: the
  biases that feed a BatchNorm have no true gradient, so Adam moves them by
  about lr along the sign of rounding noise, which differs between the
  frameworks (after 3 steps up to 4e-4 apart, e.g. ``dec_ct.4.bias``); a
  train-mode BatchNorm cancels them, but the eval pass reads running
  statistics that absorb only a tenth of them a step. The val pass itself
  is exact: on JAX's final fold weights it gives JAX's val metrics within
  rel 1e-5 (readings <= 4e-7), sparsity included. Two controls miss: the
  val loss with the sample mask dropped (the padded fold counts a sample
  twice) and the folds compared one place apart.
- The per-fold checkpoint books: files, ``meta``, and a restore that gives
  back the fold's model.
- The CLI: ``kfold --verify`` prints JAX's JSON (the synthetic corpus, and a
  CSV corpus with integer group names); ``kfold`` and ``vessel-report`` run
  with ``--device cpu``; the seven CSV files have the headers and row counts
  of JAX's ``vessel-report`` on the same corpus (JAX's report stages run on
  the JAX folds of the parity fixture, its training replaced by them).
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.model_selection import StratifiedKFold

from causalvae_tpu.config import VesselConfig as JaxVesselConfig
from causalvae_tpu.data import vessel as JV
from causalvae_tpu.models.vit import CausalViTVAE as JaxCausalViTVAE
from causalvae_tpu.ops import losses as JL
from causalvae_tpu.train import kfold as JKF
from causalvae_tpu.train.loop import make_vae_eval_step as jax_eval_step
from causalvae_tpu.train.loop import make_vae_step as jax_vae_step

from causalvae_tpu_torch.cli.main import main as port_main
from causalvae_tpu_torch.config import VesselConfig
from causalvae_tpu_torch.data import vessel as PV
from causalvae_tpu_torch.models.vae import seeded_init_
from causalvae_tpu_torch.models.vit import CausalViTVAE
from causalvae_tpu_torch.ops import losses as PL
from causalvae_tpu_torch.train import kfold as KF
from causalvae_tpu_torch.train.checkpoints import CheckpointBook
from causalvae_tpu_torch.train.loop import make_vae_eval_step, vessel_loss_fn
from causalvae_tpu_torch.train.port_maps import from_jax_stacked_variables
from causalvae_tpu_torch.train.state import ClippedAdam

from torch_port_helpers import SMALL, to_numpy_tree, two_threads  # noqa: F401

TRAIN_REL, VAL_REL = 5e-3, 1e-3  # the epoch bounds of test_torch_workloads.py
# the val sparsity after training steps, at the train bound (the docstring)
VAL_REL_BY_METRIC = {"sparsity": TRAIN_REL}
EXACT_VAL_REL = 1e-5  # the val pass on the same (JAX's final) weights
N, K, BATCH = 23, 3, 4            # val folds 8, 8, 7; 3 lockstep steps an epoch
CSV_FILES = ("predictions_by_treatment", "uncertainty_by_treatment", "feature_stats",
             "pairwise_snr", "all_pairwise_report", "pairwise_report_formatted",
             "significant_changes")


# ---------------------------------------------------------------------------
# stratified_kfold against sklearn
# ---------------------------------------------------------------------------

def _sklearn(labels, n_splits, seed):
    """(folds, error message, warning messages) of sklearn's splitter."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            folds = [(tr, va) for tr, va in StratifiedKFold(
                n_splits, shuffle=True, random_state=seed).split(np.zeros(len(labels)),
                                                                 labels)]
            err = None
        except ValueError as e:
            folds, err = None, str(e)
    return folds, err, [str(w.message) for w in caught if w.category is UserWarning]


def _port(labels, n_splits, seed):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            plan = KF.stratified_kfold(labels, n_splits, seed)
            err = None
        except ValueError as e:
            plan, err = None, str(e)
    return plan, err, [str(w.message) for w in caught if w.category is UserWarning]


def _assert_same_folds(labels, n_splits, seed):
    want, want_err, want_warn = _sklearn(labels, n_splits, seed)
    plan, err, warned = _port(labels, n_splits, seed)
    assert (err, warned) == (want_err, want_warn)
    if want is None:
        return
    assert plan.n_folds == n_splits and np.array_equal(plan.labels, labels)
    for f, (tr, va) in enumerate(want):
        assert plan.train_idx[f].dtype == plan.val_idx[f].dtype == np.int32
        assert np.array_equal(plan.train_idx[f], tr), f
        assert np.array_equal(plan.val_idx[f], va), f


@pytest.mark.parametrize("labels, n_splits, seed", [
    ([0, 0, 0, 1, 1, 1, 2, 2, 2, 2], 3, 42),             # first appearance = sorted
    ([2, 2, 0, 1, 0, 2, 1, 0, 1, 2, 5, 5, 5], 3, 42),    # out of order, a gap
    ([7] * 11 + [3] * 5 + [1] * 2, 5, 0),                # ragged, a class below K
    ([1, 0] * 9 + [4] * 3, 4, 1234),
    (list(range(4)) * 6, 6, 7),
    ([0] * 5 + [1] * 5, 5, 42),                          # every class exactly K
], ids=["sorted", "out-of-order", "ragged-warns", "mixed", "round-robin", "equal"])
def test_stratified_kfold_equals_sklearn(labels, n_splits, seed):
    _assert_same_folds(np.asarray(labels), n_splits, seed)


@pytest.mark.parametrize("n_splits", [2, 3, 5])
def test_stratified_kfold_on_the_synthetic_corpus(n_splits):
    t_idx = PV.synthetic_corpus(n=96, seed=0).t_idx
    _assert_same_folds(t_idx, n_splits, 42)


@pytest.mark.parametrize("labels, n_splits", [
    ([0, 1, 2, 3, 0, 1, 2, 3], 3),   # every class below n_splits: ValueError
    ([0, 0, 1, 1, 2], 6),            # more splits than samples
    ([0, 0, 1, 1], 1),               # fewer than two splits
], ids=["all-classes-small", "n-splits-above-n", "one-split"])
def test_stratified_kfold_errors_as_sklearn(labels, n_splits):
    _, want_err, _ = _sklearn(np.asarray(labels), n_splits, 0)
    _, err, _ = _port(np.asarray(labels), n_splits, 0)
    assert want_err is not None and err == want_err


def test_stratified_kfold_warns_as_sklearn():
    labels = np.asarray([0] * 6 + [1] * 2)
    _, _, want = _sklearn(labels, 3, 0)
    _, _, got = _port(labels, 3, 0)
    assert want == got == ["The least populated class in y has only 2 members, "
                           "which is less than n_splits=3."]


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.lists(st.integers(0, 6), min_size=2, max_size=60), st.integers(2, 7),
       st.integers(0, 2**31 - 1))
def test_stratified_kfold_equals_sklearn_on_drawn_labels(labels, n_splits, seed):
    _assert_same_folds(np.asarray(labels), n_splits, seed)


# ---------------------------------------------------------------------------
# verify_stratification and FoldBatcher against JAX's
# ---------------------------------------------------------------------------

def test_verify_stratification_and_fold_batcher_equal_jax():
    corpus = PV.synthetic_corpus(n=40, seed=0)
    plan = KF.stratified_kfold(corpus.t_idx, 4, 42)
    jplan = JKF.stratified_kfold(corpus.t_idx, 4, 42)
    assert (KF.verify_stratification(plan, corpus.group_names)
            == JKF.verify_stratification(jplan, corpus.group_names))
    assert KF.verify_stratification(plan) == JKF.verify_stratification(jplan)
    ours, theirs = KF.FoldBatcher(plan, 3, seed=5), JKF.FoldBatcher(jplan, 3, seed=5)
    assert ours.steps_per_epoch() == theirs.steps_per_epoch() == 10
    for _ in range(4 * ours.steps_per_epoch()):  # every pool reshuffled 3 times
        a, b = ours.next_indices(), theirs.next_indices()
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# train_kfold against JAX's
# ---------------------------------------------------------------------------

def _jax_noise(plan, z_dim, seed=42, batch=BATCH):
    """The eps JAX's train_kfold draws in epoch 0 from PRNGKey(seed): per
    lockstep step one split of the key, split again per fold; each fold's
    step splits its key and draws eps from the first half; per val pass one
    split, split per fold, eps drawn from each fold's key."""
    key = jax.random.PRNGKey(seed)
    out = []
    steps = max(len(t) // batch for t in plan.train_idx)
    val_len = max(len(v) for v in plan.val_idx)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append([jax.random.normal(jax.random.split(k)[0], (batch, z_dim))
                    for k in jax.random.split(sub, plan.n_folds)])
    key, sub = jax.random.split(key)
    out.append([jax.random.normal(k, (val_len, z_dim))
                for k in jax.random.split(sub, plan.n_folds)])
    return [torch.from_numpy(np.stack([np.asarray(e, np.float32) for e in per]))
            for per in out]


def _port_model():
    return CausalViTVAE(**SMALL, dropout=0.0, device="cpu")


def _run_port(fold_states, data, labels, loss_fn=None, **kw):
    cfg = VesselConfig()

    def init_one(f):
        model = _port_model()
        model.load_state_dict(fold_states[f], strict=True)
        return model

    return KF.train_kfold(
        init_one=init_one,
        make_optimizer=lambda m: ClippedAdam(m.parameters(), cfg.lr, cfg.grad_clip_norm,
                                             mu_dtype=torch.bfloat16),
        loss_fn=loss_fn or vessel_loss_fn(cfg), data=data, labels=labels,
        batch_size=BATCH, n_folds=K, seed=42, **kw)


@pytest.fixture(scope="module")
def kfold_epoch():
    """JAX's train_kfold, one epoch of K folds of the small ViT on the
    N-mask synthetic corpus (the CLI's), and what the port needs to repeat it."""
    hw = SMALL["img_size"]
    corpus = JV.synthetic_corpus(n=N, hw=(96, 160), seed=0)
    x = np.asarray(JV.make_preprocess(hw)(jnp.asarray(corpus.raw_images),
                                          jnp.zeros(N, np.int32)))
    data = {"x": x, "m": corpus.m, "t": corpus.one_hot_t(np.arange(N))}
    jcfg = JaxVesselConfig()
    jm = JaxCausalViTVAE(**SMALL, packed=False, dropout=0.0)

    def loss_fn(out, batch):
        return JL.vessel_loss(out, batch["x"], batch["m"], beta=jcfg.beta,
                              lambda_morph=jcfg.lambda_morph,
                              lambda_sparsity=jcfg.lambda_sparsity, w=batch.get("w"))

    def init_one(k):
        return jm.init({"params": k, "dropout": k}, jnp.asarray(x[:2]),
                       jnp.asarray(corpus.m[:2]), jnp.asarray(data["t"][:2]), rng=k,
                       train=True)

    # the initial fold variables, as JAX's init_stacked_states makes them
    stacked = to_numpy_tree(jax.vmap(init_one)(jax.random.split(jax.random.PRNGKey(42), K)))
    tx = optax.chain(optax.clip_by_global_norm(jcfg.grad_clip_norm),
                     optax.adam(jcfg.lr, mu_dtype=jnp.dtype(jcfg.adam_mu_dtype)))
    states, plan, history = JKF.train_kfold(
        init_one=init_one, step_fn=jax_vae_step(jm, loss_fn, has_batch_stats=True,
                                                needs_dropout=True),
        eval_fn=jax_eval_step(jm, loss_fn, has_batch_stats=True), tx=tx, data=data,
        labels=corpus.t_idx, epochs=1, batch_size=BATCH, n_folds=K, seed=42,
        mesh=JKF.make_fold_mesh(K, devices=jax.devices()[:1]))
    fold_states = from_jax_stacked_variables([_port_model() for _ in range(K)], stacked)
    return dict(corpus=corpus, data=data, plan=plan, want=history[0], states=states,
                jax_model=jm, fold_states=fold_states,
                noise=_jax_noise(plan, SMALL["z_dim"]))


def _misses(got, want, perm=range(K)):
    """(split, metric, fold) outside the epoch bounds; ``perm`` pairs port
    fold f with JAX fold perm[f]."""
    out = []
    for split in ("train", "val"):
        assert set(got[split]) == set(want[split]) == {"loss", "recon", "kld", "morph",
                                                       "sparsity"}
        for k, w in want[split].items():
            rel = TRAIN_REL if split == "train" else VAL_REL_BY_METRIC.get(k, VAL_REL)
            for f, jf in enumerate(perm):
                if abs(got[split][k][f] - w[jf]) > rel * abs(w[jf]):
                    out.append((split, k, f))
    return out


def test_train_kfold_epoch_matches_jax(kfold_epoch):
    e = kfold_epoch
    assert [len(v) for v in e["plan"].val_idx] == [8, 8, 7]
    models, plan, history = _run_port(e["fold_states"], e["data"], e["corpus"].t_idx,
                                      epochs=1, noise=iter(e["noise"]))
    for f in range(K):
        assert np.array_equal(plan.val_idx[f], e["plan"].val_idx[f])
        assert np.array_equal(plan.train_idx[f], e["plan"].train_idx[f])
    assert len(history) == 1 and history[0]["epoch"] == 0
    got = history[0]
    assert all(v.shape == (K,) for part in ("train", "val") for v in got[part].values())
    assert _misses(got, e["want"]) == []
    # control: the folds one place apart miss in train and val, every fold
    missed = _misses(got, e["want"], perm=[1, 2, 0])
    assert {(split, f) for split, _, f in missed} == {
        (split, f) for split in ("train", "val") for f in range(K)}
    # the three models are independent: their parameters differ
    assert not torch.equal(models[0].morph.mu.weight, models[1].morph.mu.weight)


def test_val_pass_on_jax_final_weights_is_exact(kfold_epoch):
    """The port's val pass (the padded batch and mask of ``train_kfold``,
    per-sample means) on JAX's final fold weights gives JAX's val metrics
    within rel 1e-5."""
    e = kfold_epoch
    final = {"params": to_numpy_tree(e["states"].params),
             "batch_stats": to_numpy_tree(e["states"].batch_stats)}
    states = from_jax_stacked_variables([_port_model() for _ in range(K)], final)
    plan = e["plan"]
    val_len = max(len(v) for v in plan.val_idx)
    for f in range(K):
        model = _port_model()
        model.load_state_dict(states[f], strict=True)
        v = plan.val_idx[f]
        idx = np.pad(v, (0, val_len - len(v)), mode="edge")
        batch = {k: torch.as_tensor(np.asarray(a)[idx]) for k, a in e["data"].items()}
        batch["w"] = torch.as_tensor((np.arange(val_len) < len(v)).astype(np.float32))
        got = make_vae_eval_step(model, vessel_loss_fn(VesselConfig()))(
            batch, eps=e["noise"][-1][f])
        for k, want in e["want"]["val"].items():
            assert abs(float(got[k]) / len(v) - want[f]) <= EXACT_VAL_REL * abs(want[f]), (f, k)


def test_train_kfold_val_without_the_mask_misses(kfold_epoch):
    """Control: an eval loss that drops ``w`` counts the padded fold's last
    sample twice, and that fold's val metrics miss the bound."""
    e = kfold_epoch
    cfg = VesselConfig()

    def unmasked(out, batch):
        return PL.vessel_loss(out, batch["x"], batch["m"], beta=cfg.beta,
                              lambda_morph=cfg.lambda_morph,
                              lambda_sparsity=cfg.lambda_sparsity)

    _, _, history = _run_port(e["fold_states"], e["data"], e["corpus"].t_idx,
                              loss_fn=unmasked, epochs=1, noise=iter(e["noise"]))
    missed = _misses(history[0], e["want"])
    assert missed and all(split == "val" and f == 2 for split, _, f in missed)
    assert ("val", "loss", 2) in missed


def test_train_kfold_checkpoints_per_fold(tmp_path):
    """One book per fold under ``<dir>/fold_<f>``: latest and best every
    epoch from that fold's val loss, epoch_N every ``period``; a restore
    gives back the fold's model."""
    corpus = PV.synthetic_corpus(n=N, hw=(96, 160), seed=0)
    x = PV.make_preprocess(SMALL["img_size"], "cpu")(
        torch.from_numpy(corpus.raw_images), torch.zeros(N, dtype=torch.int32))
    data = {"x": x, "m": corpus.m, "t": corpus.one_hot_t(np.arange(N))}
    states = [seeded_init_(_port_model(), f).state_dict() for f in range(K)]
    models, _, history = _run_port(states, data, corpus.t_idx, epochs=2,
                                   checkpoint_dir=str(tmp_path), checkpoint_period=2)
    assert sorted(os.listdir(tmp_path)) == [f"fold_{f}" for f in range(K)]
    for f in range(K):
        run = tmp_path / f"fold_{f}"
        assert {"latest.pt", "latest.meta.json", "best.pt", "best.meta.json",
                "epoch_2.pt", "epoch_2.meta.json"} == set(os.listdir(run))
        vals = [float(h["val"]["loss"][f]) for h in history]
        best = int(np.argmin(vals))
        assert json.loads((run / "latest.meta.json").read_text()) == {"epoch": 1}
        assert json.loads((run / "best.meta.json").read_text()) == {
            "epoch": best, "val_loss": vals[best]}
        restored = _port_model()
        CheckpointBook(str(run)).restore("latest", restored)
        for k, v in models[f].state_dict().items():
            assert torch.equal(restored.state_dict()[k], v), (f, k)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _jax_main(argv):
    from causalvae_tpu.cli.main import main

    return main(argv)


@pytest.mark.parametrize("n, folds", [(24, 2), (N, K)])
def test_cli_kfold_verify_prints_jax_json(tmp_path, capsys, n, folds):
    argv = ["--out", str(tmp_path), "--n-synthetic", str(n), "kfold", "--verify",
            "--folds", str(folds)]
    _jax_main(argv)
    want = capsys.readouterr().out
    port_main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert len(json.loads(want)) == folds


def test_cli_kfold_verify_with_integer_group_names(tmp_path, capsys):
    """A CSV corpus whose group names are integers (typed as pandas types
    them): the same JSON. No image is read, so the files stay empty."""
    from causalvae_tpu_torch.data.vessel import FEATURE_COLUMNS

    rng = np.random.default_rng(0)
    groups = [10, 2, 1, 2, 10, 1, 2, 10, 1, 1, 2, 10]
    root = tmp_path / "tiffs"
    root.mkdir()
    lines = [",".join(["Image ID", "group_name", *FEATURE_COLUMNS])]
    for i, g in enumerate(groups):
        (root / f"H11-{500 + i}.vessel.mip.tiff").write_bytes(b"")
        lines.append(",".join([str(500 + i), str(g),
                               *(f"{v:.3f}" for v in rng.random(len(FEATURE_COLUMNS)))]))
    (tmp_path / "table.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    argv = ["--out", str(tmp_path / "out"), "kfold", "--verify", "--folds", "3",
            "--csv", str(tmp_path / "table.csv"), "--data", str(root)]
    _jax_main(argv)
    want = capsys.readouterr().out
    port_main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert json.loads(want)["fold_0"]["val_missing_classes"] == []


def _csv_shape(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], len(lines) - 1


def test_cli_kfold_and_vessel_report_on_the_cpu(kfold_epoch, tmp_path, monkeypatch, capsys):
    """``kfold`` and ``vessel-report`` with ``--device cpu`` on the N-mask
    synthetic corpus; the CSV files' headers and row counts equal those of
    JAX's ``vessel-report`` on the same corpus, whose k-fold training is
    replaced by the JAX folds of the parity fixture."""
    import causalvae_tpu.cli.main as jax_cli

    e = kfold_epoch
    common = ["--n-synthetic", str(N)]
    train = ["--epochs", "1", "--folds", str(K), "--batch-size", str(BATCH),
             "--img-hw", *map(str, SMALL["img_size"])]
    monkeypatch.setattr(jax_cli, "_kfold_train", lambda args, corpus, n_folds: (
        e["jax_model"], e["states"], e["plan"], e["data"], [e["want"]]))
    _jax_main(["--out", str(tmp_path / "jax"), *common, "vessel-report", *train])
    models, plan, data, history = port_main(
        ["--out", str(tmp_path / "kf"), *common, "kfold", *train, "--device", "cpu"])
    assert len(models) == K and len(history) == 1
    assert all(np.isfinite(history[0][s]["loss"]).all() for s in ("train", "val"))
    assert sorted(os.listdir(tmp_path / "kf" / "kfold")) == [f"fold_{f}" for f in range(K)]
    written = port_main(["--out", str(tmp_path / "port"), *common, "vessel-report", *train,
                         "--device", "cpu"])
    assert "[vessel-report] 7 CSV artifacts" in capsys.readouterr().out
    assert [os.path.basename(p) for p in written] == [f"{f}.csv" for f in CSV_FILES]
    for name in CSV_FILES:
        got = _csv_shape(tmp_path / "port" / f"{name}.csv")
        assert got == _csv_shape(tmp_path / "jax" / f"{name}.csv"), name
        assert got[1] > 0, name

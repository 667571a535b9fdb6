"""The port's vessel trainer, checkpoints and CLI on the CPU
(``causalvae_tpu_torch/train/workloads.py``, ``train/checkpoints.py``,
``cli/main.py``).

- ``CheckpointBook``: the JAX book's cadence and meta files; a restore gives
  back every ``state_dict`` entry bit for bit (parameters, BatchNorm running
  statistics, ``ClippedAdam``'s bfloat16 mu, nu and step count), the best-val
  watermark and the next epoch; the next step after a restore equals the
  unbroken run's bit for bit.
- One epoch of ``train_vessel`` against the JAX package's, from the same
  weights (the JAX init at ``PRNGKey(42)`` carried over by
  ``from_jax_variables``) on the same synthetic corpus, dropout 0, with the
  noise JAX draws handed to the port: the epoch's last train metrics within
  rel 5e-3 and the val loss within rel 1e-3. After the epoch's 7 steps this
  configuration differs by at most 6.1e-4 (``train_kld``; 2.2e-4
  ``train_recon``, 7.8e-5 ``val_loss``). Two faulty epochs miss the bound:
  no optimizer step (lr 0; ``train_recon`` off by 0.115, ``val_loss`` by
  6.0e-3) and the train batches of the next epoch's shuffle (every train
  metric off by 3.3e-2 to 5.5e-2). A wrong clip norm stays inside it (clip
  0.5: 7.1e-4; none: 1.5e-3), since Adam's update barely depends on the
  gradient's scale: ``tests/test_torch_train.py`` holds ``ClippedAdam``'s
  clip to optax.
- The CLI at 96x160 on the synthetic corpus: ``train vessel``, ``--resume``,
  ``serve vessel --ckpt``, and a ``--packed-io`` checkpoint served by the
  spatial model; the sample-reconstruction PNG.
"""

import copy
import dataclasses
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.config import VesselConfig as JaxVesselConfig
from causalvae_tpu.data import vessel as JV
from causalvae_tpu.models.vit import CausalViTVAE as JaxCausalViTVAE
from causalvae_tpu.train import workloads as JW

from causalvae_tpu_torch.config import VesselConfig
from causalvae_tpu_torch.data import vessel as PV
from causalvae_tpu_torch.models.vae import seeded_init_
from causalvae_tpu_torch.models.vit import CausalViTVAE
from causalvae_tpu_torch.train import workloads as PW
from causalvae_tpu_torch.train.checkpoints import CheckpointBook
from causalvae_tpu_torch.train.loop import make_vae_step, vessel_loss_fn
from causalvae_tpu_torch.train.port_maps import from_jax_variables
from causalvae_tpu_torch.train.state import ClippedAdam

from torch_port_helpers import SMALL, to_numpy_tree

TRAIN_REL, VAL_REL = 5e-3, 1e-3  # epoch-0 parity bounds (see the docstring)


def _small_batch(seed, b=4):
    rng = np.random.default_rng(seed)
    h, w = SMALL["img_size"]
    return {"x": torch.from_numpy((rng.random((b, h, w, 1)) > 0.9).astype(np.float32)),
            "m": torch.from_numpy(rng.standard_normal((b, 12)).astype(np.float32)),
            "t": torch.from_numpy(np.eye(19, dtype=np.float32)[rng.integers(0, 19, b)])}


def _trained_small(seed=0, steps=2):
    model = seeded_init_(CausalViTVAE(**SMALL, device="cpu"), seed)
    opt = ClippedAdam(model.parameters(), 1e-3, 5.0, torch.bfloat16)
    step = make_vae_step(model, vessel_loss_fn(VesselConfig()), opt)
    gen = torch.Generator().manual_seed(seed)
    for i in range(steps):
        step(_small_batch(i), generator=gen)
    return model, opt, step


def _assert_state_equal(a, b, where="state"):
    """Nested state dicts equal: tensors in dtype and bits, the rest by ==."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_state_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_state_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_checkpoint_book_cadence_and_meta(tmp_path):
    model, opt, _ = _trained_small()
    book = CheckpointBook(str(tmp_path), period=2)
    for epoch, val in enumerate([5.0, 6.0, 4.0, 4.5, None]):
        book.end_of_epoch(model, opt, epoch, val)
    files = sorted(os.listdir(tmp_path))
    assert files == ["best.meta.json", "best.pt", "epoch_2.meta.json", "epoch_2.pt",
                     "epoch_4.meta.json", "epoch_4.pt", "latest.meta.json", "latest.pt"]
    meta = {f: json.loads((tmp_path / f).read_text()) for f in files if f.endswith(".json")}
    assert meta["latest.meta.json"] == {"epoch": 4}
    assert meta["best.meta.json"] == {"epoch": 2, "val_loss": 4.0}
    assert meta["epoch_2.meta.json"] == {"epoch": 1}
    assert meta["epoch_4.meta.json"] == {"epoch": 3}
    assert book.best_val == 4.0


def test_restore_latest_is_bit_exact_and_the_next_step_equals(tmp_path):
    model, opt, step = _trained_small(seed=0, steps=3)
    book = CheckpointBook(str(tmp_path), period=50)
    book.end_of_epoch(model, opt, 0, 3.5)
    book.end_of_epoch(model, opt, 1, 7.0)
    saved_model = copy.deepcopy(model.state_dict())
    saved_opt = copy.deepcopy(opt.state_dict())

    other = seeded_init_(CausalViTVAE(**SMALL, device="cpu"), 9)
    other_opt = ClippedAdam(other.parameters(), 1e-3, 5.0, torch.bfloat16)
    book2 = CheckpointBook(str(tmp_path), period=50)
    assert book2.restore_latest(other, other_opt) == 2
    assert book2.best_val == 3.5
    _assert_state_equal(other.state_dict(), saved_model)
    _assert_state_equal(other_opt.state_dict(), saved_opt)
    assert [g["count"] for g in other_opt.param_groups] == [3]
    for p in other.parameters():
        assert other_opt.state[p]["mu"].dtype == torch.bfloat16
        assert other_opt.state[p]["nu"].dtype == torch.float32
    assert any("mean" in k for k in saved_model)  # BatchNorm running statistics

    # one step from the restored pair equals one from the originals
    b = _small_batch(11)
    eps = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, SMALL["z_dim"])).astype(np.float32))
    step2 = make_vae_step(other, vessel_loss_fn(VesselConfig()), other_opt)
    torch.manual_seed(6)  # nn.Dropout draws from torch's own generator
    m1 = step(b, generator=torch.Generator().manual_seed(5), eps=eps)
    torch.manual_seed(6)
    m2 = step2(b, generator=torch.Generator().manual_seed(5), eps=eps)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    _assert_state_equal(other.state_dict(), model.state_dict())
    _assert_state_equal(other_opt.state_dict(), opt.state_dict())
    # an empty run directory resumes at epoch 0 and loads nothing
    assert CheckpointBook(str(tmp_path / "empty")).restore_latest(other, other_opt) == 0


def _jax_noise(corpus, hw, cfg, z_dim, epoch=0):
    """The eps JAX's _generic_train draws in epoch 0 from PRNGKey(42): one
    split of the key per train step (the step splits its key again and
    draws eps from the first half) and one per val batch (eps from it)."""
    key = jax.random.PRNGKey(42)
    out = []
    for b in JV.iterate_batches(corpus, "train", cfg.batch_size, hw,
                                shuffle_seed=1000 + epoch):
        key, sub = jax.random.split(key)
        r_model, _ = jax.random.split(sub)
        out.append(jax.random.normal(r_model, (len(b["m"]), z_dim)))
    for b in JV.iterate_batches(corpus, "val", cfg.batch_size, hw, augment=False,
                                drop_remainder=False):
        key, sub = jax.random.split(key)
        out.append(jax.random.normal(sub, (len(b["m"]), z_dim)))
    return [torch.from_numpy(np.asarray(e, np.float32)) for e in out]


@pytest.fixture(scope="module")
def epoch0():
    """JAX's epoch 0 at the small ViT on a 24-mask synthetic corpus, and a
    runner of the port's from the same weights and noise -> (want, run)."""
    hw = SMALL["img_size"]
    corpus_j = JV.synthetic_corpus(n=24, hw=(96, 160), seed=0)
    corpus_p = PV.synthetic_corpus(n=24, hw=(96, 160), seed=0)
    jcfg = JaxVesselConfig(epochs=1)
    jm = JaxCausalViTVAE(**SMALL, packed=False, dropout=0.0)
    # JAX's _generic_train initialises at PRNGKey(42) on the first batch of 2
    b0 = next(JV.iterate_batches(corpus_j, "train", 2, hw, shuffle_seed=0))
    key = jax.random.PRNGKey(42)
    variables = to_numpy_tree(jm.init({"params": key, "dropout": key}, jnp.asarray(b0["x"]),
                                      jnp.asarray(b0["m"]), jnp.asarray(b0["t"]), rng=key,
                                      train=True))
    _, _, jlog = JW.train_vessel(corpus_j, jcfg, model=jm, img_hw=hw, epochs=1)
    noise = _jax_noise(corpus_j, hw, jcfg, SMALL["z_dim"])

    def run(cfg):
        pm = CausalViTVAE(**SMALL, dropout=0.0, device="cpu")
        pm.load_state_dict(from_jax_variables(pm, variables), strict=True)
        _, _, plog = PW.train_vessel(corpus_p, cfg, model=pm, img_hw=hw, epochs=1,
                                     noise=iter(noise))
        assert len(noise) == plog.clock.records[0]["steps"] + 1 == 8  # 7 steps, 1 val batch
        return plog

    return {k: v for rec in jlog.history[:2] for k, v in rec.items()}, run


def _epoch0_misses(want, plog):
    """The metrics of ``plog``'s epoch 0 outside the parity bounds."""
    got = {k: v for rec in plog.history[:2] for k, v in rec.items()}
    assert set(got) == set(want) and got["step"] == want["step"] == 0
    assert {"train_loss", "train_recon", "train_kld", "train_morph", "train_sparsity",
            "val_loss"} <= set(got)
    return {k: (got[k], want[k]) for k in sorted(set(want) - {"step"})
            if abs(got[k] - want[k]) > (VAL_REL if k == "val_loss" else TRAIN_REL)
            * abs(want[k])}


def test_train_vessel_epoch0_matches_jax(epoch0):
    want, run = epoch0
    plog = run(VesselConfig(epochs=1))
    assert _epoch0_misses(want, plog) == {}
    assert plog.history[-1]["step"] == -1 and "images_per_sec" in plog.history[-1]


@pytest.mark.parametrize("fault", ["no_optimizer_step", "next_epochs_shuffle"])
def test_train_vessel_epoch0_bound_catches_a_faulty_epoch(epoch0, fault, monkeypatch):
    """The parity bounds are tight enough to see a loop that skips its
    optimizer steps or trains on the wrong shuffle."""
    want, run = epoch0
    cfg = VesselConfig(epochs=1)
    if fault == "no_optimizer_step":
        cfg = dataclasses.replace(cfg, lr=0.0)
    else:
        shuffled = PV.iterate_batches

        def next_shuffle(corpus, split, *a, shuffle_seed=0, **kw):
            return shuffled(corpus, split, *a,
                            shuffle_seed=shuffle_seed + (split == "train"), **kw)

        monkeypatch.setattr(PV, "iterate_batches", next_shuffle)
    assert _epoch0_misses(want, run(cfg)) != {}


def _read_png_gray(path):
    """Size and pixels of the 8-bit greyscale PNG ``write_png_gray`` writes."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat = 8, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert zlib.crc32(kind + body) == int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        if kind == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(body[4:8], "big")
            assert body[8:10] == b"\x08\x00"  # 8-bit greyscale
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    assert not rows[:, 0].any()
    return rows[:, 1:]


def test_sample_recon_png_at_period_1(tmp_path):
    corpus = PV.synthetic_corpus(n=12, hw=(96, 160), seed=3)
    model = seeded_init_(CausalViTVAE(**SMALL, device="cpu"), 1)
    _, _, log = PW.train_vessel(corpus, VesselConfig(epochs=2, batch_size=8), model=model,
                                img_hw=SMALL["img_size"], run_dir=str(tmp_path),
                                epochs=2, period=1)
    h, w = SMALL["img_size"]
    for epoch in (1, 2):
        img = _read_png_gray(tmp_path / f"recon_epoch_{epoch}.png")
        assert img.shape == (2 * h + 4, 2 * w + 4)  # 2 samples: original | reconstruction
        assert set(np.unique(img[:h, :w])) <= {0, 255}  # a binary mask, min-max scaled
    for name in ("epoch_1.pt", "epoch_2.pt", "latest.pt", "metrics.jsonl"):
        assert (tmp_path / name).exists(), name
    assert [r["step"] for r in log.history][-1] == -1


def _cli(out, *args):
    from causalvae_tpu_torch.cli.main import main

    return main(["--out", str(out), "--n-synthetic", "8", *args])


def _serve_smoke(out, capsys):
    _cli(out, "serve", "vessel", "--ckpt", str(out / "train_vessel"), "--smoke",
         "--device", "cpu", "--img-hw", "96", "160", "--buckets", "1", "4")
    text = capsys.readouterr().out
    assert "parameters restored from" in text
    res = json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
    assert res["smoke"] == "ok" and res["reconstruct_shape"] == [1, 96, 160, 1]


def test_cli_train_resume_and_serve_ckpt(tmp_path, capsys):
    run = tmp_path / "train_vessel"
    model, opt, log = _cli(tmp_path, "train", "vessel", "--img-hw", "96", "160",
                           "--epochs", "1", "--device", "cpu")
    assert next(model.parameters()).device.type == "cpu" and not model.backbone.packed
    recs = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 0, -1]
    assert np.isfinite(recs[0]["train_loss"]) and np.isfinite(recs[1]["val_loss"])
    assert json.loads((run / "latest.meta.json").read_text()) == {"epoch": 0}
    assert json.loads((run / "best.meta.json").read_text()) == {
        "epoch": 0, "val_loss": recs[1]["val_loss"]}
    assert "Epoch 1: loss:" in capsys.readouterr().out

    model, opt, log = _cli(tmp_path, "train", "vessel", "--img-hw", "96", "160",
                           "--epochs", "2", "--resume", "--device", "cpu")
    assert [r["step"] for r in log.history] == [1, 1, -1]
    assert [g["count"] for g in opt.param_groups] == [2 * log.clock.records[0]["steps"]]
    assert log.clock.restore_s is not None
    assert json.loads((run / "latest.meta.json").read_text()) == {"epoch": 1}
    best = json.loads((run / "best.meta.json").read_text())
    assert best["val_loss"] == min(recs[1]["val_loss"], log.history[1]["val_loss"])
    capsys.readouterr()
    _serve_smoke(tmp_path, capsys)


def test_cli_packed_io_checkpoint_serves_spatially(tmp_path, capsys):
    model, _, log = _cli(tmp_path, "train", "vessel", "--img-hw", "96", "160",
                         "--epochs", "1", "--packed-io", "--device", "cpu")
    assert model.backbone.packed_io and model.backbone.fused_stages
    assert np.isfinite(log.history[0]["train_loss"])
    capsys.readouterr()
    _serve_smoke(tmp_path, capsys)
    from causalvae_tpu_torch.cli.main import serving_model

    spatial, _ = serving_model((96, 160), "cpu", ckpt=str(tmp_path / "train_vessel"))
    assert not spatial.backbone.packed
    for k, v in spatial.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


@pytest.mark.parametrize("half", [["--csv", "features.csv"], ["--data", "tree"]])
def test_cli_train_rejects_half_a_file_corpus(tmp_path, half, capsys):
    with pytest.raises(SystemExit) as e:
        _cli(tmp_path, "train", "vessel", *half, "--device", "cpu")
    assert e.value.code == 2 and "--csv and --data go together" in capsys.readouterr().err


def test_cli_train_reads_the_file_corpus_through_the_config(tmp_path):
    from test_torch_data import _tiff_corpus

    csv_path, root = _tiff_corpus(tmp_path)
    model, _, log = _cli(tmp_path, "train", "vessel", "--csv", csv_path, "--data", root,
                         "--img-hw", "96", "160", "--epochs", "1", "--device", "cpu")
    corpus = PV.scan_corpus(csv_path, root)
    assert (model.m_dim, model.t_dim) == (corpus.m.shape[1], corpus.t_dim) == (12, 5)
    assert np.isfinite(log.history[0]["train_loss"])

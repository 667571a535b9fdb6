"""The port's scanned trainer (``causalvae_tpu_torch/train/scan_loop.py``) and
``train --scan-steps`` on the CPU, where a ``ScanTrainer`` program loops the
eager step over its stack (on the card the same program is one CUDA-graph
replay: ``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 20).

- ``chunked`` and ``stack_batches`` equal JAX's.
- The scanned MNIST epoch (C1 and C4, 6 batches of 8 at S = 4: a group and
  a ragged tail of 2) against JAX's ``ScanTrainer.run_epoch`` from the same
  weights, handed the noise that JAX's split keys draw: the total loss and
  ``d_loss`` at the end of each group within rel 2e-4, the trajectory bound
  of ``tests/test_parity_trajectory.py:17-20``; a run with lr 0 misses it.
- The small vessel model is held to the port's eager epoch (bit for bit,
  below), which ``tests/test_torch_workloads.py`` holds to JAX's epoch: the
  JAX side of a scanned vessel epoch compiles two scanned programs of the
  ViT step (~45 s each on this host, the one-step program's time there).
- The scanned epoch equals the eager epoch bit for bit (every metric, the
  parameters, BatchNorm statistics, the optimizer's moments and count, and
  the generators after it): the small CausalViTVAE with dropout 0.1 and its
  noise and attention seeds drawn (a ragged tail; ``drop_ragged_tail``
  against the eager run of the full groups), and C1.
- A checkpoint of a scanned epoch resumes eagerly and one of an eager epoch
  resumes scanned, each bit for bit the all-eager run (``train_vessel``).
- The attention operator with its seed in a tensor gives the int seed's
  outputs and gradients (the hash masks unchanged).
- ``ClippedAdam``: the count and the moments keep their tensors across
  ``load_state_dict`` (a captured graph reads them in place), the state
  dict carries the count as an int.
- A ``remat_blocks`` model scanned equals its eager epoch bit for bit.
- The refusals (a mesh step, another optimizer, no CPU generator) and the CLI's ``--scan-steps`` (parse, errors, and a
  ``train mnist --scan-steps 3`` run equal to the eager run's metrics).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from causalvae_tpu.config import MnistConfig as JaxMnistConfig
from causalvae_tpu.data import mnist as JM
from causalvae_tpu.models.heads import LatentDiscriminator as JaxDisc
from causalvae_tpu.models.vae import CausalConvVAE as JaxConvVAE
from causalvae_tpu.train import scan_loop as JS
from causalvae_tpu.train.loop import make_mnist_adversarial_step as jax_step
from causalvae_tpu.train.state import TrainState

from causalvae_tpu_torch.cli.main import main as cli_main
from causalvae_tpu_torch.config import MnistConfig, VesselConfig
from causalvae_tpu_torch.data import mnist as PM
from causalvae_tpu_torch.data import vessel as PV
from causalvae_tpu_torch.models.heads import LatentDiscriminator
from causalvae_tpu_torch.models.vae import CausalConvVAE, seeded_init_
from causalvae_tpu_torch.models.vit import CausalViTVAE
from causalvae_tpu_torch.ops.kernels import attention as pa
from causalvae_tpu_torch.train import scan_loop as PS
from causalvae_tpu_torch.train import workloads as PW
from causalvae_tpu_torch.train.loop import (make_mnist_adversarial_step, make_vae_step,
                                            vessel_loss_fn)
from causalvae_tpu_torch.train.state import ClippedAdam

from torch_port_helpers import SMALL, init_jax, load_port, two_threads  # noqa: F401

Z = 6
TRAJ_REL = 2e-4  # tests/test_parity_trajectory.py:17-20
MNIST_B, MNIST_S, MNIST_GROUPS = 8, 4, (4, 2)  # 48 samples: a group and a tail of 2


@pytest.mark.parametrize("n,size", [(7, 3), (6, 3), (2, 5), (0, 4)])
def test_chunked_and_stack_batches_match_jax(n, size):
    assert [list(c) for c in PS.chunked(iter(range(n)), size)] == \
        [list(c) for c in JS.chunked(iter(range(n)), size)]
    rng = np.random.default_rng(n)
    batches = [{"x": rng.random((2, 3)).astype(np.float32),
                "t": rng.integers(0, 5, (2,)).astype(np.int32)} for _ in range(max(n, 1))]
    got, want = PS.stack_batches(batches), JS.stack_batches(batches)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# --------------------------------------------------------------------------
# The scanned MNIST epoch against JAX's ScanTrainer
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mnist_data():
    images, labels = PM.synthetic_mnist(48, seed=7)
    ds = PM.build_morph_mnist(images, labels)
    return JM.MorphDataset(ds.x, ds.m, ds.t, ds.labels), ds


def _eps(key, b):
    """The four (B, z) draws of JAX's MNIST step on ``key``."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(r, (b, Z)))
                                      for r in jax.random.split(key, 4)]))


def _mnist_pair(bayes, seed=0):
    x = jnp.zeros((1, 28, 28, 1))
    kw = dict(m_dim=12, t_dim=10, z_dim=Z, gaussian_mechanism=bayes, decode_real_m=bayes)
    jvae, jdisc = JaxConvVAE(**kw), JaxDisc(t_dim=10)
    vv = init_jax(jvae, x, jnp.zeros((1, 12)), jnp.zeros((1, 10)),
                  rng=jax.random.PRNGKey(seed), seed=seed)
    dv = init_jax(jdisc, jnp.zeros((1, Z)), seed=seed + 10)
    return jvae, jdisc, vv, dv, kw


@pytest.fixture(scope="module", params=[False, True], ids=["C1", "C4"])
def mnist_scan(request, mnist_data):
    """JAX's ScanTrainer over one epoch (group by group, the keys chained as
    one ``run_epoch`` chains them) -> the metrics at each group's end, and a
    runner of the port's scanned epoch from the same weights and noise."""
    bayes = request.param
    jds, ds = mnist_data
    jvae, jdisc, vv, dv, kw = _mnist_pair(bayes)
    jcfg = JaxMnistConfig(batch_size=MNIST_B, z_dim=Z)
    trainer = JS.ScanTrainer(jax_step(jvae, jdisc, jcfg, bayesian=bayes), n_states=2,
                             steps_per_dispatch=MNIST_S)
    states = (TrainState.create(vv, optax.adam(jcfg.lr)),
              TrainState.create(dv, optax.adam(jcfg.lr)))
    batches = [{k: b[k] for k in ("x", "m", "t")}
               for b in jds.batches(MNIST_B, np.random.default_rng(0))]
    assert [len(g) for g in JS.chunked(iter(batches), MNIST_S)] == list(MNIST_GROUPS)
    key, want, noise, start = jax.random.PRNGKey(5), [], [], 0
    for size in MNIST_GROUPS:
        group = batches[start:start + size]
        start += size
        states, metrics = trainer.run_epoch(states, iter(group), key)
        want.append({k: float(v) for k, v in metrics.items()})
        key, sub = jax.random.split(key)
        noise += [_eps(r, MNIST_B) for r in jax.random.split(sub, size)]

    def run(lr=jcfg.lr):
        pv = load_port(CausalConvVAE(**kw, device="cpu"), vv)
        pd = load_port(LatentDiscriminator(t_dim=10, z_dim=Z, device="cpu"), dv)
        vopt = ClippedAdam(pv.parameters(), lr, None, torch.float32)
        dopt = ClippedAdam(pd.parameters(), lr, None, torch.float32)
        step = make_mnist_adversarial_step(pv, pd, vopt, dopt, MnistConfig(z_dim=Z),
                                           bayesian=bayes)
        tr = PS.ScanTrainer(step, n_states=2, steps_per_dispatch=MNIST_S)
        pbatches = [{k: torch.from_numpy(np.asarray(b[k])) for k in b} for b in batches]
        got, it, start = [], iter(noise), 0
        for size in MNIST_GROUPS:
            last = tr.run_epoch([(pv, vopt), (pd, dopt)], iter(pbatches[start:start + size]),
                                torch.Generator().manual_seed(0), noise=it)
            start += size
            got.append({k: float(v) for k, v in last.items()})
        return got, tr

    return want, run


def _traj_misses(got, want):
    return {(i, k): (g[k], w[k]) for i, (g, w) in enumerate(zip(got, want))
            for k in ("loss", "d_loss") if abs(g[k] - w[k]) > TRAJ_REL * abs(w[k])}


def test_scanned_mnist_epoch_matches_jax(mnist_scan):
    want, run = mnist_scan
    got, tr = run()
    assert len(got) == len(want) == len(MNIST_GROUPS)
    assert _traj_misses(got, want) == {}
    assert sorted(tr.programs) == sorted(MNIST_GROUPS) and tr.warmup_steps == 1
    assert [tr.programs[s].replays for s in MNIST_GROUPS] == [1, 1]


def test_scanned_mnist_bound_catches_lr_0(mnist_scan):
    want, run = mnist_scan
    assert _traj_misses(run(lr=0.0)[0], want) != {}


# --------------------------------------------------------------------------
# Scanned equals eager, bit for bit
# --------------------------------------------------------------------------


def _vessel_batch(seed, b=2):
    rng = np.random.default_rng(seed)
    h, w = SMALL["img_size"]
    return {"x": torch.from_numpy((rng.random((b, h, w, 1)) > 0.9).astype(np.float32)),
            "m": torch.from_numpy(rng.standard_normal((b, 12)).astype(np.float32)),
            "t": torch.from_numpy(np.eye(19, dtype=np.float32)[rng.integers(0, 19, b)])}


def _mnist_batch(seed, b=8):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.random((b, 28, 28, 1), dtype=np.float32)),
            "m": torch.from_numpy(rng.standard_normal((b, 12)).astype(np.float32)),
            "t": torch.from_numpy(np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)])}


def _build(kind):
    """(states, step, batches) of a model built from seed 0 (``vessel-remat``:
    the vessel model with ``remat_blocks``)."""
    if kind.startswith("vessel"):
        model = seeded_init_(CausalViTVAE(**SMALL, dropout=0.1, device="cpu",
                                          remat_blocks=kind == "vessel-remat"), 0)
        opt = ClippedAdam(model.parameters(), 1e-3, 5.0, torch.bfloat16)
        return ([(model, opt)], make_vae_step(model, vessel_loss_fn(VesselConfig()), opt),
                [_vessel_batch(i) for i in range(7)])
    vae = seeded_init_(CausalConvVAE(z_dim=Z, device="cpu"), 0)
    disc = seeded_init_(LatentDiscriminator(z_dim=Z, device="cpu"), 1)
    vopt = ClippedAdam(vae.parameters(), 1e-3, None, torch.float32)
    dopt = ClippedAdam(disc.parameters(), 1e-3, None, torch.float32)
    return ([(vae, vopt), (disc, dopt)],
            make_mnist_adversarial_step(vae, disc, vopt, dopt, MnistConfig(z_dim=Z)),
            [_mnist_batch(i) for i in range(6)])


def _run(kind, scan, S, drop):
    states, step, batches = _build(kind)
    torch.manual_seed(3)  # nn.Dropout's generator
    gen = torch.Generator().manual_seed(1)
    if scan:
        tr = PS.ScanTrainer(step, len(states), S)
        last = tr.run_epoch(states, iter(batches), gen, drop_ragged_tail=drop)
    else:
        for b in batches[:len(batches) // S * S] if drop else batches:
            last = step(b, generator=gen)
    return {"metrics": last,
            "models": [m.state_dict() for m, _ in states],
            "opts": [o.state_dict() for _, o in states],
            "gens": [gen.get_state(), torch.get_rng_state()]}


def _assert_bits(a, b, where="run"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_bits(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bits(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("kind,S,drop", [("vessel", 3, False), ("vessel", 3, True),
                                         ("mnist", 4, False), ("vessel-remat", 3, False)],
                         ids=["vessel-tail", "vessel-drop-tail", "mnist-tail",
                              "vessel-remat-tail"])
def test_scanned_epoch_equals_eager_bit_for_bit(kind, S, drop):
    """``vessel-remat``: the scanned trainer takes a ``remat_blocks`` model
    (its blocks' draws made before each checkpointed call) and gives the
    eager steps' bits."""
    eager, scanned = _run(kind, False, S, drop), _run(kind, True, S, drop)
    _assert_bits(scanned, eager)
    steps = 6 if drop else (7 if kind.startswith("vessel") else 6)
    assert [g["count"] for g in scanned["opts"][0]["param_groups"]] == [steps]


def test_checkpoints_resume_across_eager_and_scanned(tmp_path):
    """``train_vessel`` on the small model: epoch 1 eager or scanned
    (``scan_steps`` 3: a group and a tail), then epoch 2 resumed from its
    checkpoint eager or scanned; every mix writes the all-eager run's
    checkpoints bit for bit, and the epochs take their steps a group at a
    time on the clock."""
    corpus = PV.synthetic_corpus(n=8, seed=0)
    cfg = VesselConfig(batch_size=4)
    steps = len(corpus.splits["train"]) * 4 // cfg.batch_size

    def run(first, second, name):
        run_dir = str(tmp_path / name)
        for epochs, scan in ((1, first), (2, second)):
            torch.manual_seed(0)
            model = seeded_init_(CausalViTVAE(**SMALL, dropout=0.1, device="cpu"), 0)
            _, _, lg = PW.train_vessel(corpus, cfg, model=model, img_hw=SMALL["img_size"],
                                       run_dir=run_dir, epochs=epochs, resume=epochs == 2,
                                       scan_steps=3 if scan else 0)
            rec = lg.clock.records[-1]
            assert rec["steps"] == steps
            if scan:
                assert sorted(lg.trainer.programs) == sorted({3, steps % 3} - {0})
        return torch.load(os.path.join(run_dir, "latest.pt"), weights_only=True)

    want = run(False, False, "eager")
    assert want["optimizer"]["param_groups"][0]["count"] == 2 * steps
    for first, second in ((True, False), (False, True), (True, True)):
        _assert_bits(run(first, second, f"mix_{first}_{second}"), want, f"{first}/{second}")


# --------------------------------------------------------------------------
# The attention seed in device memory; ClippedAdam's in-place state
# --------------------------------------------------------------------------


def test_attention_seed_tensor_gives_the_int_seeds_masks():
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(6, 37, 8, generator=g) for _ in range(4))
    seed = 2**31 + 11
    ref = pa.attention_reference(q, k, v, 0.1, seed)
    for s in (seed, pa.seed_tensor(seed, "cpu"), torch.tensor([seed]),
              torch.tensor(seed + 2**32)):  # the low 32 bits count
        o, lse = pa.attention_fwd(q, k, v, 0.1, s)
        assert torch.equal(o, ref[0]) and torch.equal(lse, ref[1])
        grads = pa.attention_bwd(q, k, v, o, lse, do, 0.1, s)
        want = pa.attention_bwd_reference(q, k, v, o, lse, do, 0.1, seed)
        assert all(torch.equal(a, b) for a, b in zip(grads, want))
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    out = pa.flash_attention(ql[None], kl[None], vl[None], dropout_rate=0.1,
                             dropout_seed=pa.seed_tensor(seed, "cpu"))
    assert torch.equal(out[0], ref[0])
    with pytest.raises(ValueError, match="int64"):
        pa.attention_fwd(q, k, v, 0.1, torch.tensor(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="one int64"):
        pa.attention_fwd(q, k, v, 0.1, torch.tensor([1, 2]))


def test_vit_draws_the_same_seeds_as_before():
    """``draw_seed`` takes one uint32 from the generator as it did (the int
    the eager path drew), now in a 0-d int64 tensor."""
    from causalvae_tpu_torch.models.vit import MultiHeadAttention

    mha = MultiHeadAttention(16, 2, 0.1).train()
    got = [int(mha.draw_seed(torch.Generator().manual_seed(i), "cpu")) for i in range(3)]
    want = [int(torch.randint(0, 2**32, (), generator=torch.Generator().manual_seed(i),
                              dtype=torch.int64)) for i in range(3)]
    assert got == want
    assert mha.eval().draw_seed(torch.Generator(), "cpu") is None


def test_clipped_adam_keeps_its_tensors_across_a_load():
    torch.manual_seed(0)
    a, b = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    oa = ClippedAdam(a.parameters(), 1e-2, 1.0, torch.bfloat16)
    ob = ClippedAdam(b.parameters(), 1e-2, 1.0, torch.bfloat16)
    for opt, model in ((oa, a), (oa, a), (ob, b)):
        model(torch.randn(4, 3)).sum().backward()
        opt.step()
    sd = oa.state_dict()
    assert sd["param_groups"][0]["count"] == 2 and isinstance(sd["param_groups"][0]["count"], int)
    before = [ob.param_groups[0]["count"].data_ptr()] + [
        t.data_ptr() for st in ob.state.values() for t in (st["mu"], st["nu"])]
    ob.load_state_dict(sd)
    after = [ob.param_groups[0]["count"].data_ptr()] + [
        t.data_ptr() for st in ob.state.values() for t in (st["mu"], st["nu"])]
    assert after == before
    _assert_bits(ob.state_dict(), sd)
    assert ob.state[next(iter(b.parameters()))]["mu"].dtype == torch.bfloat16
    fresh = ClippedAdam(torch.nn.Linear(3, 2).parameters(), 1e-2, 1.0, torch.bfloat16)
    fresh.init_state()
    assert all(float(t.abs().sum()) == 0 for st in fresh.state.values() for t in st.values())


# --------------------------------------------------------------------------
# What the trainer refuses; the CLI
# --------------------------------------------------------------------------


def test_scan_trainer_refusals():
    from causalvae_tpu_torch.parallel.mesh import Mesh

    states, step, batches = _build("mnist")
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        PS.ScanTrainer(step, 2, 0)
    step.mesh = object.__new__(Mesh)
    with pytest.raises(ValueError, match="mesh"):
        PS.ScanTrainer(step, 2, 2)
    del step.mesh
    tr = PS.ScanTrainer(step, 2, 2)
    with pytest.raises(ValueError, match="CPU torch.Generator"):
        tr.run_epoch(states, iter(batches), None)
    with pytest.raises(ValueError, match="1 states"):
        tr.run_epoch(states[:1], iter(batches), torch.Generator())
    model = CausalViTVAE(**SMALL, device="cpu")
    with pytest.raises(TypeError, match="ClippedAdam"):
        PS.ScanTrainer(step, 1, 2).run_epoch([(model, torch.optim.SGD(model.parameters(), 0.1))],
                                             iter(batches), torch.Generator())


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["step"] >= 0]


def test_cli_scan_steps(tmp_path, capsys):
    for workload in ("cvae", "vit", "cascade"):
        with pytest.raises(SystemExit):
            cli_main(["train", workload, "--scan-steps", "2", "--device", "cpu"])
        assert "--scan-steps is the mnist, mnist-bayes and vessel" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli_main(["train", "mnist", "--scan-steps", "-1", "--device", "cpu"])
    assert "--scan-steps must be >= 0" in capsys.readouterr().err
    argv = ["--n-synthetic", "48", "train", "mnist", "--epochs", "2", "--batch-size", "8",
            "--device", "cpu"]
    eager = cli_main(["--out", str(tmp_path / "eager"), *argv])
    scanned = cli_main(["--out", str(tmp_path / "scan"), *argv, "--scan-steps", "4"])
    assert eager[4].trainer is None and sorted(scanned[4].trainer.programs) == [2, 4]
    assert _metrics(str(tmp_path / "scan" / "train_mnist")) == \
        _metrics(str(tmp_path / "eager" / "train_mnist"))
    assert [r["steps"] for r in scanned[4].clock.records] == [6, 6]

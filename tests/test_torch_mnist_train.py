"""The port's MNIST training and serving against the JAX package on the CPU:
the unclipped Adam, the adversarial step, the trainer, the pair checkpoint,
the endpoints, and the CLI's ``train``, ``serve`` and ``export mnist``,
``analyze``, ``counterfactual`` and ``train cvae``.

The corpus is ``synthetic_mnist(48, seed=7)`` with its 12 host features
(``tests/test_workloads_cli.py``'s size), z 6; JAX's weights are carried
across by ``from_jax_variables`` and JAX's noise is injected.

Tolerances, each with its worst reading here:
- ``ClippedAdam(max_norm=None)`` against ``optax.adam`` over 6 steps:
  max|Δ| <= 1e-6 max|ref| per leaf (worst 0: equal bits);
- step 0 of ``make_mnist_adversarial_step``: the loss terms at rel 1e-5
  (worst 6.8e-7) and each gradient leaf of both models at 1e-4 of its
  max|ref| (worst 3.2e-6), as C1 and C4;
- 12 steps at batch 32 through ``train_mnist``: the per-step total loss
  (and ``d_loss``) within rel 2e-4, the JAX package's own bound for this
  model (``tests/test_parity_trajectory.py:17-20``; worst 1.8e-6); a run
  with lr 0 (rel 1.29) and a run on another shuffle (rel 0.094) miss it;
- the endpoints of C1 (five) and C4 (six) against JAX ``vae_endpoints``,
  do_t included, at 1e-5 max|ref| + 1e-6 (worst 8.1e-7).
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
from causalvae_tpu.serve.endpoints import vae_endpoints as jax_endpoints
from causalvae_tpu.train import workloads as JW
from causalvae_tpu.train.loop import make_mnist_adversarial_step as jax_step
from causalvae_tpu.train.state import TrainState

from causalvae_tpu_torch.config import MnistConfig
from causalvae_tpu_torch.data import mnist as PM
from causalvae_tpu_torch.models.heads import LatentDiscriminator
from causalvae_tpu_torch.models.vae import CausalConvVAE
from causalvae_tpu_torch.serve.endpoints import endpoint_arg_specs, vae_endpoints
from causalvae_tpu_torch.train import workloads as PW
from causalvae_tpu_torch.train.checkpoints import CheckpointBook
from causalvae_tpu_torch.train.loop import make_mnist_adversarial_step
from causalvae_tpu_torch.train.port_maps import from_jax_variables
from causalvae_tpu_torch.train.state import ClippedAdam

from torch_port_helpers import close, init_jax, load_port, to_numpy_tree, two_threads  # noqa: F401

Z = 6
ADAM_REL = 1e-6
STEP_TERMS_REL = 1e-5
STEP_GRAD_REL = 1e-4
TRAJ_REL = 2e-4  # tests/test_parity_trajectory.py:17-20
FWD = dict(rel=1e-5, abs_=1e-6)


@pytest.fixture(scope="module")
def data():
    """(JAX MorphDataset, the port's) of the synthetic corpus."""
    images, labels = PM.synthetic_mnist(48, seed=7)
    ds = PM.build_morph_mnist(images, labels)
    return JM.MorphDataset(ds.x, ds.m, ds.t, ds.labels), ds


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_unclipped_adam_matches_optax():
    """Three leaves, 6 steps of random gradients; a leaf without a gradient
    at step 3 (optax: a zero gradient) still decays and moves."""
    rng = np.random.default_rng(1)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 3)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.adam(1e-2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    params = {k: torch.nn.Parameter(_t(v)) for k, v in init.items()}
    opt = ClippedAdam(list(params.values()), 1e-2, None, mu_dtype=torch.float32)
    for step in range(6):
        grads = {k: (10.0 * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        if step == 3:
            grads["b"] = np.zeros(shapes["b"], np.float32)
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in params.items():
            p.grad = None if (step == 3 and k == "b") else _t(grads[k])
        assert opt.step() is None  # no norm without clipping
        for k, p in params.items():
            close(p.detach(), jp[k], rel=ADAM_REL, abs_=0.0)
    assert all(s["mu"].dtype == torch.float32 for s in opt.state.values())
    assert [g["count"] for g in opt.param_groups] == [6]


def _capture():
    """A pass-through optax stage that keeps the gradients in its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _pair(bayes, seed=0):
    """Perturbed JAX variables of the VAE and D, and the port's pair loaded
    with them."""
    x = jnp.zeros((1, 28, 28, 1))
    kw = dict(m_dim=12, t_dim=10, z_dim=Z, gaussian_mechanism=bayes, decode_real_m=bayes)
    jvae, jdisc = JaxConvVAE(**kw), JaxDisc(t_dim=10)
    vv = init_jax(jvae, x, jnp.zeros((1, 12)), jnp.zeros((1, 10)),
                  rng=jax.random.PRNGKey(seed), seed=seed)
    dv = init_jax(jdisc, jnp.zeros((1, Z)), seed=seed + 10)
    pv = load_port(CausalConvVAE(**kw, device="cpu"), vv)
    pd = load_port(LatentDiscriminator(t_dim=10, z_dim=Z, device="cpu"), dv)
    return (jvae, jdisc, vv, dv), (pv, pd)


def _jax_eps(key, b):
    """The four (B, z) draws of JAX's step on ``key`` (r_enc, r_d, r_vae, r_conf)."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(r, (b, Z)))
                                      for r in jax.random.split(key, 4)]))


@pytest.mark.parametrize("bayes", [False, True], ids=["C1", "C4"])
def test_adversarial_step0_matches_jax(data, bayes):
    """Loss terms and both models' gradients of one step: D's from phase 1,
    the VAE's from phase 2 through the updated D (D's ``.grad`` must hold
    phase 1's alone)."""
    jds, ds = data
    (jvae, jdisc, vv, dv), (pv, pd) = _pair(bayes)
    jcfg = JaxMnistConfig(batch_size=24, z_dim=Z)
    tx = optax.chain(_capture(), optax.adam(jcfg.lr))
    vs, dst = TrainState.create(vv, tx), TrainState.create(dv, tx)
    batch = next(ds.batches(24, np.random.default_rng(0)))
    key = jax.random.PRNGKey(3)
    vs2, ds2, jmet = jax.jit(jax_step(jvae, jdisc, jcfg, bayesian=bayes))(
        vs, dst, {k: jnp.asarray(batch[k]) for k in ("x", "m", "t")}, key)

    vae_opt = ClippedAdam(pv.parameters(), jcfg.lr, None, torch.float32)
    d_opt = ClippedAdam(pd.parameters(), jcfg.lr, None, torch.float32)
    step = make_mnist_adversarial_step(pv, pd, vae_opt, d_opt, MnistConfig(z_dim=Z),
                                       bayesian=bayes)
    pmet = step({k: _t(batch[k]) for k in ("x", "m", "t")}, eps=_jax_eps(key, 24))
    assert set(pmet) == set(jmet) == {"loss", "recon", "kld", "morph", "adv", "d_loss"}
    for k in jmet:
        assert abs(float(pmet[k]) - float(jmet[k])) <= STEP_TERMS_REL * abs(float(jmet[k])), k
    for model, grads in ((pv, vs2.opt_state[0]), (pd, ds2.opt_state[0])):
        want = from_jax_variables(model, {"params": to_numpy_tree(grads)})
        for name, p in model.named_parameters():
            assert p.grad is not None, name
            close(p.grad, want[name].numpy(), rel=STEP_GRAD_REL, abs_=0.0)


def _jax_init_and_noise(jds, cfg, steps_per_epoch):
    """JAX ``train_mnist``'s initial variables (PRNGKey(seed) on the first
    two rows) and its noise: per batch, ``key, sub = split(key)``, then the
    step's four draws from ``sub``."""
    key = jax.random.PRNGKey(cfg.seed)
    b0 = next(jds.batches(2))
    jvae = JaxConvVAE(m_dim=cfg.m_dim, t_dim=cfg.t_dim, z_dim=cfg.z_dim)
    vv = to_numpy_tree(jvae.init({"params": key}, jnp.asarray(b0["x"]), jnp.asarray(b0["m"]),
                                 jnp.asarray(b0["t"]), rng=key))
    dv = to_numpy_tree(JaxDisc(t_dim=cfg.t_dim).init(key, jnp.zeros((2, cfg.z_dim))))
    noise, k = [], key
    for _ in range(cfg.epochs * steps_per_epoch):
        k, sub = jax.random.split(k)
        noise.append(_jax_eps(sub, cfg.batch_size))
    return vv, dv, noise


@pytest.fixture(scope="module")
def trajectory(data):
    """JAX ``train_mnist`` for 12 epochs of one step at batch 32, and a
    runner of the port's ``train_mnist`` from the same weights and noise."""
    jds, ds = data
    jcfg = JaxMnistConfig(batch_size=32, epochs=12, z_dim=Z)
    _, _, _, jlog = JW.train_mnist(jds, jcfg)
    vv, dv, noise = _jax_init_and_noise(jds, jcfg, 1)

    def run(cfg=MnistConfig(batch_size=32, epochs=12, z_dim=Z)):
        pv = load_port(CausalConvVAE(z_dim=Z, device="cpu"), vv)
        pd = load_port(LatentDiscriminator(z_dim=Z, device="cpu"), dv)
        return PW.train_mnist(ds, cfg, device="cpu", models=(pv, pd), noise=iter(noise))[-1]

    return [r for r in jlog.history if r["step"] >= 0], run


def _misses(want, plog):
    got = [r for r in plog.history if r["step"] >= 0]
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(12))
    return {(r["step"], k): (g[k], r[k]) for g, r in zip(got, want) for k in ("loss", "d_loss")
            if abs(g[k] - r[k]) > TRAJ_REL * abs(r[k])}


def test_train_mnist_trajectory_matches_jax(trajectory):
    want, run = trajectory
    plog = run()
    assert _misses(want, plog) == {}
    assert plog.history[-1]["step"] == -1 and plog.history[-1]["images_per_sec"] > 0
    assert want[-1]["loss"] < want[0]["loss"]


@pytest.mark.parametrize("fault", ["lr_0", "another_shuffle"])
def test_trajectory_bound_catches_a_faulty_run(trajectory, fault):
    want, run = trajectory
    cfg = MnistConfig(batch_size=32, epochs=12, z_dim=Z,
                      **({"lr": 0.0} if fault == "lr_0" else {"seed": 43}))
    assert _misses(want, run(cfg)) != {}


def test_pair_checkpoint_resume_and_bit_exact_restore(data, tmp_path):
    """Two epochs, then ``resume`` to three: the resume starts at epoch 2,
    restores both models and both optimizers bit for bit, and the file
    holds the pair's parts; a one-model book keeps the vessel layout."""
    _, ds = data
    cfg = MnistConfig(batch_size=24, epochs=2, z_dim=Z)
    run = str(tmp_path / "run")
    vae, disc, vopt, dopt, log = PW.train_mnist(ds, cfg, run_dir=run, device="cpu")
    assert sorted(os.listdir(run)) == ["latest.meta.json", "latest.pt", "metrics.jsonl"]
    payload = torch.load(os.path.join(run, "latest.pt"), weights_only=True)
    assert sorted(payload) == ["disc", "vae"]
    assert all(sorted(p) == ["model", "optimizer"] for p in payload.values())

    fresh = (CausalConvVAE(z_dim=Z, device="cpu"), LatentDiscriminator(z_dim=Z, device="cpu"))
    fopt = [ClippedAdam(m.parameters(), cfg.lr, None, torch.float32) for m in fresh]
    assert CheckpointBook(run).restore_latest(
        {"vae": (fresh[0], fopt[0]), "disc": (fresh[1], fopt[1])}) == 2
    for a, b in ((fresh[0], vae), (fresh[1], disc)):
        for k, v in b.state_dict().items():
            assert torch.equal(a.state_dict()[k], v), k
    for a, b in ((fopt[0], vopt), (fopt[1], dopt)):
        assert [g["count"] for g in a.param_groups] == [g["count"] for g in b.param_groups] == [4]
        for pa, pb in zip(a.param_groups[0]["params"], b.param_groups[0]["params"]):
            for s in ("mu", "nu"):
                assert torch.equal(a.state[pa][s], b.state[pb][s])
    # the VAE half alone (serving)
    half = CausalConvVAE(z_dim=Z, device="cpu")
    CheckpointBook(run).restore("latest", {"vae": (half, None)})
    x, m, t = (_t(ds.x[:3]), _t(ds.m[:3]), _t(ds.t[:3]))
    with torch.no_grad():
        assert torch.equal(half.encode(x, m, t)[0], vae.encode(x, m, t)[0])

    vae2, _, vopt2, _, log2 = PW.train_mnist(ds, MnistConfig(batch_size=24, epochs=3, z_dim=Z),
                                             run_dir=run, resume=True, device="cpu")
    assert [r["step"] for r in log2.history] == [2, -1]
    assert log2.clock.restore_s is not None
    assert [g["count"] for g in vopt2.param_groups] == [6]
    assert json.loads(open(os.path.join(run, "latest.meta.json")).read()) == {"epoch": 2}
    assert np.isfinite(log2.history[0]["loss"]) and np.isfinite(log2.history[0]["d_loss"])

    one = str(tmp_path / "one")
    CheckpointBook(one).end_of_epoch(disc, dopt, 0)
    assert sorted(torch.load(os.path.join(one, "latest.pt"), weights_only=True)) == [
        "model", "optimizer"]


@pytest.fixture(scope="module", params=[False, True], ids=["C1", "C4"])
def served(request):
    bayes = request.param
    (jvae, _, vv, _), (pv, _) = _pair(bayes, seed=2)
    return bayes, jax_endpoints(jvae, vv), vae_endpoints(pv), pv


def _endpoint_args(name, b=3):
    rng = np.random.default_rng(6)
    x = rng.random((b, 28, 28, 1), dtype=np.float32)
    m = rng.standard_normal((b, 12)).astype(np.float32)
    t = np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]
    z = rng.standard_normal((b, Z)).astype(np.float32)
    return {"decode": (m, z), "predict_m": (t,), "uncertainty": (t,)}.get(name, (x, m, t))


def test_endpoint_sets_and_values_match_jax(served):
    """C1 serves five endpoints (no ``uncertainty``: its mechanism is
    deterministic), C4 six, as JAX; each equals JAX's, do_t's (3, 10, 28,
    28, 1) grid included."""
    bayes, jeps, peps, pv = served
    names = ["decode", "do_t", "encode", "predict_m", "reconstruct"] + (
        ["uncertainty"] if bayes else [])
    assert sorted(peps) == sorted(jeps) == names
    for name in names:
        args = _endpoint_args(name)
        want = jeps[name](*args)
        with torch.inference_mode():
            got = peps[name](*(torch.from_numpy(a) for a in args))
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        for g, w in zip(got, want):
            close(g, w, **FWD)
    specs = endpoint_arg_specs(pv)
    assert specs["encode"] == ((28, 28, 1), (12,), (10,)) and specs["decode"] == ((12,), (Z,))


def _cli(tmp_path, *argv):
    from causalvae_tpu_torch.cli.main import main

    return main(["--out", str(tmp_path), "--n-synthetic", "48", *argv])


def _smoke(text):
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def test_cli_train_serve_and_export_mnist(tmp_path, capsys):
    """``train mnist`` (the morphology cache written once and read back),
    ``serve --smoke`` of its checkpoint with the default workload,
    ``export mnist`` of five endpoints and ``serve --export-dir``; then
    ``train mnist-bayes`` and its six-endpoint export."""
    vae, disc, vopt, dopt, log = _cli(tmp_path, "train", "mnist", "--epochs", "1",
                                      "--batch-size", "24", "--device", "cpu")
    assert not vae.gaussian_mechanism and next(vae.parameters()).device.type == "cpu"
    assert os.path.exists(tmp_path / "morph_cache_12.npz")
    recs = [json.loads(ln) for ln in
            (tmp_path / "train_mnist" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, -1] and np.isfinite(recs[0]["loss"])
    assert "Epoch 1: loss:" in capsys.readouterr().out

    _cli(tmp_path, "serve", "--ckpt", str(tmp_path / "train_mnist"), "--smoke",
         "--device", "cpu", "--buckets", "1", "4")
    text = capsys.readouterr().out
    assert "[serve] mnist CausalConvVAE 28x28" in text and "restored from" in text
    res = _smoke(text)
    assert res["smoke"] == "ok" and res["reconstruct_shape"] == [1, 28, 28, 1]

    summary = _cli(tmp_path, "export", "mnist", "--ckpt", str(tmp_path / "train_mnist"),
                   "--buckets", "1", "4", "--device", "cpu")
    assert sorted(summary["endpoints"]) == ["decode", "do_t", "encode", "predict_m",
                                            "reconstruct"]
    capsys.readouterr()
    _cli(tmp_path, "serve", "mnist", "--export-dir", summary["export_dir"], "--smoke",
         "--device", "cpu", "--buckets", "1", "4")
    res = _smoke(capsys.readouterr().out)
    assert res["smoke"] == "ok" and res["predict_m_shape"] == [3, 12]
    with pytest.raises(ValueError, match="holds the mnist workload"):
        _cli(tmp_path, "serve", "vessel", "--export-dir", summary["export_dir"], "--smoke",
             "--device", "cpu")

    vae, *_ = _cli(tmp_path, "train", "mnist-bayes", "--epochs", "1", "--batch-size", "24",
                   "--device", "cpu")
    assert vae.gaussian_mechanism and vae.decode_real_m
    summary = _cli(tmp_path, "export", "mnist-bayes", "--ckpt",
                   str(tmp_path / "train_mnist-bayes"), "--buckets", "2", "--device", "cpu")
    assert len(summary["endpoints"]) == 6 and "uncertainty" in summary["endpoints"]


def test_cli_train_mnist_reads_idx_files(tmp_path, capsys):
    """``--data`` alone (no ``--csv``) reads the IDX files; the vessel's
    options are refused for MNIST."""
    from test_torch_mnist import _write_idx

    images, labels = PM.synthetic_mnist(30, seed=3)
    root = tmp_path / "idx"
    root.mkdir()
    _write_idx(str(root / "train-images-idx3-ubyte.gz"),
               np.round(images * 255).astype(np.uint8), 8)
    _write_idx(str(root / "train-labels-idx1-ubyte.gz"), labels.astype(np.uint8), 8)
    vae, *_, log = _cli(tmp_path, "train", "mnist", "--data", str(root), "--epochs", "1",
                        "--batch-size", "10", "--device", "cpu")
    assert log.clock.records[0]["steps"] == 3
    blob = np.load(tmp_path / "morph_cache_12.npz")
    assert blob["m"].shape == (30, 12)
    for argv in (("train", "mnist", "--csv", "f.csv"), ("serve", "--img-hw", "64", "96"),
                 ("export", "mnist-bayes", "--img-hw", "64", "96")):
        with pytest.raises(SystemExit) as e:
            _cli(tmp_path, *argv, "--device", "cpu")
        assert e.value.code == 2 and "vessel workload's" in capsys.readouterr().err


# the keys of the JAX CLI's analyze_all.json (causalvae_tpu/cli/main.py:249-382)
ANALYZE_KEYS = {
    "mechanism": ["r2", "mse", "avg_r2", "verdict"],
    "phase1": ["sensitivity", "ranking"],
    "importance": ["phase1_ranking", "phase2_ranking", "comparison"],
    "residual": ["accuracy", "verdict"],
    "gradcam": ["per_class_cam_shape", "artifact"],
    "independence": ["mse_m_only", "mse_m_and_t", "independence_rejected",
                     "m_information_fraction", "verdict"],
    "uncertainty": None,  # a string for the deterministic C1
    "causal": None,  # one entry per feature name (FEATURE_NAMES_12)
    "mediation": ["pair", "m_pct_mean", "m_pct_std", "z_pct_mean", "z_pct_std",
                  "feature_pct"],
}


def test_cli_analyze_counterfactual_and_train_cvae(tmp_path, capsys):
    """``analyze all`` at n 256 and one epoch writes analyze_all.json with
    the JAX CLI's keys and gradcam_per_class.png (10 rows of 28x28);
    ``analyze uncertainty --bayesian`` the C4 table; ``counterfactual
    do-t`` the (6 sources, 10 targets) grid; ``train cvae`` its run."""
    from causalvae_tpu_torch.config import FEATURE_NAMES_12
    from causalvae_tpu_torch.cli.main import main
    from PIL import Image

    base = ["--out", str(tmp_path), "--n-synthetic", "256"]
    out = main(base + ["analyze", "all", "--epochs", "1", "--device", "cpu"])
    saved = json.loads((tmp_path / "analyze_all.json").read_text())
    keys = dict(ANALYZE_KEYS, causal=list(FEATURE_NAMES_12))  # uncertainty stays None
    assert list(saved) == list(out) == list(keys)
    for k, sub in keys.items():
        assert (isinstance(saved[k], str) if sub is None else list(saved[k]) == sub), k
    assert list(saved["causal"]["Area"]) == ["effect", "rcc_p", "placebo_p", "tipping_point",
                                             "robust"]
    assert saved["gradcam"]["per_class_cam_shape"] == [10, 28, 28]
    with Image.open(tmp_path / "gradcam_per_class.png") as im:
        assert im.size == (28, 10 * 28 + 9 * 4)
    capsys.readouterr()

    table = main(base + ["analyze", "uncertainty", "--bayesian", "--epochs", "1",
                         "--device", "cpu"])["uncertainty"]
    assert [r["condition"] for r in table] == list(range(10))
    assert list(table[0]) == ["condition", "most_certain", "least_certain", "sigma_min",
                              "sigma_max"]
    assert json.loads((tmp_path / "analyze_uncertainty.json").read_text())["uncertainty"] == table

    path = main(base + ["counterfactual", "do-t", "--epochs", "1", "--device", "cpu"])
    assert path == str(tmp_path / "do_t_grid.png")
    with Image.open(path) as im:
        assert im.size == (11 * 28 + 10 * 4, 6 * 28 + 5 * 4)
    assert "grid (6, 10, 28, 28, 1)" in capsys.readouterr().out

    model, _, log = main(base + ["train", "cvae", "--epochs", "1", "--device", "cpu"])
    assert type(model).__name__ == "ConditionalVAE"
    assert [r["step"] for r in log.history] == [0, -1] and np.isfinite(log.history[0]["train_loss"])
    assert os.path.exists(tmp_path / "train_cvae" / "latest.pt")
    with pytest.raises(SystemExit):
        main(base + ["train", "cvae", "--resume", "--device", "cpu"])

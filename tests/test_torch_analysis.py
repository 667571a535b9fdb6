"""The port's MNIST analyses, C5 and C6 against the JAX package on the CPU:
``analysis/{mechanism,importance,independence,residual,gradcam,
causal_checks,plots}.py``, ``ConditionalVAE``, ``MDecoder``,
``make_simple_vae_step`` and ``train_cvae``.

Inputs come from numpy seeds through both packages; JAX's weights (its
initialisation where the JAX function initialises its own model, else
perturbed by ``torch_port_helpers.init_jax``) are carried across by
``from_jax_variables``, and JAX's noise is injected. Tolerances, each with
its worst reading here:
- forwards (``ConditionalVAE``, ``MDecoder``, residuals) at 1e-5 max|ref| +
  1e-6 (worst 3.1e-7);
- the mechanism analyses (R², MSE, sensitivities, deltas, sigma) at rel 1e-5
  + 1e-6 (worst 4.0e-7), rankings and verdicts equal;
- ``phase2_importance``: in ``tests/test_torch_morphology.py``;
- trained probes and classifiers from JAX's initialisation, two steps:
  test MSE at rel 1e-5 (worst 1.9e-7); each classifier leaf at 1e-4 of its
  max|ref| (worst 4.6e-6), train and test accuracy equal;
- Grad-CAM maps within 1e-5 (worst 1.2e-6); ``F.interpolate`` bilinear
  against ``jax.image.resize`` within 1e-6 (worst 1.8e-7);
- the numpy report (``causal_validation_report``) and the phase
  comparison equal bit for bit;
- the C5 step: loss terms at rel 1e-5 (worst 2.5e-7), gradient leaves at
  1e-4 of max|ref| (worst 9.5e-6); 8 steps of ``train_cvae`` at rel 2e-4
  per epoch loss, the MNIST trajectory bound (worst 1.5e-6), which another
  shuffle misses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.nn import functional as F

from causalvae_tpu.analysis import causal_checks as JC
from causalvae_tpu.analysis import gradcam as JG
from causalvae_tpu.analysis import importance as JI
from causalvae_tpu.analysis import independence as JIND
from causalvae_tpu.analysis import mechanism as JMECH
from causalvae_tpu.analysis import residual as JR
from causalvae_tpu.data import mnist as JM
from causalvae_tpu.models import heads as jheads
from causalvae_tpu.models import vae as jvae
from causalvae_tpu.ops import losses as JL
from causalvae_tpu.train import workloads as JW
from causalvae_tpu.train.loop import make_simple_vae_step as jax_simple_step
from causalvae_tpu.train.state import TrainState

from causalvae_tpu_torch.analysis import causal_checks as PC
from causalvae_tpu_torch.analysis import gradcam as PG
from causalvae_tpu_torch.analysis import importance as PI
from causalvae_tpu_torch.analysis import independence as PIND
from causalvae_tpu_torch.analysis import mechanism as PMECH
from causalvae_tpu_torch.analysis import plots as PP
from causalvae_tpu_torch.analysis import residual as PR
from causalvae_tpu_torch.data import mnist as PM
from causalvae_tpu_torch.models import heads as pheads
from causalvae_tpu_torch.models.vae import ConditionalVAE, MDecoder
from causalvae_tpu_torch.ops import losses as PL
from causalvae_tpu_torch.train import workloads as PW
from causalvae_tpu_torch.train.loop import make_simple_vae_step
from causalvae_tpu_torch.train.port_maps import from_jax_variables
from causalvae_tpu_torch.train.state import ClippedAdam

from test_torch_mnist import conv_vae_pair
from torch_port_helpers import close, init_jax, load_port, to_numpy_tree, two_threads  # noqa: F401

FWD = dict(rel=1e-5, abs_=1e-6)
STAT = dict(rel=1e-5, abs_=1e-6)
NAMES = [f"f{i}" for i in range(12)]
TRAJ_REL = 2e-4  # tests/test_parity_trajectory.py:17-20
Z = 6


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _inputs(b, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.random((b, 28, 28, 1), dtype=np.float32)
    m = rng.standard_normal((b, 12), dtype=np.float32)
    labels = rng.integers(0, 10, b)
    return x, m, np.eye(10, dtype=np.float32)[labels], labels


def _dict_close(got, want, **tol):
    assert list(got) == list(want)
    close(np.array([got[k] for k in want]), np.array([want[k] for k in want]), **tol)


@pytest.mark.parametrize("bayes", [False, True], ids=["C1", "C4"])
def test_mechanism_analyses_match_jax(bayes):
    jm, v, pm = conv_vae_pair(bayes, z_dim=Z)
    _, m, t, _ = _inputs(40)
    got = PMECH.mechanism_validity(pm, m, t, NAMES)
    want = JMECH.mechanism_validity(jm, v, m, t, NAMES)
    for k in ("r2", "mse"):
        _dict_close(got[k], want[k], **STAT)
    assert abs(got["avg_r2"] - want["avg_r2"]) <= 1e-5 * abs(want["avg_r2"])
    assert got["verdict"] == want["verdict"]
    got, want = PMECH.phase1_importance(pm, 10, NAMES), JMECH.phase1_importance(jm, v, 10, NAMES)
    assert got["ranking"] == want["ranking"]
    _dict_close(got["sensitivity"], want["sensitivity"], **STAT)
    close(got["predictions"], want["predictions"], **FWD)
    got = PMECH.cascade_sensitivity(pm, 10, 3, NAMES)
    want = JMECH.cascade_sensitivity(jm, v, 10, 3, NAMES)
    assert got["ranking"] == want["ranking"] and not got["delta"][3].any()
    close(got["delta"], want["delta"], **FWD)
    _dict_close(got["importance"], want["importance"], **STAT)
    if bayes:
        got, want = PMECH.uncertainty_table(pm, 10, NAMES), JMECH.uncertainty_table(jm, v, 10, NAMES)
        close(got["sigma"], want["sigma"], **FWD)
        close(got["mu"], want["mu"], **FWD)
        for g, w in zip(got["per_condition"], want["per_condition"]):
            assert {k: g[k] for k in ("condition", "most_certain", "least_certain")} == {
                k: w[k] for k in ("condition", "most_certain", "least_certain")}
            assert abs(g["sigma_max"] - w["sigma_max"]) <= 1e-5 * w["sigma_max"]


def test_phase_comparison_and_cohens_d_equal_jax():
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((20, 12)), rng.standard_normal((25, 12)) + 0.3
    assert PI.pairwise_cohens_d(a, b, NAMES) == JI.pairwise_cohens_d(a, b, NAMES)
    p1 = {"sensitivity": dict(zip(NAMES, rng.random(12)))}
    p2 = {"sensitivity": dict(zip(NAMES[::-1], rng.random(12)))}
    assert PI.compare_phases(p1, p2, NAMES) == JI.compare_phases(p1, p2, NAMES)
    flat = np.full(4, 2.0)
    np.testing.assert_array_equal(PI.minmax_normalize(flat), JI.minmax_normalize(flat))


def test_perturbation_importance_matches_jax():
    jm, v, pm = conv_vae_pair(False, z_dim=Z)
    rng = np.random.default_rng(5)
    m = rng.standard_normal((10, 12)).astype(np.float32)
    z = rng.standard_normal((10, Z)).astype(np.float32)
    want = JI.perturbation_importance(
        lambda mm, zz: jm.apply(v, mm, zz, method=jm.decode), jnp.asarray(m), jnp.asarray(z),
        n_random=4)
    with torch.no_grad():
        got = PI.perturbation_importance(pm.decode, _t(m), _t(z), n_random=4)
    assert got["ranking"] == want["ranking"]
    _dict_close(got["image_change"], want["image_change"], **STAT)
    with torch.no_grad():
        drawn = PI.perturbation_importance(pm.decode, _t(m), _t(z), n_random=4,
                                           generator=torch.Generator().manual_seed(1))
    assert sorted(drawn["image_change"]) == sorted(NAMES)


@pytest.mark.parametrize("with_t", [False, True], ids=["m", "m_t"])
def test_mdecoder_and_probe_match_jax(with_t):
    """The forward on perturbed weights, and ``_train_probe`` for two steps
    from JAX's own initialisation (``MDecoder().init(PRNGKey(seed), ...)``)
    in JAX's batch order: the held-out MSE. A probe that did not train
    would miss: its MSE moves by more than the bound."""
    x, m, t, _ = _inputs(40, seed=6)
    tt = t if with_t else None
    jargs = (jnp.asarray(m[:3]),) + ((jnp.asarray(t[:3]),) if with_t else ())
    jm = jvae.MDecoder()
    v = init_jax(jm, *jargs, seed=2)
    pm = load_port(MDecoder(12, 10 if with_t else 0, device="cpu"), v)
    with torch.no_grad():
        got = pm(_t(m[:3]), _t(t[:3]) if with_t else None)
    close(got, jm.apply(v, *jargs), **FWD)
    assert tuple(got.shape) == (3, 28, 28, 1)

    seed = 3
    v0 = to_numpy_tree(jm.init(jax.random.PRNGKey(seed), jnp.asarray(m[:1]),
                               *((jnp.asarray(t[:1]),) if with_t else ())))
    kw = dict(epochs=1, batch_size=16, lr=1e-3, seed=seed)
    want = JIND._train_probe(x, m, tt, **kw)
    probe = load_port(MDecoder(12, 10 if with_t else 0, device="cpu"), v0)
    with torch.no_grad():
        before = float(((probe(_t(m[32:]), _t(t[32:]) if with_t else None) - _t(x[32:])) ** 2)
                       .mean())
    got = PIND._train_probe(x, m, tt, model=probe, **kw)
    assert abs(got - want) <= 1e-5 * want
    assert abs(before - want) > 1e-5 * want


def test_conditional_independence_report_keys_and_verdict():
    x, m, t, _ = _inputs(40, seed=7)
    got = PIND.conditional_independence_test(x, m, t, epochs=1, batch_size=16, device="cpu")
    assert list(got) == ["mse_m_only", "mse_m_and_t", "independence_rejected",
                         "m_information_fraction", "verdict"]
    assert got["independence_rejected"] == (got["mse_m_and_t"] < 0.95 * got["mse_m_only"])
    assert np.isfinite([got["mse_m_only"], got["mse_m_and_t"]]).all()


def test_classifier_training_and_evaluation_match_jax():
    """``train_classifier_on`` for two steps (batch 16 of 32) from JAX's
    initialisation: every leaf and the train accuracy; then
    ``evaluate_classifier`` on JAX's trained weights."""
    x, _, _, labels = _inputs(32, seed=8)
    jmodel, jvars, jacc = JR.train_classifier_on(x, labels, epochs=1, batch_size=16, seed=0)
    v0 = to_numpy_tree(jheads.SimpleClassifier().init(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 28, 28, 1))))
    clf = load_port(pheads.SimpleClassifier(device="cpu"), v0)
    model, acc = PR.train_classifier_on(x, labels, epochs=1, batch_size=16, seed=0, model=clf)
    assert model is clf and acc == jacc
    want = from_jax_variables(clf, to_numpy_tree(jvars))
    for name, p in clf.named_parameters():
        close(p.detach(), want[name].numpy(), rel=1e-4, abs_=0.0)
    x2, _, _, labels2 = _inputs(50, seed=9)
    trained = load_port(pheads.SimpleClassifier(device="cpu"), to_numpy_tree(jvars))
    assert PR.evaluate_classifier(trained, x2, labels2, batch_size=16) == \
        JR.evaluate_classifier(jmodel, jvars, x2, labels2, batch_size=16)


def test_residuals_and_leakage_report():
    jm, v, pm = conv_vae_pair(False, z_dim=Z)
    x, m, t, labels = _inputs(24, seed=10)
    key = jax.random.PRNGKey(4)
    want = JR.compute_residuals(jm, v, jnp.asarray(x), jnp.asarray(m), jnp.asarray(t), key)
    eps = np.asarray(jax.random.normal(key, (24, Z)))
    close(PR.compute_residuals(pm, _t(x), _t(m), _t(t), eps=_t(eps)), want, **FWD)
    rep = PR.residual_leakage_analysis(pm, x, m, t, labels, epochs=1, batch_size=10)
    assert rep["residuals"].shape == x.shape
    assert rep["verdict"] == ("PASS" if rep["accuracy"] < 0.2 else
                              "WARN" if rep["accuracy"] < 0.5 else "FAIL")


def test_bilinear_upscale_equals_jax_resize():
    cam = np.random.default_rng(11).random((3, 8, 8)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(cam), (3, 28, 28), method="bilinear")
    got = F.interpolate(_t(cam)[:, None], size=(28, 28), mode="bilinear",
                        align_corners=False)[:, 0]
    close(got, want, rel=0.0, abs_=1e-6)


def test_grad_cam_matches_jax():
    jm = jheads.SimpleClassifier()
    x, _, _, labels = _inputs(12, seed=12)
    v = init_jax(jm, jnp.asarray(x[:1]), seed=3)
    pm = load_port(pheads.SimpleClassifier(device="cpu"), v)
    want = JG.grad_cam(jm, v, jnp.asarray(x), jnp.asarray(labels))
    got = PG.grad_cam(pm, x, labels)
    assert got.shape == (12, 28, 28) and got.min() >= 0.0 and got.max() <= 1.0
    close(got, want, rel=0.0, abs_=1e-5)
    close(PG.per_class_mean_cam(pm, x, labels), JG.per_class_mean_cam(jm, v, x, labels),
          rel=0.0, abs_=1e-5)


def test_causal_validation_report_equals_jax():
    rng = np.random.default_rng(13)
    table = {c: rng.standard_normal((15 + c, 4)) + 0.2 * c for c in range(3)}
    names = NAMES[:4]
    want = JC.causal_validation_report(table, 0, 2, names, use_dowhy="never")
    for mode in ("never", "auto"):
        assert PC.causal_validation_report(table, 0, 2, names, use_dowhy=mode) == want
    assert list(want["f0"]) == ["effect", "rcc_p", "placebo_p", "tipping_point", "robust"]
    with pytest.raises(ImportError, match="dowhy"):
        PC.causal_validation_report(table, 0, 2, names, use_dowhy="require")
    with pytest.raises(ValueError, match="auto/never/require"):
        PC.causal_validation_report(table, 0, 2, names, use_dowhy="maybe")


def _png(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def test_image_grids(tmp_path):
    """The grids' layout (cells ``GAP`` apart on white), each cell scaled to
    its own min..max, and the percentile ceiling of ``mip_quality_grid``."""
    rng = np.random.default_rng(14)
    orig = rng.random((2, 28, 28, 1))
    grid = rng.random((2, 3, 28, 28, 1))
    PP.intervention_grid(orig, grid, str(tmp_path / "g.png"))
    img = _png(tmp_path / "g.png")
    g = PP.GAP
    assert img.shape == (2 * 28 + g, 4 * 28 + 3 * g)
    np.testing.assert_array_equal(img[:28, :28], PP._gray(orig[0]))
    np.testing.assert_array_equal(img[28 + g:, 3 * (28 + g):], PP._gray(grid[1, 2]))
    assert (img[28:28 + g] == 255).all()
    PP.sweep_strip(grid[0], [-1.0, 0.0, 1.0], str(tmp_path / "s.png"))
    assert _png(tmp_path / "s.png").shape == (28, 3 * 28 + 2 * g)
    PP.recon_triptych(orig, grid[0], str(tmp_path / "r.png"), uncertainty=orig)
    assert _png(tmp_path / "r.png").shape == (2 * 28 + g, 3 * 28 + 2 * g)
    cams = np.zeros((3, 28, 28))
    cams[0, 0, 0] = 100.0  # above the 99th percentile: clipped to white
    cams[0, 1:, :] = np.linspace(0, 1, 27 * 28).reshape(27, 28)
    PP.mip_quality_grid(cams, ["a", "b", "a"], str(tmp_path / "m.png"), per_group=2)
    img = _png(tmp_path / "m.png")
    assert img.shape == (2 * 28 + g, 2 * 28 + g)
    assert img[0, 0] == 255 and img[27, 27] == 255  # clip, and the 99th percentile
    assert (img[28 + g:, 28 + g:] == 255).all()  # group "b" has one image
    np.testing.assert_array_equal(img[:28, 28 + g:], np.zeros((28, 28)))  # a flat map


def test_conditional_vae_forward_and_step0_match_jax():
    x, _, t, _ = _inputs(8, seed=15)
    jm = jvae.ConditionalVAE(z_dim=Z)
    v = init_jax(jm, jnp.asarray(x[:1]), jnp.asarray(t[:1]), rng=jax.random.PRNGKey(0), seed=4)
    pm = load_port(ConditionalVAE(z_dim=Z, device="cpu"), v)
    key = jax.random.PRNGKey(6)
    eps = np.asarray(jax.random.normal(key, (8, Z)))
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(t), rng=key)
    with torch.no_grad():
        got = pm(_t(x), _t(t), eps=_t(eps))
    for g, w in zip(got, want):
        close(g, w, **FWD)

    def jloss(out, batch):
        return JL.cvae_loss(out[0], batch["x"], out[1], out[2])

    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))
    state = TrainState.create(v, optax.chain(capture, optax.adam(1e-3)))
    rng = jax.random.PRNGKey(9)
    state, jmet = jax.jit(jax_simple_step(jm, jloss, arg_names=("x", "t")))(
        state, {"x": jnp.asarray(x), "t": jnp.asarray(t)}, rng)
    step_eps = np.asarray(jax.random.normal(jax.random.split(rng)[0], (8, Z)))

    def ploss(out, batch):
        return PL.cvae_loss(out[0], batch["x"], out[1], out[2])

    pm.train()
    opt = ClippedAdam(pm.parameters(), 1e-3, None, mu_dtype=torch.float32)
    pmet = make_simple_vae_step(pm, ploss, opt)({"x": _t(x), "t": _t(t)}, eps=_t(step_eps))
    assert set(pmet) == set(jmet) == {"loss", "recon", "kld"}
    for k in jmet:
        assert abs(float(pmet[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), k
    want = from_jax_variables(pm, {"params": to_numpy_tree(state.opt_state[0])})
    for name, p in pm.named_parameters():
        close(p.grad, want[name].numpy(), rel=1e-4, abs_=0.0)


@pytest.fixture(scope="module")
def cvae_run():
    """JAX ``train_cvae`` for 4 epochs of 2 steps (batch 24 of 48), and a
    runner of the port's from JAX's initial weights and noise."""
    images, labels = PM.synthetic_mnist(48, seed=7)
    ds = PM.build_morph_mnist(images, labels)
    jds = JM.MorphDataset(ds.x, ds.m, ds.t, ds.labels)
    _, _, jlog = JW.train_cvae(jds, z_dim=Z, epochs=4, batch_size=24)
    key = jax.random.PRNGKey(42)
    b0 = next(jds.batches(2))
    v0 = to_numpy_tree(jvae.ConditionalVAE(z_dim=Z).init(
        {"params": key, "dropout": key}, jnp.asarray(b0["x"]), jnp.asarray(b0["t"]), rng=key))
    noise, k = [], key
    for _ in range(8):
        k, sub = jax.random.split(k)
        noise.append(torch.from_numpy(np.asarray(
            jax.random.normal(jax.random.split(sub)[0], (24, Z)))))

    def run(seed=42):
        model = load_port(ConditionalVAE(z_dim=Z, device="cpu"), v0)
        return PW.train_cvae(ds, z_dim=Z, epochs=4, batch_size=24, seed=seed, model=model,
                             noise=iter(noise))[-1]

    return [r for r in jlog.history if r["step"] >= 0], run


def _cvae_misses(want, plog):
    got = [r for r in plog.history if r["step"] >= 0]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1, 2, 3]
    return {(r["step"], k): (g[k], r[k]) for g, r in zip(got, want)
            for k in ("train_loss", "train_recon", "train_kld")
            if abs(g[k] - r[k]) > TRAJ_REL * abs(r[k])}


def test_train_cvae_matches_jax(cvae_run):
    want, run = cvae_run
    plog = run()
    assert _cvae_misses(want, plog) == {}
    assert plog.history[-1]["images_per_sec"] > 0 and want[-1]["train_loss"] < want[0]["train_loss"]
    assert _cvae_misses(want, run(seed=43)) != {}  # another shuffle misses the bound

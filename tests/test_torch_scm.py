"""The port's ensemble, uncertainty and intervention layer against the JAX
package's (``causalvae_tpu_torch/scm/``, ``analysis/kfold_eval.py``,
``analysis/vessel_report.py``, ``serve/endpoints.py ensemble_endpoints``).

Three fold members of the small CausalViTVAE (``torch_port_helpers.SMALL``,
each from its own seed, perturbed so that biases and BatchNorm statistics
are not trivial) are stacked along a leading axis as JAX's k-fold returns
them and carried across by ``from_jax_stacked_variables``. Every function
is held to its JAX counterpart on the same inputs at rel 1e-5 of max|ref|
(+1e-6 absolute; ``torch_port_helpers.close``). Where JAX draws inside a
function, the draw is handed over or made irrelevant: ``mc_decode_stats``
takes JAX's eps; ``mediation_contributions`` bootstraps from pools of one
row, so every drawn index is 0. The spreads are population standard
deviations (divided by K); a test with K = 2 shows torch's default (K - 1)
would miss. ``ensemble_endpoints`` is served through ``BatchingEngine`` to
concurrent clients as ``tests/test_serve.py::
test_ensemble_endpoints_through_engine_coalesced`` serves JAX's: each client
gets its own rows, ``uncertainty`` batch-leading (B, K, m).
"""

import csv
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from causalvae_tpu.analysis import kfold_eval as JKE
from causalvae_tpu.analysis import mechanism as JMech
from causalvae_tpu.analysis import vessel_report as JVR
from causalvae_tpu.models.vit import CausalViTVAE as JaxCausalViTVAE
from causalvae_tpu.scm import ensemble as JE
from causalvae_tpu.scm import intervene as JI
from causalvae_tpu.scm import uncertainty as JU
from causalvae_tpu.train.kfold import stratified_kfold as jax_stratified_kfold
from causalvae_tpu.utils import metrics as JMetrics

from causalvae_tpu_torch.analysis import kfold_eval as KE
from causalvae_tpu_torch.analysis import mechanism as Mech
from causalvae_tpu_torch.analysis import vessel_report as VR
from causalvae_tpu_torch.models.vit import CausalViTVAE
from causalvae_tpu_torch.scm import ensemble as E
from causalvae_tpu_torch.scm import intervene as I
from causalvae_tpu_torch.scm import uncertainty as U
from causalvae_tpu_torch.serve.endpoints import ensemble_endpoints
from causalvae_tpu_torch.serve.engine import BatchingEngine
from causalvae_tpu_torch.train.kfold import stratified_kfold
from causalvae_tpu_torch.train.port_maps import from_jax_stacked_variables
from causalvae_tpu_torch.utils import metrics as Metrics

from torch_port_helpers import SMALL, close, init_jax, inputs, two_threads  # noqa: F401

K = 3
REL = 1e-5  # of max|ref|, plus 1e-6 absolute (torch_port_helpers.close)
T_DIM, M_DIM, Z_DIM = 19, 12, SMALL["z_dim"]


@pytest.fixture(scope="module")
def ensemble():
    """(JAX model, stacked JAX variables (K, ...), the port's ModuleList)."""
    jm = JaxCausalViTVAE(**SMALL, packed=False)
    h, w = SMALL["img_size"]
    members = [init_jax(jm, jnp.zeros((1, h, w, 1)), jnp.zeros((1, M_DIM)),
                        jnp.zeros((1, T_DIM)), rng=jax.random.PRNGKey(0), train=False,
                        seed=10 + 2 * f) for f in range(K)]
    stacked = jax.tree.map(lambda *leaves: np.stack(leaves), *members)
    models = [CausalViTVAE(**SMALL, device="cpu") for _ in range(K)]
    for model, sd in zip(models, from_jax_stacked_variables(models, stacked)):
        model.load_state_dict(sd, strict=True)
    return jm, stacked, E.stack_fold_variables(models).eval()


def _member(stacked, f):
    return jax.tree.map(lambda a: a[f], stacked)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _eye():
    return np.eye(T_DIM, dtype=np.float32)


def test_from_jax_stacked_variables_checks_the_fold_axis(ensemble):
    jm, stacked, models = ensemble
    with pytest.raises(ValueError, match="leading fold axis"):
        from_jax_stacked_variables(list(models)[:2], stacked)
    assert isinstance(E.stack_fold_variables(list(models)), torch.nn.ModuleList)


# ---------------------------------------------------------------------------
# scm/ensemble.py
# ---------------------------------------------------------------------------

@torch.no_grad()
def test_ensemble_decode_and_apply(ensemble):
    jm, stacked, models = ensemble
    rng = np.random.default_rng(0)
    m = rng.standard_normal((2, M_DIM)).astype(np.float32)
    z = rng.standard_normal((2, Z_DIM)).astype(np.float32)
    want_mean, want_std = JE.ensemble_decode(jm, stacked, jnp.asarray(m), jnp.asarray(z))
    mean, std = E.ensemble_decode(models, _t(m), _t(z))
    close(mean, want_mean, rel=REL, abs_=1e-6)
    close(std, want_std, rel=REL, abs_=1e-6)
    # a tuple-valued member function stacks element by element
    mu, logvar = E.ensemble_apply(lambda mdl, tt: mdl.morph(tt), models, _t(_eye()[:4]))
    want_mu, want_lv = JE.ensemble_apply(
        lambda v, tt: jm.apply(v, tt, method=lambda mdl, t_: mdl.morph(t_)),
        stacked, jnp.asarray(_eye()[:4]))
    close(mu, want_mu, rel=REL, abs_=1e-6)
    close(logvar, want_lv, rel=REL, abs_=1e-6)


@torch.no_grad()
def test_ensemble_predict_m_and_morph_distribution(ensemble):
    jm, stacked, models = ensemble
    t = _eye()
    for got, want in zip(E.ensemble_predict_m(models, _t(t)),
                         JE.ensemble_predict_m(jm, stacked, jnp.asarray(t))):
        close(got, want, rel=REL, abs_=1e-6)
    got = E.ensemble_morph_distribution(models, _t(t))
    want = JE.ensemble_morph_distribution(jm, stacked, jnp.asarray(t))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (K, T_DIM, M_DIM)
        close(g, w, rel=REL, abs_=1e-6)


@torch.no_grad()
def test_spreads_divide_by_the_member_count(ensemble):
    """K = 2: the population std (JAX's, numpy's) and not torch's default,
    which is sqrt(2) times larger."""
    jm, stacked, models = ensemble
    pair = E.stack_fold_variables(list(models)[:2])
    t = _t(_eye())
    preds = np.stack([mdl.predict_m(t).numpy() for mdl in pair])
    _, std = E.ensemble_predict_m(pair, t)
    np.testing.assert_allclose(std.numpy(), preds.std(axis=0), rtol=1e-6, atol=1e-7)
    assert not np.allclose(std.numpy(), preds.std(axis=0, ddof=1), rtol=1e-2)
    _, want = JE.ensemble_predict_m(jm, _member(stacked, slice(0, 2)), jnp.asarray(_eye()))
    close(std, want, rel=REL, abs_=1e-6)


# ---------------------------------------------------------------------------
# scm/uncertainty.py
# ---------------------------------------------------------------------------

@torch.no_grad()
def test_morph_sigma_and_ensemble_sigma(ensemble):
    jm, stacked, models = ensemble
    v0 = _member(stacked, 0)
    t = _eye()[[3, 0, 7]]
    for got, want in zip(U.morph_sigma(models[0], _t(t)),
                         JU.morph_sigma(jm, v0, jnp.asarray(t))):
        close(got, want, rel=REL, abs_=1e-6)
    for got, want in zip(U.morph_sigma(models[1], _t(t), logvar_clip=0.5),
                         JU.morph_sigma(jm, _member(stacked, 1), jnp.asarray(t), 0.5)):
        close(got, want, rel=REL, abs_=1e-6)
    for got, want in zip(U.all_conditions_sigma(models[2], T_DIM),
                         JU.all_conditions_sigma(jm, _member(stacked, 2), T_DIM)):
        close(got, want, rel=REL, abs_=1e-6)
    for got, want in zip(U.ensemble_sigma_by_treatment(models, T_DIM),
                         JU.ensemble_sigma_by_treatment(jm, stacked, T_DIM)):
        assert tuple(got.shape) == (T_DIM, M_DIM)
        close(got, want, rel=REL, abs_=1e-6)


def test_pairwise_snr_scores_and_significant_changes():
    rng = np.random.default_rng(1)
    mu = rng.standard_normal((5, 4)).astype(np.float32)
    sigma = rng.uniform(0.2, 1.5, (5, 4)).astype(np.float32)
    scale = rng.uniform(0.5, 3.0, 4).astype(np.float32)
    for kw in ({}, {"scale": scale}):
        want = JU.pairwise_snr(jnp.asarray(mu), jnp.asarray(sigma),
                               **{k: jnp.asarray(v) for k, v in kw.items()})
        got = U.pairwise_snr(_t(mu), _t(sigma), **{k: _t(v) for k, v in kw.items()})
        close(got, want, rel=REL, abs_=1e-6)
    close(U.discriminative_score(_t(mu), _t(sigma)),
          JU.discriminative_score(jnp.asarray(mu), jnp.asarray(sigma)), rel=REL, abs_=1e-6)
    snr = np.asarray(JU.pairwise_snr(jnp.asarray(mu), jnp.asarray(sigma)))
    names, feats = [f"g{i}" for i in range(5)], [f"f{i}" for i in range(4)]
    for kw in ({}, {"baseline": 2, "top_k": 4}):
        assert (U.significant_changes(snr, mu, names, feats, **kw)
                == JU.significant_changes(snr, mu, names, feats, **kw))
    by_t = {0: mu[:3], 4: mu[2:]}
    got = U.feature_stats_real_units(by_t, scale, scale * 2)
    want = JU.feature_stats_real_units(by_t, scale, scale * 2)
    assert got.keys() == want.keys()
    for t in got:
        for k in ("mean", "std"):
            np.testing.assert_allclose(got[t][k], want[t][k], rtol=1e-6)


@torch.no_grad()
def test_mc_decode_stats_with_jax_noise(ensemble):
    jm, stacked, models = ensemble
    v0 = _member(stacked, 0)
    rng = np.random.default_rng(2)
    m = rng.standard_normal((2, M_DIM)).astype(np.float32)
    mu = rng.standard_normal((2, Z_DIM)).astype(np.float32)
    logvar = rng.uniform(-1, 0.5, (2, Z_DIM)).astype(np.float32)
    key, n_mc = jax.random.PRNGKey(4), 5
    want = JU.mc_decode_stats(jm, v0, jnp.asarray(m), jnp.asarray(mu), jnp.asarray(logvar),
                              key, n_mc=n_mc)
    eps = np.stack([np.asarray(jax.random.normal(k, mu.shape))
                    for k in jax.random.split(key, n_mc)])
    got = U.mc_decode_stats(models[0], _t(m), _t(mu), _t(logvar), n_mc=n_mc, eps=_t(eps))
    for g, w in zip(got, want):
        close(g, w, rel=REL, abs_=1e-6)
    # drawn from a generator: the same shapes, the same draws for the same seed
    a = U.mc_decode_stats(models[0], _t(m), _t(mu), _t(logvar),
                          torch.Generator().manual_seed(0), n_mc=3)
    b = U.mc_decode_stats(models[0], _t(m), _t(mu), _t(logvar),
                          torch.Generator().manual_seed(0), n_mc=3)
    assert all(torch.equal(x, y) and x.shape == g.shape for x, y, g in zip(a, b, got))


# ---------------------------------------------------------------------------
# scm/intervene.py
# ---------------------------------------------------------------------------

@torch.no_grad()
def test_intervention_matrix_and_do_m_sweep(ensemble):
    jm, stacked, models = ensemble
    v0, pm = _member(stacked, 0), models[0]
    x, m, t = inputs(2, seed=5)
    tt = _eye()[[1, 4, 9]]
    close(I.intervention_matrix(pm, _t(m), _t(tt)),
          JI.intervention_matrix(jm, v0, jnp.asarray(m), jnp.asarray(tt)), rel=REL, abs_=1e-6)
    feats, values = np.asarray([0, 7]), np.asarray([-2.0, 0.5, 3.0], np.float32)
    got = I.do_m_sweep(pm, _t(x), _t(m), _t(t), _t(feats), _t(values))
    want = JI.do_m_sweep(jm, v0, jnp.asarray(x), jnp.asarray(m), jnp.asarray(t),
                         jnp.asarray(feats), jnp.asarray(values))
    assert tuple(got.shape) == (2, 2, 3, *SMALL["img_size"], 1)
    close(got, want, rel=REL, abs_=1e-6)


@torch.no_grad()
def test_z_permute_cross_grid_and_diff_map(ensemble):
    jm, stacked, models = ensemble
    v1, pm = _member(stacked, 1), models[1]
    x, m, t = inputs(3, seed=6)
    perm = np.asarray([2, 0, 1])
    close(I.z_permute_decode(pm, _t(x), _t(m), _t(t), _t(perm), z_scale=1.5),
          JI.z_permute_decode(jm, v1, jnp.asarray(x), jnp.asarray(m), jnp.asarray(t),
                              jnp.asarray(perm), z_scale=1.5), rel=REL, abs_=1e-6)
    grid = I.m_z_cross_grid(pm, _t(x), _t(m), _t(t))
    assert tuple(grid.shape) == (3, 3, *SMALL["img_size"], 1)
    close(grid, JI.m_z_cross_grid(jm, v1, jnp.asarray(x), jnp.asarray(m), jnp.asarray(t)),
          rel=REL, abs_=1e-6)
    close(I.diff_map(pm, _t(x), _t(m), _t(t), shift=2.0),
          JI.diff_map(jm, v1, jnp.asarray(x), jnp.asarray(m), jnp.asarray(t), shift=2.0),
          rel=REL, abs_=1e-6)


@torch.no_grad()
def test_mediation_contributions(ensemble):
    """Pools of one row: every bootstrap index is 0 in both frameworks."""
    jm, stacked, models = ensemble
    v2, pm = _member(stacked, 2), models[2]
    rng = np.random.default_rng(7)
    m_a, m_b = (rng.standard_normal(M_DIM).astype(np.float32) for _ in range(2))
    z_a, z_b = (rng.standard_normal((1, Z_DIM)).astype(np.float32) for _ in range(2))
    want = JI.mediation_contributions(jm, v2, jnp.asarray(m_a), jnp.asarray(m_b),
                                      jnp.asarray(z_a), jnp.asarray(z_b),
                                      jax.random.PRNGKey(0), n_mc=3)
    got = I.mediation_contributions(pm, _t(m_a), _t(m_b), _t(z_a), _t(z_b),
                                    torch.Generator().manual_seed(0), n_mc=3)
    assert got.keys() == want.keys()
    assert tuple(got["feature_contribution_pct"].shape) == (3, M_DIM)
    for k in got:
        close(got[k], want[k], rel=REL, abs_=1e-6)


# ---------------------------------------------------------------------------
# analysis/: kfold_eval, vessel_report, mechanism; utils/metrics CSV writers
# ---------------------------------------------------------------------------

@torch.no_grad()
def test_per_fold_validation_r2_and_pairwise_report(ensemble):
    jm, stacked, models = ensemble
    rng = np.random.default_rng(8)
    labels = np.repeat(np.arange(6), 4)
    t = np.eye(T_DIM, dtype=np.float32)[labels]
    m = rng.standard_normal((len(labels), M_DIM)).astype(np.float32)
    names = [f"feat{i}" for i in range(M_DIM)]
    got = KE.per_fold_validation_r2(models, stratified_kfold(labels, K, 42), m, t, names)
    want = JKE.per_fold_validation_r2(jm, stacked, jax_stratified_kfold(labels, K, 42),
                                      m, t, names)
    for k in ("per_fold_r2", "per_fold_sigma"):
        close(got[k], want[k], rel=REL, abs_=1e-6)
    assert got["aggregate"].keys() == want["aggregate"].keys()
    for f in names:
        for k, v in want["aggregate"][f].items():
            assert abs(got["aggregate"][f][k] - v) <= 1e-4 * abs(v) + 1e-6, (f, k)

    groups = [f"Drug{i % 3} {i}nM" if i % 4 else f"PBS {i}" for i in range(T_DIM)]
    rows = KE.ensemble_pairwise_report(models, T_DIM, groups, names)
    want_rows = JKE.ensemble_pairwise_report(jm, stacked, T_DIM, groups, names)
    assert len(rows) == len(want_rows) == T_DIM * (T_DIM - 1) * M_DIM
    scale = max(r["abs_diff"] for r in want_rows)
    for r, w in zip(rows, want_rows):
        assert {k: r[k] for k in ("treatment_a", "treatment_b", "feature")} == {
            k: w[k] for k in ("treatment_a", "treatment_b", "feature")}
        assert abs(r["diff"] - w["diff"]) <= REL * scale + 1e-6
    # the filters and the top-k, on JAX's rows so the orders are comparable
    for mode in ("efficacy", "dose_response", "vs_baseline"):
        assert KE.filter_pairwise(want_rows, mode=mode) == JKE.filter_pairwise(want_rows,
                                                                              mode=mode)
    assert KE.top_k_per_pair(want_rows, k=3) == JKE.top_k_per_pair(want_rows, k=3)
    for name in ("Drug 10nM", "Foo-2.5 uM", "PBS", "x 3 mg extra"):
        assert KE.parse_treatment_name(name) == JKE.parse_treatment_name(name)


@torch.no_grad()
def test_vessel_report_rows(ensemble):
    jm, stacked, models = ensemble
    x, m, t = inputs(7, seed=9)
    t_idx = t.argmax(axis=1)
    groups = [f"group_{i:02d}" for i in range(T_DIM)]
    names = [f"feat{i}" for i in range(M_DIM)]
    got = VR.predictions_by_treatment(models[0], x, m, t, t_idx, groups, names, batch_size=4)
    want = JVR.predictions_by_treatment(jm, _member(stacked, 0), x, m, t, t_idx, groups,
                                        names, batch_size=4)
    close(got["per_sample_mu"], want["per_sample_mu"], rel=REL, abs_=1e-6)
    assert [{k: r[k] for k in ("treatment", "feature", "n")} for r in got["rows"]] == [
        {k: r[k] for k in ("treatment", "feature", "n")} for r in want["rows"]]
    assert got["by_treatment"].keys() == want["by_treatment"].keys()
    for r, w in zip(got["rows"], want["rows"]):
        for k in ("mean", "std"):
            assert abs(r[k] - w[k]) <= REL * abs(w[k]) + 1e-6, (r, w)
    rows = VR.uncertainty_by_treatment_rows(models, groups, names)
    want_rows = JVR.uncertainty_by_treatment_rows(jm, stacked, groups, names)
    assert [list(r) for r in rows] == [list(r) for r in want_rows]
    for r, w in zip(rows, want_rows):
        for k in ("pred_mean", "aleatoric_sigma"):
            assert abs(r[k] - w[k]) <= REL * abs(w[k]) + 1e-6


def test_r2_and_csv_writers_equal_jax(tmp_path):
    rng = np.random.default_rng(10)
    pred, target = rng.standard_normal((2, 9, 4))
    target[:, 2] = 1.5  # a constant column
    np.testing.assert_array_equal(Mech.r2_per_feature(pred, target),
                                  JMech.r2_per_feature(pred, target))
    rows = [{"treatment": 3, "feature": "f", "snr": 0.125}, {"treatment": 2.5,
                                                            "feature": "g", "snr": 1e-9}]
    for mod, name in ((Metrics, "port"), (JMetrics, "jax")):
        mod.write_csv(str(tmp_path / name / "rows.csv"), rows)
        mod.write_csv(str(tmp_path / name / "none.csv"), [])
        mod.write_matrix_csv(str(tmp_path / name / "matrix.csv"), pred[:3, :2],
                             ["a", "b", "c"], ["x", "y"], corner="r")
    for f in ("rows.csv", "matrix.csv"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    assert not (tmp_path / "port" / "none.csv").exists()
    with open(tmp_path / "port" / "rows.csv") as fh:
        assert list(csv.reader(fh))[0] == ["treatment", "feature", "snr"]


# ---------------------------------------------------------------------------
# ensemble_endpoints through the engine
# ---------------------------------------------------------------------------

def test_ensemble_endpoints_through_engine_coalesced(ensemble):
    """Concurrent clients each get their own rows: predict_m's (mean, spread)
    and uncertainty's batch-leading (1, K, m), against the JAX ensemble."""
    jm, stacked, models = ensemble
    eps = ensemble_endpoints(models)
    assert sorted(eps) == ["decode", "predict_m", "uncertainty"]
    assert not models.training and eps["predict_m"].device == torch.device("cpu")
    t_all = _eye()
    pm_mean, pm_std = map(np.asarray, JE.ensemble_predict_m(jm, stacked, jnp.asarray(t_all)))
    un_mu, un_sigma = map(np.asarray, JE.ensemble_morph_distribution(
        jm, stacked, jnp.asarray(t_all)))

    results = {}
    with BatchingEngine(eps, buckets=(1, 2, 4, 8, 16), max_delay_s=0.05) as eng:
        def client(i):
            name = "predict_m" if i % 2 == 0 else "uncertainty"
            results[i] = eng.infer(name, t_all[i // 2: i // 2 + 1])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2 * T_DIM)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        rng = np.random.default_rng(11)
        m = rng.standard_normal((2, M_DIM)).astype(np.float32)
        z = rng.standard_normal((2, Z_DIM)).astype(np.float32)
        dec_mean, dec_std = eng.infer("decode", m, z)
        stats = dict(eng.stats)

    for i in range(2 * T_DIM):
        row = i // 2
        a, b = results[i]
        if i % 2 == 0:
            close(a[0], pm_mean[row], rel=REL, abs_=1e-6)
            close(b[0], pm_std[row], rel=REL, abs_=1e-6)
        else:
            assert a.shape == b.shape == (1, K, M_DIM)
            close(a[0], un_mu[:, row], rel=REL, abs_=1e-6)
            close(b[0], un_sigma[:, row], rel=REL, abs_=1e-6)
    want_mean, want_std = JE.ensemble_decode(jm, stacked, jnp.asarray(m), jnp.asarray(z))
    close(dec_mean, want_mean, rel=REL, abs_=1e-6)
    close(dec_std, want_std, rel=REL, abs_=1e-6)
    assert stats["launches"] <= T_DIM + 1, stats

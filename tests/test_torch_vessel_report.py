"""The rest of the port's vessel report (``analysis/vessel_report.py``)
against the JAX package's, on the CPU.

Tolerances and rules:
- ``discriminative_feature_ensemble`` on ``tests/test_analysis.py``'s case:
  "f2" first, as JAX gives;
- on a seeded 8-feature problem whose features carry graded information
  about the group: the port's forest (seed 42) within 0.05 of sklearn's
  importances per feature, Spearman >= 0.9, where sklearn's are the mean of
  five of its forests (seeds 42-46): one sklearn forest of 100 trees moves
  by up to 0.06 per feature between seeds on this problem, and the port's
  forest draws its own trees; ``variance`` and ``anova_f`` equal to JAX's
  at 1e-6 relative, the consensus ranking equal to JAX's; the same seed
  gives the same importances, another seed others;
- ``full_report_vs_baseline``, ``reliability_gate`` and ``fix_csv_names``
  equal to JAX's: the same rows, in the same order, with the same keys;
  the same rewritten file;
- ``m_influence_check`` on C1 and the tiny C9 (``from_jax_variables``):
  the pixel difference within 1e-5 relative, the weight ratio within 1e-6,
  the verdict equal; a control that slices the layer's other axis misses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scipy.stats import spearmanr
from sklearn.ensemble import RandomForestClassifier

from causalvae_tpu.analysis import vessel_report as jvr
from causalvae_tpu.models import vae as jvae

from causalvae_tpu_torch.analysis import vessel_report as vr
from causalvae_tpu_torch.models.vae import CausalConvVAE

from torch_port_helpers import init_jax, inputs, load_port, small_causal_pair  # noqa: F401
from torch_port_helpers import two_threads  # noqa: F401

NAMES8 = [f"f{i}" for i in range(8)]


def _graded(n=150, seed=11):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 3, n)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    x += (np.arange(8, dtype=np.float32) / 4.0)[None, :] * t[:, None]
    return x, t


def test_consensus_ranking_on_the_jax_case():
    rng = np.random.default_rng(7)
    mus = rng.standard_normal((60, 4)).astype(np.float32)
    t_idx = np.repeat(np.arange(3), 20)
    mus[t_idx == 1, 2] += 2.0
    names = ["f0", "f1", "f2", "f3"]
    got = vr.discriminative_feature_ensemble(mus, t_idx, names)
    assert got["consensus_ranking"][0] == "f2"
    assert got["consensus_ranking"] == jvr.discriminative_feature_ensemble(
        mus, t_idx, names)["consensus_ranking"]


def test_feature_ensemble_against_sklearn_and_jax():
    x, t = _graded()
    got = vr.discriminative_feature_ensemble(x, t, NAMES8, seed=42)
    want = jvr.discriminative_feature_ensemble(x, t, NAMES8, seed=42)
    assert list(got) == list(want)
    for key in ("variance", "anova_f"):
        assert list(got[key]) == NAMES8
        for name in NAMES8:
            assert got[key][name] == pytest.approx(want[key][name], rel=1e-6)
    assert got["consensus_ranking"] == want["consensus_ranking"]
    imp = np.array([got["rf_importance"][n] for n in NAMES8])
    sk = np.mean([RandomForestClassifier(100, random_state=s).fit(x, t).feature_importances_
                  for s in range(42, 47)], axis=0)
    assert np.abs(imp - sk).max() <= 0.05, (imp, sk)
    assert spearmanr(imp, sk)[0] >= 0.9
    assert imp.sum() == pytest.approx(1.0)
    again = vr.random_forest_importances(x, t, seed=42)
    np.testing.assert_array_equal(again, imp)
    assert not np.array_equal(vr.random_forest_importances(x, t, seed=43), imp)


def test_anova_f_of_constant_features_is_zeroed_as_jax():
    x, t = _graded(n=30)
    x[:, 3] = 1.5  # constant: F is nan, which both set to 0
    got = vr.discriminative_feature_ensemble(x, t, NAMES8)
    want = jvr.discriminative_feature_ensemble(x, t, NAMES8)
    assert got["anova_f"]["f3"] == want["anova_f"]["f3"] == 0.0
    assert got["consensus_ranking"][-1] == want["consensus_ranking"][-1]


def test_report_rows_match_jax():
    rng = np.random.default_rng(5)
    groups = ["g0", "g1", "g2"]
    names = ["a", "b", "c", "d"]
    mu = rng.standard_normal((3, 4)).astype(np.float32)
    sigma = rng.uniform(0.3, 1.0, (3, 4)).astype(np.float32)
    for base in (0, 2):
        assert (vr.full_report_vs_baseline(mu, sigma, base, groups, names)
                == jvr.full_report_vs_baseline(mu, sigma, base, groups, names))
    r2 = rng.uniform(0, 1, (3, 4))
    sig = np.array([[0.5, 0.6, 0.7, 0.8], [0.81, 0.2, 0.6000001, 1.2], [0.0, 0.9, 0.65, 0.59]])
    got = vr.reliability_gate(r2, sig, groups, names)
    assert got == jvr.reliability_gate(r2, sig, groups, names)
    assert {r["category"] for r in got} == {"reliable", "marginal", "unreliable"}
    got = vr.reliability_gate(r2, sig, groups, names, reliable_sigma=0.3,
                              unreliable_sigma=0.9)
    assert got == jvr.reliability_gate(r2, sig, groups, names, reliable_sigma=0.3,
                                       unreliable_sigma=0.9)


def test_fix_csv_names_matches_jax(tmp_path):
    text = ("Treatment_From,Treatment_To,Feature,Diff\n"
            "0,2,area,1.5\n"
            "1,0,area,-0.3\n")
    names = ["PBS", "DrugA", "DrugB"]
    for tool, sub in ((vr, "port"), (jvr, "jax")):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "r.csv").write_text(text)
        assert tool.fix_csv_names(str(tmp_path / sub / "r.csv"), names) == 4
        assert tool.fix_csv_names(str(tmp_path / sub / "r.csv"), names) == 0
    assert (tmp_path / "port" / "r.csv").read_bytes() == (tmp_path / "jax" / "r.csv").read_bytes()
    lines = (tmp_path / "port" / "r.csv").read_text().strip().splitlines()
    assert lines[1].startswith("PBS,DrugB") and lines[2].startswith("DrugA,PBS")
    (tmp_path / "empty.csv").write_text("")
    assert vr.fix_csv_names(str(tmp_path / "empty.csv"), names) == 0


def _c1_pair():
    kw = dict(m_dim=12, t_dim=10, z_dim=10)
    jm = jvae.CausalConvVAE(**kw)
    rng = np.random.default_rng(3)
    x = rng.random((4, 28, 28, 1), dtype=np.float32)
    m = rng.standard_normal((4, 12), dtype=np.float32)
    t = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
    v = init_jax(jm, jnp.asarray(x[:1]), jnp.asarray(m[:1]), jnp.asarray(t[:1]),
                 rng=jax.random.PRNGKey(0), seed=0, jit=True)
    return jm, v, load_port(CausalConvVAE(**kw, device="cpu"), v), (x, m, t)


def _c9_pair():
    jm, v, pm = small_causal_pair(seed=2, jit=True)
    return jm, v, pm, inputs(3)


@pytest.mark.parametrize("pair", [_c1_pair, _c9_pair], ids=["C1", "C9"])
def test_m_influence_check_matches_jax(pair):
    jm, v, pm, (x, m, t) = pair()
    want = jvr.m_influence_check(jm, v, jnp.asarray(x), jnp.asarray(m), jnp.asarray(t))
    got = vr.m_influence_check(pm, x, m, t)
    assert list(got) == list(want)
    assert got["mean_pixel_diff"] == pytest.approx(want["mean_pixel_diff"], rel=1e-5)
    assert got["m_to_z_weight_ratio"] == pytest.approx(want["m_to_z_weight_ratio"], rel=1e-6)
    assert got["verdict"] == want["verdict"]
    # the control: nn.Linear's weight is (out, in); its first m_dim rows are
    # outputs, not the M inputs
    layer = next(getattr(pm, n) for n in ("dec_fc", "dec_fc1", "dec_adapter_fc1")
                 if hasattr(pm, n))
    w = layer.weight.detach().numpy()
    wrong = float(np.abs(w[:12]).mean() / (np.abs(w[12:]).mean() + 1e-12))
    assert abs(wrong - want["m_to_z_weight_ratio"]) > 1e-3 * want["m_to_z_weight_ratio"]


def test_m_influence_check_flags_a_decoder_that_ignores_m():
    _, _, pm, (x, m, t) = _c1_pair()
    with torch.no_grad():
        pm.dec_fc.weight[:, :12] = 0.0
    got = vr.m_influence_check(pm, x, m, t, shift=10.0)
    assert got["verdict"] == "CRITICAL: decoder ignoring M"
    assert got["m_to_z_weight_ratio"] == 0.0

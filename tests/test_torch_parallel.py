"""The port's ``parallel/`` and the global-batch step against the JAX package
(``causalvae_tpu/parallel``) and against the port's one-process step.

The port's ranks are processes of a gloo group on the CPU
(``torch_parallel_workers.spawn``: two ranks, each reporting within 120 s or
failing the test); the JAX side runs here over ``make_mesh(2)``, two of the
conftest's eight virtual CPU devices.

Tolerances:
- ``make_shard_map_step`` against JAX's, three steps of a LatentDiscriminator
  (Adam 1e-3): losses rtol 1e-5, parameters atol 1e-4 ("mean") / 2e-4
  ("sum"), ``tests/test_shard_step.py``'s;
- ``make_vae_step(mesh=...)`` on the small CausalViTVAE (BatchNorm, the
  vessel loss's pos_weight, dropout 0), two steps of the whole batch of 4 as
  2 x 2: the loss terms rel 1e-5 against the one-process step and 1e-4
  against JAX's sharded step (the port's f32 parity rule,
  ``tests/test_torch_train.py``); every parameter within 2·lr a step of
  both (Adam turns the rounding of a sum taken in another order into up to
  ±lr a step); BatchNorm running statistics after the first step within
  1e-5 of their max|ref| (after the second, whose statistics read parameters already apart by
  that rounding, within the parameters' bound), and bit-equal on the two
  ranks after every step;
- dropout 0.1: JAX's encoder over the mesh equals its one-device encoder
  (rel 1e-5) and not the encoder of each half (the masks are the whole
  batch's); the port's mesh step equals its one-process step with the same
  seeds (loss terms rel 1e-5, noise and masks drawn), while the control
  that draws each rank's masks and noise for its own rows misses by more
  than 1e-3;
- C10 (``CausalBioVAE``, whose mechanism's ``PlainBatchNorm`` sums its
  statistics over the ranks) under ``cascade_loss``, two steps of the
  whole batch of 4 as 2 x 2: the C9 case's tolerances against the
  one-process step, and the mechanism's running statistics bit-equal on
  the two ranks; the control that takes each rank's statistics from its
  own rows misses the loss terms by more than 1e-3;
- a masked batch (``w`` 0 on one row of rank 1 only, the two ranks' rows
  with foreground fractions ~0.1 and ~0.4): the mesh step's loss terms rel
  1e-5 against the one-process step on the whole batch (the pos_weight of
  the valid rows of both ranks), while the control that takes each rank's
  pos_weight from its own rows misses by more than 1e-3.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_parallel_workers as W
from torch_port_helpers import close, init_jax, perturb, to_numpy_tree, two_threads  # noqa: F401

from causalvae_tpu.config import VesselConfig as JaxVesselConfig
from causalvae_tpu.models.heads import LatentDiscriminator as JaxDisc
from causalvae_tpu.models.vae import CausalBioVAE as JaxCausalBioVAE
from causalvae_tpu.models.vit import CausalViTVAE as JaxCausalViTVAE
from causalvae_tpu.parallel import mesh as JM
from causalvae_tpu.parallel.shard_step import make_shard_map_step as jax_shard_step
from causalvae_tpu.train.parity_vit import make_vit_parity_step
from causalvae_tpu.train.state import TrainState

from causalvae_tpu_torch.config import VesselConfig
from causalvae_tpu_torch.models.heads import LatentDiscriminator
from causalvae_tpu_torch.models.vae import CausalBioVAE
from causalvae_tpu_torch.models.vit import CausalViTVAE
from causalvae_tpu_torch.parallel import mesh as PM
from causalvae_tpu_torch.parallel.shard_step import make_shard_map_step
from causalvae_tpu_torch.train.loop import make_vae_step, vessel_loss_fn
from causalvae_tpu_torch.train.port_maps import from_jax_variables
from causalvae_tpu_torch.train.state import ClippedAdam

B = 4
DROPOUT_SEED = 3


def _disc_case():
    rng = np.random.default_rng(0)
    variables = to_numpy_tree(JaxDisc(t_dim=10).init(jax.random.PRNGKey(0),
                                                    jnp.zeros((2, 10))))
    batches = []
    for _ in range(3):
        z = rng.standard_normal((32, 10)).astype(np.float32)
        batches.append({"z": z, "y": np.eye(10, dtype=np.float32)[rng.integers(0, 10, 32)]})
    return variables, batches


def _vit_case():
    jm = JaxCausalViTVAE(**W.SMALL, packed=False, dropout=0.0)
    h, w = W.SMALL["img_size"]
    variables = init_jax(jm, jnp.zeros((1, h, w, 1)), jnp.zeros((1, 12)),
                         jnp.zeros((1, 19)), rng=jax.random.PRNGKey(0), train=False, seed=0,
                         jit=True)
    rng = np.random.default_rng(0)
    batches = [{"x": (rng.random((B, h, w, 1)) > 0.9).astype(np.float32),
                "m": rng.standard_normal((B, 12)).astype(np.float32),
                "t": np.eye(19, dtype=np.float32)[rng.integers(0, 19, B)],
                "eps": rng.standard_normal((B, W.SMALL["z_dim"])).astype(np.float32)}
               for _ in range(2)]
    return variables, batches


def _masked_batches(vit_batches):
    """The first vit batch with rows of other foreground fractions on the
    two ranks and the third row masked out (rank 1's first row)."""
    b = dict(vit_batches[0])
    rng = np.random.default_rng(5)
    frac = np.array([0.1, 0.1, 0.4, 0.4], np.float32).reshape(-1, 1, 1, 1)
    b["x"] = (rng.random(b["x"].shape) < frac).astype(np.float32)
    b["w"] = np.array([1, 1, 0, 1], np.float32)
    return [b]


def _c10_case():
    jm = JaxCausalBioVAE(**W.C10)
    key = jax.random.PRNGKey(0)
    variables = perturb(jax.jit(functools.partial(jm.init, train=False))(
        {"params": key}, jnp.zeros((1, 64, 128, 1)), jnp.zeros((1, 12)),
        jnp.zeros((1,), jnp.int32), rng=key), 1)
    rng = np.random.default_rng(2)
    batches = [{"x": rng.standard_normal((B, 64, 128, 1)).astype(np.float32),
                "m": rng.random((B, 12), dtype=np.float32),
                "t": rng.integers(0, W.C10["t_dim"], B).astype(np.int32),
                "eps": rng.standard_normal((B, W.C10["z_dim"])).astype(np.float32)}
               for _ in range(2)]
    return variables, batches


@pytest.fixture(scope="module")
def cases():
    variables, batches = _vit_case()
    return {"disc": _disc_case(), "vit": (variables, batches),
            "masked": (variables, _masked_batches(batches)), "c10": _c10_case()}


@pytest.fixture(scope="module")
def ranks(cases):
    """Every job on the two gloo ranks, in one spawn."""
    dv, db = cases["disc"]
    vv, vb = cases["vit"]
    mb = cases["masked"][1]
    jobs = [("shard_step", dict(variables=dv, batches=db, reduction="mean")),
            ("shard_step", dict(variables=dv, batches=db, reduction="sum")),
            ("vae_step", dict(variables=vv, batches=vb)),
            ("vae_step", dict(variables=vv, batches=vb[:1], dropout=0.1, seed=DROPOUT_SEED)),
            ("vae_step", dict(variables=vv, batches=vb[:1], dropout=0.1, seed=DROPOUT_SEED,
                              draws="per_rank")),
            ("replicate", {}),
            ("vae_step", dict(variables=vv, batches=mb)),
            ("vae_step", dict(variables=vv, batches=mb, counts="per_rank")),
            ("c10_step", dict(zip(("variables", "batches"), cases["c10"]))),
            ("c10_step", dict(zip(("variables", "batches"), cases["c10"]),
                              stats="per_rank"))]
    return W.spawn(jobs, world=2, timeout=120.0)


def _port_one_process(variables, batches, dropout=0.0, seed=None):
    """The port's one-process step on the whole batches (the workers' rule
    for the draws)."""
    pm = CausalViTVAE(**W.SMALL, dropout=dropout, device="cpu")
    pm.load_state_dict(from_jax_variables(pm, variables), strict=True)
    step = make_vae_step(pm, vessel_loss_fn(VesselConfig()),
                         ClippedAdam(pm.parameters(), W.LR, 5.0, torch.bfloat16))
    gen = None
    if seed is not None:
        torch.manual_seed(seed)
        gen = torch.Generator().manual_seed(seed)
    metrics, states = [], []
    for b in batches:
        tb = W._tensors(b)
        met = step(tb, generator=gen, eps=None if seed is not None else tb["eps"])
        metrics.append({k: float(v) for k, v in met.items()})
        states.append(W._numpy_state(pm))
    return metrics, states


def _rel_close(got, want, rel):
    for k, v in want.items():
        assert abs(got[k] - v) <= rel * abs(v), (k, got[k], v)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_shard_map_step_matches_jax(cases, ranks, reduction):
    variables, batches = cases["disc"]
    model = JaxDisc(t_dim=10)

    def loss_fn(params, b, rng_):
        logp = jax.nn.log_softmax(model.apply({"params": params}, b["z"]))
        ce = -jnp.sum(b["y"] * logp, axis=-1)
        return ce.mean() if reduction == "mean" else ce.sum()

    mesh = JM.make_mesh(2)
    step = jax_shard_step(loss_fn, mesh, loss_reduction=reduction)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              optax.adam(1e-3))
    losses = []
    for b in batches:
        state, loss = step(state, b, jax.random.PRNGKey(0))
        losses.append(float(loss))
    job = 0 if reduction == "mean" else 1
    atol = 1e-4 if reduction == "mean" else 2e-4
    for got in (ranks[0][job], ranks[1][job]):
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        port = LatentDiscriminator(t_dim=10, device="cpu")
        want = from_jax_variables(port, {"params": to_numpy_tree(state.params)})
        for k, v in want.items():
            np.testing.assert_allclose(got["state"][k], v.numpy(), atol=atol)


def test_loss_reduction_is_checked():
    mesh = PM.Mesh(0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="loss_reduction must be 'sum' or 'mean', got 'max'"):
        make_shard_map_step(lambda *a: None, mesh, loss_reduction="max")
    with pytest.raises(ValueError, match="loss_reduction must be 'sum' or 'mean', got 'max'"):
        jax_shard_step(lambda *a: None, JM.make_mesh(2), loss_reduction="max")


def _jax_sharded_vit_steps(variables, batches):
    jm = JaxCausalViTVAE(**W.SMALL, packed=False, dropout=0.0)
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adam(W.LR, mu_dtype=jnp.bfloat16))
    mesh = JM.make_mesh(2)
    state = JM.replicate(TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                                           tx), mesh)
    step = jax.jit(make_vit_parity_step(jm, JaxVesselConfig()))
    metrics, trees = [], []
    for b in batches:
        state, met = step(state, JM.shard_batch(b, mesh))
        metrics.append({k: float(v) for k, v in met.items()})
        trees.append({"params": to_numpy_tree(state.params),
                      "batch_stats": to_numpy_tree(state.batch_stats)})
    return metrics, trees


def test_vae_step_over_the_mesh_is_the_whole_batch_step(cases, ranks):
    variables, batches = cases["vit"]
    one_metrics, one_states = _port_one_process(variables, batches)
    jax_metrics, jax_trees = _jax_sharded_vit_steps(variables, batches)
    r0, r1 = ranks[0][2], ranks[1][2]
    pm = CausalViTVAE(**W.SMALL, device="cpu")
    buffers = {k for k, _ in pm.named_buffers()}
    assert buffers
    for s in range(len(batches)):
        _rel_close(r0["metrics"][s], one_metrics[s], 1e-5)
        _rel_close(r0["metrics"][s], jax_metrics[s], 1e-4)
        assert r1["metrics"][s] == r0["metrics"][s]
        jax_state = from_jax_variables(pm, jax_trees[s])
        bound = 2 * W.LR * (s + 1)
        for k, v in one_states[s].items():
            got = r0["states"][s][k]
            assert np.array_equal(got, r1["states"][s][k]), k
            for want in (v, jax_state[k].numpy()):
                if k in buffers and s == 0:
                    close(got, want, rel=1e-5, abs_=1e-7)
                else:
                    assert np.max(np.abs(got - want)) <= bound, (k, s)


def test_dropout_masks_are_the_whole_batch_s(cases, ranks):
    """JAX's evidence first: its encoder at dropout 0.1 over the mesh is
    its one-device encoder on the whole batch, not each half's; then the
    port's mesh step against its one-process step with the same seeds, and
    the per-rank control."""
    variables, batches = cases["vit"]
    b = batches[0]
    jd = JaxCausalViTVAE(**W.SMALL, packed=False, dropout=0.1)
    enc = jax.jit(lambda v, x, m, t, r: jd.apply(
        v, x, m, t, train=True, rngs={"dropout": r}, method=jd.encode,
        mutable=["batch_stats"])[0][0])
    key = jax.random.PRNGKey(DROPOUT_SEED)
    whole = np.asarray(enc(variables, b["x"], b["m"], b["t"], key))
    mesh = JM.make_mesh(2)
    sharded = np.asarray(enc(JM.replicate(variables, mesh),
                             *(JM.shard_batch(b[k], mesh) for k in ("x", "m", "t")), key))
    np.testing.assert_allclose(sharded, whole, rtol=1e-5, atol=1e-5 * np.abs(whole).max())
    half = np.asarray(enc(variables, b["x"][:2], b["m"][:2], b["t"][:2], key))
    assert np.abs(half - whole[:2]).max() > 1e-2 * np.abs(whole).max()

    one_metrics, _ = _port_one_process(variables, batches[:1], dropout=0.1, seed=DROPOUT_SEED)
    dropped, per_rank = ranks[0][3], ranks[0][4]
    _rel_close(dropped["metrics"][0], one_metrics[0], 1e-5)
    assert ranks[1][3]["metrics"] == dropped["metrics"]
    miss = max(abs(per_rank["metrics"][0][k] - v) / abs(v) for k, v in one_metrics[0].items())
    assert miss > 1e-3, miss


def test_masked_loss_over_the_mesh_takes_the_whole_batch_pos_weight(cases, ranks):
    """A batch whose sample mask zeroes a row of rank 1 only: the mesh step
    is the one-process step on the whole batch, and the per-rank
    pos_weight control misses it."""
    variables, batches = cases["masked"]
    one_metrics, _ = _port_one_process(variables, batches)
    got, per_rank = ranks[0][6], ranks[0][7]
    _rel_close(got["metrics"][0], one_metrics[0], 1e-5)
    assert ranks[1][6]["metrics"] == got["metrics"]
    miss = max(abs(per_rank["metrics"][0][k] - v) / abs(v) for k, v in one_metrics[0].items())
    assert miss > 1e-3, miss


def test_c10_step_over_the_mesh_is_the_whole_batch_step(cases, ranks):
    """C10's mesh step (the mechanism's PlainBatchNorm over the whole batch)
    against the one-process step, at the C9 case's tolerances; the running
    statistics bit-equal on the two ranks after every step; the per-rank
    statistics control misses."""
    variables, batches = cases["c10"]
    pm = CausalBioVAE(**W.C10, device="cpu")
    pm.load_state_dict(from_jax_variables(pm, variables), strict=True)
    step = W.c10_step(pm)
    r0, r1 = ranks[0][8], ranks[1][8]
    buffers = {k for k, _ in pm.named_buffers()}
    assert buffers == {"mechanism.shared_bn.0.mean", "mechanism.shared_bn.0.var"}
    for s, b in enumerate(batches):
        tb = W._tensors(b)
        one = {k: float(v) for k, v in step(tb, eps=tb["eps"]).items()}
        _rel_close(r0["metrics"][s], one, 1e-5)
        assert r1["metrics"][s] == r0["metrics"][s]
        bound = 2 * W.LR * (s + 1)
        for k, v in W._numpy_state(pm).items():
            got = r0["states"][s][k]
            assert np.array_equal(got, r1["states"][s][k]), k
            if k in buffers and s == 0:
                close(got, v, rel=1e-5, abs_=1e-7)
            else:
                assert np.max(np.abs(got - v)) <= bound, (k, s)
        if s == 0:
            per_rank = ranks[0][9]["metrics"][0]
            miss = max(abs(per_rank[k] - v) / abs(v) for k, v in one.items())
            assert miss > 1e-3, miss


def test_replicate_broadcasts_rank_0(ranks):
    r0, r1 = ranks[0][5], ranks[1][5]
    assert r0["before"] != r1["before"]
    assert r0["after"] == r1["after"] == r0["before"]


def test_mesh_helpers_match_jax():
    rng = np.random.default_rng(1)
    batch = {"x": rng.standard_normal((6, 3, 2)).astype(np.float32),
             "pair": (rng.integers(0, 9, (6,)).astype(np.int32),
                      rng.standard_normal((6, 4)).astype(np.float32))}
    jmesh = JM.make_mesh(2)
    jsharded = JM.shard_batch(batch, jmesh)
    for rank in range(2):
        mesh = PM.Mesh(rank, 2, torch.device("cpu"))
        got = PM.shard_batch(batch, mesh)
        want = jax.tree_util.tree_map(
            lambda a: np.asarray(sorted(a.addressable_shards,
                                        key=lambda s: s.device.id)[rank].data), jsharded)
        np.testing.assert_array_equal(got["x"].numpy(), want["x"])
        for g, w in zip(got["pair"], want["pair"]):
            np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="pad_to_multiple"):
        PM.shard_batch({"x": np.zeros((5, 2))}, PM.Mesh(0, 2, torch.device("cpu")))

    odd = {"x": rng.standard_normal((5, 3)).astype(np.float32), "y": np.arange(5)}
    want = JM.pad_to_multiple(odd, 4)
    got = PM.pad_to_multiple(odd, 4)
    got_t = PM.pad_to_multiple({k: torch.as_tensor(v) for k, v in odd.items()}, 4)
    for k in odd:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got_t[k].numpy(), want[k])

    members = [init_jax(JaxDisc(t_dim=10), jnp.zeros((2, 10)), seed=s, jit=True)
               for s in range(3)]
    stacked = JM.stack_params(members)
    port = LatentDiscriminator(t_dim=10, device="cpu")
    got = PM.stack_params([from_jax_variables(port, m) for m in members])
    for i in range(3):
        member = from_jax_variables(
            port, jax.tree_util.tree_map(lambda a: np.asarray(a[i]), stacked))
        for k, v in member.items():
            np.testing.assert_array_equal(got[k][i].numpy(), v.numpy())
    assert PM.batch_sharding(PM.Mesh(0, 2, torch.device("cpu"))).kind == "batch"
    assert PM.replicated(PM.Mesh(0, 2, torch.device("cpu"))).kind == "replicated"


def test_make_mesh_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="NCCL reduces CUDA tensors"):
        PM.make_mesh(backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="needs RANK, WORLD_SIZE"):
        PM.make_mesh(2, device="cpu")
    pm = CausalViTVAE(**W.SMALL, device="cpu")
    pm.morph.extra = torch.nn.BatchNorm1d(4)
    with pytest.raises(ValueError, match="per-rank batch statistics"):
        make_vae_step(pm, vessel_loss_fn(VesselConfig()),
                      ClippedAdam(pm.parameters(), W.LR, 5.0, torch.bfloat16),
                      mesh=PM.Mesh(0, 2, torch.device("cpu")))

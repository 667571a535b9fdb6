"""Ranks of the port's data-parallel tests (tests/test_torch_parallel.py),
spawned as processes of a gloo group on the CPU. Imports torch and the port
only, so a rank starts quickly; the JAX sides run in the test's process.

``spawn(jobs, world)`` starts ``world`` ranks, each running every job of
``jobs`` (a list of (name, kwargs)) in order, and returns each rank's list of
results; a rank that does not report within ``timeout`` seconds fails the
test (a hung collective must not run into the suite's clock).
"""

from __future__ import annotations

import contextlib
import os
import queue as queue_mod
import traceback

import numpy as np
import torch

SMALL = dict(img_size=(64, 96), z_dim=8, embed_dim=32, depth=2, heads=4,
             mlp_dim=64, vit_latent_dim=32)
LR = 1e-4


def _numpy_state(module):
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def shard_step_job(mesh, variables, batches, reduction):
    """LatentDiscriminator steps through ``make_shard_map_step``: a
    cross-entropy averaged ("mean") or summed ("sum") over the shard."""
    from causalvae_tpu_torch.models.heads import LatentDiscriminator
    from causalvae_tpu_torch.parallel.mesh import replicate, shard_batch
    from causalvae_tpu_torch.parallel.shard_step import make_shard_map_step
    from causalvae_tpu_torch.train.port_maps import from_jax_variables
    from causalvae_tpu_torch.train.state import ClippedAdam

    model = LatentDiscriminator(t_dim=10, device="cpu")
    model.load_state_dict(from_jax_variables(model, variables), strict=True)
    replicate(model, mesh)
    opt = ClippedAdam(model.parameters(), 1e-3, None, torch.float32)

    def loss_fn(mdl, b, generator):
        ce = -(b["y"] * torch.log_softmax(mdl(b["z"]), dim=-1)).sum(dim=-1)
        return ce.mean() if reduction == "mean" else ce.sum()

    step = make_shard_map_step(loss_fn, mesh, loss_reduction=reduction)
    losses = [float(step(model, opt, shard_batch(_tensors(b), mesh))) for b in batches]
    return {"losses": losses, "state": _numpy_state(model)}


@contextlib.contextmanager
def _per_rank_draws():
    """The control: each rank's draws as a one-process step on its own rows
    would make them (offset 0, its own rows' shapes); the BatchNorm sums
    still reduced."""
    import causalvae_tpu_torch.parallel.mesh as M

    orig = M.global_batch

    @contextlib.contextmanager
    def local(mesh, rows):
        with orig(mesh, rows):
            M._CURRENT = M.GlobalBatch(mesh, 0, rows, rows)
            yield M._CURRENT

    M.global_batch = local
    try:
        yield
    finally:
        M.global_batch = orig


@contextlib.contextmanager
def _per_rank_counts():
    """The control of the masked vessel loss: each rank's pos_weight from
    its own rows' foreground count and valid size."""
    import causalvae_tpu_torch.ops.losses as L

    orig = L.batch_counts
    L.batch_counts = lambda n_pos, size: (n_pos, size)
    try:
        yield
    finally:
        L.batch_counts = orig


def vae_step_job(mesh, batches, variables=None, state=None, dropout=0.0, seed=None,
                 draws="global", counts="global"):
    """``make_vae_step(mesh=...)`` steps of the small CausalViTVAE (JAX
    ``variables`` carried across, or a port ``state`` dict of arrays) on
    this rank's shard of each whole batch; with ``seed``, the noise and
    every dropout mask drawn (CPU generator seeded ``seed`` for the noise
    and the attention seeds, torch's seeded ``seed`` for ``nn.Dropout``),
    else the batch's ``eps``. ``draws="per_rank"`` is the control of the
    draws, ``counts="per_rank"`` that of a masked batch's pos_weight."""
    from causalvae_tpu_torch.config import VesselConfig
    from causalvae_tpu_torch.models.vit import CausalViTVAE
    from causalvae_tpu_torch.parallel.mesh import replicate, shard_batch
    from causalvae_tpu_torch.train.loop import make_vae_step, vessel_loss_fn
    from causalvae_tpu_torch.train.port_maps import from_jax_variables
    from causalvae_tpu_torch.train.state import ClippedAdam

    model = CausalViTVAE(**SMALL, dropout=dropout, device="cpu")
    model.load_state_dict(from_jax_variables(model, variables) if state is None else
                          {k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    replicate(model, mesh)
    opt = ClippedAdam(model.parameters(), LR, 5.0, torch.bfloat16)
    gen = None
    if seed is not None:
        torch.manual_seed(seed)
        gen = torch.Generator().manual_seed(seed)
    metrics, states = [], []
    with (_per_rank_draws() if draws == "per_rank" else contextlib.nullcontext()), \
            (_per_rank_counts() if counts == "per_rank" else contextlib.nullcontext()):
        step = make_vae_step(model, vessel_loss_fn(VesselConfig()), opt, mesh=mesh)
        for b in batches:
            local = shard_batch(_tensors(b), mesh)
            eps = None if seed is not None else local["eps"]
            met = step(local, generator=gen, eps=eps)
            metrics.append({k: float(v) for k, v in met.items()})
            states.append(_numpy_state(model))
    return {"metrics": metrics, "states": states, "state": states[-1]}


C10 = dict(t_dim=6, z_dim=16)  # the small CausalBioVAE, 64x128 images


def c10_step(model, mesh=None):
    """``make_vae_step`` of C10 under ``cascade_loss`` with plain Adam (LR),
    as ``train_cascade`` builds it; over ``mesh`` where given."""
    from causalvae_tpu_torch.ops import losses as L
    from causalvae_tpu_torch.train.loop import make_vae_step
    from causalvae_tpu_torch.train.state import ClippedAdam

    return make_vae_step(model, lambda out, b: L.cascade_loss(out, b["x"], b["m"]),
                         ClippedAdam(model.parameters(), LR, None, torch.float32), mesh=mesh)


def c10_step_job(mesh, variables, batches, stats="global"):
    """``make_vae_step(mesh=...)`` steps of the small C10 (JAX ``variables``
    carried across; the mechanism's ``PlainBatchNorm`` in train mode) on
    this rank's shard of each whole batch, with the batch's ``eps``.
    ``stats="per_rank"`` is the control: the BatchNorm's statistics of this
    rank's rows alone."""
    import causalvae_tpu_torch.models.mechanism as mech
    from causalvae_tpu_torch.models.vae import CausalBioVAE
    from causalvae_tpu_torch.parallel.mesh import replicate, shard_batch
    from causalvae_tpu_torch.train.port_maps import from_jax_variables

    model = CausalBioVAE(**C10, device="cpu")
    model.load_state_dict(from_jax_variables(model, variables), strict=True)
    replicate(model, mesh)
    step = c10_step(model, mesh)
    metrics, states = [], []
    orig = mech.current_global_batch
    if stats == "per_rank":
        mech.current_global_batch = lambda: None
    try:
        for b in batches:
            local = shard_batch(_tensors(b), mesh)
            met = step(local, eps=local["eps"])
            metrics.append({k: float(v) for k, v in met.items()})
            states.append(_numpy_state(model))
    finally:
        mech.current_global_batch = orig
    return {"metrics": metrics, "states": states}


def replicate_job(mesh):
    """A model initialised from a seed of each rank's own, before and after
    ``replicate`` (its parameters' bytes)."""
    from causalvae_tpu_torch.models.heads import LatentDiscriminator
    from causalvae_tpu_torch.parallel.mesh import replicate

    torch.manual_seed(100 + mesh.rank)
    model = LatentDiscriminator(t_dim=10, device="cpu")

    def fingerprint():
        return np.concatenate([p.detach().numpy().ravel()
                               for p in model.parameters()]).tobytes()

    before = fingerprint()
    replicate(model, mesh)
    return {"before": before, "after": fingerprint()}


JOBS = {"shard_step": shard_step_job, "vae_step": vae_step_job,
        "replicate": replicate_job, "c10_step": c10_step_job}


def _rank_main(rank, world, port, jobs, results, device):
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        torch.set_num_threads(1)
        torch.backends.cudnn.allow_tf32 = False  # float32 convolutions, as the tests'
        torch.backends.cuda.matmul.allow_tf32 = False
        from causalvae_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(world, backend="gloo", device=device)
        out = [JOBS[name](mesh, **kwargs) for name, kwargs in jobs]
        torch.distributed.destroy_process_group()
        results.put((rank, out))
    except BaseException:  # report any failure to the test, then end
        results.put((rank, traceback.format_exc()))


def spawn(jobs, world: int = 2, timeout: float = 120.0, device: str = "cpu"):
    """Run ``jobs`` on ``world`` gloo ranks, each on ``device`` (ranks that
    share a card take gloo too); -> [rank 0's results, ...]."""
    import torch.multiprocessing as mp

    from causalvae_tpu_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, jobs, results, device),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            rank, out = results.get(timeout=timeout)
            if isinstance(out, str):
                raise AssertionError(f"rank {rank} failed:\n{out}")
            got[rank] = out
    except queue_mod.Empty:
        raise AssertionError(f"ranks {sorted(set(range(world)) - set(got))} did not "
                             f"report within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]

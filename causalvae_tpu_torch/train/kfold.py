"""K-fold training (``causalvae_tpu/train/kfold.py``): K folds in lockstep
on one card.

The fold loop. JAX advances every fold in one ``jax.vmap``-ped step over
parameters stacked along a fold axis. The port cannot batch its steps so:
``torch.func.vmap`` does not batch the ctypes kernel launches inside the
kernels' ``autograd.Function``s. So the K folds train in lockstep, one
fold after another within each step, and each fold keeps its own

  * ``nn.Module``, initialised from its own seed (``init_one(f)``; JAX's
    ``init_stacked_states`` becomes K independently built models);
  * ``ClippedAdam`` (``make_optimizer(model)``), so the clip reads that
    fold's own global norm, as under ``vmap``;
  * BatchNorm running statistics (in its module);
  * randomness: a CPU ``torch.Generator`` seeded ``seed + 1000 * f`` (the
    reparameterisation noise and the attention-dropout seeds) and its own
    state of torch's generator of the device (``nn.Dropout``), swapped in
    around each of its steps, so no fold's draws depend on another's.

The corpus lives on the device; each step sends the K folds' batch indices
there once, as one (K, B) index tensor, and gathers the K batches from it.
Validation is one batch per fold, padded to the longest val fold by
repeating its last index, with the sample mask ``w`` (1 real, 0 padding)
that the eval loss honours (``train/loop.py vessel_loss_fn``); reported val
metrics are per-sample means over the valid samples.

What has no counterpart on one card: ``make_fold_mesh``,
``shard_fold_tree``, ``make_parallel_fold_step`` and the sharding of
``gather_fold_batches``. The folds stay in lockstep on one card; the port's
data parallelism over ranks is ``parallel/`` with ``train/loop.py
make_vae_step(mesh=...)``, one model's step over the whole batch. A form
that batches the folds (vmap rules for every kernel's Function, or the
folds folded into the kernels' batch dimension) is not written either.

``stratified_kfold`` is sklearn's ``StratifiedKFold(shuffle=True,
random_state=seed)`` rewritten in numpy (the card has no sklearn), fold for
fold. ``train_kfold`` takes a ``noise`` iterator, as ``_generic_train``
does, so tests hand it the JAX side's draws: one (K, B, z) tensor per train
step and one (K, val_len, z) per val pass, in the loop's order.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from causalvae_tpu_torch.device import module_device
from causalvae_tpu_torch.train.loop import make_vae_eval_step, make_vae_step


@dataclasses.dataclass
class KFoldPlan:
    """Per-fold train/val index arrays over one dataset."""

    train_idx: List[np.ndarray]
    val_idx: List[np.ndarray]
    labels: np.ndarray

    @property
    def n_folds(self) -> int:
        return len(self.train_idx)


def _test_folds(labels: np.ndarray, n_splits: int, seed: Optional[int]) -> np.ndarray:
    """Fold of each sample, as sklearn 1.9's ``StratifiedKFold(shuffle=True,
    random_state=seed)._make_test_folds``; ``seed`` None: ``shuffle=False``."""
    rng = None if seed is None else np.random.RandomState(seed)
    _, y_idx, y_inv = np.unique(labels, return_index=True, return_inverse=True)
    # classes encoded in order of first appearance
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    counts = np.bincount(y)
    if np.all(n_splits > counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number "
                         "of members in each class.")
    if n_splits > counts.min():
        warnings.warn(f"The least populated class in y has only {counts.min()} "
                      f"members, which is less than n_splits={n_splits}.", UserWarning)
    # per class and fold, the round robin over the sorted labels
    y_order = np.sort(y)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        for_class = np.arange(n_splits).repeat(allocation[:, k])
        if rng is not None:
            rng.shuffle(for_class)
        folds[y == k] = for_class
    return folds


def stratified_kfold(labels: np.ndarray, n_splits: int = 5, seed: int = 42) -> KFoldPlan:
    """sklearn ``StratifiedKFold(n_splits, shuffle=True, random_state=seed)``'s
    folds in numpy: int32 train and val indices, ascending."""
    return _plan(labels, n_splits, seed)


def stratified_kfold_unshuffled(labels: np.ndarray, n_splits: int = 3) -> KFoldPlan:
    """sklearn ``StratifiedKFold(n_splits)``'s folds (no shuffle; the folds
    of ``cross_val_score(classifier, ..., cv=n_splits)``) in numpy."""
    return _plan(labels, n_splits, None)


def _plan(labels: np.ndarray, n_splits: int, seed: Optional[int]) -> KFoldPlan:
    labels = np.asarray(labels)
    if labels.ndim != 1:
        raise ValueError(f"labels must be 1-D, got shape {labels.shape}")
    if n_splits < 2:
        raise ValueError(f"k-fold cross-validation requires at least one "
                         f"train/test split by setting n_splits=2 or more, got "
                         f"n_splits={n_splits}.")
    if n_splits > len(labels):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater "
                         f"than the number of samples: n_samples={len(labels)}.")
    folds = _test_folds(labels, n_splits, seed)
    every = np.arange(len(labels), dtype=np.int32)
    return KFoldPlan([every[folds != f] for f in range(n_splits)],
                     [every[folds == f] for f in range(n_splits)], labels)


def verify_stratification(plan: KFoldPlan, group_names: Optional[Sequence] = None) -> Dict:
    """Per-fold class coverage report (the CLI's ``kfold --verify``)."""
    n_classes = int(plan.labels.max()) + 1
    report = {}
    for f in range(plan.n_folds):
        tr = np.bincount(plan.labels[plan.train_idx[f]], minlength=n_classes)
        va = np.bincount(plan.labels[plan.val_idx[f]], minlength=n_classes)
        report[f"fold_{f}"] = {
            "train_per_class": tr.tolist(),
            "val_per_class": va.tolist(),
            "val_missing_classes": [
                (group_names[c] if group_names else c)
                for c in range(n_classes) if va[c] == 0
            ],
        }
    return report


@dataclasses.dataclass
class FoldBatcher:
    """Host-side per-fold batch index sampler; the data stays on the device.

    Each fold's pool is shuffled without replacement and reshuffled when it
    runs out, by ``numpy.random.default_rng(seed + 1000 * f)``."""

    plan: KFoldPlan
    batch_size: int
    seed: int = 0

    def __post_init__(self):
        self._rngs = [np.random.default_rng(self.seed + 1000 * f)
                      for f in range(self.plan.n_folds)]
        self._pools = [idx.copy() for idx in self.plan.train_idx]
        self._cursor = [len(p) for p in self._pools]  # force initial shuffle

    def steps_per_epoch(self) -> int:
        return max(len(p) // self.batch_size for p in self._pools)

    def next_indices(self) -> np.ndarray:
        """(n_folds, batch_size) int32 gather indices into the full dataset."""
        out = np.empty((self.plan.n_folds, self.batch_size), np.int32)
        for f, pool in enumerate(self._pools):
            if self._cursor[f] + self.batch_size > len(pool):
                self._rngs[f].shuffle(pool)
                self._cursor[f] = 0
            out[f] = pool[self._cursor[f]: self._cursor[f] + self.batch_size]
            self._cursor[f] += self.batch_size
        return out


class _DeviceRng:
    """One state of torch's generator of ``device`` per fold, swapped in
    around that fold's work; the caller's state is put back at the end."""

    def __init__(self, device: torch.device, seeds: Sequence[int]):
        self.cuda = device.type == "cuda"
        self.device = device
        self.caller = self._get()
        self.states = []
        for s in seeds:
            if self.cuda:
                torch.cuda.manual_seed(s)
            else:
                torch.manual_seed(s)
            self.states.append(self._get())
        self._set(self.caller)

    def _get(self) -> torch.Tensor:
        return torch.cuda.get_rng_state(self.device) if self.cuda else torch.get_rng_state()

    def _set(self, state: torch.Tensor):
        if self.cuda:
            torch.cuda.set_rng_state(state, self.device)
        else:
            torch.set_rng_state(state)

    def run(self, f: int, fn: Callable, *args, **kwargs):
        self._set(self.states[f])
        try:
            return fn(*args, **kwargs)
        finally:
            self.states[f] = self._get()

    def close(self):
        self._set(self.caller)


def _gather(data: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """data[k] (N, ...) -> (K, B, ...) on the data's device."""
    return {k: v[idx] for k, v in data.items()}


def train_kfold(
    *,
    init_one: Callable[[int], nn.Module],
    make_optimizer: Callable[[nn.Module], torch.optim.Optimizer],
    loss_fn: Callable,
    data: Dict[str, object],
    labels: np.ndarray,
    epochs: int,
    batch_size: int,
    n_folds: int = 5,
    seed: int = 42,
    checkpoint_dir: Optional[str] = None,
    checkpoint_period: int = 50,
    log_every: int = 0,
    noise: Optional[Iterator[torch.Tensor]] = None,
) -> Tuple[nn.ModuleList, KFoldPlan, List[Dict]]:
    """Full k-fold training: returns (the K fold models, plan, history).

    init_one(f): fold f's freshly initialised model (all on one device).
    make_optimizer(model): that fold's optimizer (JAX's ``tx``).
    loss_fn(out, batch) -> (total, metrics): the train step's loss and the
      eval loss, which must honour the sample mask ``batch['w']``.
    data: full-dataset arrays or tensors keyed like batches ('x', 'm', 't'),
      moved to the models' device once.
    history: per epoch ``{"epoch", "train", "val"}``, each metric a (K,)
      numpy array: train the mean over the epoch's steps, val the per-sample
      mean over each fold's valid samples.
    checkpoint_dir: one ``CheckpointBook(f"{dir}/fold_{f}", period)`` per
      fold, written every epoch with that fold's val loss; no resume."""
    from causalvae_tpu_torch.train.checkpoints import CheckpointBook

    plan = stratified_kfold(labels, n_folds, seed)
    models = nn.ModuleList(init_one(f) for f in range(n_folds))
    dev = module_device(models)
    if any(module_device(m) != dev for m in models):
        raise ValueError("the fold models must share one device")
    optimizers = [make_optimizer(m) for m in models]
    steps_fn = [make_vae_step(m, loss_fn, o) for m, o in zip(models, optimizers)]
    evals_fn = [make_vae_eval_step(m, loss_fn) for m in models]
    device_data = {k: torch.as_tensor(v).to(dev) for k, v in data.items()}
    batcher = FoldBatcher(plan, batch_size, seed)
    gens = [torch.Generator().manual_seed(seed + 1000 * f) for f in range(n_folds)]
    rng = _DeviceRng(dev, [seed + 1000 * f for f in range(n_folds)])

    books = None
    if checkpoint_dir:
        books = [CheckpointBook(f"{checkpoint_dir}/fold_{f}", period=checkpoint_period)
                 for f in range(n_folds)]

    # one val batch per fold: ragged folds padded to the longest val set,
    # with a validity mask so every real sample counts exactly once
    val_len = max(len(v) for v in plan.val_idx)
    val_idx = torch.from_numpy(np.stack([
        np.pad(v, (0, val_len - len(v)), mode="edge") for v in plan.val_idx])).to(dev)
    val_w = torch.from_numpy(np.stack([
        (np.arange(val_len) < len(v)).astype(np.float32) for v in plan.val_idx])).to(dev)
    val_counts = np.asarray([len(v) for v in plan.val_idx], np.float32)

    def eps():
        return [None] * n_folds if noise is None else next(noise)

    history: List[Dict] = []
    steps = batcher.steps_per_epoch()
    try:
        for epoch in range(epochs):
            agg = None
            for _ in range(steps):
                idx = torch.from_numpy(batcher.next_indices()).to(dev)
                batch, e = _gather(device_data, idx), eps()
                per_fold = [
                    rng.run(f, steps_fn[f], {k: v[f] for k, v in batch.items()},
                            generator=gens[f], eps=e[f])
                    for f in range(n_folds)]
                metrics = {k: torch.stack([m[k] for m in per_fold]) for k in per_fold[0]}
                agg = metrics if agg is None else {k: agg[k] + metrics[k] for k in agg}
            train_metrics = {k: v.float().cpu().numpy() / steps for k, v in agg.items()}

            vbatch, e = _gather(device_data, val_idx), eps()
            vbatch["w"] = val_w
            per_fold = [
                rng.run(f, evals_fn[f], {k: v[f] for k, v in vbatch.items()},
                        generator=gens[f], eps=e[f])
                for f in range(n_folds)]
            # per-sample means over the valid samples
            val_metrics = {k: torch.stack([m[k] for m in per_fold]).float().cpu().numpy()
                           / val_counts for k in per_fold[0]}
            history.append({"epoch": epoch, "train": train_metrics, "val": val_metrics})
            if log_every and (epoch + 1) % log_every == 0:
                print(f"[kfold] epoch {epoch + 1}/{epochs} loss per fold: "
                      f"{val_metrics['loss']}", flush=True)
            if books:
                for f in range(n_folds):
                    books[f].end_of_epoch(models[f], optimizers[f], epoch,
                                          float(val_metrics["loss"][f]))
    finally:
        rng.close()
    return models, plan, history

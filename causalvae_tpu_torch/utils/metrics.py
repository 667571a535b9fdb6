"""Metrics logging and step timing (``causalvae_tpu/utils/metrics.py``).

``MetricLogger`` keeps per-epoch dicts, appends them to ``metrics.jsonl``
and prints the reference-style ``Epoch N: loss: ...`` line, as the JAX one
does; ``to_host`` reads a step's metrics (0-d tensors on the device) to
the host in one copy, so a trainer that logs once per epoch synchronises
once per epoch. ``StepTimer`` reads the clock only after synchronising the
device, so ``images_per_sec`` is the card's rate, not the rate at which the
host queues work. ``EpochClock`` (no JAX counterpart) splits each epoch's
host-clock wall time into batch building, train steps, validation and
checkpoint writes, and reads each train step's period on the device's clock
from CUDA events. ``write_csv`` and ``write_matrix_csv`` write the
analysis artifacts in the JAX package's file contracts. ``profile_trace``
records a ``torch.profiler`` trace of a block into a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch


def to_host(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Metrics with every tensor read to the host, the 0-d ones in one copy."""
    scalars = [k for k, v in metrics.items()
               if isinstance(v, torch.Tensor) and v.ndim == 0]
    out = dict(metrics)
    if scalars:
        vals = torch.stack([metrics[k].detach().float() for k in scalars]).cpu().numpy()
        out.update(zip(scalars, vals))
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
    return out


class MetricLogger:
    def __init__(self, run_dir: Optional[str] = None, print_every: int = 1):
        self.run_dir = run_dir
        self.print_every = print_every
        self.history: List[Dict[str, float]] = []
        self._jsonl = None
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    @staticmethod
    def _scalarize(metrics: Dict[str, Any]) -> Dict[str, float]:
        out = {}
        for k, v in metrics.items():
            arr = np.asarray(v)
            out[k] = float(arr) if arr.ndim == 0 else arr.tolist()
        return out

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "") -> Dict:
        rec = {"step": step, **{prefix + k: v for k, v in self._scalarize(metrics).items()}}
        self.history.append(rec)
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        return rec

    def print_epoch(self, epoch: int, metrics: Dict[str, Any]):
        """Reference-style per-epoch loss breakdown line."""
        if (epoch + 1) % self.print_every:
            return
        parts = ", ".join(
            f"{k}: {float(np.asarray(v)):.4f}"
            for k, v in metrics.items()
            if np.asarray(v).ndim == 0
        )
        print(f"Epoch {epoch + 1}: {parts}", flush=True)

    def close(self):
        if self._jsonl:
            self._jsonl.close()


def _sync(device: Optional[torch.device]):
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """Images per second after ``warmup`` steps: the clock starts, after a
    synchronise, at the ``warmup``-th tick and counts the images of the
    later ticks; ``images_per_sec`` synchronises before it reads the clock."""

    def __init__(self, warmup: int = 2, device: Optional[torch.device] = None):
        self.warmup = warmup
        self.device = device
        self._count = 0
        self._start: Optional[float] = None
        self.images = 0

    def tick(self, batch_size: int):
        self._count += 1
        if self._count == self.warmup:
            _sync(self.device)
            self._start = time.perf_counter()
            self.images = 0
        elif self._count > self.warmup:
            self.images += batch_size

    @property
    def images_per_sec(self) -> float:
        if self._start is None or self.images == 0:
            return 0.0
        _sync(self.device)
        return self.images / (time.perf_counter() - self._start)


class EpochClock:
    """Where each epoch's wall time goes. ``part(name)`` adds the host-clock
    seconds of its block to ``name``; ``step_done()`` records a CUDA event
    after each train step (nothing on the CPU); ``end(epoch)``, called after
    a synchronising read, appends and returns the epoch's record: ``wall_s``,
    ``steps``, ``<name>_s`` per part, and ``step_ms``, the device-clock
    period of each step (from the epoch's start for the first). A trainer
    that resumes puts its load's seconds in ``restore_s``. A scanned trainer
    (``train/scan_loop.py``) calls ``step_done(steps=S)`` once a group:
    ``steps`` counts optimizer steps, ``step_ms`` then each group's period."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.cuda = device is not None and device.type == "cuda"
        self.records: List[Dict[str, Any]] = []
        self.restore_s: Optional[float] = None  # a resume's checkpoint load

    def since(self, t0: float) -> float:
        """Host-clock seconds from ``t0`` to now, after a synchronise."""
        _sync(self.device)
        return time.perf_counter() - t0

    def _event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self):
        self._t0 = time.perf_counter()
        self._parts: Dict[str, float] = defaultdict(float)
        self._events = [self._event()]
        self._steps = 0

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._parts[name] += time.perf_counter() - t0

    def step_done(self, steps: int = 1):
        self._steps += steps
        if self.cuda:
            self._events.append(self._event())

    def end(self, epoch: int) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"epoch": epoch, "steps": self._steps,
                               "wall_s": time.perf_counter() - self._t0}
        rec.update({f"{k}_s": v for k, v in self._parts.items()})
        if self.cuda and len(self._events) > 1:
            self._events[-1].synchronize()
            rec["step_ms"] = [a.elapsed_time(b) for a, b in
                              zip(self._events[:-1], self._events[1:])]
        self.records.append(rec)
        return rec


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace around a block; no-op when log_dir is None.
    Records CPU activity and, where CUDA is available, the card's; on exit
    writes ``trace_<pid>_<ns>.json`` (a Chrome trace) under ``log_dir``,
    which it creates. Open it in Perfetto or ``chrome://tracing``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def write_csv(path: str, rows: Iterable[Dict[str, Any]], fieldnames=None):
    """Rows of dicts as a CSV with a header (the keys of the first row unless
    ``fieldnames``); nothing is written for no rows."""
    rows = list(rows)
    if not rows:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fieldnames = fieldnames or list(rows[0].keys())
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        for r in rows:
            w.writerow(r)


def write_matrix_csv(path: str, matrix: np.ndarray, row_names, col_names,
                     corner: str = ""):
    """A named matrix as a CSV: a header of ``corner`` and the column names,
    then each row's name and its values in ``%.6g``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([corner] + list(col_names))
        for name, row in zip(row_names, np.asarray(matrix)):
            w.writerow([name] + [f"{v:.6g}" for v in row])

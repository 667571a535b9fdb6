"""Dynamic-batching inference engine (``causalvae_tpu/serve/engine.py``).

Concurrent requests for one endpoint are coalesced into the smallest batch
bucket that fits (padding by repeating the last row), run as ONE call on the
device, and the rows are scattered back to the callers' futures. Requests for
other endpoints that arrive meanwhile are stashed per endpoint and served
right after, so each endpoint's group keeps coalescing toward its bucket.
The buckets keep the JAX engine's shape ladder (there it bounded the number
of compiled programs; PyTorch runs eagerly, so nothing is compiled here).

Usage:

    eng = BatchingEngine(vae_endpoints(model))
    fut = eng.submit("reconstruct", x1, m1, t1)   # numpy (1, ...) rows
    out = fut.result()                            # numpy
    eng.close()

A model that computes in bfloat16 answers in bfloat16 tensors, as the JAX
endpoints answer in bfloat16 arrays; numpy has no bfloat16, so the engine
hands those outputs back as float32 arrays of the same values.

Thread model: any number of producer threads call ``submit``/``infer``;
exactly one worker thread touches the model and the device, inside
``torch.inference_mode()`` (which is thread-local, so it is entered there).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)


def _to_numpy(out):
    """A tree of tensors as numpy arrays; bfloat16 (which numpy lacks) is
    widened to float32, exactly."""
    if isinstance(out, torch.Tensor):
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.detach().cpu().numpy()
    if isinstance(out, (tuple, list)):
        return type(out)(_to_numpy(o) for o in out)
    return np.asarray(out)


def _rows(out, lo: int, hi: int):
    if isinstance(out, (tuple, list)):
        return type(out)(_rows(o, lo, hi) for o in out)
    return out[lo:hi]


def _concat(parts):
    if isinstance(parts[0], (tuple, list)):
        return type(parts[0])(_concat(list(p)) for p in zip(*parts))
    return np.concatenate(parts, axis=0)


class _Request:
    __slots__ = ("name", "args", "n", "future")

    def __init__(self, name: str, args: Tuple[np.ndarray, ...], n: int):
        self.name = name
        self.args = args
        self.n = n
        self.future: Future = Future()


class BatchingEngine:
    """Coalesce concurrent endpoint requests into bucket-padded device calls.

    Parameters
    ----------
    endpoints:   name -> ``BoundEndpoint`` (batch axis 0 on every arg),
                 as ``vae_endpoints`` builds them.
    buckets:     ascending batch-size ladder; requests larger than the top
                 bucket are split into top-bucket chunks.
    max_delay_s: how long the worker waits for more requests to coalesce
                 once it holds at least one (latency/throughput knob).

    Request tensors go to the device of the endpoints' model
    (``BoundEndpoint.device``).
    """

    def __init__(
        self,
        endpoints: Dict[str, Callable],
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_delay_s: float = 0.002,
    ):
        if not endpoints:
            raise ValueError("need at least one endpoint")
        self._endpoints = dict(endpoints)
        self._buckets = tuple(sorted(set(int(b) for b in buckets)))
        if any(b <= 0 for b in self._buckets):
            raise ValueError(f"buckets must be positive, got {buckets}")
        self._max_delay_s = float(max_delay_s)
        devices = {getattr(fn, "device", None) for fn in self._endpoints.values()}
        if len(devices) != 1 or None in devices:
            raise ValueError(f"endpoints must be bound to one model's device, got {devices}")
        self.device = devices.pop()
        self._q: "queue.Queue[_Request | None]" = queue.Queue()
        self._closed = False
        self.stats = {"launches": 0, "rows": 0, "padded_rows": 0}
        self._worker = threading.Thread(
            target=self._run, name="causalvae-serve-worker", daemon=True
        )
        self._worker.start()

    # -- client API ---------------------------------------------------------
    @property
    def endpoint_names(self):
        return sorted(self._endpoints)

    def submit(self, name: str, *args) -> Future:
        """Enqueue one request; every arg is (n, ...) with a common n."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if name not in self._endpoints:
            raise KeyError(f"unknown endpoint {name!r}; have {sorted(self._endpoints)}")
        arrs = tuple(np.asarray(a) for a in args)
        if not arrs:
            raise ValueError("endpoint requests need at least one array argument")
        n = arrs[0].shape[0]
        if any(a.shape[0] != n for a in arrs):
            raise ValueError(
                f"inconsistent batch axis: {[a.shape for a in arrs]}")
        req = _Request(name, arrs, n)
        self._q.put(req)
        return req.future

    def infer(self, name: str, *args):
        """Synchronous convenience wrapper around ``submit``."""
        return self.submit(name, *args).result()

    def close(self):
        """Drain and stop the worker (idempotent)."""
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- worker -------------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _run(self):
        with torch.inference_mode():
            self._loop()

    def _loop(self):
        top = self._buckets[-1]
        pending: "dict[str, list[_Request]]" = {}
        stop = False
        while True:
            if pending:
                name, group = pending.popitem()
                rows = sum(r.n for r in group)
            elif stop:
                return
            else:
                head = self._q.get()
                if head is None:
                    return
                name, group, rows = head.name, [head], head.n
            while rows < top and not stop:
                try:
                    nxt = self._q.get(timeout=self._max_delay_s)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                if nxt.name != name:
                    pending.setdefault(nxt.name, []).append(nxt)
                    continue
                group.append(nxt)
                rows += nxt.n
            self._flush(group)

    def _flush(self, group):
        try:
            self._execute(group)
        except Exception as e:
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)

    def _execute(self, group):
        fn = self._endpoints[group[0].name]
        top = self._buckets[-1]
        # chunk the coalesced rows into top-bucket-sized launches
        pending = list(group)
        while pending:
            chunk, rows = [], 0
            while pending and rows + pending[0].n <= top:
                r = pending.pop(0)
                chunk.append(r)
                rows += r.n
            if not chunk:  # single oversized request: split it
                r = pending.pop(0)
                outs = []
                for s in range(0, r.n, top):
                    part = tuple(a[s : s + top] for a in r.args)
                    outs.append(self._launch(fn, [(part, min(top, r.n - s))])[0])
                r.future.set_result(_concat(outs))
                continue
            results = self._launch(fn, [(r.args, r.n) for r in chunk])
            for r, out in zip(chunk, results):
                r.future.set_result(out)

    def _launch(self, fn, parts):
        """One padded device call; returns per-part numpy output trees."""
        rows = sum(n for _, n in parts)
        bucket = self._bucket_for(rows)
        batched = []
        for i in range(len(parts[0][0])):
            cat = np.concatenate([p[0][i] for p in parts], axis=0)
            if cat.dtype.kind == "f":  # the served models take float32 inputs
                cat = cat.astype(np.float32, copy=False)
            if rows < bucket:  # pad by repeating the last row (finite values)
                pad = np.repeat(cat[-1:], bucket - rows, axis=0)
                cat = np.concatenate([cat, pad], axis=0)
            batched.append(torch.from_numpy(np.ascontiguousarray(cat)).to(self.device))
        out = _to_numpy(fn(*batched))
        self.stats["launches"] += 1
        self.stats["rows"] += rows
        self.stats["padded_rows"] += bucket - rows
        results, offset = [], 0
        for _, n in parts:
            results.append(_rows(out, offset, offset + n))
            offset += n
        return results

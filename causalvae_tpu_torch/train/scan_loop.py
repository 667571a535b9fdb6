"""Scanned training: S optimizer steps per host dispatch
(``causalvae_tpu/train/scan_loop.py``).

JAX puts the loop on the device with ``lax.scan`` over a stacked leading
batch axis, so that one dispatch runs S steps. The port's counterpart on
the card is a CUDA graph: ``ScanTrainer`` captures S steps, unrolled, each
reading its slice of one static (S, ...) stack of batches, into a
``torch.cuda.CUDAGraph``, and replays it once per group of S batches. The
graph's private memory pool lets step i + 1 reuse step i's activations, so
the peak stays near one step's. At most two programs a trainer, as JAX's
"at most two compiles": full groups and one ragged tail (or the tail
dropped, ``drop_ragged_tail``). On the CPU the same object loops the eager
step over the stack (the plain version the CPU tests hold the port to);
there is no fallback from the card to it: a capture or replay that fails on
a CUDA tensor raises.

Works for any step ``step(batch, generator=None, eps=None) -> metrics`` of
``train/loop.py`` (the single-model VAE steps and the two-model adversarial
MNIST step), with ``states`` the (module, ``ClippedAdam``) pairs it
updates in place.

What a graph cannot hold, and what is done about it:

- the host's draws (the reparameterisation noise and the attention seeds,
  ``ops/draws.py``): before each replay the host draws the group's values
  from the caller's CPU generator, in the eager path's per-step order, into
  a pinned staging buffer (two, used in turns), and copies them into the
  static device buffers the graph reads. A scanned epoch thus takes the
  randomness of the eager epoch; ``nn.Dropout`` (and the ViT blocks' keep
  masks, drawn ahead) draws from torch's device generator, which graphs
  replay with the eager offsets. A ``remat_blocks`` model is captured as
  any other: its blocks' draws are made before each checkpointed call and
  the checkpoint stashes no generator state (``models/vit.py``);
- per-step host state: ``ClippedAdam`` keeps its count on the device and
  writes its moments in place (``train/state.py``);
- the launch counters of ``ops/kernels`` are Python ints that a replay does
  not bump: the trainer reads each counter's delta during the capture,
  puts the counters back, and adds the delta at every replay;
- warm-up: before its first capture a trainer runs one eager step on the
  first batch, with its draws recorded (their kinds, shapes and order) and
  the lazy state made (kernel libraries, the ELBO scratch, the optimizer's
  moments); then it puts back the parameters, buffers, optimizer state and
  generators it snapshotted before, so the warm-up leaves the training
  state as it found it. Its kernel launches count: they ran (``warmup_steps``).

Refused with an error naming the option: ``make_vae_step(mesh=...)`` (its
gloo all-reduce runs on the host).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from causalvae_tpu_torch.ops import draws

State = Tuple[nn.Module, torch.optim.Optimizer]


def make_scan_epoch(step_fn: Callable, n_states: int = 1) -> Callable:
    """Wrap ``step_fn`` into a multi-step program.

    Returns ``epoch(states, stacked_batches, generator=None, eps=None,
    tape=None) -> metrics``: ``step_fn`` on each slice of
    ``stacked_batches`` (a batch dict with an extra leading steps axis) in
    order, with ``eps[i]`` (when given) and ``generator``; every metric is
    stacked over the S steps. ``states`` is the tuple of ``n_states``
    (module, optimizer) pairs the step updates in place. A ``tape``
    (``ScanTrainer``'s) takes the host's draws of step i."""

    def epoch(states: Sequence[State], stacked_batches: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              eps: Optional[torch.Tensor] = None, tape=None) -> Dict[str, torch.Tensor]:
        if len(states) != n_states:
            raise ValueError(f"{len(states)} states for a step of {n_states}")
        steps = next(iter(stacked_batches.values())).shape[0]
        out = []
        for i in range(steps):
            batch = {k: v[i] for k, v in stacked_batches.items()}
            step_tape = None if tape is None else tape.at(i)
            with draws.taped(step_tape):
                out.append(step_fn(batch, generator=generator,
                                   eps=None if eps is None else eps[i]))
            if step_tape is not None:
                step_tape.finish()
        return {k: torch.stack([m[k] for m in out]) for k in out[0]}

    return epoch


def stack_batches(batches: Sequence[Dict]) -> Dict[str, torch.Tensor]:
    """Stack a list of same-shape batch dicts along a new leading steps axis
    (on the batches' device)."""
    keys = batches[0].keys()
    return {k: torch.stack([torch.as_tensor(b[k]) for b in batches]) for k in keys}


def chunked(iterator: Iterator, size: int):
    """Yield lists of up to ``size`` items from ``iterator``."""
    chunk = []
    for item in iterator:
        chunk.append(item)
        if len(chunk) == size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def launch_counters() -> List[Tuple[object, str]]:
    """(module, name) of every launch counter of ``ops/kernels``."""
    from causalvae_tpu_torch.ops.kernels import attention, batchnorm, elbo, stage

    return [(mod, name) for mod in (attention, batchnorm, elbo, stage)
            for name, value in sorted(vars(mod).items())
            if "LAUNCHES" in name and name.isupper() and isinstance(value, int)]


def _read_counters() -> List[int]:
    return [getattr(mod, name) for mod, name in launch_counters()]


def _write_counters(values: Sequence[int]) -> None:
    for (mod, name), v in zip(launch_counters(), values):
        setattr(mod, name, v)


# --------------------------------------------------------------------------
# The host's draws: recorded once, then drawn per group and replayed
# --------------------------------------------------------------------------


class _Draw(NamedTuple):
    """One host draw of a step: its kind ("normal" or "seed"), shape and
    dtype, the CPU generator it is made from (``own``: the trainer's), and
    the device the step reads it on."""
    kind: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    own: bool
    generator: Optional[torch.Generator]
    to: torch.device

    def draw(self, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The eager path's draw, on the host (``generator``: the trainer's)."""
        g = generator if self.own else self.generator
        if self.kind == "normal":
            return torch.randn(self.shape, generator=g, device="cpu", dtype=self.dtype)
        return torch.tensor(draws.draw_seed(g), dtype=torch.int64)


def _host_drawn(generator, on) -> bool:
    """Whether a draw is the host's: made on the CPU. A draw made on the
    card by torch's default generator there is replayed by the graph; one
    from a CUDA generator object is refused."""
    if torch.device(on).type == "cpu":
        return True
    if generator is not None:
        raise ValueError("the scanned trainer takes draws from CPU generators only")
    return False


class _Recorder:
    """The warm-up's tape: draws as the eager path does, notes each draw,
    and keeps each generator's state from before its first draw."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.draws: List[_Draw] = []
        self._saved = {}

    def _note(self, d: _Draw) -> torch.Tensor:
        g = d.generator if d.generator is not None else torch.default_generator
        self._saved.setdefault(id(g), (g, g.get_state()))
        self.draws.append(d)
        return d.draw(self.generator).to(d.to)

    def normal(self, shape, dtype, generator, on, to):
        if not _host_drawn(generator, on):
            return torch.randn(shape, device=on, dtype=dtype).to(to)
        return self._note(_Draw("normal", shape, dtype, generator is self.generator,
                                generator, torch.device(to)))

    def seed(self, generator, device):
        return self._note(_Draw("seed", (), torch.int64, generator is self.generator,
                                generator, torch.device(device)))

    def restore_generators(self) -> None:
        for g, state in self._saved.values():
            g.set_state(state)


class _Player:
    """The tape of a program: step i's draws are views of row i of the
    static buffers, handed out in the recorded order."""

    def __init__(self, recorded: Sequence[_Draw], buffers: Sequence[torch.Tensor]):
        self.recorded, self.buffers = recorded, buffers

    def at(self, i: int) -> "_StepTape":
        return _StepTape(self, i)


class _StepTape:
    def __init__(self, player: _Player, i: int):
        self.player, self.i, self.j = player, i, 0

    def _next(self, kind, shape, dtype) -> torch.Tensor:
        rec = self.player.recorded
        if self.j >= len(rec) or (rec[self.j].kind, rec[self.j].shape,
                                  rec[self.j].dtype) != (kind, tuple(shape), dtype):
            raise RuntimeError(f"step draw {self.j} ({kind} {tuple(shape)} {dtype}) is "
                               "not the one the warm-up step recorded")
        out = self.player.buffers[self.j][self.i]
        self.j += 1
        return out

    def normal(self, shape, dtype, generator, on, to):
        if not _host_drawn(generator, on):
            return torch.randn(shape, device=on, dtype=dtype).to(to)
        return self._next("normal", shape, dtype)

    def seed(self, generator, device):
        return self._next("seed", (), torch.int64)

    def finish(self) -> None:
        if self.j != len(self.player.recorded):
            raise RuntimeError(f"the step made {self.j} host draws; the warm-up step "
                               f"made {len(self.player.recorded)}")


# --------------------------------------------------------------------------
# Training state: snapshot and restore around the warm-up
# --------------------------------------------------------------------------


def _state_tensors(states: Sequence[State]) -> List[torch.Tensor]:
    """Every tensor a step updates in place: parameters, buffers, the
    optimizers' counts and moments."""
    out = []
    for model, opt in states:
        out += list(model.state_dict().values())
        out += [g["count"] for g in opt.param_groups]
        out += [t for st in opt.state.values() for t in st.values()
                if isinstance(t, torch.Tensor)]
    return out


# --------------------------------------------------------------------------
# Programs and the trainer
# --------------------------------------------------------------------------


class _Program:
    """S steps over one static (S, ...) stack: a captured CUDA graph on the
    card, the eager loop on the CPU."""

    def __init__(self, trainer: "ScanTrainer", states: Sequence[State], group: List[Dict],
                 generator: torch.Generator, eps: Optional[List[torch.Tensor]]):
        self.size = len(group)
        self.stacked = stack_batches(group)
        self.device = next(iter(self.stacked.values())).device
        self.cuda = self.device.type == "cuda"
        self.eps = None if eps is None else stack_batches([{"e": e} for e in eps])["e"].to(
            self.device)
        self.generator = generator
        self.recorded = trainer.recorded
        self.buffers = [torch.empty((self.size,) + d.shape, dtype=d.dtype, device=d.to)
                        for d in self.recorded]
        self.replays, self.capture_s, self.delta = 0, None, None
        self.graph = None
        if self.cuda:
            self.staging = [[torch.empty((self.size,) + d.shape, dtype=d.dtype,
                                         pin_memory=True) for d in self.recorded]
                            for _ in range(2)]
            self._events = [None, None]
            self._turn = 0
            self._capture(trainer, states)

    def _capture(self, trainer: "ScanTrainer", states: Sequence[State]) -> None:
        before = _read_counters()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                self.out = trainer._epoch(states, self.stacked, self.generator, self.eps,
                                          tape=_Player(self.recorded, self.buffers))
        except Exception as e:
            _write_counters(before)
            raise RuntimeError(f"ScanTrainer: capturing {self.size} steps into a CUDA "
                               f"graph failed: {e}") from e
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        after = _read_counters()
        self.delta = [a - b for a, b in zip(after, before)]
        _write_counters(before)  # nothing ran yet
        self.graph = graph

    def _load(self, group: List[Dict], eps: Optional[List[torch.Tensor]]) -> None:
        if len(group) != self.size or group[0].keys() != self.stacked.keys():
            raise ValueError(f"a group of {len(group)} batches with keys {list(group[0])} "
                             f"for a program of {self.size} with {list(self.stacked)}")
        for k, buf in self.stacked.items():
            rows = [torch.as_tensor(b[k]).to(buf.device) for b in group]
            if any(r.shape != buf.shape[1:] or r.dtype != buf.dtype for r in rows):
                raise ValueError(f"batch {k!r} of shape {[tuple(r.shape) for r in rows]} "
                                 f"for a stack of {tuple(buf.shape)} {buf.dtype}")
            torch.stack(rows, out=buf)
        if (eps is None) != (self.eps is None):
            raise ValueError("noise given to some groups only")
        if eps is not None:
            self.eps.copy_(stack_batches([{"e": e} for e in eps])["e"])

    def _draw(self, generator: torch.Generator) -> None:
        """The group's host draws, step by step in the eager order."""
        if not self.cuda:
            for i in range(self.size):
                for d, buf in zip(self.recorded, self.buffers):
                    buf[i].copy_(d.draw(generator))
            return
        turn = self._turn
        self._turn ^= 1
        if self._events[turn] is not None:  # its last copy to the card is done
            self._events[turn].synchronize()
        staging = self.staging[turn]
        for i in range(self.size):
            for d, st in zip(self.recorded, staging):
                st[i].copy_(d.draw(generator))
        for st, buf in zip(staging, self.buffers):
            buf.copy_(st, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._events[turn] = ev

    def run(self, trainer: "ScanTrainer", states: Sequence[State], group: List[Dict],
            generator: torch.Generator, eps) -> Dict[str, torch.Tensor]:
        self._load(group, eps)
        self._draw(generator)
        self.replays += 1
        if not self.cuda:
            return trainer._epoch(states, self.stacked, generator, self.eps,
                                  tape=_Player(self.recorded, self.buffers))
        try:
            self.graph.replay()
        except Exception as e:
            raise RuntimeError(f"ScanTrainer: replaying the graph of {self.size} steps "
                               f"failed: {e}") from e
        _write_counters([v + d for v, d in zip(_read_counters(), self.delta)])
        return self.out


class ScanTrainer:
    """Drives a scanned step over a host batch iterator.

    Batches are grouped into fixed-size stacks, one program per stack size
    (at most two a run: full stacks and one ragged tail), each run as one
    CUDA-graph replay on the card. ``programs`` maps a group size to its
    program (``capture_s``, ``replays``); ``warmup_steps`` counts the eager
    warm-up steps (one a trainer)."""

    def __init__(self, step_fn: Callable, n_states: int = 1, steps_per_dispatch: int = 32):
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch {steps_per_dispatch} < 1")
        if getattr(step_fn, "mesh", None) is not None:
            raise ValueError("ScanTrainer: a make_vae_step(mesh=...) step cannot be "
                             "captured (its gradient all-reduce runs through the host)")
        self.n_states = n_states
        self.steps = steps_per_dispatch
        self._step = step_fn
        self._epoch = make_scan_epoch(step_fn, n_states)
        self.programs: Dict[int, _Program] = {}
        self.recorded: Optional[List[_Draw]] = None
        self.warmup_steps = 0

    def _check(self, states: Sequence[State], generator) -> None:
        if len(states) != self.n_states:
            raise ValueError(f"{len(states)} states for a trainer of {self.n_states}")
        for model, opt in states:
            if not hasattr(opt, "init_state"):
                raise TypeError(f"ScanTrainer needs ClippedAdam optimizers, got "
                                f"{type(opt).__name__}")
        if not isinstance(generator, torch.Generator) or generator.device.type != "cpu":
            raise ValueError("ScanTrainer draws the host's noise and seeds from a CPU "
                             f"torch.Generator, got {generator!r}")

    def _warm_up(self, states: Sequence[State], batch: Dict, generator: torch.Generator,
                 eps: Optional[torch.Tensor]) -> None:
        """One eager step with its draws recorded; the training state and
        the generators put back as they were."""
        for _, opt in states:
            opt.init_state()
        live = _state_tensors(states)
        with torch.no_grad():
            saved = [t.clone() for t in live]
        dev = next(v for v in batch.values() if isinstance(v, torch.Tensor)).device
        cpu_rng = torch.get_rng_state()
        cuda = dev.type == "cuda"
        cuda_rng = torch.cuda.get_rng_state(dev) if cuda else None
        rec = _Recorder(generator)
        side = torch.cuda.Stream(dev) if cuda else None
        if cuda:
            side.wait_stream(torch.cuda.current_stream(dev))
        with (torch.cuda.stream(side) if cuda else contextlib.nullcontext()), draws.taped(rec):
            self._step(batch, generator=generator, eps=eps)
        if cuda:
            torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(live, saved):
                t.copy_(s)
        rec.restore_generators()
        torch.set_rng_state(cpu_rng)
        if cuda:
            torch.cuda.set_rng_state(cuda_rng, dev)
        self.recorded = rec.draws
        self.warmup_steps += 1

    def run_group(self, states: Sequence[State], group: List[Dict],
                  generator: torch.Generator,
                  eps: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One group of batches as one dispatch (one replay on the card) ->
        its metrics stacked over the group's steps (on the card, the
        program's output buffers: read them before the next group)."""
        self._check(states, generator)
        program = self.programs.get(len(group))
        if program is None:
            if self.recorded is None:
                self._warm_up(states, group[0], generator, None if eps is None else eps[0])
            program = self.programs[len(group)] = _Program(self, states, group, generator,
                                                          eps)
        return program.run(self, states, group, generator, eps)

    def run_epoch(self, states: Sequence[State], batch_iter: Iterator[Dict],
                  generator: torch.Generator, drop_ragged_tail: bool = False,
                  noise: Optional[Iterator[torch.Tensor]] = None
                  ) -> Optional[Dict[str, torch.Tensor]]:
        """Consume ``batch_iter`` in groups of ``steps_per_dispatch``;
        returns the last step's metrics. A ragged tail (fewer batches) makes
        a second program the first time; ``drop_ragged_tail=True`` skips it.
        ``noise`` hands in each step's eps, in order."""
        last = None
        for group in chunked(batch_iter, self.steps):
            if drop_ragged_tail and len(group) < self.steps:
                break
            eps = None if noise is None else [next(noise) for _ in group]
            metrics = self.run_group(states, group, generator, eps)
            last = {k: v[-1].clone() for k, v in metrics.items()}
        return last


"""Multi-worker runtime: Hogwild-style multi-trainer training on one card.

Paper §3.1 runs many trainer processes per machine, all updating one shared
embedding store without locks; §3.3 overlaps CPU sampling with device
compute. A port of the JAX package's launch/runtime.py:

* ``WorkerPool`` (data/pipeline.py) — N sampler threads feed one bounded
  batch queue (or, ordered, one queue each, read round-robin).
* ``StoreSlot`` — the shared-store cell: ``read()`` is a lock-free
  reference read, ``swap(fn)`` publishes ``fn(current)`` under ``lock``.
* ``hogwild_train_loop`` — M trainer threads, each looping:

      batch          <- pool                 (any sampler's output)
      grads, metrics <- grad_fn(slot.read(), batch)
                        (gathers copies of the rows the apply of no other
                        trainer has reached yet: possibly stale, tolerated)
      slot.swap(cur -> apply_fn(cur, batch, grads))
                        (the sparse apply, onto the LATEST tables: staleness
                        changes what the gradients were computed against,
                        never which updates survive — no update is lost)

  Without a ``(grad_fn, apply_fn)`` split the whole ``step_fn`` is swapped
  (read-latest -> step -> publish, serialised by the lock): trainers then
  overlap sampling and hook work, not steps.

* **Ordered mode** (``ordered=True``; the distributed path, where every
  step and every checkpoint gather is a collective that all ranks must
  issue in one order). The pool hands out batch t as sampler ``t mod N``'s
  next one, and steps pass a turnstile in sequence order: the trainer
  holding batch t waits until step t-1 is done, then swaps the whole step,
  runs that step's hooks and lets t+1 in. So every rank steps one batch
  sequence and its hooks see step ``start + t + 1`` on batch t. Trainers
  overlap sampling, the batch's copy to the card and waiting, not steps,
  as in the reference's multi-trainer distributed run; any order the
  turnstile fixes is one the reference's queue could have produced.

What differs from the reference, because PyTorch updates the tables in
place where JAX publishes immutable stores:

* **Hooks run holding the slot's lock.** No apply lands while a checkpoint
  or eval reads the tables, so a save never holds ``entity`` and
  ``ent_gsq`` from different steps (the barrier of the paper's checkpoint
  path). The step number a hook sees counts completed applies, and the
  state it sees holds at least that many.
* **One stream.** Every trainer and sampler thread enters the caller's
  device and current CUDA stream before its first CUDA call (a new host
  thread starts on device 0 and its own default stream). On one stream,
  stream order is dispatch order: a gradient's gather sees exactly the
  applies dispatched before it, and applies never overlap on the device.
  Staleness counts the applies published between the version read just
  before the gather and the trainer's own apply.
* Trainer 0 (the caller's thread) completes step 1 before the others
  start, as in JAX: the kernel libraries load, and their per-device host
  caches fill, on one thread.

A trainer's exception stops the others and re-raises in the caller; no
thread falls back to the CPU. In ordered mode a failed step does not open
the turnstile: the trainers waiting at it stop instead of issuing the next
step's collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.common import telemetry
from repro_torch.data.pipeline import WorkerPool
from repro_torch.launch.engine import _finish


class StoreSlot:
    """Published reference to the shared store (paper §3.1's shared memory).

    ``read``   — lock-free (one reference load); whatever was last published.
    ``swap``   — publish ``fn(current)`` under ``lock``. The critical section
                 only dispatches the (asynchronous) update, so trainers
                 serialise on microseconds of dispatch, not device compute.
    ``version``— bumps once per swap.
    ``lock``   — also held by the runtime around hooks (see module docstring).
    """

    def __init__(self, state):
        self._state = state
        self.lock = threading.Lock()
        self.version = 0

    def read(self):
        return self._state

    def swap(self, fn: Callable):
        with self.lock:
            new = fn(self._state)
            self._state = new
            self.version += 1
        return new


class _Counter:
    """Atomic claim counter for work distribution across trainer threads."""

    def __init__(self, total: int):
        self._n = 0
        self._total = total
        self._lock = threading.Lock()

    def claim(self) -> bool:
        with self._lock:
            if self._n >= self._total:
                return False
            self._n += 1
            return True

    def unclaim(self):
        with self._lock:
            self._n -= 1


def _cuda_device_of(state) -> Optional[torch.device]:
    """The CUDA device of the state's first tensor field (or value, for a
    dict); None for a state without CUDA tensors (CPU tables, or a counter
    in tests)."""
    if torch.is_tensor(state):
        tensors = [state]
    elif dataclasses.is_dataclass(state):
        tensors = [getattr(state, f.name) for f in dataclasses.fields(state)]
    elif isinstance(state, dict):  # the distributed state: this rank's blocks
        tensors = list(state.values())
    else:
        tensors = []
    for t in tensors:
        if torch.is_tensor(t):
            return t.device if t.is_cuda else None
    return None


def _on_card(device: Optional[torch.device], stream):
    """Context of a worker thread: the caller's device and stream."""
    if device is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


def hogwild_train_loop(
    step_fn,
    state,
    make_batch,
    n_steps: int,
    *,
    start: int = 0,
    hooks: Sequence = (),
    n_trainers: int = 1,
    n_samplers: int = 1,
    sampler_factory: Optional[Callable[[int], Callable[[], object]]] = None,
    split_step: Optional[Tuple[Callable, Callable]] = None,
    ordered: bool = False,
):
    """Drive ``n_trainers`` Hogwild trainers from ``start`` to ``n_steps``.

    ``make_batch() -> (batch, stats)`` as in ``engine.train_loop``; with
    ``sampler_factory`` each sampler worker gets its own callable
    (``sampler_factory(worker_id)``), required for ``n_samplers > 1`` so
    workers do not share an RNG.

    ``split_step = (grad_fn, apply_fn)`` enables Hogwild staleness:
    ``grad_fn(state, batch) -> (grads, metrics)`` against a possibly stale
    store, ``apply_fn(state, batch, grads) -> state`` onto the latest.
    Without it ``step_fn(state, batch) -> (state, metrics)`` is swapped
    whole.

    ``ordered`` fixes the batch order (sampler ``t mod N`` gives batch t)
    and steps in that order, each with its hooks (module docstring); it
    takes the whole-step swap only.

    Hooks run serialised, holding the slot's lock, with a monotone 1-based
    step number that counts completed steps; ``stats`` carries ``trainer``
    and ``queue_depth``. Returns the final state after every trainer has
    joined and the hooks' ``on_end`` ran.
    """
    if start >= n_steps:
        return _finish(start, state, hooks)
    if n_samplers > 1 and sampler_factory is None:
        raise ValueError("n_samplers > 1 requires sampler_factory (each "
                         "sampler worker needs its own RNG stream)")
    if ordered and split_step is not None:
        raise ValueError("ordered steps take the whole-step swap: a split "
                         "step's gradient phase would leave the turnstile")
    device = _cuda_device_of(state)
    stream = None if device is None else torch.cuda.current_stream(device)
    factory = sampler_factory or (lambda _wid: make_batch)

    def on_card_factory(wid):
        fn = factory(wid)
        if device is None:
            return fn

        def sample():
            with _on_card(device, stream):
                return fn()
        return sample

    pool = WorkerPool(on_card_factory, n_workers=n_samplers,
                      depth=2 * max(n_trainers, n_samplers), ordered=ordered)
    slot = StoreSlot(state)
    todo = _Counter(n_steps - start)
    done = [start]
    stop = threading.Event()
    first_done = threading.Event()
    errors: list = []
    grad_fn, apply_fn = split_step if split_step is not None else (None, None)
    turn = threading.Condition()  # ordered mode: the next step to run
    next_turn = [0]

    def wait_turn(seq) -> bool:
        """Block until step ``seq`` is next; False if the run stopped."""
        with turn:
            while next_turn[0] != seq:
                if stop.is_set():
                    return False
                turn.wait(0.1)
        return True

    def end_turn():
        with turn:
            next_turn[0] += 1
            turn.notify_all()

    def step_once(tid, batch, stats):
        if grad_fn is not None:
            v_read = slot.version
            with telemetry.span("runtime/grad"):
                grads, metrics = grad_fn(slot.read(), batch)
            with telemetry.span("runtime/apply"):
                new = slot.swap(lambda cur: apply_fn(cur, batch, grads))
            # applies published between our read and our own apply
            stale = slot.version - v_read - 1
            if stale > 0:
                telemetry.inc("runtime/stale_steps")
                telemetry.observe("runtime/staleness", stale)
        else:
            box = [None]

            def chained(cur):
                out, m = step_fn(cur, batch)
                box[0] = m
                return out

            with telemetry.span("runtime/step"):
                new = slot.swap(chained)
            metrics = box[0]
        telemetry.inc("runtime/steps")
        with slot.lock:  # the barrier: no apply lands while hooks run
            done[0] += 1
            st = dict(stats) if stats else {}
            st.setdefault("trainer", tid)
            st.setdefault("queue_depth", pool.qsize())
            with telemetry.span("runtime/hooks"):
                for h in hooks:
                    h.on_step(done[0], new, metrics, st)

    def trainer(tid: int):
        # one trace track per trainer (trainer 0 runs on the caller's thread,
        # whose thread name would otherwise label the track)
        telemetry.set_track_name(f"trainer-{tid}")
        try:
            with _on_card(device, stream):
                if tid != 0:
                    while not first_done.wait(0.1):
                        if stop.is_set():
                            return
                while not stop.is_set() and todo.claim():
                    with telemetry.span("runtime/wait_batch"):
                        got = _get(pool, stop)
                    if got is None:  # shut down while waiting
                        todo.unclaim()
                        return
                    seq, (batch, stats) = got
                    if ordered:
                        with telemetry.span("runtime/wait_turn"):
                            if not wait_turn(seq):
                                return
                    step_once(tid, batch, stats)
                    if ordered:  # only after a step that completed
                        end_turn()
                    first_done.set()
        except BaseException as e:  # propagate to the caller, release peers
            errors.append(e)
            stop.set()
        finally:
            if tid == 0:
                first_done.set()  # never leave peers waiting on a dead lead

    threads = [threading.Thread(target=trainer, args=(t,), daemon=True,
                                name=f"trainer-{t}")
               for t in range(1, n_trainers)]
    try:
        for t in threads:
            t.start()
        trainer(0)  # trainer 0 runs on the caller's thread
        for t in threads:
            t.join()
    finally:
        stop.set()
        pool.close()
    if errors:
        raise errors[0]
    return _finish(done[0], slot.read(), hooks)


def _get(pool: WorkerPool, stop: threading.Event):
    """Blocking ``pool.get_numbered`` that stays responsive to the stop
    event: ``(sequence number, batch)``, or None once stopped."""
    while not stop.is_set():
        try:
            return pool.get_numbered(timeout=0.1)
        except queue.Empty:
            continue
    return None

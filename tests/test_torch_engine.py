"""launch/engine, port vs JAX package: the twins of tests/test_engine.py.

Every test runs against both packages' engines on the same counter steps
(``step_fn`` is a counter, batches are tokens), so the port's loop API —
``prefetch=``, ``start=``, an ``on_end`` that replaces the state, the drop
rate, ``CheckpointHook("")`` — is held to the reference's.
"""

import time

import pytest

from repro.launch import engine as jax_engine
from repro_torch.launch import engine as torch_engine


@pytest.fixture(params=["jax", "torch"])
def E(request):
    return {"jax": jax_engine, "torch": torch_engine}[request.param]


def _count_step(state, batch):
    return state + 1, {"loss": float(state)}


def _batches():
    return ({"x": 0}, {"dropped": 3})


class _SaveRecorder:
    def __init__(self):
        self.calls = []

    def __call__(self, ckpt_dir, step, state):
        self.calls.append((step, state))


def test_train_loop_runs_n_steps(E):
    state = E.train_loop(_count_step, 0, _batches, 5, prefetch=False)
    assert state == 5


def test_train_loop_honors_start(E):
    """Resume: start=3 means only steps 4..5 run."""
    state = E.train_loop(_count_step, 3, _batches, 5, start=3, prefetch=False)
    assert state == 5
    # fully-trained resume: no steps, hooks still finalized
    mh = E.MetricsHook()
    state = E.train_loop(_count_step, 7, _batches, 5, start=7, hooks=[mh],
                         prefetch=False)
    assert state == 7 and mh.history["loss"] == []


def test_checkpoint_hook_no_duplicate_final_save(E, tmp_path):
    rec = _SaveRecorder()
    hook = E.CheckpointHook(str(tmp_path), save_every=2, save_fn=rec)
    E.train_loop(_count_step, 0, _batches, 4, hooks=[hook], prefetch=False)
    assert [s for s, _ in rec.calls] == [2, 4]


def test_checkpoint_hook_final_save_when_needed(E, tmp_path):
    rec = _SaveRecorder()
    hook = E.CheckpointHook(str(tmp_path), save_every=2, save_fn=rec)
    E.train_loop(_count_step, 0, _batches, 5, hooks=[hook], prefetch=False)
    assert [s for s, _ in rec.calls] == [2, 4, 5]
    rec2 = _SaveRecorder()
    hook2 = E.CheckpointHook(str(tmp_path), save_every=0, save_fn=rec2)
    E.train_loop(_count_step, 0, _batches, 3, hooks=[hook2], prefetch=False)
    assert [s for s, _ in rec2.calls] == [3]


def test_checkpoint_hook_without_dir_saves_nothing(E):
    rec = _SaveRecorder()
    hook = E.CheckpointHook("", save_every=2, save_fn=rec)
    E.train_loop(_count_step, 0, _batches, 5, hooks=[hook], prefetch=False)
    assert rec.calls == []


def test_checkpoint_hook_flush_fn_applied(E, tmp_path):
    """Deferred (T5) state must be flushed into every checkpoint."""
    rec = _SaveRecorder()
    hook = E.CheckpointHook(str(tmp_path), save_every=2, save_fn=rec,
                            flush_fn=lambda s: s + 1000)
    E.train_loop(_count_step, 0, _batches, 2, hooks=[hook], prefetch=False)
    assert rec.calls == [(2, 1002)]


def test_metrics_hook_records_history(E):
    mh = E.MetricsHook(["loss"])
    E.train_loop(_count_step, 0, _batches, 4, hooks=[mh], prefetch=False)
    assert mh.history["loss"] == [0.0, 1.0, 2.0, 3.0]


def test_logging_hook_reports_drops(E):
    lines = []
    lh = E.LoggingHook(log_every=2, batch_size=10, print_fn=lines.append)
    E.train_loop(_count_step, 0, _batches, 4, hooks=[lh], prefetch=False)
    assert len(lines) == 2
    assert "loss" in lines[0] and "drop" in lines[0]
    # 3 dropped per step of 10 samples = 30%
    assert "30.00%" in lines[1]


def test_on_end_can_replace_state(E):
    class Flusher(E.Hook):
        def on_end(self, i, state):
            return state * 100

    state = E.train_loop(_count_step, 0, _batches, 2, hooks=[Flusher()],
                         prefetch=False)
    assert state == 200


def test_run_loop_indices_and_hooks(E):
    seen = []

    def step(i, state):
        seen.append(i)
        return state + i, {"loss": 0.0}

    mh = E.MetricsHook()
    state = E.run_loop(step, 0, 4, hooks=[mh])
    assert seen == [0, 1, 2, 3]
    assert state == 6
    assert len(mh.history["loss"]) == 4


def test_run_loop_honors_start(E):
    seen = []

    def step(i, state):
        seen.append(i)
        return state + 1, {"loss": 0.0}

    assert E.run_loop(step, 10, 5, start=2) == 13
    assert seen == [2, 3, 4]


def test_train_loop_prefetches(E):
    """The default prefetching path produces identical results."""
    assert E.train_loop(_count_step, 0, _batches, 6) == 6


def test_eval_hook_periodic_and_final(E):
    evals = []
    hook = E.EvalHook(lambda state: evals.append(state), eval_every=2)
    E.train_loop(_count_step, 0, _batches, 5, hooks=[hook], prefetch=False)
    assert evals == [2, 4, 5]


def test_eval_hook_skips_duplicate_final_eval(E):
    evals = []
    hook = E.EvalHook(lambda state: evals.append(state), eval_every=2)
    E.train_loop(_count_step, 0, _batches, 4, hooks=[hook], prefetch=False)
    assert evals == [2, 4]


def test_eval_hook_default_is_final_only(E):
    evals = []
    hook = E.EvalHook(lambda state: evals.append(state))
    E.train_loop(_count_step, 0, _batches, 5, hooks=[hook], prefetch=False)
    assert evals == [5]


def test_throughput_hook_clock_starts_at_first_step(E):
    lines = []
    hook = E.ThroughputHook(items_per_step=10, label="tok", print_fn=lines.append)
    assert hook.t0 is None
    time.sleep(0.25)  # set-up time before the first step
    E.run_loop(lambda i, s: (s + 1, {"loss": 0.0}), 0, 4, hooks=[hook])
    assert len(lines) == 1
    assert float(lines[0].split("-> ")[1].split(" ")[0]) > 1000


def test_logging_hook_reports_trainer_count(E):
    lines = []
    lh = E.LoggingHook(log_every=4, print_fn=lines.append)
    for i in range(1, 5):
        lh.on_step(i, i, {"loss": 0.0}, {"trainer": i % 2, "queue_depth": 3})
    assert lines and "2 trainers" in lines[0] and "q=3" in lines[0]


def test_train_loop_multi_trainer_pure_host(E):
    """train_loop delegates to the Hogwild runtime; the runtime ends through
    the same on_end protocol."""
    class Flusher(E.Hook):
        def on_end(self, i, state):
            return state * 10

    mh = E.MetricsHook()
    state = E.train_loop(_count_step, 0, _batches, 12, hooks=[mh, Flusher()],
                         n_trainers=3)
    assert state == 120
    assert len(mh.history["loss"]) == 12

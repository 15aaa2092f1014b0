"""The port's spans inside a training loop: the span tree of a tiny
``train_loop`` (names, nesting, threads, the step and batch args), the
``pipeline/wait`` span only where the queue was empty, the sample spans'
batch numbers in the ordered mode, and the clock anchor in the trace file,
which both packages' validators accept.

Loops run on a helper thread joined with a timeout."""

import functools
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.common import telemetry as jax_telemetry
from repro.data.kg_synth import make_synthetic_kg
from repro_torch.common import telemetry
from repro_torch.common.config import KGEConfig
from repro_torch.core import kge_model as K
from repro_torch.core.sampling import JointSampler
from repro_torch.data.pipeline import WorkerPool
from repro_torch.launch.engine import train_loop

torch.set_num_threads(2)
TIMEOUT_S = 60.0
N_ENT, N_REL, STEPS = 200, 8, 4
PHASES = ["step/gather", "step/score", "step/backward"]


def bounded(fn, *args, **kw):
    """``fn(*args, **kw)`` on a helper thread, joined within TIMEOUT_S;
    returns its value and the thread's id."""
    out = {}

    def run():
        out["tid"] = threading.get_ident()
        out["value"] = fn(*args, **kw)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(TIMEOUT_S)
    assert not th.is_alive(), f"{fn.__name__} did not return within {TIMEOUT_S} s"
    assert "value" in out, f"{fn.__name__} raised"
    return out["value"], out["tid"]


def _within(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _spans(doc, name):
    return sorted((e for e in doc["traceEvents"] if e.get("ph") == "X" and e["name"] == name),
                  key=lambda e: e["ts"])


@pytest.fixture(scope="module")
def traced():
    """A tiny RESCAL loop (T5 on) under a tracing registry: its trace."""
    kg = make_synthetic_kg(n_entities=N_ENT, n_relations=N_REL, n_edges=2000,
                           n_clusters=4, seed=0)
    cfg = KGEConfig(model="rescal", n_entities=N_ENT, n_relations=N_REL, dim=8,
                    batch_size=16, neg_sample_size=4, neg_group_size=8, lr=0.1)
    state = K.init_state(cfg, overlap=True, device="cpu")
    sampler = JointSampler(kg.train, N_ENT, cfg, np.random.default_rng(0))
    with telemetry.active(trace=True) as reg:
        _, tid = bounded(train_loop, functools.partial(K.train_step, cfg), state,
                         lambda: (K.batch_to_device(sampler.sample(), "cpu"), None),
                         STEPS)
    return reg.trace_json(), tid


def test_step_spans_nest_on_the_trainer(traced):
    doc, tid = traced
    steps = _spans(doc, "engine/step")
    assert [e["args"] for e in steps] == [{"step": i} for i in range(1, STEPS + 1)]
    assert {e["tid"] for e in steps} == {tid}
    for name in ["step/flush", "step/grad", "step/apply"] + PHASES:
        got = _spans(doc, name)
        assert len(got) == STEPS and "args" not in got[0], name
        assert all(_within(e, s) for e, s in zip(got, steps)), name
    for grad, *phases in zip(_spans(doc, "step/grad"), *map(lambda n: _spans(doc, n), PHASES)):
        assert all(_within(p, grad) for p in phases)
        ends = [p["ts"] + p["dur"] for p in phases]
        assert ends == sorted(ends) and phases[1]["ts"] >= ends[0]


def test_sampler_spans_carry_the_batch_number(traced):
    doc, tid = traced
    samples = _spans(doc, "pipeline/sample")
    tracks = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"] if e.get("ph") == "M"}
    assert len(samples) >= STEPS
    assert [e["args"] for e in samples] == [{"batch": k} for k in range(len(samples))]
    assert {tracks[e["tid"]] for e in samples} == {"sampler-0"}
    copies = _spans(doc, "pipeline/copy")
    assert len(copies) == len(samples)
    assert all(_within(c, s) for c, s in zip(copies, samples))
    for w in _spans(doc, "pipeline/wait"):  # a step that found the queue empty
        assert w["tid"] == tid and not any(_within(w, s) for s in _spans(doc, "engine/step"))
        step = _spans(doc, "engine/step")[w["args"]["batch"]]
        assert w["ts"] + w["dur"] <= step["ts"]


def test_the_trace_file_holds_the_clock_and_passes_both_validators(traced, tmp_path):
    doc, _ = traced
    clock = doc["otherData"]["clock"]
    assert isinstance(clock["perf_counter_ns"], int) and isinstance(clock["time_ns"], int)
    first = _spans(doc, "engine/step")[0]
    wall = telemetry.profiler_ns(first["ts"], clock)
    assert clock["time_ns"] < wall < time.time_ns()
    path = tmp_path / "t.json"
    path.write_text(json.dumps(doc))
    assert telemetry.validate_trace(str(path)) == len(doc["traceEvents"])
    assert jax_telemetry.validate_trace(str(path)) == len(doc["traceEvents"])


def test_wait_span_only_where_the_queue_was_empty():
    gate = threading.Event()

    def sample():
        gate.wait(TIMEOUT_S)
        return "batch"

    with telemetry.active(trace=True) as reg:
        pool = WorkerPool(lambda wid: sample, depth=2)
        try:
            timer = threading.Timer(0.05, gate.set)
            timer.start()
            assert pool.get_numbered(timeout=TIMEOUT_S) == (0, "batch")  # waits
            deadline = time.monotonic() + TIMEOUT_S
            while pool.qsize() < 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert pool.qsize() == 2
            assert pool.get_numbered(timeout=TIMEOUT_S) == (1, "batch")  # no wait
        finally:
            pool.close()
            timer.join(TIMEOUT_S)
    waits = _spans(reg.trace_json(), "pipeline/wait")
    assert len(waits) == 1 and waits[0]["args"] == {"batch": 0}
    assert waits[0]["tid"] == threading.get_ident() and waits[0]["dur"] >= 40e3
    assert pool.stats()["consumer_wait_s"] >= 0.04


def test_sample_spans_number_batches_round_robin_when_ordered():
    def factory(wid):
        return lambda: wid

    with telemetry.active(trace=True) as reg:
        pool = WorkerPool(factory, n_workers=2, depth=4, ordered=True)
        try:
            got = [pool.get_numbered(timeout=TIMEOUT_S) for _ in range(6)]
        finally:
            pool.close()
    assert [wid for _, wid in got] == [0, 1, 0, 1, 0, 1]
    doc = reg.trace_json()
    tracks = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"] if e.get("ph") == "M"}
    for wid in (0, 1):
        mine = [e["args"]["batch"] for e in _spans(doc, "pipeline/sample")
                if tracks[e["tid"]] == f"sampler-{wid}"]
        assert mine == [wid + 2 * k for k in range(len(mine))] and len(mine) >= 3
    # the free mode's workers race for one queue: their spans name the worker
    with telemetry.active(trace=True) as reg:
        pool = WorkerPool(factory, n_workers=2, depth=2)
        try:
            for _ in range(4):
                pool.get(timeout=TIMEOUT_S)
        finally:
            pool.close()
    doc = reg.trace_json()
    tracks = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"] if e.get("ph") == "M"}
    samples = _spans(doc, "pipeline/sample")
    assert len(samples) >= 4
    assert all(tracks[e["tid"]] == f"sampler-{e['args']['worker']}" for e in samples)

"""The port's telemetry against the JAX package's (tests/test_telemetry.py):
registry thread-safety, trace schema, the validators, ``TelemetryHook``
through the loop, Hogwild per-trainer tracks; and files across packages:
the port's JSONL and trace pass JAX's validators, and JAX's pass the port's.

Loops run on a helper thread joined with a timeout."""

import json
import threading
import warnings

import pytest

from repro.common import telemetry as jax_telemetry
from repro.launch.engine import TelemetryHook as JaxTelemetryHook
from repro.launch.engine import train_loop as jax_train_loop
from repro_torch.common import telemetry
from repro_torch.common.telemetry import (
    MetricsRegistry, validate_metrics_jsonl, validate_trace,
)
from repro_torch.launch.engine import LoggingHook, TelemetryHook, train_loop

TIMEOUT_S = 60.0


def bounded(fn, *args, **kw):
    """``fn(*args, **kw)`` on a helper thread, joined within TIMEOUT_S."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args, **kw)
        except BaseException as e:  # handed to the test thread
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(TIMEOUT_S)
    assert not th.is_alive(), f"{fn.__name__} did not return within {TIMEOUT_S} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


# ---------------------------------------------------------------------------
# MetricsRegistry
# ---------------------------------------------------------------------------
def test_registry_counters_exact_under_contention():
    reg = MetricsRegistry(enabled=True)
    n_threads, n_incs = 8, 2000

    def worker():
        for _ in range(n_incs):
            reg.inc("pipeline/produced")
            reg.observe("runtime/staleness", 1.0)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)
    assert reg.counters["pipeline/produced"] == n_threads * n_incs
    h = reg.snapshot()["hists"]["runtime/staleness"]
    assert h["count"] == n_threads * n_incs
    assert h["mean"] == 1.0


def test_disabled_registry_records_nothing():
    reg = MetricsRegistry(enabled=False)
    reg.inc("pipeline/produced")
    reg.gauge("pipeline/queue_depth", 3)
    reg.observe("runtime/staleness", 1.0)
    reg.trace_inc("kvstore/pull_rows", 64)
    assert reg.counters == {} and reg.gauges == {}
    assert reg.snapshot()["hists"] == {}
    assert reg.drain_statics() == {}
    # disabled spans are the shared no-op singleton — no per-call allocation
    assert reg.span("x") is reg.span("y") is telemetry._NULL_SPAN


def test_module_helpers_default_disabled_and_active_restores():
    assert not telemetry.enabled()
    telemetry.inc("pipeline/produced")  # no-op, must not raise
    with telemetry.active() as reg:
        assert telemetry.enabled()
        telemetry.inc("pipeline/produced")
        telemetry.gauge("pipeline/queue_depth", 2)
        telemetry.observe("runtime/staleness", 3)
        assert reg.counters["pipeline/produced"] == 1
        snap = telemetry.snapshot(step=7, run="x")
        assert snap["step"] == 7 and snap["run"] == "x"
        assert snap["gauges"]["pipeline/queue_depth"] == 2.0
    assert not telemetry.enabled()


def test_trace_inc_buffers_until_drained():
    reg = MetricsRegistry(enabled=True)
    reg.trace_inc("kvstore/pull_rows", 64)
    reg.trace_inc("kvstore/pull_rows", 64)
    assert "kvstore/pull_rows" not in reg.counters  # buffered, not recorded
    assert reg.drain_statics() == {"kvstore/pull_rows": 128.0}
    assert reg.drain_statics() == {}


def test_span_trace_roundtrip(tmp_path):
    reg = MetricsRegistry(enabled=True, trace=True)
    reg.set_track_name("trainer-0")
    with reg.span("runtime/grad"):
        pass
    with reg.span("runtime/apply"):
        pass
    path = tmp_path / "t.json"
    reg.write_trace(str(path))
    assert validate_trace(str(path)) >= 3  # 2 spans + 1 track
    doc = json.loads(path.read_text())
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert names == {"runtime/grad", "runtime/apply"}
    tracks = {e["args"]["name"] for e in doc["traceEvents"] if e.get("ph") == "M"}
    assert "trainer-0" in tracks


def test_trace_event_cap_counts_drops():
    reg = MetricsRegistry(enabled=True, trace=True, max_events=3)
    for _ in range(10):
        with reg.span("engine/step"):
            pass
    assert len(reg.trace_json()["traceEvents"]) == 4  # 3 spans + metadata
    assert reg.counters["telemetry/trace_events_dropped"] == 7


# ---------------------------------------------------------------------------
# schema validators
# ---------------------------------------------------------------------------
def _write_jsonl(path, recs):
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))


def _rec(step, counters, gauges=None):
    return {"ts": 0.0, "uptime_s": float(step), "counters": counters,
            "gauges": gauges or {}, "hists": {}, "step": step}


def test_validator_accepts_known_and_rejects_unknown_names(tmp_path):
    p = tmp_path / "m.jsonl"
    _write_jsonl(p, [_rec(1, {"engine/steps": 1.0}, {"bench/anything": 2.0})])
    assert validate_metrics_jsonl(str(p)) == 1
    _write_jsonl(p, [_rec(1, {"engine/steps": 1.0, "engine/stepz": 1.0})])
    with pytest.raises(ValueError, match="engine/stepz"):
        validate_metrics_jsonl(str(p))


def test_validator_rejects_decreasing_counters_and_missing_required(tmp_path):
    p = tmp_path / "m.jsonl"
    _write_jsonl(p, [_rec(1, {"engine/steps": 5.0}), _rec(2, {"engine/steps": 3.0})])
    with pytest.raises(ValueError, match="decreased"):
        validate_metrics_jsonl(str(p))
    _write_jsonl(p, [_rec(1, {"pipeline/produced": 1.0})])
    with pytest.raises(ValueError, match="engine/steps"):
        validate_metrics_jsonl(str(p))


def test_known_metrics_are_the_jax_schema():
    """One schema for both packages: the same names, meanings and families,
    covering every name the port's instrumented modules emit."""
    assert telemetry.KNOWN_METRICS == jax_telemetry.KNOWN_METRICS
    assert telemetry.KNOWN_PREFIXES == jax_telemetry.KNOWN_PREFIXES
    for name in ("pipeline/produced", "pipeline/producer_wait_s",
                 "pipeline/consumer_wait_s", "pipeline/queue_depth",
                 "runtime/steps", "runtime/stale_steps", "runtime/staleness",
                 "store/flush_calls", "store/pend_dropped", "engine/steps",
                 "step/loss", "step/pend_dropped", "telemetry/trace_events_dropped"):
        assert name in telemetry.KNOWN_METRICS, name


# ---------------------------------------------------------------------------
# TelemetryHook through the engine loop
# ---------------------------------------------------------------------------
def _fake_step(state, batch):
    return state + 1, {"loss": 0.5, "pos_score": 1.0, "neg_score": -1.0}


def test_telemetry_hook_writes_valid_jsonl_and_trace(tmp_path):
    mpath, tpath = tmp_path / "m.jsonl", tmp_path / "t.json"
    with telemetry.active(trace=True) as reg:
        telemetry.trace_inc("kvstore/pull_rows", 64)
        telemetry.trace_inc("kvstore/pull_bytes", 1024)
        hook = TelemetryHook(metrics_out=str(mpath), trace_out=str(tpath), every=4)
        bounded(train_loop, _fake_step, 0, lambda: (None, {"queue_depth": 3}),
                n_steps=10, hooks=[hook])
        assert reg.counters["engine/steps"] == 10
        # statics replayed every step: counter = per-step * steps
        assert reg.counters["kvstore/pull_rows"] == 64 * 10
        assert reg.gauges["kvstore/pull_rows_per_step"] == 64
        assert reg.counters["kvstore/pull_bytes"] == 1024 * 10
    assert validate_metrics_jsonl(str(mpath)) == 3  # steps 4, 8, final 10
    recs = [json.loads(line) for line in mpath.read_text().splitlines()]
    assert [r["step"] for r in recs] == [4, 8, 10]
    assert [r["counters"]["engine/steps"] for r in recs] == [4.0, 8.0, 10.0]
    assert recs[0]["gauges"]["step/loss"] == 0.5
    assert validate_trace(str(tpath)) > 0


def test_telemetry_hook_inert_when_disabled(tmp_path):
    mpath = tmp_path / "m.jsonl"
    hook = TelemetryHook(metrics_out=str(mpath), every=2)
    bounded(train_loop, _fake_step, 0, lambda: (None, None), n_steps=6, hooks=[hook])
    assert not mpath.exists()  # no registry enabled -> no file, no error


def _hogwild_files(tmp_path, loop, telemetry_mod, hook_cls, tag):
    """A 3-trainer, 2-sampler two-phase run of ``loop`` under ``telemetry_mod``
    with ``hook_cls`` writing both files; returns (state, registry, paths)."""
    mpath, tpath = tmp_path / f"{tag}.jsonl", tmp_path / f"{tag}.json"
    with telemetry_mod.active(trace=True) as reg:
        hook = hook_cls(metrics_out=str(mpath), trace_out=str(tpath), every=10)
        state = bounded(
            loop, None, 0, None, 30, hooks=[hook], n_trainers=3, n_samplers=2,
            sampler_factory=lambda wid: (lambda: ((), None)),
            split_step=(lambda s, b: (0, {"loss": 0.0}), lambda s, b, g: s + 1))
    return state, reg, mpath, tpath


def test_hogwild_per_trainer_tracks_and_exact_step_counts(tmp_path):
    state, reg, mpath, tpath = _hogwild_files(tmp_path, train_loop, telemetry,
                                              TelemetryHook, "port")
    assert state == 30  # every step's apply landed exactly once
    assert reg.counters["runtime/steps"] == 30
    assert reg.counters["engine/steps"] == 30
    validate_metrics_jsonl(str(mpath), require=("engine/steps", "runtime/steps"))
    validate_trace(str(tpath))
    doc = json.loads(tpath.read_text())
    tracks = {e["args"]["name"] for e in doc["traceEvents"] if e.get("ph") == "M"}
    for tid in range(3):
        assert f"trainer-{tid}" in tracks, tracks
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"runtime/grad", "runtime/apply", "runtime/wait_batch"} <= names


def test_port_files_pass_jax_validators(tmp_path):
    _, _, mpath, tpath = _hogwild_files(tmp_path, train_loop, telemetry,
                                        TelemetryHook, "port")
    assert jax_telemetry.validate_metrics_jsonl(
        str(mpath), require=("engine/steps", "runtime/steps")) == 3
    assert jax_telemetry.validate_trace(str(tpath)) > 0


def test_jax_files_pass_port_validators(tmp_path):
    state, _, mpath, tpath = _hogwild_files(tmp_path, jax_train_loop, jax_telemetry,
                                            JaxTelemetryHook, "jax")
    assert state == 30
    assert validate_metrics_jsonl(str(mpath), require=("engine/steps",
                                                       "runtime/steps")) == 3
    assert validate_trace(str(tpath)) > 0


def test_logging_hook_reports_trainers_queue_and_pend_drops():
    lines = []
    hook = LoggingHook(log_every=1, batch_size=8, print_fn=lines.append)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        hook.on_step(1, None, {"loss": 0.1, "pend_dropped": 0.0},
                     {"trainer": 0, "queue_depth": 2})
        hook.on_step(2, None, {"loss": 0.1, "pend_dropped": 7.0},
                     {"trainer": 1, "queue_depth": 3})
        hook.on_step(3, None, {"loss": 0.1, "pend_dropped": 9.0}, None)
    pend = [w for w in caught if "pend buffer overflowed" in str(w.message)]
    assert len(pend) == 1  # warn-once
    assert "trainers" not in lines[0] and "pend_drop" not in lines[0]
    assert "2 trainers, q=3" in lines[1] and "pend_drop 7" in lines[1]
    assert "pend_drop 9" in lines[2]

"""The spans' attribution on a trace made by hand, against numbers worked
by hand: each phase's device time, the idle split by the trainer's
innermost span with nested spans, the sampler's overlap with the step,
the launch count and the calls outside a step; the clock anchor's
conversion; and a traced run of a tiny cell on the CPU, for its spans."""

import time

import pytest

from _tiny import tiny  # puts the repo root and src/ on sys.path

import torch

from kgebench import graph, harness, phases, spans
from repro_torch.common.telemetry import MetricsRegistry

T, S, A = 1, 2, 3  # trainer, sampler, and autograd's device thread (no spans)


def _span(name, th, s, e, **args):
    return (name, th, float(s), float(e), args)


def _step(i, t0, flush, gather, score, backward, apply_, end):
    """One engine/step with its phases: each phase an (s, e) pair; step/grad
    runs from the gather's start - 1 to the backward's end + 1."""
    return [_span("engine/step", T, t0, end, step=i), _span("step/flush", T, *flush),
            _span("step/grad", T, gather[0] - 1, backward[1] + 1),
            _span("step/gather", T, *gather), _span("step/score", T, *score),
            _span("step/backward", T, *backward), _span("step/apply", T, *apply_)]


SPANS = sorted(
    _step(1, 10, (12, 15), (17, 25), (26, 40), (41, 49), (51, 58), 60)
    + [_span("pipeline/wait", T, 62, 70, batch=1)]
    + _step(2, 72, (73, 74), (76, 80), (81, 85), (86, 89), (91, 99), 100)
    + [_span("pipeline/sample", S, 0, 30, batch=2), _span("pipeline/copy", S, 25, 29),
       _span("pipeline/sample", S, 64, 80, batch=3), _span("pipeline/copy", S, 78, 80)],
    key=lambda sp: (sp[2], -sp[3]))

# (launch time, thread, device op or None): the ops' correlation ids are
# their calls' indices
CALLS = [(13, T, (14, 16)), (18, T, (19, 23)), (27, T, (28, 35)), (42, T, (43, 50)),
         (52, T, (53, 56)), (55, T, None), (59, T, (60, 61)),  # step 1
         (73.5, T, (74, 75)), (77, T, (78, 80)), (82, T, (83, 88)), (87, A, (88, 95)),
         (92, T, (95, 99)),  # step 2
         (101, T, (102, 103)),  # after the step, in the window
         (26, S, (26.5, 27.5)), (79, S, (80, 81))]  # the sampler's copies
PROF = spans.Profile(
    ops=sorted([("k", s, e, i) for i, (_, _, op) in enumerate(CALLS) if op for s, e in [op]],
               key=lambda op: op[1]),
    calls=[("cudaLaunchKernel", t, t + 0.5, th, i) for i, (t, th, _) in enumerate(CALLS)],
    start_ns=0)


@pytest.fixture(scope="module")
def att():
    return spans.attribute(PROF, SPANS, 5.0, 105.0)


def test_innermost_pieces_of_nested_spans():
    pieces = spans.innermost(SPANS, T)
    assert pieces[:6] == [(10, 12, "engine/step"), (12, 15, "step/flush"),
                          (15, 16, "engine/step"), (16, 17, "step/grad"),
                          (17, 25, "step/gather"), (25, 26, "step/grad")]
    assert (62, 70, "pipeline/wait") in pieces
    assert sum(e - s for s, e, _ in pieces) == 50 + 8 + 28
    starts = [p[0] for p in pieces]
    assert spans.label_at(pieces, starts, 61) == spans.LOOP
    assert spans.label_at(pieces, starts, 87) == "step/backward"
    assert spans.innermost(SPANS, S) == [(0, 25, "pipeline/sample"), (25, 29, "pipeline/copy"),
                                         (29, 30, "pipeline/sample"), (64, 78, "pipeline/sample"),
                                         (78, 80, "pipeline/copy")]


def test_phase_device_time_by_the_launching_span(att):
    """Step 2's backward launch comes from a thread with no spans, while the
    trainer waits in step/backward: it counts as the trainer's."""
    assert att.steps == 2
    # gather 4 + 2, score 7 + 5, backward 7 + 7, update (flush and apply)
    # 2 + 3 + 1 + 4 us over two steps
    assert att.device_ms == pytest.approx({"gather": 0.003, "score": 0.006,
                                           "backward": 0.007, "update": 0.005})
    assert att.copy_ms == pytest.approx(0.001)  # the sampler's two 1 us copies
    assert att.other_ms == pytest.approx(0.001)  # step 1's own op, the one after step 2


def test_idle_split_by_the_trainers_innermost_span(att):
    # 54 of the window's 100 us idle
    assert att.window_us == 100
    assert sum(att.idle_us.values()) == pytest.approx(54)
    assert att.idle_us == pytest.approx({
        spans.LOOP: 12, "engine/step": 7, "step/flush": 3, "step/grad": 4,
        "step/gather": 6, "step/score": 8, "step/backward": 2, "step/apply": 4,
        "pipeline/wait": 8})
    m = att.metrics()
    assert m["idle_enqueue_share"] == pytest.approx(34.0)
    assert m["idle_wait_share"] == pytest.approx(8.0)


def test_launches_overlap_and_the_calls_outside_a_step(att):
    # 7 calls in step 1 (one enqueues no op), 5 in step 2; the one at 101
    # is 1 us after step 2
    assert att.launches == pytest.approx({"step/flush": 1, "step/gather": 1,
                                          "step/score": 1, "step/backward": 1,
                                          "step/apply": 1.5, "engine/step": 0.5})
    m = att.metrics()
    assert m["launches_per_step"] == pytest.approx(6)
    assert att.inside == pytest.approx(12 / 13) and att.outside_us == pytest.approx(1)
    # sampling [0, 30] and [64, 80] against the steps [10, 60] and [72, 100]
    assert m["sample_overlap_share"] == pytest.approx(100 * 28 / 78)
    assert m["gather_device_ms"] == pytest.approx(0.003)
    assert att.host_ms["engine/step"] == pytest.approx((50 + 28) / 2 / 1e3)
    assert att.host_ms["pipeline/wait"] == pytest.approx(8 / 2 / 1e3)


def test_no_trainer_step_in_the_window():
    assert spans.attribute(PROF, SPANS, 101.0, 200.0) is None
    assert spans.attribute(PROF, [sp for sp in SPANS if sp[0] != "engine/step"],
                           5.0, 105.0) is None


def test_a_slice_of_a_registry_trace(att):
    """The registry's trace of SPANS with a clock anchor at 0 on both clocks
    (a span's ts is its start on the profiler's timebase, a perf_counter
    reading of p s is p * 1e6 us there): the spans that overlap the slice,
    the same attribution as SPANS', and none where spans were lost."""
    doc = {"traceEvents": [{"name": n, "ph": "X", "tid": th, "ts": s, "dur": e - s, "args": a}
                           for n, th, s, e, a in SPANS],
           "otherData": {"clock": {"perf_counter_ns": 0, "time_ns": 0}}}
    inside, got = spans.slice_attribution(PROF, doc, 61e-6, 105e-6)
    assert inside == [sp for sp in SPANS if sp[3] > 61]  # step 1 and its phases out
    assert got == spans.attribute(PROF, SPANS, 61.0, 105.0) and got.steps == 1
    inside, got = spans.slice_attribution(PROF, doc, 5e-6, 105e-6)
    assert inside == SPANS and got == att
    assert spans.slice_attribution(PROF, doc, 5e-6, 105e-6, dropped=1)[1] is None
    assert spans.slice_attribution(PROF, {"traceEvents": doc["traceEvents"]},
                                   5e-6, 105e-6) == (None, None)


def test_the_registry_clock_puts_spans_on_the_profilers_timebase():
    reg = MetricsRegistry(enabled=True, trace=True)
    before = time.perf_counter()
    with reg.span("engine/step", step=3):
        time.sleep(0.002)
    after = time.perf_counter()
    doc = reg.trace_json()
    clock = spans.clock_of(doc)
    start_ns = clock["time_ns"] - 10**9  # a trace that began a second earlier
    (name, th, s, e, args), = spans.spans_of(doc, start_ns)
    lo, hi = (spans.perf_to_us(p, clock, start_ns) for p in (before, after))
    assert name == "engine/step" and args == {"step": 3}
    assert lo <= s < e <= hi and e - s >= 2000
    assert 1e6 < lo < 1e6 + (time.perf_counter() - clock["perf_counter_ns"] / 1e9) * 1e6
    assert spans.spans_of({"traceEvents": doc["traceEvents"]}, start_ns) is None


def test_a_traced_tiny_run_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(graph, "CACHE_DIR", tmp_path / "cache")
    cell = tiny(harness.load_cell("rescal-fb15k.train"))
    out = phases.run(cell, 2**31 + 5, torch.device("cpu"), 4, 3)
    att = out["attribution"]
    assert att["steps"] == 3 and "metrics" not in out
    assert out["step_device_ms"] is None
    for name in ("engine/step", "step/gather", "step/score", "step/backward",
                 "step/apply", "step/flush"):
        assert att["host_ms"][name] > 0, name
    assert att["host_ms"]["engine/step"] > att["host_ms"]["step/grad"] > att["host_ms"]["step/score"]

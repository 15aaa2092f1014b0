"""The readers' arithmetic on records made by hand: the rate is all the work
over all the time, the p95 is over every step and shows a planted stall,
the trace reductions and roofline shares count what they say."""

import numpy as np
import pytest

from _tiny import ROOT

from kgebench import harness
from kgebench.cost import KernelCost, bound_s, peaks
from kgebench.cost import launches
from kgebench.cost.rescal_proj import rescal_proj_cost
from kgebench.cost.step import step_cost
from kgebench.spans import LOOP, Attribution
from kgebench.trace import Trace, busy_us, idle_gaps, top_ops

SPEC = harness.load_cell("rescal-fb15k.train").spec
RATES = peaks("NVIDIA H100 80GB HBM3")


def reader(name):
    return harness.load_module(ROOT / "kgebench" / "metrics" / f"{name}.py").read


def record(**kw):
    base = dict(spec=SPEC, setup_s=12.5, window_s=10.0, steps=1000,
                step_ms=[10.0] * 1000, batches=[])
    base.update(kw)
    return harness.Record(**base)


def test_rate_is_all_the_work_over_all_the_time():
    rec = record(window_s=8.0, steps=1000)
    assert reader("window_triplets_per_s")(rec) == pytest.approx(1000 * 1024 / 8.0)
    assert reader("setup_s")(rec) == 12.5


def test_p95_is_over_every_step_and_shows_a_stall():
    steps = [10.0] * 1000
    assert reader("step_ms_p95")(record(step_ms=steps)) == pytest.approx(10.0)
    for i in range(0, 1000, 10):  # one step in ten stalls for 40 ms more
        steps[i] = 50.0
    assert reader("step_ms_p95")(record(step_ms=steps)) == pytest.approx(50.0)
    steps = [10.0] * 1000
    steps[-60:] = [30.0] * 60  # a stall at the window's end counts too
    assert reader("step_ms_p95")(record(step_ms=steps)) == pytest.approx(30.0)


def test_host_clock_readers():
    calls = [0.0, 0.010, 0.021, 0.033]
    rets = [0.008, 0.018, 0.030, 0.041]
    rec = record(call_s=calls, return_s=rets, sample_s=[0.001, 0.003])
    assert reader("step_host_ms")(rec) == pytest.approx(8.0 * 0.25 + 8 * 0.25 + 9 * 0.25 + 8 * 0.25)
    assert reader("loop_wait_ms")(rec) == pytest.approx((2 + 3 + 3) / 3)
    assert reader("sample_ms")(rec) == pytest.approx(2.0)


def test_trace_reductions():
    dev = [("gemm_a", 0, 10), ("k", 5, 20), ("gemm_b", 30, 40), ("k", 60, 70),
           ("copy", 61, 66)]
    tr = Trace(device=dev, steps=2, window_s=100e-6)
    assert busy_us(dev) == 40
    assert top_ops(dev, 2) == [["k", 25e-6], ["gemm_a", 10e-6]]
    # gaps 20..30 (then gemm_b) and 40..60 (then k), longest first
    assert idle_gaps(tr) == [["before k", 20e-6], ["before gemm_b", 10e-6]]
    rec = record(trace=tr, rates=RATES)
    assert reader("gemm_ms")(rec) == pytest.approx(20 / 2 / 1e3)
    assert reader("step_device_ms")(rec) == pytest.approx(50 / 2 / 1e3)
    # 40 of the traced window's 100 us busy (the overlap counted once)
    assert reader("device_idle_share")(rec) == pytest.approx(60.0)


def _batch(rng, b=1024, k=256, ng=4, n_e=14951, n_r=1345):
    return (rng.integers(0, n_e, b), rng.integers(0, n_r, b), rng.integers(0, n_e, b),
            rng.integers(0, n_e, (2, ng, k)))


def test_roofline_shares_match_launches_in_order():
    rng = np.random.default_rng(0)
    batches = [_batch(rng) for _ in range(3)]
    applies = [a for p, c in zip(batches, batches[1:])
               for a in launches.applies(SPEC, p, c)]
    assert [a[:2] for a in applies[:3]] == [(4096, 500), (1024, 500), (1024, 250000)]
    assert applies[0][2] == np.unique(np.concatenate(
        [batches[0][0], batches[0][2], batches[0][3].reshape(-1)])).size
    from kgebench.cost.fused_update import update_cost

    costs = [update_cost(*a) for a in applies]
    # each launch at exactly twice its bound: the share reads 50%
    t, dev = 0.0, []
    for kc in costs:
        dur = 2 * bound_s(kc, RATES) * 1e6
        dev.append(("fused_update_kernel<true>", t, t + dur))
        t += dur + 1
    rec = record(trace=Trace(dev, 2, 1.0), traced_batches=batches, rates=RATES)
    assert reader("update_roofline")(rec) == pytest.approx(50.0)
    assert reader("dedup_roofline")(rec) is None  # no dedup launch traced
    rec.trace.device.pop()  # a launch the trace lost: no reading, not a wrong one
    assert reader("update_roofline")(rec) is None


def test_rescal_proj_roofline_takes_a_forward_and_a_backward_a_step():
    b, d, r = SPEC["batch_size"], SPEC["dim"], SPEC["rel_dim"]
    costs = [rescal_proj_cost(b, d, r, backward) for _ in range(2) for backward in (False, True)]
    # each launch at exactly twice its bound, beside other ops: the share reads 50%
    t, dev = 0.0, [("dedup_warp_kernel", 0.0, 900.0)]
    for kc in costs:
        dur = 2 * bound_s(kc, RATES) * 1e6
        flag = "true" if kc.name.endswith("bwd") else "false"
        dev.append((f"void (anonymous namespace)::rescal_proj_kernel<4, {flag}>(float const*)",
                    t, t + dur))
        t += dur + 1
    rec = record(trace=Trace(dev, 2, 1.0), rates=RATES)
    assert reader("rescal_proj_roofline")(rec) == pytest.approx(50.0)
    rec.trace.device.pop()  # a launch the trace lost: no reading, not a wrong one
    assert reader("rescal_proj_roofline")(rec) is None
    assert reader("rescal_proj_roofline")(record(trace=Trace(dev[:1], 2, 1.0), rates=RATES)) is None


def test_phase_readers_read_the_attribution():
    """Each of the eight readers returns its number of the traced slice's
    attribution, and nothing where the run has none."""
    att = Attribution(
        steps=4, window_us=2000.0,
        device_ms={"gather": 0.5, "score": 0.25, "backward": 0.75},  # no update op
        copy_ms=0.01, other_ms=0.02,
        idle_us={LOOP: 40.0, "engine/step": 100.0, "step/score": 60.0,
                 "step/backward": 20.0, "pipeline/wait": 30.0, "pipeline/sample": 5.0},
        launches={"engine/step": 8.0, "step/score": 24.0, "step/backward": 49.0},
        host_ms={"engine/step": 5.0}, sample_overlap=0.45, inside=1.0, outside_us=0.0)
    want = {"gather_device_ms": 0.5, "score_device_ms": 0.25, "backward_device_ms": 0.75,
            "update_device_ms": 0.0, "launches_per_step": 81.0,
            "idle_enqueue_share": 100.0 * 180 / 2000, "idle_wait_share": 100.0 * 30 / 2000,
            "sample_overlap_share": 45.0}
    assert set(want) == set(att.metrics())
    for name, value in want.items():
        assert reader(name)(record(phases=att)) == pytest.approx(value), name
        assert reader(name)(record()) is None


def test_step_mfu_counts_needed_work():
    rng = np.random.default_rng(1)
    bt = _batch(rng)
    kc = step_cost("transr", *bt, 200, 200)
    # distinct relations, summed over the 4 groups of 256 triplets
    u = sum(np.unique(bt[1][g * 256:(g + 1) * 256]).size for g in range(4))
    assert kc.flops == 3 * (2 * 2 * 1024 * 200 * 200 + 2 * 2 * u * 256 * 200 * 200)
    rec = record(spec=harness.load_cell("transr-fb15k.train").spec, batches=[bt],
                 rates=RATES, window_s=1.0, steps=100)
    want = 100.0 * bound_s(kc, RATES) / 0.01
    assert reader("step_mfu")(rec) == pytest.approx(want)
    assert bound_s(KernelCost("x", 164.9e12, 0, "tf32x3"), RATES) == pytest.approx(1.0)

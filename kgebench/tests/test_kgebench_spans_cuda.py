"""The port's spans and the device trace on one clock, on the card, at each
cell's own graph, widths and batch: the trainer's launch calls fall inside
its ``engine/step`` spans, the phases' device time and the batches' copies
add up to the step's device time, and the idle time put down to the
trainer's spans is idle time of the device."""

import gc

import pytest

from _tiny import cells  # puts the repo root and src/ on sys.path

import torch

from kgebench import graph, harness, phases

CELLS = cells()


@pytest.fixture
def card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(graph, "CACHE_DIR", tmp_path / "cache")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_spans_and_the_device_trace_share_a_clock(name, card):
    out = phases.run(harness.load_cell(name), 2**31 + 301, card, 30, 10)
    gc.collect()
    torch.cuda.empty_cache()
    att, m = out["attribution"], out["metrics"]
    assert att["steps"] == 10
    assert att["inside"] >= 0.99, att
    assert att["outside_us"] <= 20.0, att
    step = out["step_device_ms"]
    assert abs(sum(att["device_ms"].values()) + att["copy_ms"] - step) <= 0.03 * step, att
    assert m["idle_enqueue_share"] + m["idle_wait_share"] <= out["device_idle_share"] + 0.1, out
